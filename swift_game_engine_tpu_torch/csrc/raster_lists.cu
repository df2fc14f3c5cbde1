// K9: list-binned tile rasterizer — the nearest fragment per pixel, behind
// an optional per-pixel depth (depth peeling); K10: the `layers` nearest
// fragments per pixel in one pass. One kernel template, two policies.
//
// K9 replaces swift_game_engine_tpu/render/tile_raster.py:_raster_kernel
// (wrapper rasterize), K10 replaces :_raster_kernel_peeled (wrapper
// rasterize_peeled). Both read the per-tile candidate lists of the list
// binning (tile_raster.setup_lists): (tiles, K, 16) rows of 2D-homogeneous
// cofactors, vertex w's and the triangle id (-1 on fill rows), the first
// `count` of them real, in triangle index order. Per pixel and candidate:
// three edge forms, the orientation flip, the fragment depth detp/sig, and
// the reference's division-free depth tests — K9 keeps a fragment when
// detp*zd < zn*sig (strictly nearer: the first of equal depths wins) and
// detp > prev_w*sig (strictly behind the previous peel); K10 runs the
// insertion network of tile_raster.py:285-298 over `layers` slots.
// Expressions are kept literal, including zn = 3e38 with zd = 1 before the
// first fragment (zn*sig may overflow to inf there, as on the TPU).
//
// The first design for the card ran one thread a pixel over every
// candidate of its 32x128 tile: ~1.1e9 edge tests a peel on path 5, almost
// none of them inside, so the call was bound by the FP32 instructions it
// issued on tests that could not pass (~3.95 ms a call, PERF.md). This
// design:
//   * footprint: a warp covers an 8x4 pixel patch of a tile (each thread
//     still writes its pixel's tile-major slot); a block is LIST_WARPS
//     patches of one tile;
//   * staging: the block copies its tile's rows into shared memory with
//     cp.async, STAGE_ROWS at a time, double-buffered, so the lists are
//     read from L2 once a block instead of once a warp;
//   * cull: for each staged row one lane of each warp proves, or fails to
//     prove, that no pixel of its patch can pass the `inside` test (below);
//     the warp ballots, and its 32 pixels edge-test only the surviving
//     rows, in list order, each row a broadcast from shared memory. A
//     culled row cannot change any record of the patch, so every pixel
//     meets the same inside fragments in the same order as the
//     one-thread-a-pixel walk did, and the records are that walk's (the
//     plain twins', bit for bit);
//   * no split of a tile's list across blocks: the records depend on the
//     order in which a pixel meets equal depths (K9's first of equal
//     depths, K10's insertion order), which a merge of partial results
//     would have to rebuild;
//   * a counting instantiation (COUNT, null `work` in production) reports
//     per pixel the rows it edge-tests and the inside fragments it meets,
//     and per warp the rows it culls and the rows it admits.
//
// The cull. `inside` needs min(flip*lam0, flip*lam1, flip*lam2) >= 0 with
// flip = the sign of sig = lam0 + lam1 + lam2, so all three raw forms must
// share one sign. If one form is > 0 at every pixel of the patch and
// another < 0 at every pixel, no pixel can pass, whatever its flip (a NaN
// form makes sig NaN, which fails sig > 1e-20). A form f = a*x + b*y + c
// is evaluated at a pixel as the kernel evaluates it,
// e = fl(fl(fl(a*x) + fl(b*y)) + c) (separately rounded: --fmad=false),
// with x, y the pixel's f32 sample. The samples grow (x) and fall (y)
// monotonically with the pixel's column and row, each step a rounded
// monotone operation, and so does every step of e in each argument. So
// over the patch e is least at the corner pixel where a*x and b*y are
// least, and lo = fl(fl(min(fl(a*x0), fl(a*x1)) + min(fl(b*y0), fl(b*y1)))
// + c), with x0, x1, y0, y1 the patch's extreme samples (warp min/max of
// the pixels' own), is the kernel's own e at that corner; hi (max for min)
// is its greatest e. lo > 0 alone would prove e > 0 at every pixel. The
// cull asks for lo > m (or hi < -m), m = S*2^-19 + 1e-30 with
// S = |a|*X + |b|*Y + |c|, X = max(|x0|, |x1|), Y = max(|y0|, |y1|): a
// margin that holds even where the two evaluations round differently (a
// build that contracts them into FMAs, another operation order). The
// build here (ops/_cuda.py: --fmad=false, both written in one order) does
// neither, so there the margin is redundant: it guards a change of those
// flags or of either expression, at 9 of form_sign's 25 operations. With the
// unit roundoff u = 2^-24 and g3 = 3u/(1-3u), each term of either
// evaluation is rounded at most three times, so each lies within g3*S of
// the exact value and every pixel's e >= lo - 2*g3*S. S is itself rounded
// (relative error below g3), and 2^-19 = 32u is more than five times
// 2*g3*(1 + g3)*(1 + u); 1e-30 covers subnormal products (absolute error
// <= 2^-150 each). A form is used only when S < 1e38: then a, b, c are
// finite and no product or sum overflows; an inf or NaN coefficient makes
// S inf or NaN and the row is kept. The comparisons are strict, so a
// proved form is nonzero at every pixel. The cull never drops a fragment
// that the plain twin keeps (a screen-box cull can: ROADMAP §3, K1's pixel
// (652, 22)), and it admits only the patches that the triangle, its
// all-negative region or a vertex neighbourhood touch.

#include "common.cuh"

namespace sge {
namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int PER_TILE = TILE_H * TILE_W;
constexpr int PATCH_W = 8;                 // a warp's pixels: 8 x 4
constexpr int PATCH_H = 4;
constexpr int PATCHES_X = TILE_W / PATCH_W;
constexpr int WARPS_PER_TILE = PER_TILE / 32;
constexpr int LIST_WARPS = 8;              // warps (patches) per block
constexpr int BLOCKS_PER_TILE = WARPS_PER_TILE / LIST_WARPS;
constexpr int STAGE_ROWS = 128;            // rows staged at once (8 KB)
constexpr float CULL_MARGIN = 1.9073486328125e-06f;  // 2^-19 = 32u
constexpr float CULL_TINY = 1e-30f;
constexpr float CULL_SCALE_MAX = 1e38f;

// The patch's sample box: x in [x0, x1], y in [y0, y1], |x| <= ax,
// |y| <= ay.
struct PatchBox {
  float x0, x1, y0, y1, ax, ay;
};

// The sign the edge form a*x + b*y + c provably has at every pixel of the
// patch, as the kernel evaluates it: +1 (> 0 everywhere), -1 (< 0
// everywhere) or 0 (not proved). See the header for the margin.
__device__ __forceinline__ int form_sign(float a, float b, float c,
                                         const PatchBox& p) {
  const float ax0 = a * p.x0, ax1 = a * p.x1;
  const float by0 = b * p.y0, by1 = b * p.y1;
  const float lo = (fminf(ax0, ax1) + fminf(by0, by1)) + c;
  const float hi = (fmaxf(ax0, ax1) + fmaxf(by0, by1)) + c;
  const float s = (fabsf(a) * p.ax + fabsf(b) * p.ay) + fabsf(c);
  const float m = s * CULL_MARGIN + CULL_TINY;
  if (!(s < CULL_SCALE_MAX)) return 0;
  return lo > m ? 1 : (hi < -m ? -1 : 0);
}

// Row r (in shared memory) can have no inside fragment in the patch.
__device__ __forceinline__ bool culled(const float4* r, const PatchBox& p) {
  const float4 q0 = r[0], q1 = r[1], q2 = r[2];
  const int s0 = form_sign(q0.x, q0.y, q0.z, p);
  const int s1 = form_sign(q0.w, q1.x, q1.y, p);
  const int s2 = form_sign(q1.z, q1.w, q2.x, p);
  return (s0 > 0 || s1 > 0 || s2 > 0) && (s0 < 0 || s1 < 0 || s2 < 0);
}

// A candidate at the pixel: edge forms orientation-flipped, sig, detp =
// sum_i lam_i w_i and whether it is inside (tile_raster.py:186-202).
struct Frag {
  float lam1, lam2, sig, detp, id;
  bool inside;
};

__device__ __forceinline__ Frag frag(const Row16& r, float x, float y) {
  float lam0 = r.s(0) * x + r.s(1) * y + r.s(2);
  float lam1 = r.s(3) * x + r.s(4) * y + r.s(5);
  float lam2 = r.s(6) * x + r.s(7) * y + r.s(8);
  float sig = lam0 + lam1 + lam2;
  const float flip = sig < 0.0f ? -1.0f : 1.0f;
  lam0 *= flip; lam1 *= flip; lam2 *= flip; sig *= flip;
  Frag f;
  f.lam1 = lam1;
  f.lam2 = lam2;
  f.sig = sig;
  f.detp = lam0 * r.s(9) + lam1 * r.s(10) + lam2 * r.s(11);
  f.id = r.s(12);
  f.inside = fminf(fminf(lam0, lam1), lam2) >= 0.0f && sig > 1e-20f &&
             f.id >= 0.0f;
  return f;
}

// A pixel's kept fragments, L slots: (zn, zd) the depth detp/sig as a
// fraction, the id (-1: empty) and lam1, lam2.
template <int L>
struct Records {
  static constexpr int LAYERS = L;
  float zn[L], zd[L], tid[L], l1[L], l2[L];
  __device__ __forceinline__ Records() {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      zn[l] = BIG; zd[l] = 1.0f; tid[l] = -1.0f; l1[l] = 0.0f; l2[l] = 0.0f;
    }
  }
  // out (tiles, L, 32, 128): id int32, b1, b2, w
  __device__ __forceinline__ void store(int64_t tile, int within,
                                        int32_t* id_out, float* b1_out,
                                        float* b2_out, float* w_out) const {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int64_t o = (tile * L + l) * PER_TILE + within;
      const float inv = 1.0f / zd[l];
      id_out[o] = int32_t(tid[l]);
      b1_out[o] = l1[l] * inv;
      b2_out[o] = l2[l] * inv;
      w_out[o] = tid[l] >= 0.0f ? zn[l] * inv : BIG;
    }
  }
};

// K9's policy: the nearest inside fragment in front of the camera and
// strictly behind the previous peel's depth pw (0 without one); the first
// of equal depths stays.
struct NearestBehind : Records<1> {
  float pw;
  __device__ __forceinline__ explicit NearestBehind(float prev) : pw(prev) {}
  __device__ __forceinline__ void visit(const Frag& f) {
    if (f.inside && f.detp > 0.0f && f.detp * zd[0] < zn[0] * f.sig &&
        f.detp > pw * f.sig) {
      zn[0] = f.detp; zd[0] = f.sig; tid[0] = f.id; l1[0] = f.lam1;
      l2[0] = f.lam2;
    }
  }
};

// K10's policy: the insertion network over L slots; the displaced
// incumbent becomes the candidate for the next slot.
template <int L>
struct Peeled : Records<L> {
  __device__ __forceinline__ explicit Peeled(float) {}
  __device__ __forceinline__ void visit(const Frag& f) {
    if (!(f.inside && f.detp > 0.0f)) return;
    float czn = f.detp, czd = f.sig, ctid = f.id, cl1 = f.lam1,
          cl2 = f.lam2;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const bool win = ctid >= 0.0f &&
                       (this->tid[l] < 0.0f ||
                        czn * this->zd[l] < this->zn[l] * czd);
      if (win) {
        float t;
        t = this->zn[l]; this->zn[l] = czn; czn = t;
        t = this->zd[l]; this->zd[l] = czd; czd = t;
        t = this->tid[l]; this->tid[l] = ctid; ctid = t;
        t = this->l1[l]; this->l1[l] = cl1; cl1 = t;
        t = this->l2[l]; this->l2[l] = cl2; cl2 = t;
      }
    }
  }
};

// Rows [c*STAGE_ROWS, c*STAGE_ROWS + n) of the tile's list into `dst`,
// the block's threads each copying 16 bytes at a time.
__device__ __forceinline__ void stage_rows(float4* dst,
                                           const float4* __restrict__ rows,
                                           int c, int n) {
  const float4* src = rows + int64_t(c) * STAGE_ROWS * 4;
  for (int e = threadIdx.x; e < n * 4; e += LIST_WARPS * 32)
    cp_async16(dst + e, src + e);
}

// grid (tiles, BLOCKS_PER_TILE); block b of a tile holds patches
// [b*LIST_WARPS, (b+1)*LIST_WARPS) in tile-major order, a warp each.
// work (COUNT), in launch order (32 lanes a warp, one pixel each): per
// pixel [0, n) rows it edge-tests, [n, 2n) inside fragments it meets; per
// warp w at 2n + 2w: rows its lanes cull-test, rows its ballots admit.
template <class P, bool COUNT>
__global__ void __launch_bounds__(LIST_WARPS * 32)
list_kernel(const int32_t* __restrict__ counts,
            const float4* __restrict__ cand, const float* __restrict__ prev_w,
            int k, float sx, float sy, int tiles_x,
            int32_t* __restrict__ work, int32_t* __restrict__ id_out,
            float* __restrict__ b1_out, float* __restrict__ b2_out,
            float* __restrict__ w_out) {
  __shared__ float4 stage[2][STAGE_ROWS * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = blockIdx.x;
  const int patch = int(blockIdx.y) * LIST_WARPS + warp;
  const int qx = (patch % PATCHES_X) * PATCH_W + lane % PATCH_W;
  const int qy = (patch / PATCHES_X) * PATCH_H + lane / PATCH_W;
  const int within = qy * TILE_W + qx;
  const int px = int(tile % tiles_x) * TILE_W + qx;
  const int py = int(tile / tiles_x) * TILE_H + qy;
  const float x = (float(px) + 0.5f) * sx - 1.0f;
  const float y = 1.0f - (float(py) + 0.5f) * sy;
  PatchBox box;
  box.x0 = warp_min(x);
  box.x1 = warp_max(x);
  box.y0 = warp_min(y);
  box.y1 = warp_max(y);
  box.ax = fmaxf(fabsf(box.x0), fabsf(box.x1));
  box.ay = fmaxf(fabsf(box.y0), fabsf(box.y1));
  P rec(prev_w != nullptr ? __ldg(prev_w + tile * PER_TILE + within)
                          : 0.0f);
  int l_test = 0, l_inside = 0, w_cull = 0, w_admit = 0;

  const int count = __ldg(counts + tile);
  const float4* rows = cand + tile * int64_t(k) * 4;
  const int chunks = (count + STAGE_ROWS - 1) / STAGE_ROWS;
  if (chunks > 0) stage_rows(stage[0], rows, 0, min(STAGE_ROWS, count));
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {                  // the next chunk loads meanwhile
      stage_rows(stage[(c + 1) & 1], rows, c + 1,
                 min(STAGE_ROWS, count - (c + 1) * STAGE_ROWS));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // chunk c is in shared memory
    const float4* buf = stage[c & 1];
    const int n = min(STAGE_ROWS, count - c * STAGE_ROWS);
#pragma unroll 1
    for (int q = 0; q < n; q += 32) {
      const int j = q + lane;
      const unsigned rs =
          __ballot_sync(FULL, j < n && !culled(buf + 4 * j, box));
      if (COUNT) {
        w_cull += min(32, n - q);
        w_admit += __popc(rs);
      }
      for (unsigned s = rs; s; s &= s - 1) {   // admitted rows, in order
        const float4* r4 = buf + 4 * (q + __ffs(s) - 1);
        const Frag f = frag(Row16{r4[0], r4[1], r4[2], r4[3]}, x, y);
        if (COUNT) {
          ++l_test;
          l_inside += f.inside;
        }
        rec.visit(f);
      }
    }
    __syncthreads();                       // the buffer is free again
  }
  rec.store(tile, within, id_out, b1_out, b2_out, w_out);
  if (COUNT) {
    const int64_t wid = tile * WARPS_PER_TILE + patch;
    const int64_t n = int64_t(gridDim.x) * PER_TILE, i = wid * 32 + lane;
    work[i] = l_test;
    work[n + i] = l_inside;
    if (lane == 0) {
      work[2 * n + 2 * wid] = w_cull;
      work[2 * n + 2 * wid + 1] = w_admit;
    }
  }
}

template <class P>
void launch(const int32_t* counts, const float* cand, const float* prev_w,
            int n_tiles, int k, float sx, float sy, int tiles_x,
            int32_t* work, int32_t* id, float* b1, float* b2, float* w,
            cudaStream_t st) {
  const dim3 grid(n_tiles, BLOCKS_PER_TILE);
  const float4* c4 = reinterpret_cast<const float4*>(cand);
  if (work != nullptr)
    list_kernel<P, true><<<grid, LIST_WARPS * 32, 0, st>>>(
        counts, c4, prev_w, k, sx, sy, tiles_x, work, id, b1, b2, w);
  else
    list_kernel<P, false><<<grid, LIST_WARPS * 32, 0, st>>>(
        counts, c4, prev_w, k, sx, sy, tiles_x, work, id, b1, b2, w);
}

}  // namespace
}  // namespace sge

// counts (tiles,) int32, cand (tiles, k, 16) f32, prev_w (tiles, 32, 128) f32
// or null, work (2*tiles*4096 + 2*tiles*128,) int32 or null. Out (tiles, 32,
// 128): id int32, b1, b2, w.
SGE_API int sge_list_raster(const int32_t* counts, const float* cand,
                            const float* prev_w, int n_tiles, int k, float sx,
                            float sy, int tiles_x, int32_t* work, int32_t* id,
                            float* b1, float* b2, float* w, void* stream) {
  if (n_tiles > 0)
    sge::launch<sge::NearestBehind>(counts, cand, prev_w, n_tiles, k, sx, sy,
                                    tiles_x, work, id, b1, b2, w,
                                    static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}

// counts (tiles,) int32, cand (tiles, k, 16) f32, work as above or null.
// Out (tiles, layers, 32, 128): id int32, b1, b2, w.
SGE_API int sge_list_peeled(const int32_t* counts, const float* cand,
                            int n_tiles, int k, float sx, float sy,
                            int tiles_x, int layers, int32_t* work,
                            int32_t* id, float* b1, float* b2, float* w,
                            void* stream) {
  if (n_tiles == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (layers) {
    case 1: sge::launch<sge::Peeled<1>>(counts, cand, nullptr, n_tiles, k, sx,
                                        sy, tiles_x, work, id, b1, b2, w, st);
      break;
    case 2: sge::launch<sge::Peeled<2>>(counts, cand, nullptr, n_tiles, k, sx,
                                        sy, tiles_x, work, id, b1, b2, w, st);
      break;
    case 3: sge::launch<sge::Peeled<3>>(counts, cand, nullptr, n_tiles, k, sx,
                                        sy, tiles_x, work, id, b1, b2, w, st);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
