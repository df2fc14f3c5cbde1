// K9: list-binned tile rasterizer — the nearest fragment per pixel, behind
// an optional per-pixel depth (depth peeling); K10: the `layers` nearest
// fragments per pixel in one pass.
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
// Design for Hopper: one thread per pixel, walking its tile's candidates in
// list order. A 32x128 tile is four blocks of 8x128 pixels (a block holds
// at most 1024 threads); every thread of a block reads the same candidate
// row at the same time, so the row loads (four 16-byte loads) are
// warp-wide broadcasts served from L1/L2. The candidate lists are read
// once per block: 136 tiles x 8,192 rows x 64 B = 71 MB at 960x540, which
// at four blocks per tile is ~285 MB of L2 traffic. What bounds it is the
// per-pixel edge-test arithmetic over the tile's candidates (FP32 issue).
// Staging rows through shared memory is left to a later change.

#include "common.cuh"

namespace sge {
namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int PER_TILE = TILE_H * TILE_W;
constexpr int QUARTER = 1024;   // pixels (threads) per block

// Pixel of this thread: (tile, within-tile lane) and its NDC sample.
struct Pixel {
  int64_t tile;
  int within;
  float x, y;
};

__device__ __forceinline__ Pixel pixel(int tiles_x, float sx, float sy) {
  Pixel p;
  p.tile = blockIdx.x;
  p.within = int(blockIdx.y) * QUARTER + int(threadIdx.x);
  const int px = int(p.tile % tiles_x) * TILE_W + p.within % TILE_W;
  const int py = int(p.tile / tiles_x) * TILE_H + p.within / TILE_W;
  p.x = (float(px) + 0.5f) * sx - 1.0f;
  p.y = 1.0f - (float(py) + 0.5f) * sy;
  return p;
}

// Edge forms of candidate row r at (x, y), orientation-flipped: lam0..2,
// sig and detp = sum_i lam_i w_i (tile_raster.py:186-199).
__device__ __forceinline__ void edges(const Row16& r, float x, float y,
                                      float& lam0, float& lam1, float& lam2,
                                      float& sig, float& detp) {
  lam0 = r.s(0) * x + r.s(1) * y + r.s(2);
  lam1 = r.s(3) * x + r.s(4) * y + r.s(5);
  lam2 = r.s(6) * x + r.s(7) * y + r.s(8);
  sig = lam0 + lam1 + lam2;
  const float flip = sig < 0.0f ? -1.0f : 1.0f;
  lam0 *= flip; lam1 *= flip; lam2 *= flip; sig *= flip;
  detp = lam0 * r.s(9) + lam1 * r.s(10) + lam2 * r.s(11);
}

__global__ void __launch_bounds__(QUARTER)
list_raster_kernel(const int32_t* __restrict__ counts,
                   const float4* __restrict__ cand,
                   const float* __restrict__ prev_w, int k, float sx,
                   float sy, int tiles_x, int32_t* __restrict__ id_out,
                   float* __restrict__ b1_out, float* __restrict__ b2_out,
                   float* __restrict__ w_out) {
  const Pixel p = pixel(tiles_x, sx, sy);
  const int64_t o = p.tile * PER_TILE + p.within;
  const float pw = prev_w != nullptr ? __ldg(prev_w + o) : 0.0f;
  float zn = BIG, zd = 1.0f, tid = -1.0f, l1 = 0.0f, l2 = 0.0f;
  const int count = __ldg(counts + p.tile);
  const float4* rows = cand + p.tile * int64_t(k) * 4;
  for (int j = 0; j < count; ++j) {
    const Row16 r = load_row16(rows, j);
    float lam0, lam1, lam2, sig, detp;
    edges(r, p.x, p.y, lam0, lam1, lam2, sig, detp);
    const bool inside = fminf(fminf(lam0, lam1), lam2) >= 0.0f &&
                        sig > 1e-20f && r.s(12) >= 0.0f;
    const bool front = detp > 0.0f;
    const bool nearer = detp * zd < zn * sig;
    const bool behind_prev = detp > pw * sig;
    if (inside && front && nearer && behind_prev) {
      zn = detp; zd = sig; tid = r.s(12); l1 = lam1; l2 = lam2;
    }
  }
  const float inv = 1.0f / zd;
  id_out[o] = int32_t(tid);
  b1_out[o] = l1 * inv;
  b2_out[o] = l2 * inv;
  w_out[o] = tid >= 0.0f ? zn * inv : BIG;
}

template <int LAYERS>
__global__ void __launch_bounds__(QUARTER)
list_peeled_kernel(const int32_t* __restrict__ counts,
                   const float4* __restrict__ cand, int k, float sx, float sy,
                   int tiles_x, int32_t* __restrict__ id_out,
                   float* __restrict__ b1_out, float* __restrict__ b2_out,
                   float* __restrict__ w_out) {
  const Pixel p = pixel(tiles_x, sx, sy);
  float zn[LAYERS], zd[LAYERS], tid[LAYERS], l1s[LAYERS], l2s[LAYERS];
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
    zn[l] = BIG; zd[l] = 1.0f; tid[l] = -1.0f; l1s[l] = 0.0f; l2s[l] = 0.0f;
  }
  const int count = __ldg(counts + p.tile);
  const float4* rows = cand + p.tile * int64_t(k) * 4;
  for (int j = 0; j < count; ++j) {
    const Row16 r = load_row16(rows, j);
    float lam0, lam1, lam2, sig, detp;
    edges(r, p.x, p.y, lam0, lam1, lam2, sig, detp);
    const bool inside = fminf(fminf(lam0, lam1), lam2) >= 0.0f &&
                        sig > 1e-20f && r.s(12) >= 0.0f && detp > 0.0f;
    float czn = detp, czd = sig, ctid = inside ? r.s(12) : -1.0f,
          cl1 = lam1, cl2 = lam2;
#pragma unroll
    for (int l = 0; l < LAYERS; ++l) {
      // the displaced incumbent becomes the candidate for slot l+1
      const bool win = ctid >= 0.0f &&
                       (tid[l] < 0.0f || czn * zd[l] < zn[l] * czd);
      if (win) {
        float t;
        t = zn[l]; zn[l] = czn; czn = t;
        t = zd[l]; zd[l] = czd; czd = t;
        t = tid[l]; tid[l] = ctid; ctid = t;
        t = l1s[l]; l1s[l] = cl1; cl1 = t;
        t = l2s[l]; l2s[l] = cl2; cl2 = t;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
    const int64_t o = (p.tile * LAYERS + l) * PER_TILE + p.within;
    const float inv = 1.0f / zd[l];
    id_out[o] = int32_t(tid[l]);
    b1_out[o] = l1s[l] * inv;
    b2_out[o] = l2s[l] * inv;
    w_out[o] = tid[l] >= 0.0f ? zn[l] * inv : BIG;
  }
}

}  // namespace
}  // namespace sge

// counts (tiles,) int32, cand (tiles, k, 16) f32, prev_w (tiles, 32, 128) f32
// or null. Out (tiles, 32, 128): id int32, b1, b2, w.
SGE_API int sge_list_raster(const int32_t* counts, const float* cand,
                            const float* prev_w, int n_tiles, int k, float sx,
                            float sy, int tiles_x, int32_t* id, float* b1,
                            float* b2, float* w, void* stream) {
  if (n_tiles > 0)
    sge::list_raster_kernel<<<dim3(n_tiles, sge::PER_TILE / sge::QUARTER),
                              sge::QUARTER, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        counts, reinterpret_cast<const float4*>(cand), prev_w, k, sx, sy,
        tiles_x, id, b1, b2, w);
  return int(cudaGetLastError());
}

// counts (tiles,) int32, cand (tiles, k, 16) f32. Out (tiles, layers, 32,
// 128): id int32, b1, b2, w.
SGE_API int sge_list_peeled(const int32_t* counts, const float* cand,
                            int n_tiles, int k, float sx, float sy,
                            int tiles_x, int layers, int32_t* id, float* b1,
                            float* b2, float* w, void* stream) {
  if (n_tiles == 0) return int(cudaGetLastError());
  const dim3 grid(n_tiles, sge::PER_TILE / sge::QUARTER);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* c4 = reinterpret_cast<const float4*>(cand);
  switch (layers) {
    case 1: sge::list_peeled_kernel<1><<<grid, sge::QUARTER, 0, st>>>(
        counts, c4, k, sx, sy, tiles_x, id, b1, b2, w); break;
    case 2: sge::list_peeled_kernel<2><<<grid, sge::QUARTER, 0, st>>>(
        counts, c4, k, sx, sy, tiles_x, id, b1, b2, w); break;
    case 3: sge::list_peeled_kernel<3><<<grid, sge::QUARTER, 0, st>>>(
        counts, c4, k, sx, sy, tiles_x, id, b1, b2, w); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
