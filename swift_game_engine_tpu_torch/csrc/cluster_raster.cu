// K1: cluster tile rasterizer — nearest `layers` fragments per pixel.
//
// Replaces swift_game_engine_tpu/render/tile_raster.py:_cluster_kernel
// (wrapper rasterize_clusters). Same contract: 2D-homogeneous edge tests
// from the per-triangle (T,16) cofactor rows, clusters walked front to back
// by their min view depth with a screen-AABB reject, the `layers` nearest
// fragments kept by a division-free insertion network, an early exit once
// no later cluster can displace a kept fragment (opaque track and prior_w
// bound included), outputs in padded tile-major lane order. Padding pixels
// outside the image write empty records (the caller crops them).
//
// The first design for the card ran one thread per pixel, 32 pixels of one
// tile row to a warp; every thread stepped the depth-sorted metadata one
// entry at a time and edge-tested every row of each cluster whose box held
// its pixel. Counted on path 1's first frame (PERF.md), the warp's 32x1
// strip looped over every row of every cluster any of its pixels entered,
// and that row work, not memory traffic, set the time. This design (on
// that frame 2.73 -> 0.27 ms for the opaque raster and 2.08 -> 0.06 ms for
// the translucent one; still far above the bytes floor, held by the
// warp's rounds of metadata and row-box ballots):
//   * footprint: a warp covers an 8x4 pixel patch of a tile (each thread
//     still writes its pixel's tile-major slot), so its pixels share the
//     clusters and rows they overlap;
//   * culling: the warp tests 32 metadata entries at once, one per thread,
//     against the patch's pixel box and the largest depth bound of its live
//     pixels, and ballots the survivors; each pixel then meets its own
//     bound and box tests on the survivors in depth order, as the
//     per-pixel walk did;
//   * rows: within an entered cluster the warp tests 32 rows' screen boxes
//     at once (`boxes`, one per row, from setup; up to 128 rows' boxes in
//     flight) against the patch and copies only the rows that overlap it
//     into shared memory, one row a thread (plain loads: a warp stages
//     ~10 rows in all on path 1, too few for an asynchronous copy to hide
//     anything);
//     each pixel that entered the cluster edge-tests those rows in row
//     order. A row whose box misses the patch cannot cover a pixel of it,
//     so every pixel meets the same inside fragments in the same order as
//     the per-pixel walk, and the records are that walk's;
//   * exit: the warp stops once every pixel is past its bound (__all_sync)
//     or the next entry lies past the warp's largest bound;
//   * a counting instantiation (COUNT, null counts in production) reports
//     the per-pixel and per-warp work.

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
constexpr int RASTER_WARPS = 8;            // warps per block
constexpr int ROWS_CHUNK = 32;             // rows culled and staged at once
constexpr int BOX_ROWS = 128;              // row boxes loaded at once

// A box [x0, y0, x1, y1] (pixel units) misses the pixel square
// [fx0, fx1] x [fy0, fy1].
__device__ __forceinline__ bool misses(float x0, float y0, float x1, float y1,
                                       float fx0, float fy0, float fx1,
                                       float fy1) {
  return x0 > fx1 || x1 < fx0 || y0 > fy1 || y1 < fy0;
}

// One warp per 8x4 pixel patch, patches in tile-major order.
// counts (COUNT), per thread in launch order (32 a warp, one pixel each):
// [0, n) metadata entries the pixel tests itself (footprint survivors
// while it walks), [n, 2n) clusters it enters, [2n, 3n) triangle rows it
// edge-tests; per warp w at 3n + 5w: entries its ballots test, footprint
// survivors, clusters some pixel enters, row boxes its ballots test, rows
// it stages and loops over.
template <int LAYERS, bool PRIOR, bool COUNT>
__global__ void __launch_bounds__(RASTER_WARPS * 32)
cluster_raster_kernel(const float4* __restrict__ rows,
                      const float4* __restrict__ boxes,
                      const float* __restrict__ meta,
                      const float* __restrict__ prior, int n_clusters,
                      int cluster, int width, int height, float sx, float sy,
                      int tiles_x, int64_t n_warps,
                      int32_t* __restrict__ counts,
                      int32_t* __restrict__ id_out, float* __restrict__ b1_out,
                      float* __restrict__ b2_out, float* __restrict__ w_out) {
  __shared__ float4 stage[RASTER_WARPS][ROWS_CHUNK * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wid = int64_t(blockIdx.x) * RASTER_WARPS + warp;
  if (wid >= n_warps) return;              // the whole warp leaves
  const int64_t tile = wid / WARPS_PER_TILE;
  const int patch = int(wid % WARPS_PER_TILE);
  const int qx = (patch % PATCHES_X) * PATCH_W + lane % PATCH_W;
  const int qy = (patch / PATCHES_X) * PATCH_H + lane / PATCH_W;
  const int within = qy * TILE_W + qx;
  const int px = int(tile % tiles_x) * TILE_W + qx;
  const int py = int(tile / tiles_x) * TILE_H + qy;

  float zn[LAYERS], zd[LAYERS], tid[LAYERS], l1s[LAYERS], l2s[LAYERS];
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
    zn[l] = BIG; zd[l] = 1.0f; tid[l] = -1.0f; l1s[l] = 0.0f; l2s[l] = 0.0f;
  }
  float on = BIG, od = 1.0f;  // nearest opaque fragment (LAYERS > 1)
  int l_meta = 0, l_enter = 0, l_tri = 0;
  int w_meta = 0, w_surv = 0, w_enter = 0, w_box = 0, w_tri = 0;

  const bool in = px < width && py < height;
  const float x = (float(px) + 0.5f) * sx - 1.0f;
  const float y = 1.0f - (float(py) + 0.5f) * sy;
  const float pb = PRIOR && in ? __ldg(prior + tile * PER_TILE + within)
                               : BIG;
  float bound = pb;
  bool done = !in;
  // the pixel's square, and the patch's (over in-image pixels)
  const float fx0 = float(px), fx1 = float(px + 1);
  const float fy0 = float(py), fy1 = float(py + 1);
  const float gx0 = warp_min(in ? fx0 : BIG), gx1 = warp_max(in ? fx1 : -BIG);
  const float gy0 = warp_min(in ? fy0 : BIG), gy1 = warp_max(in ? fy1 : -BIG);
  const float4* meta4 = reinterpret_cast<const float4*>(meta);
  float4* buf = stage[warp];

  for (int c0 = 0; c0 < n_clusters; c0 += 32) {
    if (__all_sync(FULL, done)) break;
    const float wb = warp_max(done ? -BIG : bound);
    // 32 entries at once, one per thread: [x0, y0, x1, y1], [w_min, base]
    const int c = c0 + lane;
    float4 m0 = make_float4(BIG, BIG, -BIG, -BIG);
    float4 m1 = make_float4(BIG, 0.0f, 0.0f, 0.0f);
    if (c < n_clusters) {
      m0 = __ldg(meta4 + 2 * int64_t(c));
      m1 = __ldg(meta4 + 2 * int64_t(c) + 1);
    }
    // entries are sorted by w_min: from the first one past every pixel's
    // bound on, none is needed
    const unsigned past = __ballot_sync(FULL, c >= n_clusters || m1.x >= wb);
    const int live_n = past ? __ffs(past) - 1 : 32;
    const unsigned surv = __ballot_sync(
        FULL, lane < live_n && !misses(m0.x, m0.y, m0.z, m0.w, gx0, gy0, gx1,
                                       gy1));
    if (COUNT) {
      w_meta += min(32, n_clusters - c0);
      w_surv += __popc(surv);
    }
    for (unsigned sv = surv; sv; sv &= sv - 1) {
      const int s = __ffs(sv) - 1;
      const float a0 = __shfl_sync(FULL, m0.x, s);
      const float b0 = __shfl_sync(FULL, m0.y, s);
      const float a1 = __shfl_sync(FULL, m0.z, s);
      const float b1 = __shfl_sync(FULL, m0.w, s);
      const float d0 = __shfl_sync(FULL, m1.x, s);
      const int base = int(__shfl_sync(FULL, m1.y, s));
      // each pixel's own tests, in the per-pixel walk's order
      if (!done) {
        if (COUNT) ++l_meta;
        done = d0 >= bound;                // nothing later can win
      }
      const bool need = !done && !misses(a0, b0, a1, b1, fx0, fy0, fx1, fy1);
      if (!__any_sync(FULL, need)) {
        if (__all_sync(FULL, done)) break;
        continue;
      }
      if (COUNT) {
        l_enter += need;
        ++w_enter;
      }
      const int64_t row0 = int64_t(base) * 8;
      for (int g0 = 0; g0 < cluster; g0 += BOX_ROWS) {
        // the boxes of up to 128 rows, loaded together: bit q of `keep`
        // says whether row g0 + 32q + lane overlaps the patch
        unsigned keep = 0;
#pragma unroll
        for (int q = 0; q < BOX_ROWS / ROWS_CHUNK; ++q) {
          const int j = g0 + q * ROWS_CHUNK + lane;
          if (j < cluster) {
            const float4 bx = __ldg(boxes + row0 + j);
            keep |= unsigned(!misses(bx.x, bx.y, bx.z, bx.w, gx0, gy0, gx1,
                                     gy1)) << q;
          }
        }
#pragma unroll 1
        for (int q = 0; q < BOX_ROWS / ROWS_CHUNK; ++q) {
          const int j0 = g0 + q * ROWS_CHUNK;
          const unsigned rs = __ballot_sync(FULL, keep >> q & 1u);
          if (COUNT && j0 < cluster) {
            w_box += min(ROWS_CHUNK, cluster - j0);
            w_tri += __popc(rs);
          }
          if (!rs) continue;
          // the rows that overlap the patch, in row order
          if (rs >> lane & 1u) {
            const int k = __popc(rs & ((1u << lane) - 1u));
            const float4* src = rows + (row0 + j0 + lane) * 4;
#pragma unroll
            for (int e = 0; e < 4; ++e) buf[4 * k + e] = __ldg(src + e);
          }
          __syncwarp();
          if (need) {
            const int nk = __popc(rs);
            for (int k = 0; k < nk; ++k) {
              const Row16 r{buf[4 * k], buf[4 * k + 1], buf[4 * k + 2],
                            buf[4 * k + 3]};
              if (COUNT) ++l_tri;
              float lam0 = r.s(0) * x + r.s(1) * y + r.s(2);
              float lam1 = r.s(3) * x + r.s(4) * y + r.s(5);
              float lam2 = r.s(6) * x + r.s(7) * y + r.s(8);
              float sig = lam0 + lam1 + lam2;
              const float flip = sig < 0.0f ? -1.0f : 1.0f;
              lam0 *= flip; lam1 *= flip; lam2 *= flip; sig *= flip;
              const float detp = lam0 * r.s(9) + lam1 * r.s(10) +
                                 lam2 * r.s(11);
              bool inside = fminf(fminf(lam0, lam1), lam2) >= 0.0f &&
                            sig > 1e-20f && r.s(12) >= 0.0f && detp > 0.0f;
              if (PRIOR) inside = inside && detp < pb * sig;
              if (!inside) continue;
              float czn = detp, czd = sig, ctid = r.s(12), cl1 = lam1,
                    cl2 = lam2;
#pragma unroll
              for (int l = 0; l < LAYERS; ++l) {
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
              if (LAYERS > 1 && r.s(13) > 0.5f && detp * od < on * sig) {
                on = detp;
                od = sig;
              }
            }
          }
          __syncwarp();                    // the buffer is free again
        }
      }
      if (need) {                          // the pixel's bound after it
        float depth = tid[LAYERS - 1] >= 0.0f
                          ? zn[LAYERS - 1] / zd[LAYERS - 1] : BIG;
        if (LAYERS > 1) depth = fminf(depth, on / od);
        if (PRIOR) depth = fminf(depth, pb);
        bound = depth;
      }
    }
    if (live_n < 32) break;               // the rest lies past every bound
  }
#pragma unroll
  for (int l = 0; l < LAYERS; ++l) {
    const int64_t o = (tile * LAYERS + l) * PER_TILE + within;
    const float inv = 1.0f / zd[l];
    id_out[o] = int32_t(tid[l]);
    b1_out[o] = l1s[l] * inv;
    b2_out[o] = l2s[l] * inv;
    w_out[o] = tid[l] >= 0.0f ? zn[l] * inv : BIG;
  }
  if (COUNT) {
    const int64_t n = n_warps * 32, i = wid * 32 + lane;
    counts[i] = l_meta;
    counts[n + i] = l_enter;
    counts[2 * n + i] = l_tri;
    if (lane == 0) {
      int32_t* w = counts + 3 * n + 5 * wid;
      w[0] = w_meta;
      w[1] = w_surv;
      w[2] = w_enter;
      w[3] = w_box;
      w[4] = w_tri;
    }
  }
}

template <int LAYERS, bool PRIOR>
void launch(bool count, const float4* rows, const float4* boxes,
            const float* meta, const float* prior, int n_clusters,
            int cluster, int width, int height, float sx, float sy,
            int tiles_x, int64_t n_warps, int32_t* counts, int32_t* id,
            float* b1, float* b2, float* w, cudaStream_t st) {
  const unsigned blocks =
      unsigned((n_warps + RASTER_WARPS - 1) / RASTER_WARPS);
  if (count)
    cluster_raster_kernel<LAYERS, PRIOR, true>
        <<<blocks, RASTER_WARPS * 32, 0, st>>>(
            rows, boxes, meta, prior, n_clusters, cluster, width, height, sx,
            sy, tiles_x, n_warps, counts, id, b1, b2, w);
  else
    cluster_raster_kernel<LAYERS, PRIOR, false>
        <<<blocks, RASTER_WARPS * 32, 0, st>>>(
            rows, boxes, meta, prior, n_clusters, cluster, width, height, sx,
            sy, tiles_x, n_warps, counts, id, b1, b2, w);
}

template <int LAYERS>
void launch_layers(const float4* rows, const float4* boxes, const float* meta,
                   const float* prior, int n_clusters, int cluster, int width,
                   int height, float sx, float sy, int tiles_x,
                   int64_t n_warps, int32_t* counts, int32_t* id, float* b1,
                   float* b2, float* w, cudaStream_t st) {
  const bool count = counts != nullptr;
  if (prior != nullptr)
    launch<LAYERS, true>(count, rows, boxes, meta, prior, n_clusters, cluster,
                         width, height, sx, sy, tiles_x, n_warps, counts, id,
                         b1, b2, w, st);
  else
    launch<LAYERS, false>(count, rows, boxes, meta, prior, n_clusters,
                          cluster, width, height, sx, sy, tiles_x, n_warps,
                          counts, id, b1, b2, w, st);
}

}  // namespace
}  // namespace sge

// rows (Tp,16) f32, boxes (Tp,4) f32, meta (C,8) f32, prior
// (tiles*32*128,) f32 or null, counts (3P + 5P/32,) int32 or null.
// Outputs (tiles, layers, 32, 128). Returns the launch's cudaError_t.
SGE_API int sge_cluster_raster(const float* rows, const float* boxes,
                               const float* meta, const float* prior,
                               int n_clusters, int cluster, int width,
                               int height, float sx, float sy, int tiles_x,
                               int n_tiles, int layers, int32_t* counts,
                               int32_t* id, float* b1, float* b2, float* w,
                               void* stream) {
  const int64_t n_warps = int64_t(n_tiles) * sge::WARPS_PER_TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  switch (layers) {
    case 1: sge::launch_layers<1>(r4, b4, meta, prior, n_clusters, cluster,
                                  width, height, sx, sy, tiles_x, n_warps,
                                  counts, id, b1, b2, w, st);
      break;
    case 2: sge::launch_layers<2>(r4, b4, meta, prior, n_clusters, cluster,
                                  width, height, sx, sy, tiles_x, n_warps,
                                  counts, id, b1, b2, w, st);
      break;
    case 3: sge::launch_layers<3>(r4, b4, meta, prior, n_clusters, cluster,
                                  width, height, sx, sy, tiles_x, n_warps,
                                  counts, id, b1, b2, w, st);
      break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

SGE_API const char* sge_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
