// K7: shared-direction shadow walk — every shadow layer of an origin toward
// light 0 in one traversal.
//
// Replaces swift_game_engine_tpu/ops/rt_kernel.py:_kernel_shadow_factor
// (wrapper trace_shadow_factor). Every shadow ray of a frame points at the
// same light L, so the per-frame shadow rows (build_shadow_rows) hold, per
// leaf triangle, constants g1, g2, g3, c with u = P.g1 - c1, v = P.g2 - c2,
// t = P.g3 - c3: a slot test is three dot products of the origin P. One walk
// returns, per origin, the nearest OPAQUE t and the NS nearest TRANSLUCENT
// (t, id + 0.5) below t_lim, ascending; the caller applies the layer
// semantics (alpha product, 0.02 cut-off, layer cap) elementwise.
//
// Design for Hopper: one thread per origin follows the tree's skip links
// (descend to node+1 on a box hit at an interior node, else jump to the
// skip link), with the per-origin prune bound min(t_lim, t_opq, ts[NS-1]).
// The TPU kernel walks a 4096-origin packet with one cursor; a lane's
// records change only at leaves its own box hits, in the same preorder, so
// the two give the same records. At the decimated DemoScene's 12,768 rows
// the header is 0.4 MB and the leaf rows (156 f32, 624 B each) 4.0 MB,
// inside the 50 MB L2, read straight from global memory. What bounds it is
// the chain of dependent node loads per origin (latency), hidden by many
// origins in flight.

#include "common.cuh"

namespace sge {
namespace {

constexpr int SH_SLOT_F = 12;                        // g1, g2, g3, c
constexpr int SH_ROW_W = SH_SLOT_F * SLOT_N + SLOT_N;  // + the ids

template <int NS>
__global__ void __launch_bounds__(BLOCK_THREADS)
shadow_walk_kernel(const float* __restrict__ header,
                   const float* __restrict__ srows, float ix, float iy,
                   float iz, const float* __restrict__ o,
                   const float* __restrict__ t_lim, int64_t n,
                   float* __restrict__ t_opq_out, float* __restrict__ ts_out,
                   float* __restrict__ ids_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ts[NS], ids[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) { ts[k] = BIG; ids[k] = -1.0f; }
  const float tl = __ldg(t_lim + i);
  float t_opq = 0.0f;   // inactive lane (t_lim <= 0)
  if (tl > 0.0f) {
    t_opq = BIG;
    const float px = __ldg(o + 3 * i), py = __ldg(o + 3 * i + 1),
                pz = __ldg(o + 3 * i + 2);
    int node = 0;
    while (node >= 0) {
      const float* h = header + int64_t(node) * 8;
      bool box_hit;
      slab(h, px, py, pz, ix, iy, iz, fminf(fminf(tl, t_opq), ts[NS - 1]),
           box_hit);
      const float h7 = __ldg(h + 7);
      const bool leaf = h7 > 0.5f;
      if (leaf && box_hit) {
        const float* row = srows + int64_t(int(h7) - 1) * SH_ROW_W;
#pragma unroll 2
        for (int j = 0; j < SLOT_N; ++j) {
          const float tri_id = __ldg(row + SH_SLOT_F * SLOT_N + j);
          const float* s = row + SH_SLOT_F * j;
          const float u = ((px * __ldg(s) + py * __ldg(s + 1)) + pz * __ldg(s + 2)) - __ldg(s + 9);
          const float v = ((px * __ldg(s + 3) + py * __ldg(s + 4)) + pz * __ldg(s + 5)) - __ldg(s + 10);
          const float t = ((px * __ldg(s + 6) + py * __ldg(s + 7)) + pz * __ldg(s + 8)) - __ldg(s + 11);
          if (!(tri_id >= 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                u + v <= 1.0f && t > 1e-4f && t < tl))
            continue;
          if (tri_id == floorf(tri_id))
            t_opq = fminf(t_opq, t);
          else
            insert_slot<NS>(t, tri_id, ts, ids);
        }
      }
      node = box_hit && !leaf ? node + 1 : int(__ldg(h + 6));
    }
  }
  t_opq_out[i] = t_opq;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    ts_out[i * NS + k] = ts[k];
    ids_out[i * NS + k] = ids[k];
  }
}

template <int NS>
void launch(const float* header, const float* srows, float ix, float iy,
            float iz, const float* o, const float* t_lim, int64_t n,
            float* t_opq, float* ts, float* ids, cudaStream_t st) {
  shadow_walk_kernel<NS><<<blocks_for(n), BLOCK_THREADS, 0, st>>>(
      header, srows, ix, iy, iz, o, t_lim, n, t_opq, ts, ids);
}

}  // namespace
}  // namespace sge

// header (M*8,), srows (Lp, 156), inverse light direction (ix, iy, iz),
// o (N,3), t_lim (N,). Out: t_opq (N,), ts (N, n_slots), ids (N, n_slots).
SGE_API int sge_shadow_walk(const float* header, const float* srows, float ix,
                            float iy, float iz, const float* o,
                            const float* t_lim, int64_t n, int n_slots,
                            float* t_opq, float* ts, float* ids,
                            void* stream) {
  if (n == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_slots) {
    case 1: sge::launch<1>(header, srows, ix, iy, iz, o, t_lim, n, t_opq, ts,
                           ids, st); break;
    case 2: sge::launch<2>(header, srows, ix, iy, iz, o, t_lim, n, t_opq, ts,
                           ids, st); break;
    case 3: sge::launch<3>(header, srows, ix, iy, iz, o, t_lim, n, t_opq, ts,
                           ids, st); break;
    case 4: sge::launch<4>(header, srows, ix, iy, iz, o, t_lim, n, t_opq, ts,
                           ids, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
