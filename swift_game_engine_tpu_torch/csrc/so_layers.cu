// K5: layered shared-origin walk — every transparency layer of a primary ray
// in one traversal.
//
// Replaces swift_game_engine_tpu/ops/rt_kernel.py:_kernel_layers_so
// (wrapper trace_layers_so). All rays share the camera origin o, so the
// per-frame origin rows (build_origin_rows) hold, per leaf triangle,
// k_u = e2 x (o-a), k_v = (o-a) x e1, k_d = e2 x e1 and tn = e2 . k_v: a
// slot test is three dot products of the ray direction with constants and
// sign-folded compares, with one division for the accepted t (so_slot in
// common.cuh, in the reference's operation order). K5 returns, per ray, the
// nearest OPAQUE hit (t, id) and the NS nearest TRANSLUCENT hits
// (t, id + 0.5) met on the way, ascending (the insertion network); the
// caller turns these into layer records. K6, the shared-origin closest hit,
// is an instance of K4's wide walk (bvh_trace.cu) over the same rows.
//
// Design for Hopper: one thread per ray walks the tree near-first with its
// own 128-deep stack (interior node n has children n+1 and skip[n+1]; the
// child with the nearer box entry of THIS ray goes first). The TPU kernel
// walks a 4096-ray packet with one cursor, ordering children by the packet's
// minimum entry distance, because the TPU has no vector gathers; a GPU
// thread gathers its own nodes. The per-ray prune bound is
// min(t_max, t_opq, ts[NS-1]). The whole working set is small: at the
// decimated DemoScene's 12,768 rows the header is 0.4 MB and the leaf rows
// (132 f32, 528 B each) 3.4 MB, inside the 50 MB L2, so both are read
// straight from global memory. What bounds it is the chain of dependent
// node loads of each ray (latency), hidden by many rays in flight; the
// arithmetic per node is a few dozen operations.

#include "common.cuh"

namespace sge {
namespace {

// One near-first step at interior node `node`: the next node to visit, or
// -1 to pop the stack.
__device__ __forceinline__ int descend(const float* __restrict__ header,
                                       int node, float ox, float oy, float oz,
                                       float ix, float iy, float iz,
                                       float bound, int* stack, int& sp) {
  const int left = node + 1;
  const int right = int(__ldg(header + int64_t(left) * 8 + 6));
  bool hl, hr;
  const float tl = slab(header + int64_t(left) * 8, ox, oy, oz, ix, iy, iz,
                        bound, hl);
  const float tr = slab(header + int64_t(right) * 8, ox, oy, oz, ix, iy, iz,
                        bound, hr);
  if (hl && hr) {
    const bool left_near = tl <= tr;
    stack[sp++] = left_near ? right : left;   // the far child waits
    return left_near ? left : right;
  }
  if (hl || hr) return hl ? left : right;
  return -1;
}

template <int NS>
__global__ void __launch_bounds__(BLOCK_THREADS)
so_layers_kernel(const float* __restrict__ header,
                 const float* __restrict__ srows, float ox, float oy, float oz,
                 const float* __restrict__ d, const float* __restrict__ t_max,
                 int64_t n, float* __restrict__ t_opq_out,
                 int32_t* __restrict__ tri_out, float* __restrict__ ts_out,
                 float* __restrict__ ids_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ts[NS], ids[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) { ts[k] = BIG; ids[k] = -1.0f; }
  const float tm = __ldg(t_max + i);
  float t_opq = 0.0f, tri_opq = -1.0f;   // inactive lane (t_max <= 0)
  if (tm > 0.0f) {
    t_opq = BIG;
    const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1),
                dz = __ldg(d + 3 * i + 2);
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int stack[STACK];
    int sp = 0;
    int node = 0;
    while (node >= 0) {
      const float bound = fminf(fminf(tm, t_opq), ts[NS - 1]);
      const float* h = header + int64_t(node) * 8;
      const float h7 = __ldg(h + 7);
      int next = -1;
      if (h7 > 0.5f) {
        bool box_hit;
        slab(h, ox, oy, oz, ix, iy, iz, bound, box_hit);
        if (box_hit) {
          const float* row = srows + int64_t(int(h7) - 1) * SO_ROW_W;
#pragma unroll 2
          for (int j = 0; j < SLOT_N; ++j) {
            float t, dnp, tn_s, tri_id;
            if (!(so_slot(row, j, dx, dy, dz, t, dnp, tn_s, tri_id) &&
                  tn_s > 1e-4f * dnp && t < bound))
              continue;
            if (tri_id == floorf(tri_id)) {
              if (t < t_opq) { t_opq = t; tri_opq = tri_id; }
            } else {
              insert_slot<NS>(t, tri_id, ts, ids);
            }
          }
        }
      } else {
        next = descend(header, node, ox, oy, oz, ix, iy, iz, bound, stack, sp);
      }
      node = next >= 0 ? next : (sp > 0 ? stack[--sp] : -1);
    }
  }
  t_opq_out[i] = t_opq;
  tri_out[i] = int32_t(tri_opq);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    ts_out[i * NS + k] = ts[k];
    ids_out[i * NS + k] = ids[k];
  }
}

template <int NS>
void launch(const float* header, const float* srows, float ox, float oy,
            float oz, const float* d, const float* t_max, int64_t n,
            float* t_opq, int32_t* tri, float* ts, float* ids,
            cudaStream_t st) {
  so_layers_kernel<NS><<<blocks_for(n), BLOCK_THREADS, 0, st>>>(
      header, srows, ox, oy, oz, d, t_max, n, t_opq, tri, ts, ids);
}

}  // namespace
}  // namespace sge

// header (M*8,), srows (Lp, 132), origin (ox, oy, oz), d (N,3), t_max (N,).
// Out: t_opq (N,), tri (N,) int32, ts (N, n_slots), ids (N, n_slots).
SGE_API int sge_so_layers(const float* header, const float* srows, float ox,
                          float oy, float oz, const float* d,
                          const float* t_max, int64_t n, int n_slots,
                          float* t_opq, int32_t* tri, float* ts, float* ids,
                          void* stream) {
  if (n == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_slots) {
    case 1: sge::launch<1>(header, srows, ox, oy, oz, d, t_max, n, t_opq, tri,
                           ts, ids, st); break;
    case 2: sge::launch<2>(header, srows, ox, oy, oz, d, t_max, n, t_opq, tri,
                           ts, ids, st); break;
    case 3: sge::launch<3>(header, srows, ox, oy, oz, d, t_max, n, t_opq, tri,
                           ts, ids, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
