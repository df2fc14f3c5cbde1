// K5: layered shared-origin walk — every transparency layer of a primary ray
// in one traversal; K6: shared-origin closest hit with a per-ray t floor.
//
// K5 replaces swift_game_engine_tpu/ops/rt_kernel.py:_kernel_layers_so
// (wrapper trace_layers_so), K6 replaces :_kernel_so_ordered (wrapper
// trace_rays_so). All rays share the camera origin o, so the per-frame
// origin rows (build_origin_rows) hold, per leaf triangle, k_u = e2 x (o-a),
// k_v = (o-a) x e1, k_d = e2 x e1 and tn = e2 . k_v: a slot test is three
// dot products of the ray direction with constants and sign-folded
// compares, with one division for the accepted t (so_slot, in the
// reference's operation order). K5 returns, per ray, the nearest OPAQUE hit
// (t, id) and the NS nearest TRANSLUCENT hits (t, id + 0.5) met on the way,
// ascending (the insertion network); the caller turns these into layer
// records. K6 returns the nearest hit of any kind with
// t_floor*dn < tn < t_best*dn: the non-layered trace calls it once for
// layer 1 and once per continuation layer with t_floor = t_hit + 2*bias.
//
// Design for Hopper: one thread per ray walks the tree near-first with its
// own 128-deep stack (interior node n has children n+1 and skip[n+1]; the
// child with the nearer box entry of THIS ray goes first). The TPU kernels
// walk a 4096-ray packet with one cursor, ordering children by the packet's
// minimum entry distance, because the TPU has no vector gathers; a GPU
// thread gathers its own nodes. The closest hit does not depend on the
// order except at exactly equal t. The per-ray prune bound is
// min(t_max, t_opq, ts[NS-1]) for K5 and t_best for K6. The whole working
// set is small: at the decimated DemoScene's 12,768 rows the header is
// 0.4 MB and the leaf rows (132 f32, 528 B each) 3.4 MB, inside the 50 MB
// L2, so both are read straight from global memory. What bounds them is the
// chain of dependent node loads of each ray (latency), hidden by many rays
// in flight; the arithmetic per node is a few dozen operations.

#include "common.cuh"

namespace sge {
namespace {

constexpr int SO_SLOT_F = 10;                        // k_u, k_v, k_d, tn
constexpr int SO_ROW_W = SO_SLOT_F * SLOT_N + SLOT_N;  // + the ids

// Slot j of leaf row `row` against direction d: the sign-folded terms of
// rt_kernel.py:1393-1401. Returns t = tn_s / dnp and whether the ray's line
// crosses the triangle (id >= 0, dnp >= EPS, barycentric range); the caller
// adds its t range test on tn_s or t.
__device__ __forceinline__ bool so_slot(const float* __restrict__ row, int j,
                                        float dx, float dy, float dz,
                                        float& t, float& dnp, float& tn_s,
                                        float& tri_id) {
  tri_id = __ldg(row + SO_SLOT_F * SLOT_N + j);
  const float* s = row + SO_SLOT_F * j;
  const float un = (dx * __ldg(s) + dy * __ldg(s + 1)) + dz * __ldg(s + 2);
  const float vn = (dx * __ldg(s + 3) + dy * __ldg(s + 4)) + dz * __ldg(s + 5);
  const float dn = (dx * __ldg(s + 6) + dy * __ldg(s + 7)) + dz * __ldg(s + 8);
  const float tn = __ldg(s + 9);
  const float sgn = dn < 0.0f ? -1.0f : 1.0f;
  dnp = dn * sgn;
  const float un_s = un * sgn, vn_s = vn * sgn;
  tn_s = tn * sgn;
  t = tn_s / (dnp >= EPS ? dnp : 1.0f);
  return tri_id >= 0.0f && dnp >= EPS && un_s >= 0.0f && un_s <= dnp &&
         vn_s >= 0.0f && un_s + vn_s <= dnp;
}

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

__global__ void __launch_bounds__(BLOCK_THREADS)
so_closest_kernel(const float* __restrict__ header,
                  const float* __restrict__ srows, float ox, float oy,
                  float oz, const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  const float* __restrict__ t_floor, int64_t n,
                  float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t_best = __ldg(t_max + i);   // a miss keeps t_max
  float tri_best = -1.0f;
  if (t_best > 0.0f) {
    const float fl = t_floor != nullptr ? __ldg(t_floor + i) : 1e-4f;
    const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1),
                dz = __ldg(d + 3 * i + 2);
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int stack[STACK];
    int sp = 0;
    int node = 0;
    while (node >= 0) {
      const float* h = header + int64_t(node) * 8;
      const float h7 = __ldg(h + 7);
      int next = -1;
      if (h7 > 0.5f) {
        bool box_hit;
        slab(h, ox, oy, oz, ix, iy, iz, t_best, box_hit);
        if (box_hit) {
          const float* row = srows + int64_t(int(h7) - 1) * SO_ROW_W;
#pragma unroll 2
          for (int j = 0; j < SLOT_N; ++j) {
            float t, dnp, tn_s, tri_id;
            if (so_slot(row, j, dx, dy, dz, t, dnp, tn_s, tri_id) &&
                tn_s > fl * dnp && tn_s < t_best * dnp) {
              t_best = t;
              tri_best = tri_id;
            }
          }
        }
      } else {
        next = descend(header, node, ox, oy, oz, ix, iy, iz, t_best, stack,
                       sp);
      }
      node = next >= 0 ? next : (sp > 0 ? stack[--sp] : -1);
    }
  }
  t_out[i] = t_best;
  tri_out[i] = int32_t(tri_best);
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

// header (M*8,), srows (Lp, 132), origin (ox, oy, oz), d (N,3), t_max (N,),
// t_floor (N,) or null (1e-4). Out: t (N,), tri (N,) int32.
SGE_API int sge_so_closest(const float* header, const float* srows, float ox,
                           float oy, float oz, const float* d,
                           const float* t_max, const float* t_floor,
                           int64_t n, float* t, int32_t* tri, void* stream) {
  if (n > 0)
    sge::so_closest_kernel<<<sge::blocks_for(n), sge::BLOCK_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        header, srows, ox, oy, oz, d, t_max, t_floor, n, t, tri);
  return int(cudaGetLastError());
}
