// K4: closest-hit BVH traversal over the packed (M,128) row-per-node tree.
//
// Replaces swift_game_engine_tpu/ops/rt_kernel.py:_kernel_stream (wrapper
// trace_rays_pallas), the member that serves trees past the TPU's 26k-node
// VMEM cap, and computes the same function as its siblings
// (_kernel_smem_ordered, _kernel, _kernel_smem, _kernel_smem_interval,
// _kernel_smem_ordered2): per ray the nearest (t, triangle id) with
// 1e-4 < t < t_max, Moller-Trumbore leaf tests, translucent ids (id + 0.5)
// truncated to the triangle id.
//
// Row layout: [0:3] bmin, [3:6] bmax, [6] skip link, [7] leaf flag,
// [8+9j : 17+9j] triangle j as (a, b-a, c-a), [116+j] triangle j's id.
//
// Design for Hopper: one thread per ray with a near-first stack walk
// (interior node n has children n+1 and skip[n+1]; the nearer child by box
// entry distance is visited first). The TPU kernels walk 4096-ray packets
// with one shared cursor because the TPU has no vector gathers; a GPU
// thread gathers its own nodes, so incoherent bounce rays do not drag a
// packet through the union of their subtrees. The full DemoScene tree is
// ~30k nodes x 512 B = ~16 MB, inside the 50 MB L2, so rows are read
// straight from global memory with no streaming window. What bounds it is
// dependent node loads (latency), hidden by many rays in flight.
//
// K8: any-hit occlusion against OPAQUE triangles (integral ids), the shadow
// prepass. Replaces swift_game_engine_tpu/ops/rt_kernel.py:
// _kernel_shadow_smem (wrapper trace_shadow_any): per ray, whether some
// opaque triangle lies at 1e-4 < t < t_lim; a lane with t_lim <= 0 counts
// as blocked. One thread per ray follows the tree's skip links (descend to
// node+1 on a box hit at an interior node, else jump to the skip link),
// with the fixed bound t_lim, and stops at its first opaque hit. The TPU
// kernel walks a 4096-ray packet with one cursor and exits once every lane
// is blocked; the answer does not depend on the order, so the two agree
// lane for lane. Bound by the same dependent node loads as K4, cut short
// by the first blocker.

#include "common.cuh"

namespace sge {
namespace {

constexpr int ROW = 128;

// Slab test of node `node` against the ray's best hit so far.
__device__ __forceinline__ float box(const float* __restrict__ rows,
                                     int node, float ox, float oy, float oz,
                                     float ix, float iy, float iz,
                                     float t_best, bool& hit) {
  return slab(rows + int64_t(node) * ROW, ox, oy, oz, ix, iy, iz, t_best,
              hit);
}

// Moller-Trumbore test of the triangle (a, e1, e2) at `tr` in the reference's
// operation order: whether the ray crosses it (|det| >= EPS, barycentrics in
// range), and its t.
__device__ __forceinline__ bool mt_hit(const float* __restrict__ tr, float ox,
                                       float oy, float oz, float dx, float dy,
                                       float dz, float& t) {
  const float ax = __ldg(tr), ay = __ldg(tr + 1), az = __ldg(tr + 2);
  const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
  const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) >= EPS)) return false;
  const float inv_det = 1.0f / det;
  const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

__global__ void __launch_bounds__(BLOCK_THREADS)
trace_closest_kernel(const float* __restrict__ rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, int64_t n,
                     float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1),
              oz = __ldg(o + 3 * i + 2);
  const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1),
              dz = __ldg(d + 3 * i + 2);
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = __ldg(t_max + i);
  float tri_best = -1.0f;

  int stack_node[STACK];
  float stack_t[STACK];
  int sp = 0;
  bool hit;
  const float t_root = box(rows, 0, ox, oy, oz, ix, iy, iz, t_best, hit);
  if (hit) { stack_node[0] = 0; stack_t[0] = t_root; sp = 1; }
  while (sp > 0) {
    --sp;
    const int node = stack_node[sp];
    if (!(stack_t[sp] < t_best)) continue;  // pruned by a nearer hit
    const float* row = rows + int64_t(node) * ROW;
    if (__ldg(row + 7) > 0.5f) {
#pragma unroll 4
      for (int j = 0; j < SLOT_N; ++j) {
        const float tri_id = __ldg(row + 8 + 9 * SLOT_N + j);
        float t;
        if (tri_id >= 0.0f &&
            mt_hit(row + 8 + 9 * j, ox, oy, oz, dx, dy, dz, t) &&
            t > 1e-4f && t < t_best) {
          t_best = t;
          tri_best = tri_id;
        }
      }
      continue;
    }
    const int l = node + 1;
    const int r = int(__ldg(rows + int64_t(l) * ROW + 6));
    bool hl, hr;
    const float tl = box(rows, l, ox, oy, oz, ix, iy, iz, t_best, hl);
    const float tr = box(rows, r, ox, oy, oz, ix, iy, iz, t_best, hr);
    // push the far child first so the near one pops next
    if (hl && hr) {
      const bool left_near = tl <= tr;
      stack_node[sp] = left_near ? r : l; stack_t[sp] = left_near ? tr : tl; ++sp;
      stack_node[sp] = left_near ? l : r; stack_t[sp] = left_near ? tl : tr; ++sp;
    } else if (hl) {
      stack_node[sp] = l; stack_t[sp] = tl; ++sp;
    } else if (hr) {
      stack_node[sp] = r; stack_t[sp] = tr; ++sp;
    }
  }
  t_out[i] = t_best;
  tri_out[i] = int32_t(tri_best);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
shadow_any_kernel(const float* __restrict__ rows, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ t_lim, int64_t n,
                  bool* __restrict__ blocked_out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tl = __ldg(t_lim + i);
  bool blocked = !(tl > 0.0f);   // a lane with t_lim <= 0 counts as blocked
  if (!blocked) {
    const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1),
                oz = __ldg(o + 3 * i + 2);
    const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1),
                dz = __ldg(d + 3 * i + 2);
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    int node = 0;
    while (node >= 0 && !blocked) {
      const float* row = rows + int64_t(node) * ROW;
      bool box_hit;
      box(rows, node, ox, oy, oz, ix, iy, iz, tl, box_hit);
      const bool leaf = __ldg(row + 7) > 0.5f;
      if (leaf && box_hit) {
        for (int j = 0; j < SLOT_N && !blocked; ++j) {
          const float tri_id = __ldg(row + 8 + 9 * SLOT_N + j);
          float t;
          blocked = tri_id >= 0.0f && tri_id == floorf(tri_id) &&
                    mt_hit(row + 8 + 9 * j, ox, oy, oz, dx, dy, dz, t) &&
                    t > 1e-4f && t < tl;
        }
      }
      node = box_hit && !leaf ? node + 1 : int(__ldg(row + 6));
    }
  }
  blocked_out[i] = blocked;
}

}  // namespace
}  // namespace sge

// rows (M_pad,128), o/d (N,3), t_max (N,). Out: t (N,), tri (N,) int32.
SGE_API int sge_trace_closest(const float* rows, const float* o,
                              const float* d, const float* t_max, int64_t n,
                              float* t, int32_t* tri, void* stream) {
  if (n > 0)
    sge::trace_closest_kernel<<<sge::blocks_for(n), sge::BLOCK_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        rows, o, d, t_max, n, t, tri);
  return int(cudaGetLastError());
}

// rows (M_pad,128), o/d (N,3), t_lim (N,). Out: blocked (N,) bool.
SGE_API int sge_shadow_any(const float* rows, const float* o, const float* d,
                           const float* t_lim, int64_t n, bool* blocked,
                           void* stream) {
  if (n > 0)
    sge::shadow_any_kernel<<<sge::blocks_for(n), sge::BLOCK_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, o, d, t_lim, n, blocked);
  return int(cudaGetLastError());
}
