// K4: closest-hit BVH traversal over the 4-wide tree.
//
// Replaces swift_game_engine_tpu/ops/rt_kernel.py:_kernel_stream (wrapper
// trace_rays_pallas), the member that serves trees past the TPU's 26k-node
// VMEM cap, and computes the same function as its siblings
// (_kernel_smem_ordered, _kernel, _kernel_smem, _kernel_smem_interval,
// _kernel_smem_ordered2): per ray the nearest (t, triangle id) with
// 1e-4 < t < t_max, Moller-Trumbore leaf tests, translucent ids (id + 0.5)
// truncated to the triangle id.
//
// Layouts (ops/rt_kernel.py): a wide node is one 128-byte line, its four
// children's boxes as structure of arrays ([0:24]) and their refs
// ([24:28]: >= 0 a wide node, -1 empty, <= -2 a leaf: -2 - ref = 16 row +
// triangle count); a leaf's triangles are the packed row's slots
// [8+9j : 17+9j] and ids [116+j].
//
// What bound the one-thread-per-ray binary walk this replaces, on the
// H100 (counted on path 1's first bounce batch, 10,684 rays, 3.70
// ms): the call lasted as long as its slowest ray's chain of dependent
// node loads, up to 2,164 (two per binary node: the right child's index
// sat in the left child's row), with its stack in local memory and a
// leaf's 12 slot tests one after another; 42 blocks left most SMs idle.
// The tree's top 6 levels took 6.5% of the node visits, so the top of the
// tree is not kept in shared memory. This design takes 1.18 ms on that
// batch, still bound by its slowest ray's chain: 434 wide-node and 521
// leaf steps, about 1.2 us each, against 0.021 ms for its operations:
//   * one dependent load per step: a step reads one wide-node line, tests
//     all four child boxes against the ray's best t, goes on to the
//     nearest hit child and stacks the others farthest first;
//   * the stack lives in shared memory, per ray, sized by the tree's own
//     bound (the largest sum of children less one down a root-to-leaf
//     path, computed with the topology and checked at build);
//   * four threads a ray: each tests one child box and 3 of a leaf's 12
//     slots, and the group shares the results by warp shuffles, so a
//     ray's steps run four-wide. A one-thread-a-ray build of the same walk
//     was slower at every batch the frames give it, from 6 rays (2.58
//     against 1.19 ms) to 557,056 (3.60 against 2.58 ms): with about as
//     many threads resident, it ran a leaf's 12 tests one after another,
//     and a warp of 32 rays waited on the longest of their walks;
//   * a counting instantiation (COUNT, with a null counts pointer in
//     production) reports each ray's wide nodes, the child boxes it tests
//     (the non-empty slots of those nodes), leaves and slot tests.
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

constexpr int WIDE = 4;
constexpr int NODE_F = 32;          // f32 per wide node: one 128-byte line
constexpr int TRACE_THREADS = 128;

// The slab test of `slab` (common.cuh) on one child's box held in registers.
__device__ __forceinline__ float child_slab(float lx, float ly, float lz,
                                            float hx, float hy, float hz,
                                            float ox, float oy, float oz,
                                            float ix, float iy, float iz,
                                            float bound, bool& hit) {
  const float tx0 = (lx - ox) * ix, tx1 = (hx - ox) * ix;
  const float ty0 = (ly - oy) * iy, ty1 = (hy - oy) * iy;
  const float tz0 = (lz - oz) * iz, tz1 = (hz - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  hit = tmax >= fmaxf(tmin, 0.0f) && tmin < bound;
  return tmin;
}

// Compare-exchange of the child order: b moves ahead of a only when its
// entry distance is strictly smaller (ops/rt_kernel.py _SORT4).
__device__ __forceinline__ void cswap(float (&t)[WIDE], int (&r)[WIDE],
                                      int a, int b) {
  const bool sw = t[b] < t[a];
  const float ta = t[a], tb = t[b];
  const int ra = r[a], rb = r[b];
  t[a] = sw ? tb : ta; t[b] = sw ? ta : tb;
  r[a] = sw ? rb : ra; r[b] = sw ? ra : rb;
}

// G = WIDE threads per ray, one per child. The per-ray stack is stack_n
// entries of (ref, entry distance) in dynamic shared memory, one column
// per ray.
constexpr int G = WIDE;
constexpr int RPB = TRACE_THREADS / G;     // rays per block

template <bool COUNT>
__global__ void __launch_bounds__(TRACE_THREADS)
trace_wide_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ rows, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ t_max, int64_t n, int stack_n,
                  int32_t* __restrict__ counts, float* __restrict__ t_out,
                  int32_t* __restrict__ tri_out) {
  extern __shared__ float4 smem4[];
  int* st_ref = reinterpret_cast<int*>(smem4);
  float* st_t = reinterpret_cast<float*>(st_ref + stack_n * RPB);
  const int slot = threadIdx.x / G;
  const int k = threadIdx.x % G;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << G) - 1u) << (lane & ~unsigned(G - 1));
  const int64_t i = int64_t(blockIdx.x) * RPB + slot;
  if (i >= n) return;                      // the whole group leaves
  const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1),
              oz = __ldg(o + 3 * i + 2);
  const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1),
              dz = __ldg(d + 3 * i + 2);
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float INF = __int_as_float(0x7f800000);
  float t_best = __ldg(t_max + i);
  float tri_best = -1.0f;
  int cur = 0, sp = 0;
  int n_nodes = 0, n_boxes = 0, n_leaves = 0, n_slots = 0;
  while (true) {
    if (cur >= 0) {                        // wide node: one line
      const float* nd = nodes + int64_t(cur) * NODE_F;
      float ct[WIDE];
      int cr[WIDE];
      bool hit;                            // thread k tests child k
      const float tm = child_slab(
          __ldg(nd + k), __ldg(nd + 4 + k), __ldg(nd + 8 + k),
          __ldg(nd + 12 + k), __ldg(nd + 16 + k), __ldg(nd + 20 + k), ox, oy,
          oz, ix, iy, iz, t_best, hit);
      const int rf = int(__ldg(nd + 24 + k));
      const float mine = hit && rf != -1 ? tm : INF;
#pragma unroll
      for (int c = 0; c < WIDE; ++c) {
        ct[c] = __shfl_sync(mask, mine, c, G);
        cr[c] = __shfl_sync(mask, rf, c, G);
      }
      if (COUNT) {
        ++n_nodes;
#pragma unroll
        for (int c = 0; c < WIDE; ++c) n_boxes += cr[c] != -1;
      }
      cswap(ct, cr, 0, 1); cswap(ct, cr, 2, 3); cswap(ct, cr, 0, 2);
      cswap(ct, cr, 1, 3); cswap(ct, cr, 1, 2);
      int h = 0;
#pragma unroll
      for (int c = 0; c < WIDE; ++c) h += ct[c] < INF;
      if (h > 0) {                         // nearest next, the rest stacked
        cur = cr[0];
        __syncwarp(mask);                  // every pop of the group is done
#pragma unroll
        for (int c = WIDE - 1; c >= 1; --c) {
          if (c < h) {
            if (k == 0) {
              st_ref[sp * RPB + slot] = cr[c];
              st_t[sp * RPB + slot] = ct[c];
            }
            ++sp;
          }
        }
        __syncwarp(mask);
        continue;
      }
    } else {                               // leaf: its slots, G at a time
      const int code = -2 - cur;
      const int cnt = code & 15;
      const float* r = rows + int64_t(code >> 4) * ROW;
      float bt = t_best;
      int bj = -1;
      for (int j = k; j < cnt; j += G) {
        float t;
        if (mt_hit(r + 8 + 9 * j, ox, oy, oz, dx, dy, dz, t) && t > 1e-4f &&
            t < bt) {
          bt = t;
          bj = j;
        }
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {  // nearest, first slot of equals
        const float ot = __shfl_xor_sync(mask, bt, off, G);
        const int oj = __shfl_xor_sync(mask, bj, off, G);
        if (ot < bt || (ot == bt && oj < bj)) {
          bt = ot;
          bj = oj;
        }
      }
      if (bj >= 0) {
        t_best = bt;
        tri_best = __ldg(r + 8 + 9 * SLOT_N + bj);
      }
      if (COUNT) {
        ++n_leaves;
        n_slots += cnt;
      }
    }
    bool found = false;                    // pop the nearest live entry
    while (sp > 0) {
      --sp;
      if (st_t[sp * RPB + slot] < t_best) {
        cur = st_ref[sp * RPB + slot];
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  if (k == 0) {
    t_out[i] = t_best;
    tri_out[i] = int32_t(tri_best);
    if (COUNT) {
      counts[i] = n_nodes;
      counts[n + i] = n_boxes;
      counts[2 * n + i] = n_leaves;
      counts[3 * n + i] = n_slots;
    }
  }
}

template <bool COUNT>
int launch_trace(const float* nodes, const float* rows, const float* o,
                 const float* d, const float* t_max, int64_t n, int stack_n,
                 int32_t* counts, float* t, int32_t* tri, cudaStream_t st) {
  // at most 96 entries (WIDE_STACK_MAX): 24 KB, under the default 48 KB
  const size_t smem = size_t(stack_n) * RPB * 8;
  trace_wide_kernel<COUNT><<<unsigned((n + RPB - 1) / RPB), TRACE_THREADS,
                             smem, st>>>(nodes, rows, o, d, t_max, n,
                                         stack_n, counts, t, tri);
  return int(cudaGetLastError());
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

// nodes (W,32) wide nodes, rows (M_pad,128), o/d (N,3), t_max (N,);
// stack_n: the tree's stack bound; counts: (4,N) int32 per-ray work, or
// null. Out: t (N,), tri (N,) int32.
SGE_API int sge_trace_closest(const float* nodes, const float* rows,
                              const float* o, const float* d,
                              const float* t_max, int64_t n, int stack_n,
                              int32_t* counts, float* t, int32_t* tri,
                              void* stream) {
  if (n == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return counts ? sge::launch_trace<true>(nodes, rows, o, d, t_max, n,
                                          stack_n, counts, t, tri, st)
                : sge::launch_trace<false>(nodes, rows, o, d, t_max, n,
                                           stack_n, counts, t, tri, st);
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
