// K4, K6 and K8: one walk over the 4-wide tree, three leaf tests.
//
// K4, closest hit. Replaces swift_game_engine_tpu/ops/rt_kernel.py:
// _kernel_stream (wrapper trace_rays_pallas), the member that serves trees
// past the TPU's 26k-node VMEM cap, and computes the same function as its
// siblings (_kernel_smem_ordered, _kernel, _kernel_smem,
// _kernel_smem_interval, _kernel_smem_ordered2): per ray the nearest
// (t, triangle id) with 1e-4 < t < t_max, Moller-Trumbore leaf tests,
// translucent ids (id + 0.5) truncated to the triangle id.
//
// K6, shared-origin closest hit past a per-lane floor. Replaces
// rt_kernel.py:_kernel_so_ordered (wrapper trace_rays_so): per ray the
// nearest hit of any kind with t_floor*dnp < tn_s < t_best*dnp (t_floor
// 1e-4 unless given), tested by so_cross<true> (common.cuh: the dot
// products fused as XLA fuses the reference's) on the origin rows of
// build_origin_rows, in the reference's operation order; a miss keeps
// t = t_max and id -1, a lane with t_max <= 0 is inactive. A floor set at
// a hit's t therefore lets that hit through exactly where the reference
// does: where t*dnp rounds below tn_s.
//
// K8, any-hit occlusion against OPAQUE triangles (integral ids; a
// translucent id carries +0.5), the shadow prepass. Replaces
// rt_kernel.py:_kernel_shadow_smem (wrapper trace_shadow_any): per ray,
// whether some opaque triangle lies at 1e-4 < t < t_lim; a lane with
// t_lim <= 0 counts as blocked. The walk bound is the fixed t_lim and the
// ray's threads stop together at its first opaque hit. The answer does not
// depend on the order; the children are still visited nearest first (the
// sort is five compare-exchanges a node, and a nearer blocker ends the
// walk no later than a farther one).
//
// Layouts (ops/rt_kernel.py): a wide node is one 128-byte line, its four
// children's boxes as structure of arrays ([0:24]), their refs ([24:28]:
// >= 0 a wide node, -1 empty, <= -2 a leaf: -2 - ref = 16 row + triangle
// count) and each leaf child's 1-based leaf rank ([28:32]: the leaf's row
// in the origin rows, plus one; 0 elsewhere); a leaf's triangles are the
// packed row's slots [8+9j : 17+9j] and ids [116+j].
//
// What bound the one-thread-per-ray binary walks this replaces, on the
// H100: a call lasted as long as its slowest ray's chain of dependent node
// loads (two per binary node: the right child's index sat in the left
// child's row), with its stack in local memory and a leaf's 12 slot tests
// one after another; K4's binary walk visited 3.2x the wide walk's nodes.
// K6 and K8 ran that design until they became instances of this walk
// (binary walk on path 6's first frame: K6 rays visit 869 nodes and test
// 3,936 slots each on average, K8's slowest 1% 1,500 nodes). The design:
//   * one dependent load per step: a step reads one wide-node line, tests
//     all four child boxes against the ray's bound, goes on to the nearest
//     hit child and stacks the others farthest first;
//   * the stack lives in shared memory, per ray, sized by the tree's own
//     bound (the largest sum of children less one down a root-to-leaf
//     path, computed with the topology and checked at build);
//   * G threads a ray, the policy's choice. K4 and K8 run four: each
//     thread tests one child box and 3 of a leaf's 12 slots, and the
//     group shares the results by warp shuffles, so a ray's steps run
//     four-wide; their calls last as long as their slowest rays. A
//     one-thread-a-ray build of the K4 walk was slower at every batch the
//     frames give it, from 6 rays (2.58 against 1.19 ms) to 557,056 (3.60
//     against 2.58 ms), and K8 at 557,056 shadow rays took 2.93 ms at
//     one thread, 2.03 at two, 1.83 at four. K6 runs one: every camera
//     ray of its dense call walks ~270 wide nodes and ~330 leaves, so the
//     call is bound by the instructions it issues, and a warp serving 32
//     rays issues fewest: 9.48 ms at one thread, 9.70 at two, 12.05 at
//     four on path 6's 557,056 rays (H100, commit 4f2c21d);
//   * the leaf test is a policy (Closest, SharedOrigin, AnyOpaque): it
//     loads its ray, names the walk bound and its threads a ray, tests a
//     leaf's slots and says whether the walk ends. K6 divides for t only
//     when a slot is accepted (the slot test compares tn_s against the
//     bounds times dnp);
//   * a counting instantiation (COUNT, with a null counts pointer in
//     production) reports each ray's wide nodes, the child boxes it tests
//     (the non-empty slots of those nodes), leaves and slot tests.

#include "common.cuh"

namespace sge {
namespace {

constexpr int ROW = 128;
constexpr int IDS = 8 + 9 * SLOT_N;   // a packed row's triangle ids

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

__device__ __forceinline__ float f32_inf() {
  return __int_as_float(0x7f800000);
}

// The group's nearest candidate (t, slot j; a thread without one holds
// (inf, -1)), the first slot among equal t.
template <int G>
__device__ __forceinline__ void group_nearest(float& bt, int& bj,
                                              unsigned mask) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float ot = __shfl_xor_sync(mask, bt, off, G);
    const int oj = __shfl_xor_sync(mask, bj, off, G);
    if (ot < bt || (ot == bt && oj < bj)) {
      bt = ot;
      bj = oj;
    }
  }
}

// A ray's origin, direction and the direction's safe inverse.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  __device__ void load_d(const float* __restrict__ d, int64_t i) {
    dx = __ldg(d + 3 * i); dy = __ldg(d + 3 * i + 1); dz = __ldg(d + 3 * i + 2);
    ix = safe_inv(dx); iy = safe_inv(dy); iz = safe_inv(dz);
  }
  __device__ void load_o(const float* __restrict__ o, int64_t i) {
    ox = __ldg(o + 3 * i); oy = __ldg(o + 3 * i + 1); oz = __ldg(o + 3 * i + 2);
  }
};

// The leaf ref of child k as the walk carries it: the packed row's code.
__device__ __forceinline__ int packed_ref(const float* __restrict__ nd,
                                          int k) {
  return int(__ldg(nd + 24 + k));
}

// The closest-hit policies' state (K4, K6): the best hit so far, which is
// also the walk bound.
struct NearestHit : Ray {
  float t_best, tri_best;
  __device__ float bound() const { return t_best; }
  // A leaf of cnt slots (ids at `ids`), G at a time: hit(j, bt, t) tests
  // slot j against the thread's best t so far; the group keeps the nearest
  // of its threads' hits, the first slot among equal t.
  template <int G, class Hit>
  __device__ void nearest(const float* __restrict__ ids, int cnt, int k,
                          unsigned mask, int& tests, Hit hit) {
    float bt = t_best;
    int bj = -1;
    for (int j = k; j < cnt; j += G) {
      float t;
      ++tests;
      if (hit(j, bt, t)) {
        bt = t;
        bj = j;
      }
    }
    if (bj < 0) bt = f32_inf();
    group_nearest<G>(bt, bj, mask);
    if (bj >= 0) {
      t_best = bt;
      tri_best = __ldg(ids + bj);
    }
  }
  template <class Args>
  __device__ void write(const Args& a, int64_t i) const {
    a.t_out[i] = t_best;
    a.tri_out[i] = int32_t(tri_best);
  }
};

// K4: the nearest Moller-Trumbore hit with 1e-4 < t < t_best.
struct Closest : NearestHit {
  struct Args {
    const float* rows; const float* o; const float* d; const float* t_max;
    float* t_out; int32_t* tri_out;
  };
  static constexpr int G = WIDE;
  __device__ Closest(const Args& a, int64_t i) {
    load_o(a.o, i);
    load_d(a.d, i);
    t_best = __ldg(a.t_max + i);
    tri_best = -1.0f;
  }
  // a lane with t_max <= 0 walks and finds nothing (its origin is parked)
  __device__ bool live() const { return true; }
  __device__ int child_ref(const float* nd, int k) const {
    return packed_ref(nd, k);
  }
  __device__ bool leaf(const Args& a, int code, int k, unsigned mask,
                       int& tests) {
    const float* r = a.rows + int64_t(code >> 4) * ROW;
    nearest<G>(r + IDS, code & 15, k, mask, tests,
               [&](int j, float bt, float& t) {
                 return mt_hit(r + 8 + 9 * j, ox, oy, oz, dx, dy, dz, t) &&
                        t > 1e-4f && t < bt;
               });
    return false;
  }
};

// K6: the nearest so_cross<true> hit with t_floor*dnp < tn_s < t_best*dnp,
// all rays from one origin; leaves name their origin row by rank.
struct SharedOrigin : NearestHit {
  struct Args {
    const float* srows; float ox, oy, oz; const float* d; const float* t_max;
    const float* t_floor; float* t_out; int32_t* tri_out;
  };
  static constexpr int G = 1;
  float fl;
  __device__ SharedOrigin(const Args& a, int64_t i) {
    ox = a.ox; oy = a.oy; oz = a.oz;
    load_d(a.d, i);
    t_best = __ldg(a.t_max + i);       // a miss keeps t_max
    tri_best = -1.0f;
    fl = a.t_floor != nullptr ? __ldg(a.t_floor + i) : 1e-4f;
  }
  __device__ bool live() const { return t_best > 0.0f; }
  __device__ int child_ref(const float* nd, int k) const {
    const int rf = packed_ref(nd, k);
    if (rf > -2) return rf;
    const int rank = int(__ldg(nd + 28 + k));
    return -2 - (16 * (rank - 1) + ((-2 - rf) & 15));
  }
  __device__ bool leaf(const Args& a, int code, int k, unsigned mask,
                       int& tests) {
    const float* row = a.srows + int64_t(code >> 4) * SO_ROW_W;
    nearest<G>(row + SO_SLOT_F * SLOT_N, code & 15, k, mask, tests,
               [&](int j, float bt, float& t) {
                 float dnp, tn_s, tri_id;
                 if (!(so_cross<true>(row, j, dx, dy, dz, dnp, tn_s,
                                      tri_id) &&
                       tn_s > fl * dnp && tn_s < bt * dnp))
                   return false;
                 t = tn_s / dnp;       // so_slot's t: dnp >= EPS here
                 return true;
               });
    return false;
  }
};

// K8: whether an opaque triangle lies at 1e-4 < t < t_lim.
struct AnyOpaque : Ray {
  struct Args {
    const float* rows; const float* o; const float* d; const float* t_lim;
    bool* blocked_out;
  };
  static constexpr int G = WIDE;
  float tl;
  bool blocked;
  __device__ AnyOpaque(const Args& a, int64_t i) {
    tl = __ldg(a.t_lim + i);
    blocked = !(tl > 0.0f);            // t_lim <= 0 counts as blocked
    load_o(a.o, i);
    load_d(a.d, i);
  }
  __device__ bool live() const { return !blocked; }
  __device__ float bound() const { return tl; }
  __device__ int child_ref(const float* nd, int k) const {
    return packed_ref(nd, k);
  }
  __device__ bool leaf(const Args& a, int code, int k, unsigned mask,
                       int& tests) {
    const int cnt = code & 15;
    const float* r = a.rows + int64_t(code >> 4) * ROW;
    bool mine = false;
    for (int j = k; j < cnt; j += G) {
      const float tri_id = __ldg(r + IDS + j);
      if (tri_id != floorf(tri_id)) continue;   // translucent
      float t;
      ++tests;
      mine |= mt_hit(r + 8 + 9 * j, ox, oy, oz, dx, dy, dz, t) &&
              t > 1e-4f && t < tl;
    }
    blocked = __any_sync(mask, mine);
    return blocked;
  }
  __device__ void write(const Args& a, int64_t i) const {
    a.blocked_out[i] = blocked;
  }
};

// G = R::G threads a ray (1 or 4) share its walk: thread k tests children
// k, k+G, ... and slots k, k+G, ... of a leaf. The per-ray stack is
// stack_n entries of (ref, entry distance) in dynamic shared memory, one
// column per ray.
template <class R, bool COUNT>
__global__ void __launch_bounds__(TRACE_THREADS)
wide_walk_kernel(const float* __restrict__ nodes, const typename R::Args a,
                 int64_t n, int stack_n, int32_t* __restrict__ counts) {
  constexpr int G = R::G;
  constexpr int RPB = TRACE_THREADS / G;   // rays per block
  extern __shared__ float4 smem4[];
  int* st_ref = reinterpret_cast<int*>(smem4);
  float* st_t = reinterpret_cast<float*>(st_ref + stack_n * RPB);
  const int slot = threadIdx.x / G;
  const int k = threadIdx.x % G;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << G) - 1u) << (lane & ~unsigned(G - 1));
  const int64_t i = int64_t(blockIdx.x) * RPB + slot;
  if (i >= n) return;                      // the whole group leaves
  R ray(a, i);
  const float INF = f32_inf();
  int cur = 0, sp = 0;
  int n_nodes = 0, n_boxes = 0, n_leaves = 0, n_slots = 0;
  bool walk = ray.live();                  // the same in the whole group
  while (walk) {
    if (cur >= 0) {                        // wide node: one line
      const float* nd = nodes + int64_t(cur) * NODE_F;
      float ct[WIDE], mt[WIDE / G];
      int cr[WIDE], mr[WIDE / G];
#pragma unroll
      for (int q = 0; q < WIDE / G; ++q) {  // thread k: children k + qG
        const int c = k + q * G;
        bool hit;
        const float tm = child_slab(
            __ldg(nd + c), __ldg(nd + 4 + c), __ldg(nd + 8 + c),
            __ldg(nd + 12 + c), __ldg(nd + 16 + c), __ldg(nd + 20 + c),
            ray.ox, ray.oy, ray.oz, ray.ix, ray.iy, ray.iz, ray.bound(), hit);
        mr[q] = ray.child_ref(nd, c);
        mt[q] = hit && mr[q] != -1 ? tm : INF;
      }
#pragma unroll
      for (int c = 0; c < WIDE; ++c) {
        ct[c] = G == 1 ? mt[c] : __shfl_sync(mask, mt[c / G], c % G, G);
        cr[c] = G == 1 ? mr[c] : __shfl_sync(mask, mr[c / G], c % G, G);
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
      if (COUNT) ++n_leaves;
      if (ray.leaf(a, -2 - cur, k, mask, n_slots)) break;
    }
    bool found = false;                    // pop the nearest live entry
    while (sp > 0) {
      --sp;
      if (st_t[sp * RPB + slot] < ray.bound()) {
        cur = st_ref[sp * RPB + slot];
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  if (COUNT) {                             // each thread counted its slots
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      n_slots += __shfl_xor_sync(mask, n_slots, off, G);
  }
  if (k == 0) {
    ray.write(a, i);
    if (COUNT) {
      counts[i] = n_nodes;
      counts[n + i] = n_boxes;
      counts[2 * n + i] = n_leaves;
      counts[3 * n + i] = n_slots;
    }
  }
}

template <class R, bool COUNT>
void launch(const float* nodes, const typename R::Args& a, int64_t n,
            int stack_n, int32_t* counts, cudaStream_t st) {
  constexpr int RPB = TRACE_THREADS / R::G;
  // stack_n <= 96 (WIDE_STACK_MAX): up to 96 KB a block at one thread a
  // ray, past the default 48 KB of dynamic shared memory
  const size_t smem = size_t(stack_n) * RPB * 8;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(wide_walk_kernel<R, COUNT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  wide_walk_kernel<R, COUNT><<<unsigned((n + RPB - 1) / RPB), TRACE_THREADS,
                               smem, st>>>(nodes, a, n, stack_n, counts);
}

template <class R>
int launch_walk(const float* nodes, const typename R::Args& a, int64_t n,
                int stack_n, int32_t* counts, void* stream) {
  if (n == 0) return int(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counts)
    launch<R, true>(nodes, a, n, stack_n, counts, st);
  else
    launch<R, false>(nodes, a, n, stack_n, counts, st);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace sge

// Each entry: nodes (W,32) wide nodes, n rays, stack_n the tree's stack
// bound, counts (4,N) int32 per-ray work or null.

// K4: rows (M_pad,128), o/d (N,3), t_max (N,). Out: t (N,), tri (N,) int32.
SGE_API int sge_trace_closest(const float* nodes, const float* rows,
                              const float* o, const float* d,
                              const float* t_max, int64_t n, int stack_n,
                              int32_t* counts, float* t, int32_t* tri,
                              void* stream) {
  return sge::launch_walk<sge::Closest>(nodes, {rows, o, d, t_max, t, tri}, n,
                                        stack_n, counts, stream);
}

// K6: srows (Lp,132) origin rows, origin (ox, oy, oz), d (N,3), t_max (N,),
// t_floor (N,) or null (1e-4). Out: t (N,), tri (N,) int32.
SGE_API int sge_trace_so(const float* nodes, const float* srows, float ox,
                         float oy, float oz, const float* d,
                         const float* t_max, const float* t_floor, int64_t n,
                         int stack_n, int32_t* counts, float* t, int32_t* tri,
                         void* stream) {
  return sge::launch_walk<sge::SharedOrigin>(
      nodes, {srows, ox, oy, oz, d, t_max, t_floor, t, tri}, n, stack_n,
      counts, stream);
}

// K8: rows (M_pad,128), o/d (N,3), t_lim (N,). Out: blocked (N,) bool.
SGE_API int sge_trace_any(const float* nodes, const float* rows,
                          const float* o, const float* d, const float* t_lim,
                          int64_t n, int stack_n, int32_t* counts,
                          bool* blocked, void* stream) {
  return sge::launch_walk<sge::AnyOpaque>(nodes, {rows, o, d, t_lim, blocked},
                                          n, stack_n, counts, stream);
}

// Threads a ray of a walk's policy: 0 K4, 1 K6, 2 K8; -1 otherwise. The
// counting instantiations' callers group their per-ray counts by warp
// with it.
SGE_API int sge_walk_threads(int walk) {
  switch (walk) {
    case 0: return sge::Closest::G;
    case 1: return sge::SharedOrigin::G;
    case 2: return sge::AnyOpaque::G;
    default: return -1;
  }
}
