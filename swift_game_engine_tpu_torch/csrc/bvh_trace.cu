// K4, K5, K6, K7 and K8: one walk over the 4-wide tree, five leaf tests.
//
// K4, closest hit. Replaces swift_game_engine_tpu/ops/rt_kernel.py:
// _kernel_stream (wrapper trace_rays_pallas), the member that serves trees
// past the TPU's 26k-node VMEM cap, and computes the same function as its
// siblings (_kernel_smem_ordered, _kernel, _kernel_smem,
// _kernel_smem_interval, _kernel_smem_ordered2): per ray the nearest
// (t, triangle id) with 1e-4 < t < t_max, Moller-Trumbore leaf tests,
// translucent ids (id + 0.5) truncated to the triangle id.
//
// K5, layered shared-origin walk. Replaces rt_kernel.py:_kernel_layers_so
// (wrapper trace_layers_so): per ray of one shared origin, the nearest
// OPAQUE hit (t, id) and the NS (1..3) nearest TRANSLUCENT hits
// (t, id + 0.5) met on the way, ascending (the insertion network), tested
// by so_cross<false> (separately rounded dot products) on the origin rows
// of build_origin_rows; a slot is accepted where tn_s > 1e-4*dnp and
// t = tn_s/dnp lies below the walk bound taken at the leaf's entry. A lane
// with t_max <= 0 is inactive (t_opq 0, tri -1).
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
// K7, shared-direction shadow walk. Replaces
// rt_kernel.py:_kernel_shadow_factor (wrapper trace_shadow_factor): per
// origin P toward one light, the nearest OPAQUE t and the NS (1..4)
// nearest TRANSLUCENT (t, id + 0.5) with 1e-4 < t < t_lim, ascending; the
// shadow rows of build_shadow_rows give u = P.g1 - c1, v = P.g2 - c2,
// t = P.g3 - c3 (separately rounded dots). A lane with t_lim <= 0 is
// inactive (t_opq 0, ids -1).
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
// in the origin and shadow rows, plus one; 0 elsewhere); a leaf's
// triangles are the packed row's slots [8+9j : 17+9j] and ids [116+j].
//
// What bound the one-thread-per-ray binary walks this replaces, on the
// H100: a call lasted as long as its slowest ray's chain of dependent node
// loads (two per binary node: the right child's index sat in the left
// child's row), with its stack in local memory and a leaf's 12 slot tests
// one after another; K4's binary walk visited 3.2x the wide walk's nodes.
// K5-K8 ran that design until they became instances of this walk. Their
// binary walks on the first frame's calls (H100): K6 and K5 camera rays
// visit 869 and 882 nodes and test 3,936 and 4,003 slots each on average
// (paths 6 and 2); K8's slowest 1% visit 1,500 nodes (path 6); K7, which
// followed skip links and never ordered children near-first, so that its
// prune bound min(t_lim, t_opq, last slot) tightened late, visits 316
// nodes an origin on average and 1,661 at most (path 3). On the same rays
// this walk visits 272, 276, 392 (K8's max) and 79 (K7; 415 at most)
// wide nodes. The design:
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
//     four on path 6's 557,056 rays (H100, commit 4f2c21d). K7 runs four
//     and K5 four or one by the call's ray count (k5_threads,
//     K7_THREADS);
//   * the leaf test is a policy (Closest, LayeredOrigin, SharedOrigin,
//     ShadowSlots, AnyOpaque): it loads its ray, names the walk bound and
//     its threads a ray, tests a leaf's slots and says whether the walk
//     ends. K5 and K6 divide for t only when a slot crosses;
//   * the slot policies (K5, K7) keep records whose walk bound depends on
//     them, so a ray's group must agree on them: each thread tests its
//     slots against what the leaf's entry fixed, then the group applies
//     the accepted slots in slot order, each broadcast from its thread
//     (slots_in_order), which is one thread's order at any G;
//   * a counting instantiation (COUNT, with a null counts pointer in
//     production) reports each ray's wide nodes, the child boxes it tests
//     (the non-empty slots of those nodes), leaves and slot tests.
//
// Per-frame values come from device memory, so that a CUDA graph that
// captured a launch reads each replay's own: K5's and K6's shared origin
// and K7's inverse light direction (3 floats each). K4 and K6 also take an
// optional lane count (int32, device memory; null: every lane): a lane at
// or past it is not walked and keeps its miss record (t = t_max, id -1),
// so a call on compacted lanes costs its live lanes, not its capacity, and
// a block past the count ends after one read and one write a lane.

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

// The slab test of one child's box held in registers: returns tmin and sets
// `hit` as the reference's box_hit = (tmax >= max(tmin, 0)) & (tmin < bound).
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

// A leaf's cnt slots in slot order, G threads at a time: thread k tests
// slots k, k+G, ... with test(j, t, id) (it reads only what the leaf's
// entry fixed), then every thread of the group applies the accepted
// (t, id) in the order j = 0, 1, ..., each broadcast from its thread, so
// the group's records stay equal, and equal to one thread's.
template <int G, class Test, class Apply>
__device__ __forceinline__ void slots_in_order(int cnt, int k, unsigned mask,
                                               int& tests, Test test,
                                               Apply apply) {
  if constexpr (G == 1) {
    for (int j = 0; j < cnt; ++j) {
      float t, id;
      ++tests;
      if (test(j, t, id)) apply(t, id);
    }
  } else {
    constexpr int Q = (SLOT_N + G - 1) / G;
    float tq[Q], iq[Q];
    bool mine = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = k + q * G;
      tq[q] = f32_inf();
      iq[q] = -1.0f;
      if (j < cnt) {
        float t, id;
        ++tests;
        if (test(j, t, id)) {
          tq[q] = t;
          iq[q] = id;
          mine = true;
        }
      }
    }
    if (!__any_sync(mask, mine)) return;
#pragma unroll
    for (int j = 0; j < SLOT_N; ++j) {
      if (j < cnt) {                       // cnt: the same in the group
        const float t = __shfl_sync(mask, tq[j / G], j % G, G);
        const float id = __shfl_sync(mask, iq[j / G], j % G, G);
        if (t < f32_inf()) apply(t, id);
      }
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

// The ref of child k with a leaf named by its rank: the code of the leaf's
// row in the per-leaf tables ordered by rank (the origin rows of K5 and
// K6, the shadow rows of K7).
__device__ __forceinline__ int ranked_ref(const float* __restrict__ nd,
                                          int k) {
  const int rf = packed_ref(nd, k);
  if (rf > -2) return rf;
  const int rank = int(__ldg(nd + 28 + k));
  return -2 - (16 * (rank - 1) + ((-2 - rf) & 15));
}

// Whether lane i lies at or past the lane count in device memory (null: no
// count), which a call's compacted lanes give K4 and K6.
__device__ __forceinline__ bool beyond_count(const int32_t* __restrict__ count,
                                             int64_t i) {
  return count != nullptr && i >= int64_t(__ldg(count));
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
    const int32_t* count; float* t_out; int32_t* tri_out;
  };
  static constexpr int G = WIDE;
  bool past;
  __device__ Closest(const Args& a, int64_t i) {
    t_best = __ldg(a.t_max + i);
    tri_best = -1.0f;
    past = beyond_count(a.count, i);
    if (!past) {
      load_o(a.o, i);
      load_d(a.d, i);
    }
  }
  // a lane with t_max <= 0 walks and finds nothing (its origin is parked)
  __device__ bool live() const { return !past; }
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
    const float* srows; const float* origin; const float* d;
    const float* t_max; const float* t_floor; const int32_t* count;
    float* t_out; int32_t* tri_out;
  };
  static constexpr int G = 1;
  float fl;
  bool past;
  __device__ SharedOrigin(const Args& a, int64_t i) {
    t_best = __ldg(a.t_max + i);       // a miss keeps t_max
    tri_best = -1.0f;
    past = beyond_count(a.count, i);
    if (!past) {
      load_o(a.origin, 0);
      load_d(a.d, i);
      fl = a.t_floor != nullptr ? __ldg(a.t_floor + i) : 1e-4f;
    }
  }
  __device__ bool live() const { return t_best > 0.0f && !past; }
  __device__ int child_ref(const float* nd, int k) const {
    return ranked_ref(nd, k);
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
                 t = tn_s / dnp;       // the reference's t: dnp >= EPS here
                 return true;
               });
    return false;
  }
};

// The slot policies' records (K5, K7): the nearest opaque hit (t, id; K7
// reports t alone) and the NS nearest translucent (t, id + 0.5),
// ascending.
template <int NS>
struct SlotRecords : Ray {
  float t_opq, tri_opq, ts[NS], ids[NS];
  __device__ void init(bool live) {
    t_opq = live ? BIG : 0.0f;         // 0: an inactive lane
    tri_opq = -1.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      ts[s] = BIG;
      ids[s] = -1.0f;
    }
  }
  __device__ bool live() const { return t_opq > 0.0f; }
  // the opaque hit or the translucent slot list takes an accepted (t, id)
  __device__ void take(float t, float id) {
    if (id == floorf(id)) {
      if (t < t_opq) {
        t_opq = t;
        tri_opq = id;
      }
    } else {
      insert_slot<NS>(t, id, ts, ids);
    }
  }
  template <class Args>
  __device__ void write_slots(const Args& a, int64_t i) const {
    a.t_out[i] = t_opq;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      a.ts_out[i * NS + s] = ts[s];
      a.ids_out[i * NS + s] = ids[s];
    }
  }
};

// K5: the nearest opaque so_cross<false> hit and the NS nearest translucent
// ones with tn_s > 1e-4*dnp and t = tn_s/dnp below the bound at the leaf's
// entry, all rays from one origin; leaves name their origin row by rank.
struct LayeredArgs {
  const float* srows; const float* origin; const float* d;
  const float* t_max; float* t_out; int32_t* tri_out; float* ts_out;
  float* ids_out;
};

template <int NS, int G_>
struct LayeredOrigin : SlotRecords<NS> {
  using Args = LayeredArgs;
  static constexpr int G = G_;
  static constexpr int MAX_NS = 3;
  float tm;
  __device__ LayeredOrigin(const Args& a, int64_t i) {
    this->load_o(a.origin, 0);
    this->load_d(a.d, i);
    tm = __ldg(a.t_max + i);
    this->init(tm > 0.0f);
  }
  __device__ float bound() const {
    return fminf(fminf(tm, this->t_opq), this->ts[NS - 1]);
  }
  __device__ int child_ref(const float* nd, int k) const {
    return ranked_ref(nd, k);
  }
  __device__ bool leaf(const Args& a, int code, int k, unsigned mask,
                       int& tests) {
    const float* row = a.srows + int64_t(code >> 4) * SO_ROW_W;
    const float b = bound();
    slots_in_order<G>(
        code & 15, k, mask, tests,
        [&](int j, float& t, float& id) {
          float dnp, tn_s;
          if (!(so_cross<false>(row, j, this->dx, this->dy, this->dz, dnp,
                                tn_s, id) &&
                tn_s > 1e-4f * dnp))
            return false;
          t = tn_s / dnp;              // the reference's t: dnp >= EPS here
          return t < b;
        },
        [&](float t, float id) { this->take(t, id); });
    return false;
  }
  __device__ void write(const Args& a, int64_t i) const {
    this->write_slots(a, i);
    a.tri_out[i] = int32_t(this->tri_opq);
  }
};

// K7: the nearest opaque hit and the NS nearest translucent ones at
// 1e-4 < t < t_lim along the light, each origin its own; leaves name their
// shadow row by rank.
struct ShadowArgs {
  const float* srows; const float* inv_l; const float* o;
  const float* t_lim; float* t_out; float* ts_out; float* ids_out;
};

// K7 runs four threads an origin: its calls (40,960 origins at RT scale
// 0.25; the walk serves frames under 100,000 lanes) last as long as their
// slowest origins, 1.293-1.297 ms at four threads against 3.171-3.188 at
// one (H100, path 3; chip_smoke.py of commit 429fc42).
constexpr int K7_THREADS = WIDE;

template <int NS, int G_>
struct ShadowSlots : SlotRecords<NS> {
  using Args = ShadowArgs;
  static constexpr int G = G_;
  static constexpr int MAX_NS = 4;
  float tl;
  __device__ ShadowSlots(const Args& a, int64_t i) {
    this->load_o(a.o, i);
    this->ix = __ldg(a.inv_l); this->iy = __ldg(a.inv_l + 1);
    this->iz = __ldg(a.inv_l + 2);
    tl = __ldg(a.t_lim + i);
    this->init(tl > 0.0f);
  }
  __device__ float bound() const {
    return fminf(fminf(tl, this->t_opq), this->ts[NS - 1]);
  }
  __device__ int child_ref(const float* nd, int k) const {
    return ranked_ref(nd, k);
  }
  __device__ bool leaf(const Args& a, int code, int k, unsigned mask,
                       int& tests) {
    const float* row = a.srows + int64_t(code >> 4) * SH_ROW_W;
    const float px = this->ox, py = this->oy, pz = this->oz;
    slots_in_order<G>(
        code & 15, k, mask, tests,
        [&](int j, float& t, float& id) {
          id = __ldg(row + SH_SLOT_F * SLOT_N + j);
          const float* s = row + SH_SLOT_F * j;
          const float u = dot3<false>(s, px, py, pz) - __ldg(s + 9);
          const float v = dot3<false>(s + 3, px, py, pz) - __ldg(s + 10);
          t = dot3<false>(s + 6, px, py, pz) - __ldg(s + 11);
          return id >= 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                 u + v <= 1.0f && t > 1e-4f && t < tl;
        },
        [&](float t, float id) { this->take(t, id); });
    return false;
  }
  __device__ void write(const Args& a, int64_t i) const {
    this->write_slots(a, i);
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

// A slot policy P<NS, G> with n_slots = NS in 1..P::MAX_NS.
template <template <int, int> class P, int G, int NS = 1>
int launch_slots(int n_slots, const float* nodes,
                 const typename P<1, G>::Args& a, int64_t n, int stack_n,
                 int32_t* counts, void* stream) {
  if constexpr (NS > P<1, G>::MAX_NS) {
    return int(cudaErrorInvalidValue);
  } else {
    if (n_slots == NS)
      return launch_walk<P<NS, G>>(nodes, a, n, stack_n, counts, stream);
    return launch_slots<P, G, NS + 1>(n_slots, nodes, a, n, stack_n, counts,
                                      stream);
  }
}

// K5's threads a ray by the call's ray count: four while one thread a ray
// leaves the SMs short of warps, one once the call is bound by the
// instructions it issues. K5 on path 3's 40,960 rays and on the first m of
// path 2's 557,056 (H100, chip_smoke.py of commit 429fc42):
//   rays            four threads      one thread
//   40,960 (p3)     1.559-1.583 ms    3.311-3.330 ms
//   163,840         3.366-3.403       3.834-3.837
//   327,680         6.722-6.759       6.091-6.110
//   557,056 (p2)    12.327-12.338     9.552-9.560
constexpr int64_t K5_ONE_THREAD_FROM = 262144;

__host__ __device__ constexpr int k5_threads(int64_t n) {
  return n < K5_ONE_THREAD_FROM ? WIDE : 1;
}

}  // namespace
}  // namespace sge

// Each entry: nodes (W,32) wide nodes, n rays, stack_n the tree's stack
// bound, counts (4,N) int32 per-ray work or null.

// K4: rows (M_pad,128), o/d (N,3), t_max (N,), count (1,) int32 or null.
// Out: t (N,), tri (N,) int32.
SGE_API int sge_trace_closest(const float* nodes, const float* rows,
                              const float* o, const float* d,
                              const float* t_max, const int32_t* count,
                              int64_t n, int stack_n, int32_t* counts,
                              float* t, int32_t* tri, void* stream) {
  return sge::launch_walk<sge::Closest>(
      nodes, {rows, o, d, t_max, count, t, tri}, n, stack_n, counts, stream);
}

// K5: srows (Lp,132) origin rows, origin (3,), d (N,3), t_max (N,),
// n_slots 1..3. Out: t_opq (N,), tri (N,) int32, ts (N, n_slots),
// ids (N, n_slots).
SGE_API int sge_so_layers(const float* nodes, const float* srows,
                          const float* origin, const float* d,
                          const float* t_max, int64_t n, int stack_n,
                          int n_slots, int32_t* counts, float* t_opq,
                          int32_t* tri, float* ts, float* ids, void* stream) {
  const sge::LayeredArgs a{srows, origin, d, t_max, t_opq, tri, ts, ids};
  if (sge::k5_threads(n) == 1)
    return sge::launch_slots<sge::LayeredOrigin, 1>(n_slots, nodes, a, n,
                                                     stack_n, counts, stream);
  return sge::launch_slots<sge::LayeredOrigin, sge::WIDE>(
      n_slots, nodes, a, n, stack_n, counts, stream);
}

// K6: srows (Lp,132) origin rows, origin (3,), d (N,3), t_max (N,),
// t_floor (N,) or null (1e-4), count (1,) int32 or null. Out: t (N,),
// tri (N,) int32.
SGE_API int sge_trace_so(const float* nodes, const float* srows,
                         const float* origin, const float* d,
                         const float* t_max, const float* t_floor,
                         const int32_t* count, int64_t n, int stack_n,
                         int32_t* counts, float* t, int32_t* tri,
                         void* stream) {
  return sge::launch_walk<sge::SharedOrigin>(
      nodes, {srows, origin, d, t_max, t_floor, count, t, tri}, n, stack_n,
      counts, stream);
}

// K7: srows (Lp,156) shadow rows, the light direction's safe inverse
// inv_l (3,), o (N,3), t_lim (N,), n_slots 1..4. Out: t_opq (N,),
// ts (N, n_slots), ids (N, n_slots).
SGE_API int sge_shadow_walk(const float* nodes, const float* srows,
                            const float* inv_l, const float* o,
                            const float* t_lim, int64_t n, int stack_n,
                            int n_slots, int32_t* counts, float* t_opq,
                            float* ts, float* ids, void* stream) {
  return sge::launch_slots<sge::ShadowSlots, sge::K7_THREADS>(
      n_slots, nodes, {srows, inv_l, o, t_lim, t_opq, ts, ids}, n, stack_n,
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

// Threads a ray of a walk's policy at n rays: 0 K4, 1 K6, 2 K8, 3 K5, 4 K7;
// -1 otherwise. The counting instantiations' callers group their per-ray
// counts by warp with it.
SGE_API int sge_walk_threads(int walk, int64_t n) {
  switch (walk) {
    case 0: return sge::Closest::G;
    case 1: return sge::SharedOrigin::G;
    case 2: return sge::AnyOpaque::G;
    case 3: return sge::k5_threads(n);
    case 4: return sge::K7_THREADS;
    default: return -1;
  }
}
