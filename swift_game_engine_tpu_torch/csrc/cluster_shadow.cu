// K2 + K3: shared-direction shadow sweeps over depth-sorted light-space
// clusters.
//
// K2 replaces swift_game_engine_tpu/ops/cluster_shadow.py:_kernel_occl
// (wrapper trace_shadow_occl): the nearest OPAQUE hit t per origin, with
// the per-lane settle threshold `tt` (a lane whose t_opq < tt is settled:
// any-hit mode). K3 replaces cluster_shadow.py:_kernel (wrapper
// trace_shadow_clusters): t_opq plus the n_slots nearest translucent
// (t, id | 2+alpha) records per origin, kept ascending by insertion.
//
// Each triangle test is three dot products of the origin against per-frame
// constants (u, v, t along the light). Rejection and the stop use a small
// margin so that rounding between the footprint projection and the
// triangle constants can only add work, never drop a hit. The row tables
// (64 B per triangle) are L2-resident.
//
// Both sweeps run one template (NS = 0: K2, the occlusion sweep with the
// any-hit settle; NS = 1..4: K3, the slotted sweep of the translucent
// subset). The first design ran one thread per lane; counted on path 1's
// first shade call (557,056 lanes; PERF.md), every lane stepped the
// metadata list one entry at a time, about seven broadcast loads and a
// branch each (K2: 328 entries a lane on average, all 1,414 for a lit
// lane), and a warp looped over every row of every cluster one of its
// lanes entered. The warp-cooperative design (on that call K2 1.42 ->
// 0.28 ms, K3 0.25 -> 0.08 ms; both far above their bytes floor, held by
// the latency of the warp's ballot rounds):
//   * culling: each warp forms its live lanes' footprint (the min/max of
//     the light-plane a and b with their margins, the least depth less its
//     margin) and the largest stop bound, tests 32 metadata entries at once,
//     one per thread, and ballots the survivors; a survivor then meets each
//     lane's own settle, stop and overlap tests, in depth order, as the
//     per-lane sweep did. The footprint only over-admits and skipped
//     entries change no lane's records, so the records are the per-lane
//     sweep's;
//   * staging: the rows of each cluster some lane enters are copied to
//     shared memory by cp.async in 64-row chunks, double-buffered, so the
//     triangle loop reads shared memory while the next chunk loads;
//   * groups: a lane tests a 32-row group of an entered cluster only when
//     its point lies in the group's light-plane box (with the margins) and
//     the group starts before its stop bound; the warp skips a group no
//     lane needs;
//   * exit: a warp stops once every lane is dead, settled or past its
//     bound (__all_sync), or the next entry lies past the warp's bound;
//   * a counting instantiation (COUNT, null counts in production) reports
//     the per-lane and per-warp work.
// A lane's stop bound is its depth plus the least of t_lim, t_opq and (K3)
// its last slot's t: nothing farther can change its records.

#include "common.cuh"

namespace sge {
namespace {

struct Lane {
  float px, py, pz, a, b, dep;
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o,
                                          const float* __restrict__ basis,
                                          int64_t i) {
  Lane L;
  L.px = __ldg(o + 3 * i);
  L.py = __ldg(o + 3 * i + 1);
  L.pz = __ldg(o + 3 * i + 2);
  L.a = L.px * __ldg(basis + 0) + L.py * __ldg(basis + 1) + L.pz * __ldg(basis + 2);
  L.b = L.px * __ldg(basis + 3) + L.py * __ldg(basis + 4) + L.pz * __ldg(basis + 5);
  L.dep = L.px * __ldg(basis + 6) + L.py * __ldg(basis + 7) + L.pz * __ldg(basis + 8);
  return L;
}

__device__ __forceinline__ float margin(float x) {
  return 1e-4f * (1.0f + fabsf(x));
}

// Cluster meta: [a0, b0, a1, b1, d0, d1, base_row, 0], sorted by d0.

struct Hit {
  float t;
  bool hit;
};

__device__ __forceinline__ Hit tri_test(const Row16& r, const Lane& L,
                                        float t_lim) {
  const float u = L.px * r.s(0) + L.py * r.s(1) + L.pz * r.s(2) - r.s(9);
  const float v = L.px * r.s(3) + L.py * r.s(4) + L.pz * r.s(5) - r.s(10);
  const float t = L.px * r.s(6) + L.py * r.s(7) + L.pz * r.s(8) - r.s(11);
  const bool hit = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > 1e-4f && t < t_lim;
  return Hit{t, hit};
}

constexpr int OCCL_WARPS = 4;     // warps per block
constexpr int CHUNK = 64;         // rows per staged chunk: 4 KB
constexpr int GROUP = 32;         // rows per culling group

// The warp copies chunk `ch` of the cluster whose rows start at packed row
// `base` (units of 8 rows) into `dst`: 256 float4, 8 per lane.
__device__ __forceinline__ void stage_chunk(float4* dst,
                                            const float4* __restrict__ rows,
                                            int base, int ch, int lane) {
  const float4* src = rows + (int64_t(base) * 8 + int64_t(ch) * CHUNK) * 4;
#pragma unroll
  for (int q = 0; q < CHUNK * 4 / 32; ++q)
    cp_async16(dst + lane + 32 * q, src + lane + 32 * q);
}

// One warp per 32 consecutive lanes (the frame's tile-major order).
// groups: per GROUP rows of each cluster (in meta's order) [a0, b0, a1, b1,
// d0, d1, 0, 0]: a lane tests a group's rows only when its point lies in
// the group's box and the group starts before its stop bound.
// NS = 0 (K2): only opaque rows are tested, and a lane whose t_opq drops
// below its settle threshold `tt` stops. NS > 0 (K3): every row; opaque
// hits lower t_opq, translucent ones enter the NS slots (payload: the id,
// or with ALPHA row lane 13).
// counts (COUNT): per lane [0, n) footprint survivors the lane tests
// itself, [n, 2n) clusters it enters, [2n, 3n) triangle rows it tests
// (K2: opaque rows only; padding rows are skipped); per warp w at 3n + 4w:
// entries its ballots test (32 at a time), footprint survivors, clusters
// staged, triangle rows it loops over.
template <int NS, bool ALPHA, bool COUNT>
__global__ void __launch_bounds__(OCCL_WARPS * 32)
shadow_sweep_kernel(const float4* __restrict__ rows,
                    const float* __restrict__ meta,
                    const float4* __restrict__ groups,
                    const float* __restrict__ basis,
                    const float* __restrict__ o,
                    const float* __restrict__ t_lim,
                    const float* __restrict__ tt, int64_t n, int n_clusters,
                    int cluster, int32_t* __restrict__ counts,
                    float* __restrict__ t_opq_out, float* __restrict__ ts_out,
                    float* __restrict__ ids_out) {
  __shared__ float4 stage[OCCL_WARPS][2][CHUNK * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wid = int64_t(blockIdx.x) * OCCL_WARPS + warp;
  const int64_t i = wid * 32 + lane;
  if (wid * 32 >= n) return;               // the whole warp leaves
  const bool in = i < n;
  const float tl = in ? __ldg(t_lim + i) : 0.0f;
  bool done = !(tl > 0.0f);                // dead lanes and the tail
  Lane L{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (!done) L = load_lane(o, basis, i);
  const float settle = NS == 0 && tt != nullptr && in ? __ldg(tt + i) : 0.0f;
  const float ma = margin(L.a), mb = margin(L.b), md = margin(L.dep);
  const float4* meta4 = reinterpret_cast<const float4*>(meta);
  const int nch = cluster / CHUNK;
  const int per = cluster / GROUP;         // groups per cluster
  constexpr int NSA = NS > 0 ? NS : 1;
  float ts[NSA], ids[NSA];
#pragma unroll
  for (int k = 0; k < NSA; ++k) { ts[k] = BIG; ids[k] = -1.0f; }
  float t_opq = BIG;
  // the lane's stop bound: nothing past it can change its records
  auto stop = [&]() {
    float s = fminf(tl, t_opq);
    if constexpr (NS > 0) s = fminf(s, ts[NS - 1]);
    return L.dep + s;
  };
  int l_meta = 0, l_enter = 0, l_tri = 0;
  int w_meta = 0, w_surv = 0, w_enter = 0, w_tri = 0;
  for (int c0 = 0; c0 < n_clusters; c0 += 32) {
    done = done || t_opq < settle;          // settled: the factor is decided
    if (__all_sync(FULL, done)) break;
    // the warp's footprint and its largest stop bound, over live lanes
    const float fa0 = warp_min(done ? BIG : L.a - ma);
    const float fa1 = warp_max(done ? -BIG : L.a + ma);
    const float fb0 = warp_min(done ? BIG : L.b - mb);
    const float fb1 = warp_max(done ? -BIG : L.b + mb);
    const float fd0 = warp_min(done ? BIG : L.dep - md);
    const float bnd = stop();
    const float wb = warp_max(done ? -BIG : bnd + margin(bnd));
    // 32 entries at once, one per thread: [a0, b0, a1, b1], [d0, d1, base]
    const int c = c0 + lane;
    float4 m0 = make_float4(BIG, BIG, -BIG, -BIG);
    float4 m1 = make_float4(BIG, -BIG, 0.0f, 0.0f);
    if (c < n_clusters) {
      m0 = __ldg(meta4 + 2 * int64_t(c));
      m1 = __ldg(meta4 + 2 * int64_t(c) + 1);
    }
    // entries are sorted by d0: from the first one past every lane's
    // bound on, none is needed
    const unsigned past = __ballot_sync(FULL, c >= n_clusters || m1.x >= wb);
    const int live_n = past ? __ffs(past) - 1 : 32;
    const unsigned surv =
        __ballot_sync(FULL, lane < live_n &&
                                !(m0.x > fa1 || m0.z < fa0 || m0.y > fb1 ||
                                  m0.w < fb0 || !(m1.y > fd0)));
    if (COUNT) {
      w_meta += min(32, n_clusters - c0);
      w_surv += __popc(surv);
    }
    // survivors some live lane overlaps: the clusters to stage
    unsigned todo = 0;
    for (unsigned sv = surv; sv; sv &= sv - 1) {
      const int s = __ffs(sv) - 1;
      const float a0 = __shfl_sync(FULL, m0.x, s);
      const float b0 = __shfl_sync(FULL, m0.y, s);
      const float a1 = __shfl_sync(FULL, m0.z, s);
      const float b1 = __shfl_sync(FULL, m0.w, s);
      const float d1 = __shfl_sync(FULL, m1.y, s);
      const bool ov = !done && !(a0 > L.a + ma || a1 < L.a - ma ||
                                 b0 > L.b + mb || b1 < L.b - mb ||
                                 !(d1 > L.dep - md));
      if (COUNT) l_meta += !done;
      if (__any_sync(FULL, ov)) todo |= 1u << s;
    }
    if (!todo) {
      if (live_n < 32) break;              // the rest lies past every bound
      continue;
    }
    // the staged clusters, in depth order, each chunk loading while the
    // previous one is tested
    int b = 0;
    stage_chunk(stage[warp][0], rows,
                int(__shfl_sync(FULL, m1.z, __ffs(todo) - 1)), 0, lane);
    cp_async_commit();
    while (todo) {
      const int s = __ffs(todo) - 1;
      todo &= todo - 1;
      const float d0 = __shfl_sync(FULL, m1.x, s);
      const float a0 = __shfl_sync(FULL, m0.x, s);
      const float b0 = __shfl_sync(FULL, m0.y, s);
      const float a1 = __shfl_sync(FULL, m0.z, s);
      const float b1 = __shfl_sync(FULL, m0.w, s);
      const float d1 = __shfl_sync(FULL, m1.y, s);
      const int base = int(__shfl_sync(FULL, m1.z, s));
      const int next = todo ? int(__shfl_sync(FULL, m1.z, __ffs(todo) - 1))
                            : -1;
      // each lane's own tests, in the per-lane sweep's order
      if (!done) {
        const float bound = stop();
        done = t_opq < settle || d0 >= bound + margin(bound);
      }
      const bool need = !done && !(a0 > L.a + ma || a1 < L.a - ma ||
                                   b0 > L.b + mb || b1 < L.b - mb ||
                                   !(d1 > L.dep - md));
      if (COUNT) {
        l_enter += need;
        ++w_enter;
      }
      const float4* gq = groups + 2 * (int64_t(c0 + s) * per);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch)
          stage_chunk(stage[warp][b ^ 1], rows, base, ch + 1, lane);
        else if (next >= 0)
          stage_chunk(stage[warp][b ^ 1], rows, next, 0, lane);
        cp_async_commit();
        cp_async_wait<1>();                // this chunk's copies are done
        __syncwarp();
#pragma unroll 1
        for (int g = 0; g < CHUNK / GROUP; ++g) {
          bool need_g = false;
          if (need) {                      // the group's box and its start
            const float4 q0 = __ldg(gq + 2 * (ch * (CHUNK / GROUP) + g));
            const float4 q1 = __ldg(gq + 2 * (ch * (CHUNK / GROUP) + g) + 1);
            const float bound = stop();
            need_g = !(q0.x > L.a + ma || q0.z < L.a - ma ||
                       q0.y > L.b + mb || q0.w < L.b - mb ||
                       !(q1.y > L.dep - md) || q1.x >= bound + margin(bound));
          }
          if (!__any_sync(FULL, need_g)) continue;
          if (COUNT) w_tri += GROUP;
          if (need_g) {
            const float4* r4 = stage[warp][b] + 4 * GROUP * g;
            for (int j = 0; j < GROUP; ++j) {
              const Row16 r{r4[4 * j], r4[4 * j + 1], r4[4 * j + 2],
                            r4[4 * j + 3]};
              const float id = r.s(12);
              const bool opaque = id == floorf(id);
              if (!(id >= 0.0f) || (NS == 0 && !opaque)) continue;
              if (COUNT) ++l_tri;
              const Hit h = tri_test(r, L, tl);
              if (!h.hit) continue;
              if (NS == 0 || opaque) {
                t_opq = fminf(t_opq, h.t);
              } else if constexpr (NS > 0) {
                insert_slot<NS>(h.t, ALPHA ? r.s(13) : id, ts, ids);
              }
            }
          }
        }
        __syncwarp();                      // the buffer is free again
        b ^= 1;
      }
      if (__all_sync(FULL, done || t_opq < settle)) break;
    }
    cp_async_wait<0>();
    __syncwarp();
    if (live_n < 32) break;
  }
  if (in) {
    t_opq_out[i] = tl > 0.0f ? t_opq : 0.0f;
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        ts_out[i * NS + k] = ts[k];
        ids_out[i * NS + k] = ids[k];
      }
    }
  }
  if (COUNT) {
    if (in) {
      counts[i] = l_meta;
      counts[n + i] = l_enter;
      counts[2 * n + i] = l_tri;
    }
    if (lane == 0) {
      int32_t* w = counts + 3 * n + 4 * wid;
      w[0] = w_meta;
      w[1] = w_surv;
      w[2] = w_enter;
      w[3] = w_tri;
    }
  }
}

template <int NS, bool ALPHA>
void launch_sweep(const float4* rows, const float* meta, const float4* groups,
                  const float* basis, const float* o, const float* t_lim,
                  const float* tt, int64_t n, int n_clusters, int cluster,
                  int32_t* counts, float* t_opq, float* ts, float* ids,
                  cudaStream_t st) {
  const int64_t warps = (n + 31) / 32;
  const unsigned blocks = unsigned((warps + OCCL_WARPS - 1) / OCCL_WARPS);
  if (counts)
    shadow_sweep_kernel<NS, ALPHA, true><<<blocks, OCCL_WARPS * 32, 0, st>>>(
        rows, meta, groups, basis, o, t_lim, tt, n, n_clusters, cluster,
        counts, t_opq, ts, ids);
  else
    shadow_sweep_kernel<NS, ALPHA, false><<<blocks, OCCL_WARPS * 32, 0, st>>>(
        rows, meta, groups, basis, o, t_lim, tt, n, n_clusters, cluster,
        counts, t_opq, ts, ids);
}

template <int NS>
void launch_slots(bool alpha, const float4* rows, const float* meta,
                  const float4* groups, const float* basis, const float* o,
                  const float* t_lim, int64_t n, int n_clusters, int cluster,
                  int32_t* counts, float* t_opq, float* ts, float* ids,
                  cudaStream_t st) {
  if (alpha)
    launch_sweep<NS, true>(rows, meta, groups, basis, o, t_lim, nullptr, n,
                           n_clusters, cluster, counts, t_opq, ts, ids, st);
  else
    launch_sweep<NS, false>(rows, meta, groups, basis, o, t_lim, nullptr, n,
                            n_clusters, cluster, counts, t_opq, ts, ids, st);
}

}  // namespace
}  // namespace sge

// rows (Tp,16), meta (C,8), groups (C*cluster/32,8), basis (3,3), o (N,3),
// t_lim (N,), tt (N,) or null; cluster a multiple of 64; counts
// (3N + 4 ceil(N/32),) int32 or null. Out: t_opq (N,).
SGE_API int sge_shadow_occl(const float* rows, const float* meta,
                            const float* groups, const float* basis,
                            const float* o,
                            const float* t_lim, const float* tt, int64_t n,
                            int n_clusters, int cluster, int32_t* counts,
                            float* t_opq, void* stream) {
  if (n == 0) return int(cudaGetLastError());
  if (cluster % sge::CHUNK != 0) return int(cudaErrorInvalidValue);
  sge::launch_sweep<0, false>(
      reinterpret_cast<const float4*>(rows), meta,
      reinterpret_cast<const float4*>(groups), basis, o, t_lim, tt, n,
      n_clusters, cluster, counts, t_opq, nullptr, nullptr,
      static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}

// As sge_shadow_occl, without tt. Out: t_opq (N,), ts (N, n_slots), ids
// (N, n_slots).
SGE_API int sge_shadow_slots(const float* rows, const float* meta,
                             const float* groups, const float* basis,
                             const float* o, const float* t_lim, int64_t n,
                             int n_clusters, int cluster, int n_slots,
                             int alpha_payload, int32_t* counts, float* t_opq,
                             float* ts, float* ids, void* stream) {
  if (n == 0) return int(cudaGetLastError());
  if (cluster % sge::CHUNK != 0) return int(cudaErrorInvalidValue);
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const float4* g4 = reinterpret_cast<const float4*>(groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a = alpha_payload != 0;
  switch (n_slots) {
    case 1: sge::launch_slots<1>(a, r4, meta, g4, basis, o, t_lim, n,
                                 n_clusters, cluster, counts, t_opq, ts, ids,
                                 st); break;
    case 2: sge::launch_slots<2>(a, r4, meta, g4, basis, o, t_lim, n,
                                 n_clusters, cluster, counts, t_opq, ts, ids,
                                 st); break;
    case 3: sge::launch_slots<3>(a, r4, meta, g4, basis, o, t_lim, n,
                                 n_clusters, cluster, counts, t_opq, ts, ids,
                                 st); break;
    case 4: sge::launch_slots<4>(a, r4, meta, g4, basis, o, t_lim, n,
                                 n_clusters, cluster, counts, t_opq, ts, ids,
                                 st); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
