// Shared definitions for the port's Hopper kernels (built for sm_90a by
// swift_game_engine_tpu_torch/ops/_cuda.py, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SGE_API extern "C" __attribute__((visibility("default")))

namespace sge {

constexpr float BIG = 3.0e38f;

// A row of 16 f32 lanes (one triangle of the cluster tables) read as four
// 16-byte loads; s(i) picks lane i.
struct Row16 {
  float4 a, b, c, d;
  __device__ __forceinline__ float s(int i) const {
    switch (i) {
      case 0: return a.x; case 1: return a.y; case 2: return a.z; case 3: return a.w;
      case 4: return b.x; case 5: return b.y; case 6: return b.z; case 7: return b.w;
      case 8: return c.x; case 9: return c.y; case 10: return c.z; case 11: return c.w;
      case 12: return d.x; case 13: return d.y; case 14: return d.z; default: return d.w;
    }
  }
};

__device__ __forceinline__ Row16 load_row16(const float4* __restrict__ rows,
                                            int64_t i) {
  const float4* r = rows + i * 4;
  return Row16{__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3)};
}

// The BVH walks (bvh_trace.cu) over the packed tree (ops/rt_kernel.py
// pack_bvh): 12 triangles per leaf row.
constexpr int SLOT_N = 12;
constexpr float EPS = 1e-6f;

__device__ __forceinline__ float safe_inv(float v) {
  const float vs = fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v;
  return 1.0f / vs;
}

// Origin rows (ops/rt_kernel.py build_origin_rows) of the shared-origin
// walks K5 and K6: per leaf triangle k_u, k_v, k_d, tn, then the ids.
constexpr int SO_SLOT_F = 10;                          // k_u, k_v, k_d, tn
constexpr int SO_ROW_W = SO_SLOT_F * SLOT_N + SLOT_N;  // + the ids
// Shadow rows (build_shadow_rows) of the shadow walk K7: per leaf triangle
// g1, g2, g3, c, then the ids.
constexpr int SH_SLOT_F = 12;                          // g1, g2, g3, c
constexpr int SH_ROW_W = SH_SLOT_F * SLOT_N + SLOT_N;  // + the ids

// d . s[0:3] as the reference computes it: separately rounded,
// (dx*s0 + dy*s1) + dz*s2; or, FUSED, as XLA contracts that sum when it
// runs the reference on the CPU, fma(dz, s2, fma(dx, s0, dy*s1)) (K6's
// t then equals the reference's bit for bit on the same origin rows).
template <bool FUSED>
__device__ __forceinline__ float dot3(const float* __restrict__ s, float dx,
                                      float dy, float dz) {
  if (FUSED)
    return fmaf(dz, __ldg(s + 2), fmaf(dx, __ldg(s), dy * __ldg(s + 1)));
  return (dx * __ldg(s) + dy * __ldg(s + 1)) + dz * __ldg(s + 2);
}

// Slot j of origin row `row` against direction d: the sign-folded terms of
// swift_game_engine_tpu/ops/rt_kernel.py:1393-1401, in its operation order
// (its dot products as dot3<FUSED>). Returns whether the ray's line crosses
// the triangle (id >= 0, dnp >= EPS, barycentric range), with dnp, tn_s and
// the id; the caller adds its t range test on tn_s or t = tn_s / dnp.
template <bool FUSED = false>
__device__ __forceinline__ bool so_cross(const float* __restrict__ row, int j,
                                         float dx, float dy, float dz,
                                         float& dnp, float& tn_s,
                                         float& tri_id) {
  tri_id = __ldg(row + SO_SLOT_F * SLOT_N + j);
  const float* s = row + SO_SLOT_F * j;
  const float un = dot3<FUSED>(s, dx, dy, dz);
  const float vn = dot3<FUSED>(s + 3, dx, dy, dz);
  const float dn = dot3<FUSED>(s + 6, dx, dy, dz);
  const float tn = __ldg(s + 9);
  const float sgn = dn < 0.0f ? -1.0f : 1.0f;
  dnp = dn * sgn;
  const float un_s = un * sgn, vn_s = vn * sgn;
  tn_s = tn * sgn;
  return tri_id >= 0.0f && dnp >= EPS && un_s >= 0.0f && un_s <= dnp &&
         vn_s >= 0.0f && un_s + vn_s <= dnp;
}

// The reference's insertion network: (t, id) enters the ascending slot
// list (ts, ids) of NS entries; the largest falls off the end.
template <int NS>
__device__ __forceinline__ void insert_slot(float ct, float cid,
                                            float (&ts)[NS], float (&ids)[NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    if (ct < ts[k]) {
      float tmp = ts[k]; ts[k] = ct; ct = tmp;
      tmp = ids[k]; ids[k] = cid; cid = tmp;
    }
  }
}

// Asynchronous 16-byte copies from device to shared memory (cp.async,
// bypassing L1), committed in groups; cp_async_wait<N> waits until at most
// the N newest groups of this thread are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp-wide reductions over all 32 lanes.
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

}  // namespace sge
