// Device helpers shared by the MRF stage kernels: shared-memory addresses,
// cp.async copies, bf16 rounding, packing and leaky ReLU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// leaky ReLU on two packed bf16 values. `slope` is bf16(0.1), so the f32
// product is exact and one rounding to bf16 matches bf16 arithmetic.
__device__ __forceinline__ uint32_t leaky2(uint32_t u, float slope) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  float2 f = __bfloat1622float2(h);
  if (f.x < 0.f) f.x *= slope;
  if (f.y < 0.f) f.y *= slope;
  __nv_bfloat162 o = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&o);
}

// eight bf16 values (one 16-byte vector) to f32 and back (round to nearest)
__device__ __forceinline__ void unpack_bf16x8(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace
