// One convolution of a W8A8 HiFi-GAN MRF stage, for Hopper (sm_90a). A
// stage is 18 launches of `mrf_conv_int8` (3 ResBlock1 branches, 6 convs
// each) plus, with dynamic activation scales, one `mrf_absmax` launch at its
// entry; the Python wrapper `efficient_tts_tpu_torch/ops/mrf_int8.py:
// mrf_stage_int8` orders them.
//
// Replaces the TPU kernel efficient_tts_tpu/ops/pallas/mrf_packed.py:
// mrf_stage_packed with int8=True (_mrf_packed_kernel) on plain [B, T, C]
// bf16 activations (the packed [B, T/r, r*C] layout is a contiguous reshape
// of it). Per conv: leaky 0.1 in bf16, q = clip(rint(x * (127 / s)), -127,
// 127) in int8, an int32 sum over taps and input channels of q times the
// int8 weights, y = acc * ((s / 127) * scale[co]) + bias[co] rounded to
// bf16, then the residual add, branch sum and average in bf16 as the bf16
// kernel does. s is the absmax of the conv's input after leaky, per batch
// element over all of [0, T) (the TPU kernel's per-tile scale when the
// sequence fits one tile), or a static per-conv scale. Every f32 operation
// of the epilogue is an explicit round-to-nearest intrinsic, so no FMA
// contraction separates the kernel from its plain version: the two agree
// bit for bit (integer sums are exact in any order).
//
// Bound on the H100: 2*B*T*C^2*126 int8 operations per stage against one
// read of x and one write of the result in bf16, 63*C operations per byte,
// above the 590 int8 operations per byte where the tensor cores, not the
// memory, are the limit, so every stage is bound by operations at 1979
// TOP/s. The 18 launches do not reach that bound: each conv's dynamic
// scale is a max over the whole utterance of the conv before it, a
// grid-wide reduction, so the convs of a stage cannot be fused, and the 18
// launches together move about 47 passes over the activations
// (utils/roofline.py: mrf_stage_launch_bytes), 3.8 ms at [16, 262144, 32].
//
// Design: the bf16 kernel's (csrc/mrf_stage.cu), an implicit GEMM per conv
// on warpgroup MMA with 8-bit operands (wgmma ... .s32.s8.s8, k = 32 bytes),
// both read from shared memory. A block owns 128 output positions x all C
// output channels: two consumer warpgroups of 64 positions, one wgmma of
// width C per (32-channel chunk, tap), and one producer warp.
//  - Weights: the producer warp streams one [C_out, 32 bytes of C_in] box
//    per (chunk, tap) by TMA (SWIZZLE_32B: a 32-byte row is one k step, and
//    at C = 32 the whole row; one 2D tensor map per conv weight, made once
//    by `mrf_int8_weight_map`) into an 8-deep ring behind full and empty
//    mbarriers.
//  - Activations: the consumers copy each chunk's 32 bf16 channels of the
//    block's rows plus the (k-1)*dil halo by cp.async into a landing tile
//    (zeros outside [0, T)), then leaky and quantize them into an int8 tile
//    of two 16-byte planes, each plane's rows back to back. Any 8
//    consecutive rows are then an unswizzled core matrix, so a tap's shift
//    by tap*dil rows is a shift of the A descriptor's start address. The
//    next chunk's copy is in flight while the taps of this one run; each
//    step leaves its product in flight while the next one issues
//    (wgmma.wait_group 1) and frees the ring slot of the step before.
//  - Epilogue through shared memory: the int32 sums dequantized, plus bias,
//    rounded to bf16 into a tile where the ring was; then residual, running
//    branch sum and average on whole 16-byte vectors, and the absmax of the
//    next conv's input: an atomicMax per warp on the float bits of
//    |leaky(out)| per batch element (non-negative floats order as their
//    bits do), into a buffer the wrapper fills with 1e-12, which gives
//    max(absmax, 1e-12).
// Shared memory at C=256, k=11, dil=5 (178 rows): 64 KB ring + 11 KB landing
// tile + 11 KB of int8 tiles = 86 KB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;                  // output positions per block
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 8;                // weight ring depth
constexpr int KC = 32;                   // input channels per chunk: one k step, one 32-byte weight row
constexpr int SMEM_LIMIT = 232448;

constexpr int kResidual = 1;  // v = res + v
constexpr int kAddSum = 2;    // v = out + v (running branch sum, in place)
constexpr int kAverage = 4;   // v = v / n_avg

__device__ __forceinline__ float leaky_bf16(float v, float slope) {
  return v < 0.f ? round_bf16(v * slope) : v;
}

__device__ __forceinline__ uint32_t quantize2(uint32_t u, float inv) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  const int a = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.x, inv)), -127.f), 127.f));
  const int b = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.y, inv)), -127.f), 127.f));
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8);
}

// 16 bf16 values (two vectors) -> leaky -> 16 int8 values (one vector)
__device__ __forceinline__ uint4 quantize16(uint4 a, uint4 b, float slope, float inv) {
  return make_uint4(quantize2(leaky2(a.x, slope), inv) | (quantize2(leaky2(a.y, slope), inv) << 16),
                    quantize2(leaky2(a.z, slope), inv) | (quantize2(leaky2(a.w, slope), inv) << 16),
                    quantize2(leaky2(b.x, slope), inv) | (quantize2(leaky2(b.y, slope), inv) << 16),
                    quantize2(leaky2(b.z, slope), inv) | (quantize2(leaky2(b.w, slope), inv) << 16));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ void fence_int(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// D[64 x N] += A[64 x 32] B[N x 32]^T for one warpgroup, int8 operands K-major
// in shared memory, int32 sums (exact); d in the layout of `wgmma_ss`.
// Instantiated for N = 32, 64, ..., 256.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<224>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111},"
      " %112, %113, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The layout of the dynamic shared memory past its 1024-byte-aligned start:
// the weight ring, the bf16 landing tile of a chunk (rows x 64 bytes), two
// int8 chunk tiles (rows x 32 bytes), all overlaid by the epilogue's [BM, C]
// bf16 tile at the end; then the mbarriers.
__host__ __device__ __forceinline__ int body_bytes(int C, int rows) {
  const int stream = STAGES * C * KC + rows * 2 * KC + 2 * rows * KC;
  const int epi = BM * (2 * C + 16);
  return stream > epi ? stream : epi;
}

size_t smem_bytes(int C, int k, int dil) {
  return 1024 + body_bytes(C, BM + (k - 1) * dil) + 2 * STAGES * sizeof(uint64_t);
}

// x [B, T, C] bf16, the weight through `wmap`, wscale/bias [C] f32, res/out
// [B, T, C] bf16. `res` and `out` may alias each other (element-wise in
// place); `x` must not alias `out` (its halo rows belong to other blocks).
// s_in[b * s_stride] is batch element b's activation scale; amax_out, when
// not null, receives max |leaky(out)| per batch element.
template <int C>
__global__ void __launch_bounds__(THREADS, C <= 128 ? 2 : 1)
    mrf_conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ wscale, const float* __restrict__ bias,
                               const __nv_bfloat16* res, __nv_bfloat16* out, const float* s_in, int s_stride,
                               float* amax_out, int T, int k, int dil, int flags, int n_avg, float slope) {
  constexpr int N_CHUNKS = C / KC;
  constexpr int W_BYTES = C * KC;  // one weight box: C_out rows of 32 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int span = (k - 1) * dil;
  const int pad = span / 2;
  const int rows = BM + span;
  const int plane = rows * 16;    // one 16-byte plane of an int8 chunk tile
  const int a_bytes = 2 * plane;  // one int8 chunk tile
  unsigned char* landing = ring + STAGES * W_BYTES;
  unsigned char* abuf = landing + rows * 2 * KC;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + body_bytes(C, rows));
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BM;
  const size_t base = static_cast<size_t>(blockIdx.z) * T * C;
  const int n_steps = N_CHUNKS * k;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one weight box per (chunk, tap)
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        const int c = i / k, tap = i - c * k;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], W_BYTES);
        tma_load_2d(ring + s * W_BYTES, &wmap, &full[s], c * KC, tap * C);
      }
    }
    return;
  }

  // consumers
  const float s = s_in[blockIdx.z * s_stride];
  const float inv = __fdiv_rn(127.f, s);
  // a thread copies, and later quantizes, the 16 channels of one plane row
  auto issue_chunk = [&](int c) {
    for (int i = tid; i < rows * 2; i += CONSUMERS) {
      const int r = i >> 1, pl = i & 1;
      const int t = t0 - pad + r;
      unsigned char* d = landing + r * 64 + pl * 32;
      if (t >= 0 && t < T) {
        const __nv_bfloat16* src = x + base + static_cast<size_t>(t) * C + c * KC + pl * 16;
        cp_async16(d, src);
        cp_async16(d + 16, src + 8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(d + 16) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  // leaky and quantize this thread's own rows of the landing tile into int8
  // tile b; then the tile is complete for every consumer and visible to wgmma
  auto finish_chunk = [&](int b) {
    cp_async_wait<0>();
    unsigned char* dst = abuf + b * a_bytes;
    for (int i = tid; i < rows * 2; i += CONSUMERS) {
      const int r = i >> 1, pl = i & 1;
      const unsigned char* src = landing + r * 64 + pl * 32;
      *reinterpret_cast<uint4*>(dst + pl * plane + r * 16) = quantize16(
          *reinterpret_cast<const uint4*>(src), *reinterpret_cast<const uint4*>(src + 16), slope, inv);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  };

  int acc[C / 2];
#pragma unroll
  for (int j = 0; j < C / 2; ++j) acc[j] = 0;

  // this warpgroup's 64 rows: A descriptors step 16 bytes a row; the k step's
  // two core matrices are a plane apart along K, 128 bytes along M
  const int wg = warp >> 2;

  issue_chunk(0);
  finish_chunk(0);
  int it = 0;
  for (int c = 0; c < N_CHUNKS; ++c) {
    const int b = c & 1;
    if (c + 1 < N_CHUNKS) issue_chunk(c + 1);
    const uint32_t tile = smem_u32(abuf + b * a_bytes) + wg * 64 * 16;
    for (int tap = 0; tap < k; ++tap, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
      wgmma_s8<C>(acc, desc_plain(tile + tap * dil * 16, plane, 128), desc_sw32(smem_u32(ring + st * W_BYTES)));
      wgmma_commit();
      // the step before is done: its ring slot is free
      wgmma_wait<1>();
      if (tap > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    // the chunk's last product is done before its int8 tile is reused
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    if (c + 1 < N_CHUNKS) finish_chunk(b ^ 1);
  }
#pragma unroll
  for (int j = 0; j < C / 2; ++j) fence_int(acc[j]);

  // epilogue, through shared memory so that global reads and writes are
  // whole 16-byte vectors of consecutive channels: once every consumer's
  // products are done (the barrier), the ring and the tiles are free.
  // Pass 1: acc * ((s / 127) * scale) + bias, rounded to bf16, into a
  // padded [BM, C] tile. Pass 2: residual, running branch sum and average
  // per vector, bf16 rounding after each, and the absmax of the result.
  constexpr int ROW = 2 * C + 16;  // padded tile row (bytes)
  constexpr int VPR = C / 8;       // vectors per row
  unsigned char* tile_out = ring;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const float fs = __fdiv_rn(s, 127.f);
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int J = 0; J < C / 8; ++J) {
    const int col = J * 8 + (lane & 3) * 2;
    const float f0 = __fmul_rn(fs, wscale[col]), f1 = __fmul_rn(fs, wscale[col + 1]);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * J + 2 * h]), f0), b0);
      const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * J + 2 * h + 1]), f1), b1);
      *reinterpret_cast<__nv_bfloat162*>(tile_out + (r0 + h * 8) * ROW + col * 2) = __floats2bfloat162_rn(v0, v1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float m = 0.f;
  for (int i = tid; i < BM * VPR; i += CONSUMERS) {
    const int r = i / VPR, q = i - r * VPR;
    const int t = t0 + r;
    if (t >= T) continue;
    const size_t o = base + static_cast<size_t>(t) * C + q * 8;
    float v[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(tile_out + r * ROW + q * 16), v);
    if (flags & kResidual) {
      float a[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(res + o), a);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = round_bf16(__fadd_rn(a[j], v[j]));
    }
    if (flags & kAddSum) {
      float a[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(out + o), a);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = round_bf16(__fadd_rn(a[j], v[j]));
    }
    if (flags & kAverage) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fdiv_rn(v[j], static_cast<float>(n_avg));
    }
    const uint4 ov = pack_bf16x8(v);
    *reinterpret_cast<uint4*>(out + o) = ov;
    float of[8];
    unpack_bf16x8(ov, of);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(leaky_bf16(of[j], slope)));
  }
  if (amax_out != nullptr) {
    m = warp_max(m);
    if (lane == 0) atomicMax(reinterpret_cast<int*>(amax_out) + blockIdx.z, __float_as_int(m));
  }
}

// max |leaky(x)| over each batch element's [T, C] into amax[b] (atomicMax on
// the float bits; amax holds a non-negative floor on entry)
__global__ void __launch_bounds__(256)
    absmax_leaky_kernel(const __nv_bfloat16* __restrict__ x, float* amax, long long n_vec,
                        float slope) {
  const uint4* xb = reinterpret_cast<const uint4*>(x) + blockIdx.y * n_vec;
  float m = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 v = xb[i];
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t l = leaky2(u[j], slope);
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&l));
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(reinterpret_cast<int*>(amax) + blockIdx.y, __float_as_int(m));
}

template <int C>
cudaError_t launch(const CUtensorMap& map, const void* x, const void* wscale, const void* bias, const void* res,
                   void* out, const void* s_in, int s_stride, void* amax_out, int B, int T, int k, int dil,
                   int flags, int n_avg, float slope, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k, dil);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // the limit is set per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(mrf_conv_int8_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BM - 1) / BM, 1, B);
  mrf_conv_int8_wgmma_kernel<C><<<grid, THREADS, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), static_cast<const float*>(s_in),
      s_stride, static_cast<float*>(amax_out), T, k, dil, flags, n_avg, slope);
  return cudaGetLastError();
}

}  // namespace

// The TMA descriptor (128 bytes, written to `map_out`) of one conv's int8
// weight [k, C_out, C_in] (`quantize_weights`' layout), seen as a 2D [k *
// C_out, C_in] tensor cut into boxes of 32 bytes x C_out rows with
// SWIZZLE_32B. Build it once per weight tensor; it holds the weight's
// address. Returns 0, or a cudaError_t / CUresult code.
extern "C" int mrf_int8_weight_map(void* map_out, const void* w, int k, int C) {
  if (map_out == nullptr || w == nullptr || C < KC || C % KC != 0 || C > 256 || k < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(k) * C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KC), static_cast<cuuint32_t>(C)};
  const cuuint32_t estrides[2] = {1, 1};
  alignas(64) CUtensorMap m;
  const CUresult r = fn(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, estrides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  memcpy(map_out, &m, sizeof(m));
  return 0;
}

// Returns a cudaError_t (0 on success). `map` is the weight's descriptor from
// `mrf_int8_weight_map`; launches on `stream`, does not synchronise and
// allocates nothing.
extern "C" int mrf_conv_int8(const void* map, const void* x, const void* wscale, const void* bias,
                             const void* res, void* out, const void* s_in, int s_stride,
                             void* amax_out, int B, int T, int C, int k, int dil, int flags,
                             int n_avg, float slope, void* stream) {
  if (map == nullptr || B < 1 || T < 1 || C < KC || C % KC != 0 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 ||
      n_avg < 1 || s_in == nullptr || s_stride < 0 || ((flags & kResidual) && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (C) {
#define MRF_CASE(c)                                                                                                 \
  case c:                                                                                                           \
    e = launch<c>(m, x, wscale, bias, res, out, s_in, s_stride, amax_out, B, T, k, dil, flags, n_avg, slope, s); \
    break;
    MRF_CASE(32)
    MRF_CASE(64)
    MRF_CASE(96)
    MRF_CASE(128)
    MRF_CASE(160)
    MRF_CASE(192)
    MRF_CASE(224)
    MRF_CASE(256)
#undef MRF_CASE
  }
  return static_cast<int>(e);
}

// amax[b] = max(amax[b], max |leaky(x[b])|) for x [B, T, C] bf16.
extern "C" int mrf_absmax(const void* x, void* amax, int B, int T, int C, float slope,
                          void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 8 || C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = static_cast<long long>(T) * C / 8;
  const long long blocks = (n_vec + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), B);
  absmax_leaky_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(amax), n_vec, slope);
  return static_cast<int>(cudaGetLastError());
}
