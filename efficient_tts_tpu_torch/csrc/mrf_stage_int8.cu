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
// bit for bit.
//
// Bound on the H100: 2*B*T*C^2*126 int8 operations per stage against one
// read of x and one write of the result in bf16, 63*C operations per byte,
// above the 590 int8 operations per byte where the tensor cores, not the
// memory, are the limit, so every stage is bound by operations at 1979
// TOP/s. Design: the bf16 kernel's (csrc/mrf_stage.cu), one implicit GEMM
// per conv with mma.sync m16n8k32 s8 -> s32, the input tile quantized to
// int8 as it goes into shared memory (half the bytes of the bf16 tile).
// The dynamic scale of the next conv's input is reduced in this launch's
// epilogue: an atomicMax per warp on the float bits of |leaky(out)| per
// batch element (non-negative floats order as their bits do), into a
// buffer the wrapper fills with 1e-12, which gives max(absmax, 1e-12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 64;          // output positions per block
constexpr int KC = 32;          // input channels per weight chunk (one k32 mma step)
constexpr int LDB = KC + 16;    // padded shared row of a weight chunk (bytes)
constexpr int THREADS = 128;    // 4 warps, 2 (rows) x 2 (columns)

constexpr int kResidual = 1;    // v = res + v
constexpr int kAddSum = 2;      // v = out + v (running branch sum, in place)
constexpr int kAverage = 4;     // v = v / n_avg

__device__ __forceinline__ float leaky_bf16(float v, float slope) {
  return v < 0.f ? round_bf16(v * slope) : v;
}

__device__ __forceinline__ uint32_t quantize2(uint32_t u, float inv) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  const int a = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.x, inv)), -127.f), 127.f));
  const int b = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(f.y, inv)), -127.f), 127.f));
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// x [B, T, C] bf16, w [k, C_out, C_in] int8, wscale/bias [C] f32, res/out
// [B, T, C] bf16 (the aliasing rules of the bf16 kernel). s_in[b * s_stride]
// is batch element b's activation scale; amax_out, when not null, receives
// max |leaky(out)| per batch element.
template <int BN>
__global__ void __launch_bounds__(THREADS)
    mrf_conv_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ wscale, const float* __restrict__ bias,
                         const __nv_bfloat16* res, __nv_bfloat16* out, const float* s_in,
                         int s_stride, float* amax_out, int T, int C, int k, int dil, int flags,
                         int n_avg, float slope) {
  constexpr int WN = BN / 2;  // columns per warp
  constexpr int NT = WN / 8;  // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem8[];

  const int span = (k - 1) * dil;
  const int pad = span / 2;
  const int rows = BM + span;
  const int lda = C + 16;  // padded shared row (bytes): conflict-free ldmatrix
  int8_t* As = reinterpret_cast<int8_t*>(smem8);
  int8_t* Bs = As + rows * lda;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t base = static_cast<size_t>(blockIdx.z) * T * C;
  const float s = s_in[blockIdx.z * s_stride];
  const float inv = __fdiv_rn(127.f, s);

  const int chunks_per_tap = C / KC;
  const int n_chunks = k * chunks_per_tap;
  auto load_w = [&](int c, int stage) {
    const int tap = c / chunks_per_tap, ci0 = (c - tap * chunks_per_tap) * KC;
    const int8_t* src = w + (static_cast<size_t>(tap) * C + n0) * C + ci0;
    int8_t* dst = Bs + stage * BN * LDB;
    for (int i = tid; i < BN * (KC / 16); i += THREADS) {
      const int n = i / (KC / 16), q = i % (KC / 16);
      cp_async16(dst + n * LDB + q * 16, src + static_cast<size_t>(n) * C + q * 16);
    }
    cp_async_commit();
  };
  load_w(0, 0);

  // input rows t0 - pad .. t0 + BM + span - pad: leaky, quantized; zeros outside [0, T)
  const int vecs = C / 8;
  for (int i = tid; i < rows * vecs; i += THREADS) {
    const int r = i / vecs, v = i - r * vecs;
    const int t = t0 - pad + r;
    uint2 q = make_uint2(0u, 0u);
    if (t >= 0 && t < T) {
      const uint4 val = *reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(t) * C + v * 8);
      q.x = quantize2(leaky2(val.x, slope), inv) | (quantize2(leaky2(val.y, slope), inv) << 16);
      q.y = quantize2(leaky2(val.z, slope), inv) | (quantize2(leaky2(val.w, slope), inv) << 16);
    }
    *reinterpret_cast<uint2*>(As + r * lda + v * 8) = q;
  }

  int acc[2][NT][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_w(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = c / chunks_per_tap, ci0 = (c - tap * chunks_per_tap) * KC;
    const int8_t* Bst = Bs + (c & 1) * BN * LDB;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + (lane & 15) + tap * dil;
      ldmatrix_x4(a[mt], As + row * lda + ci0 + (lane >> 4) * 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bq[4];
      const int n = wn * WN + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(bq, Bst + n * LDB + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][nt], a[mt], bq[0], bq[1]);
        mma_s8(acc[mt][nt + 1], a[mt], bq[2], bq[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: dequantize + bias, bf16 rounding, then residual / branch sum / average
  const float fs = __fdiv_rn(s, 127.f);
  float m = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WN + nt * 8 + (lane & 3) * 2;
      const float f0 = __fmul_rn(fs, wscale[col]), f1 = __fmul_rn(fs, wscale[col + 1]);
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * 32 + mt * 16 + (lane >> 2) + h * 8;
        if (t >= T) continue;
        const size_t o = base + static_cast<size_t>(t) * C + col;
        float v0 = round_bf16(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), f0), b0));
        float v1 = round_bf16(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), f1), b1));
        if (flags & kResidual) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + o));
          v0 = round_bf16(__fadd_rn(r.x, v0));
          v1 = round_bf16(__fadd_rn(r.y, v1));
        }
        if (flags & kAddSum) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + o));
          v0 = round_bf16(__fadd_rn(r.x, v0));
          v1 = round_bf16(__fadd_rn(r.y, v1));
        }
        if (flags & kAverage) {
          v0 = __fdiv_rn(v0, static_cast<float>(n_avg));
          v1 = __fdiv_rn(v1, static_cast<float>(n_avg));
        }
        const __nv_bfloat162 ov = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(out + o) = ov;
        const float2 of = __bfloat1622float2(ov);
        m = fmaxf(m, fmaxf(fabsf(leaky_bf16(of.x, slope)), fabsf(leaky_bf16(of.y, slope))));
      }
    }
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

size_t smem_bytes(int C, int k, int dil, int bn) {
  return static_cast<size_t>(BM + (k - 1) * dil) * (C + 16) + 2 * bn * LDB;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* wscale, const void* bias,
                   const void* res, void* out, const void* s_in, int s_stride, void* amax_out,
                   int B, int T, int C, int k, int dil, int flags, int n_avg, float slope,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k, dil, BN);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mrf_conv_int8_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + BM - 1) / BM, C / BN, B);
  mrf_conv_int8_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(s_in), s_stride, static_cast<float*>(amax_out), T, C, k, dil,
      flags, n_avg, slope);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int mrf_conv_int8(const void* x, const void* w, const void* wscale, const void* bias,
                             const void* res, void* out, const void* s_in, int s_stride,
                             void* amax_out, int B, int T, int C, int k, int dil, int flags,
                             int n_avg, float slope, void* stream) {
  if (B < 1 || T < 1 || C < KC || C % KC != 0 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 ||
      n_avg < 1 || s_in == nullptr || s_stride < 0 || ((flags & kResidual) && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0)
    return static_cast<int>(launch<128>(x, w, wscale, bias, res, out, s_in, s_stride, amax_out, B,
                                        T, C, k, dil, flags, n_avg, slope, s));
  if (C % 64 == 0)
    return static_cast<int>(launch<64>(x, w, wscale, bias, res, out, s_in, s_stride, amax_out, B,
                                       T, C, k, dil, flags, n_avg, slope, s));
  return static_cast<int>(launch<32>(x, w, wscale, bias, res, out, s_in, s_stride, amax_out, B, T,
                                     C, k, dil, flags, n_avg, slope, s));
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
