// One convolution of a HiFi-GAN MRF stage, with its prologue and epilogue
// fused, for Hopper (sm_90a). A stage (3 ResBlock1 branches, 18 convs, the
// branch average) is 18 launches of `mrf_conv`; the Python wrapper
// `efficient_tts_tpu_torch/ops/mrf.py:mrf_stage` orders them.
//
// Replaces the TPU kernel efficient_tts_tpu/ops/pallas/mrf_packed.py:
// mrf_stage_packed (_mrf_packed_kernel, bf16 mode) and the bf16 mode of
// efficient_tts_tpu/ops/pallas/mrf.py:mrf_stage. Same function on plain
// [B, T, C] bf16 activations, any C that is a multiple of 32 up to 256 and
// any T: leaky 0.1 -> dilated conv + bias, zero padding at the ends of the
// tensor [0, T), bf16 rounding after each conv's bias, after each residual
// add, after each partial branch sum and after the final / n_kernels.
//
// Bound on the H100: a V1 stage does 2*B*T*C^2*126 operations on one read
// of x and one write of the result, 63*C operations per byte (2016 at
// C=32), far above the card's 295 bf16 operations per byte, so every stage
// is bound by tensor-core operations. The design is the simple one: an
// implicit GEMM per conv, 64 output positions x BN output channels per
// block, bf16 mma.sync with f32 accumulation. The block loads its input
// rows plus the (k-1)*d halo once into shared memory, applying leaky 0.1
// and the zero padding on the way in, then streams the weights tap by tap
// in 32-channel chunks (cp.async, double-buffered) and reads every tap as
// a row-shifted view of the same input tile. One launch per conv moves
// about 45 activation passes per stage instead of 2, so at small C a
// single conv is near the byte bound; fusing the 18 convs of a stage,
// wgmma and TMA are left for later work.
//
// `mrf_conv_f32` is the same launch in f32, the f32 mode of
// efficient_tts_tpu/ops/pallas/mrf.py:mrf_stage (the synthesis path's
// default, compute_dtype=None): leaky 0.1, the dilated conv plus bias, zero
// padding at the ends of [0, T), the residual adds and the average, all in
// f32 with no rounding to a narrower type. Its products are f32 FMAs on the
// CUDA cores (not TF32): the reference is full f32. Bound on the H100: the
// same 63*C operations per byte at FP32's 67 TFLOP/s, so operations bound
// every stage. Design: a register-tiled SIMT implicit GEMM. A block of 256
// threads owns BM positions x BN output channels, each thread 8 x 8 of them;
// input channels stream in chunks of 8, with the chunk's input rows (plus
// the halo, leaky applied) and all k taps of its weights in shared memory:
// 52 KB at C=256, k=11, d=5 (two blocks per SM), where a whole f32 input
// tile of 64 rows would take 114 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int BM = 64;          // output positions per block
constexpr int KC = 32;          // input channels per weight chunk
constexpr int LDB = KC + 8;     // padded shared row of a weight chunk (elements)
constexpr int THREADS = 128;    // 4 warps, 2 (rows) x 2 (columns)

// epilogue flags
constexpr int kResidual = 1;    // v = res + v
constexpr int kAddSum = 2;      // v = out + v (running branch sum, in place)
constexpr int kAverage = 4;     // v = v / n_avg

// x [B, T, C] bf16, w [k, C_out, C_in] bf16, bias [C] f32, res/out [B, T, C]
// bf16. `res` and `out` may alias each other (element-wise in place); `x`
// must not alias `out` (its halo rows belong to other blocks).
template <int BN>
__global__ void __launch_bounds__(THREADS)
    mrf_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, const __nv_bfloat16* res,
                    __nv_bfloat16* out, int T, int C, int k, int dil, int flags, int n_avg,
                    float slope) {
  constexpr int WN = BN / 2;  // columns per warp
  constexpr int NT = WN / 8;  // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int span = (k - 1) * dil;
  const int pad = span / 2;
  const int rows = BM + span;
  const int lda = C + 8;  // padded shared row (elements): conflict-free ldmatrix
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + rows * lda;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t base = static_cast<size_t>(blockIdx.z) * T * C;

  const int chunks_per_tap = C / KC;
  const int n_chunks = k * chunks_per_tap;
  auto load_w = [&](int s, int stage) {
    const int tap = s / chunks_per_tap, ci0 = (s - tap * chunks_per_tap) * KC;
    const __nv_bfloat16* src = w + (static_cast<size_t>(tap) * C + n0) * C + ci0;
    __nv_bfloat16* dst = Bs + stage * BN * LDB;
    for (int i = tid; i < BN * (KC / 8); i += THREADS) {
      const int n = i / (KC / 8), q = i % (KC / 8);
      cp_async16(dst + n * LDB + q * 8, src + static_cast<size_t>(n) * C + q * 8);
    }
    cp_async_commit();
  };
  load_w(0, 0);

  // input rows t0 - pad .. t0 + BM + span - pad, leaky applied, zeros outside [0, T)
  const int vecs = C / 8;
  for (int i = tid; i < rows * vecs; i += THREADS) {
    const int r = i / vecs, v = i - r * vecs;
    const int t = t0 - pad + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T) {
      val = *reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(t) * C + v * 8);
      val.x = leaky2(val.x, slope);
      val.y = leaky2(val.y, slope);
      val.z = leaky2(val.z, slope);
      val.w = leaky2(val.w, slope);
    }
    *reinterpret_cast<uint4*>(As + r * lda + v * 8) = val;
  }

  float acc[2][NT][4] = {};
  for (int s = 0; s < n_chunks; ++s) {
    if (s + 1 < n_chunks) {
      load_w(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = s / chunks_per_tap, ci0 = (s - tap * chunks_per_tap) * KC;
    const __nv_bfloat16* Bst = Bs + (s & 1) * BN * LDB;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + (lane & 15) + tap * dil;
        ldmatrix_x4(a[mt], As + row * lda + ci0 + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bq[4];
        const int n = wn * WN + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bq, Bst + n * LDB + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, bf16 rounding, then residual / branch sum / average
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WN + nt * 8 + (lane & 3) * 2;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * 32 + mt * 16 + (lane >> 2) + h * 8;
        if (t >= T) continue;
        const size_t o = base + static_cast<size_t>(t) * C + col;
        float v0 = round_bf16(acc[mt][nt][2 * h] + b0);
        float v1 = round_bf16(acc[mt][nt][2 * h + 1] + b1);
        if (flags & kResidual) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + o));
          v0 = round_bf16(r.x + v0);
          v1 = round_bf16(r.y + v1);
        }
        if (flags & kAddSum) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + o));
          v0 = round_bf16(r.x + v0);
          v1 = round_bf16(r.y + v1);
        }
        if (flags & kAverage) {
          v0 = v0 / static_cast<float>(n_avg);
          v1 = v1 / static_cast<float>(n_avg);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

size_t smem_bytes(int C, int k, int dil, int bn) {
  return (static_cast<size_t>(BM + (k - 1) * dil) * (C + 8) + 2 * bn * LDB) * 2;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* res, void* out,
                   int B, int T, int C, int k, int dil, int flags, int n_avg, float slope,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k, dil, BN);
  // the limit is set per device, so it is set on every launch that needs it
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mrf_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + BM - 1) / BM, C / BN, B);
  mrf_conv_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), T, C, k, dil, flags, n_avg, slope);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int mrf_conv(const void* x, const void* w, const void* bias, const void* res,
                        void* out, int B, int T, int C, int k, int dil, int flags, int n_avg,
                        float slope, void* stream) {
  if (B < 1 || T < 1 || C < KC || C % KC != 0 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 ||
      n_avg < 1 || ((flags & kResidual) && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0)
    return static_cast<int>(launch<128>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
  if (C % 64 == 0)
    return static_cast<int>(launch<64>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
  return static_cast<int>(launch<32>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
}

// ---------------------------------------------------------------------------
// f32

namespace {

constexpr int F_THREADS = 256;
constexpr int F_KC = 8;           // input channels per chunk
constexpr int F_XP = F_KC + 1;    // padded shared row of the input chunk: conflict-free reads
constexpr int F_TM = 8;           // positions per thread
constexpr int F_TN = 8;           // output channels per thread (two float4)

template <int BN>
struct F32Tile {
  static constexpr int NL = BN / F_TN;        // thread columns
  static constexpr int ML = F_THREADS / NL;   // thread rows
  static constexpr int BM = ML * F_TM;        // positions per block: 128 / 256 / 512
};

__device__ __forceinline__ float leaky_f32(float v, float slope) { return v < 0.f ? v * slope : v; }

// x [B, T, C] f32, w [k, C_out, C_in] f32, bias [C] f32, res/out [B, T, C]
// f32; the same aliasing rules as the bf16 kernel. Thread (ml, nl) owns
// positions t0 + ml + ML*i (i < 8) and channels n0 + 4*nl + j and
// n0 + BN/2 + 4*nl + j (j < 4).
template <int BN>
__global__ void __launch_bounds__(F_THREADS, 2)
    mrf_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, const float* res, float* out, int T, int C,
                        int k, int dil, int flags, int n_avg, float slope) {
  using Tile = F32Tile<BN>;
  constexpr int ML = Tile::ML, BM = Tile::BM;
  extern __shared__ __align__(16) float fsmem[];

  const int span = (k - 1) * dil;
  const int pad = span / 2;
  const int rows = BM + span;
  float* Xs = fsmem;                                  // [rows][F_XP]
  float* Ws = fsmem + ((rows * F_XP + 3) & ~3);       // [k][F_KC][BN]

  const int tid = threadIdx.x;
  const int ml = tid % ML, nl = tid / ML;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t base = static_cast<size_t>(blockIdx.z) * T * C;

  float acc[F_TM][F_TN] = {};
  for (int c0 = 0; c0 < C; c0 += F_KC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < rows * (F_KC / 4); i += F_THREADS) {
      const int r = i % rows, q = i / rows;
      const int t = t0 - pad + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) {
        v = *reinterpret_cast<const float4*>(x + base + static_cast<size_t>(t) * C + c0 + q * 4);
        v.x = leaky_f32(v.x, slope);
        v.y = leaky_f32(v.y, slope);
        v.z = leaky_f32(v.z, slope);
        v.w = leaky_f32(v.w, slope);
      }
      float* d = Xs + r * F_XP + q * 4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    for (int i = tid; i < k * (F_KC / 4) * BN; i += F_THREADS) {
      const int n = i % BN, q = (i / BN) % (F_KC / 4), tap = i / (BN * (F_KC / 4));
      const float4 v = *reinterpret_cast<const float4*>(
          w + (static_cast<size_t>(tap) * C + n0 + n) * C + c0 + q * 4);
      float* d = Ws + (tap * F_KC + q * 4) * BN + n;
      d[0] = v.x;
      d[BN] = v.y;
      d[2 * BN] = v.z;
      d[3 * BN] = v.w;
    }
    __syncthreads();
    for (int tap = 0; tap < k; ++tap) {
      const float* xa = Xs + (tap * dil + ml) * F_XP;
      const float* wb = Ws + tap * F_KC * BN + nl * 4;
#pragma unroll
      for (int ci = 0; ci < F_KC; ++ci) {
        float a[F_TM];
#pragma unroll
        for (int i = 0; i < F_TM; ++i) a[i] = xa[i * ML * F_XP + ci];
        const float4 b0 = *reinterpret_cast<const float4*>(wb + ci * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(wb + ci * BN + BN / 2);
        const float bv[F_TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < F_TM; ++i)
#pragma unroll
          for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

  // epilogue: bias, then residual / branch sum / average, all in f32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + nl * 4 + h * (BN / 2);
    const float4 bb = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
    for (int i = 0; i < F_TM; ++i) {
      const int t = t0 + ml + i * ML;
      if (t >= T) continue;
      const size_t o = base + static_cast<size_t>(t) * C + col;
      float v[4] = {__fadd_rn(acc[i][4 * h], bb.x), __fadd_rn(acc[i][4 * h + 1], bb.y),
                    __fadd_rn(acc[i][4 * h + 2], bb.z), __fadd_rn(acc[i][4 * h + 3], bb.w)};
      if (flags & kResidual) {
        const float4 r = *reinterpret_cast<const float4*>(res + o);
        v[0] = __fadd_rn(r.x, v[0]);
        v[1] = __fadd_rn(r.y, v[1]);
        v[2] = __fadd_rn(r.z, v[2]);
        v[3] = __fadd_rn(r.w, v[3]);
      }
      if (flags & kAddSum) {
        const float4 r = *reinterpret_cast<const float4*>(out + o);
        v[0] = __fadd_rn(r.x, v[0]);
        v[1] = __fadd_rn(r.y, v[1]);
        v[2] = __fadd_rn(r.z, v[2]);
        v[3] = __fadd_rn(r.w, v[3]);
      }
      if (flags & kAverage) {
        const float n = static_cast<float>(n_avg);
        for (int j = 0; j < 4; ++j) v[j] = __fdiv_rn(v[j], n);
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

size_t smem_bytes_f32(int k, int dil, int bm, int bn) {
  const size_t xs = (static_cast<size_t>(bm + (k - 1) * dil) * F_XP + 3) & ~static_cast<size_t>(3);
  return (xs + static_cast<size_t>(k) * F_KC * bn) * sizeof(float);
}

template <int BN>
cudaError_t launch_f32(const void* x, const void* w, const void* bias, const void* res, void* out,
                       int B, int T, int C, int k, int dil, int flags, int n_avg, float slope,
                       cudaStream_t stream) {
  constexpr int BM = F32Tile<BN>::BM;
  const size_t smem = smem_bytes_f32(k, dil, BM, BN);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mrf_conv_f32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + BM - 1) / BM, C / BN, B);
  mrf_conv_f32_kernel<BN><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), T, C, k, dil, flags, n_avg, slope);
  return cudaGetLastError();
}

}  // namespace

// The f32 counterpart of `mrf_conv`, with the same arguments and flags.
extern "C" int mrf_conv_f32(const void* x, const void* w, const void* bias, const void* res,
                            void* out, int B, int T, int C, int k, int dil, int flags, int n_avg,
                            float slope, void* stream) {
  if (B < 1 || T < 1 || C < KC || C % KC != 0 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 ||
      n_avg < 1 || ((flags & kResidual) && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0)
    return static_cast<int>(launch_f32<128>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
  if (C % 64 == 0)
    return static_cast<int>(launch_f32<64>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
  return static_cast<int>(launch_f32<32>(x, w, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, s));
}
