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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output positions per block
constexpr int KC = 32;          // input channels per weight chunk
constexpr int LDB = KC + 8;     // padded shared row of a weight chunk (elements)
constexpr int THREADS = 128;    // 4 warps, 2 (rows) x 2 (columns)

// epilogue flags
constexpr int kResidual = 1;    // v = res + v
constexpr int kAddSum = 2;      // v = out + v (running branch sum, in place)
constexpr int kAverage = 4;     // v = v / n_avg

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
