// Matmul rate probe for Hopper (sm_90a): out = x @ w applied `repeat`
// times per row tile, x [M, 128], w [128, 128] ([K, N]: row k holds the
// weights of input k), in bf16 (f32 accumulation, rounded to bf16 between
// repeats and at the end) or int8 (int32 accumulation, its low 8 bits kept
// between repeats and at the end, as a cast to int8 wraps: 300 -> 44).
//
// Replaces the TPU kernel scripts/probe_int8_pallas.py:make (its
// pallas_call and `kernel` body), which measured the int8/bf16 rate ratio
// of the matrix unit. Bound on the H100: 2*M*128*128*repeat operations on
// one read of x and w and one write of out, 128*repeat/elem_bytes
// operations per byte (512 in bf16, 1024 in int8 at repeat 8), so both
// modes are bound by tensor-core operations (bf16 at 989 TFLOP/s, int8 at
// 1979 TOP/s). Design: w goes once per block into shared memory in the
// mma B layout (one row per output column); each warp owns 16 rows at a
// time and keeps them in registers through all repeats: the m16n8
// accumulator of one product is the A fragment of the next (bf16: the
// m16n8k16 A layout is two accumulator tiles side by side; int8: the
// m16n8k32 A layout wants 4 consecutive columns per thread where the
// accumulator holds 2, so the k order inside each 32-column chunk is
// permuted, in A and in the shared copy of w alike). x is read straight
// into the accumulator layout, so the first product takes the same path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int K = 128;            // = N
constexpr int THREADS = 256;      // 8 warps
constexpr int ROWS = 1024;        // rows per block, 16 at a time per warp

// bytes of a shared row of w (one output column): padded to an odd
// multiple of 16 bytes, so ldmatrix is conflict-free
template <typename T>
constexpr int kLdw = K * static_cast<int>(sizeof(T)) + 16;

// logical k (inside a 32-column chunk) of physical column p for the int8
// A fragment built from accumulators: logical 4*tig + b holds physical
// 2*tig + b (b < 2) or 8 + 2*tig + b - 2 (b >= 2), per 16-column half
__device__ __forceinline__ int int8_logical_k(int k) {
  const int chunk = k & ~31, p = k & 31, h = p >> 4, q = p & 15;
  const int tig = (q < 8 ? q : q - 8) >> 1, b = (q & 1) + (q < 8 ? 0 : 2);
  return chunk + 16 * h + 4 * tig + b;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__global__ void __launch_bounds__(THREADS)
    probe_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int M, int repeat) {
  constexpr int LDW = kLdw<__nv_bfloat16>;
  __shared__ __align__(16) unsigned char ws[K * LDW];
  for (int i = threadIdx.x; i < K * K; i += THREADS) {
    const int kk = i / K, n = i % K;  // coalesced read of w[kk][n]
    *reinterpret_cast<__nv_bfloat16*>(ws + n * LDW + kk * 2) = w[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int row_end = min(M, static_cast<int>(blockIdx.x + 1) * ROWS);
  for (int r0 = static_cast<int>(blockIdx.x) * ROWS + warp * 16; r0 < row_end; r0 += 8 * 16) {
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<size_t>(r0 + g + 8 * h) * K + nt * 8 + 2 * tig));
        acc[nt][2 * h] = f.x;
        acc[nt][2 * h + 1] = f.y;
      }
    }
    for (int rep = 0; rep < repeat; ++rep) {
      uint32_t a[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j][0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
        a[j][1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
        a[j][2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
        a[j][3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int nt = 0; nt < 16; nt += 2) {
          uint32_t bq[4];
          const int n = nt * 8 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bq, ws + n * LDW + j * 32 + ((lane >> 3) & 1) * 16);
          mma_bf16(acc[nt], a[j], bq[0], bq[1]);
          mma_bf16(acc[nt + 1], a[j], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0 + g + 8 * h) * K + nt * 8 + 2 * tig) =
            pack_bf16(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    probe_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      int8_t* __restrict__ out, int M, int repeat) {
  constexpr int LDW = kLdw<int8_t>;
  __shared__ __align__(16) unsigned char ws[K * LDW];
  for (int i = threadIdx.x; i < K * K; i += THREADS) {
    const int kk = i / K, n = i % K;
    ws[n * LDW + int8_logical_k(kk)] = static_cast<unsigned char>(w[i]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int row_end = min(M, static_cast<int>(blockIdx.x + 1) * ROWS);
  for (int r0 = static_cast<int>(blockIdx.x) * ROWS + warp * 16; r0 < row_end; r0 += 8 * 16) {
    int acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const char2 v = *reinterpret_cast<const char2*>(
            x + static_cast<size_t>(r0 + g + 8 * h) * K + nt * 8 + 2 * tig);
        acc[nt][2 * h] = v.x;
        acc[nt][2 * h + 1] = v.y;
      }
    }
    for (int rep = 0; rep < repeat; ++rep) {
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j][0] = pack_s8(acc[4 * j][0], acc[4 * j][1], acc[4 * j + 1][0], acc[4 * j + 1][1]);
        a[j][1] = pack_s8(acc[4 * j][2], acc[4 * j][3], acc[4 * j + 1][2], acc[4 * j + 1][3]);
        a[j][2] = pack_s8(acc[4 * j + 2][0], acc[4 * j + 2][1], acc[4 * j + 3][0], acc[4 * j + 3][1]);
        a[j][3] = pack_s8(acc[4 * j + 2][2], acc[4 * j + 2][3], acc[4 * j + 3][2], acc[4 * j + 3][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int nt = 0; nt < 16; nt += 2) {
          uint32_t bq[4];
          const int n = nt * 8 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bq, ws + n * LDW + j * 32 + ((lane >> 3) & 1) * 16);
          mma_s8(acc[nt], a[j], bq[0], bq[1]);
          mma_s8(acc[nt + 1], a[j], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint16_t v = static_cast<uint16_t>((static_cast<uint32_t>(acc[nt][2 * h]) & 0xffu) |
                                                 ((static_cast<uint32_t>(acc[nt][2 * h + 1]) & 0xffu) << 8));
        *reinterpret_cast<uint16_t*>(out + static_cast<size_t>(r0 + g + 8 * h) * K + nt * 8 + 2 * tig) = v;
      }
    }
  }
}

}  // namespace

// mode 0: bf16, mode 1: int8. M a multiple of 16. Returns a cudaError_t (0
// on success); launches on `stream`, does not synchronise, allocates nothing.
extern "C" int probe_matmul(const void* x, const void* w, void* out, int M, int repeat, int mode,
                            void* stream) {
  if (M < 16 || M % 16 != 0 || repeat < 1 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + ROWS - 1) / ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    probe_bf16_kernel<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                               static_cast<const __nv_bfloat16*>(w),
                                               static_cast<__nv_bfloat16*>(out), M, repeat);
  else
    probe_int8_kernel<<<grid, THREADS, 0, s>>>(static_cast<const int8_t*>(x),
                                               static_cast<const int8_t*>(w),
                                               static_cast<int8_t*>(out), M, repeat);
  return static_cast<int>(cudaGetLastError());
}
