// One convolution of a HiFi-GAN MRF stage, with its prologue and epilogue
// fused, for Hopper (sm_90a), in bf16 (`mrf_conv`) and in f32 (`mrf_conv_f32`,
// as 3xTF32 products). A stage (3 ResBlock1 branches, 18 convs, the branch
// average) is 18 launches; the Python wrapper
// `efficient_tts_tpu_torch/ops/mrf.py:mrf_stage` orders them.
//
// Replaces the TPU kernel efficient_tts_tpu/ops/pallas/mrf_packed.py:
// mrf_stage_packed (_mrf_packed_kernel, bf16 mode) and both modes of
// efficient_tts_tpu/ops/pallas/mrf.py:mrf_stage (_mrf_kernel). Same function
// on plain [B, T, C] activations, any C that is a multiple of 32 up to 256
// and any T: leaky 0.1 -> dilated conv + bias, zero padding at the ends of
// each utterance's [0, T). bf16 rounds after each conv's bias, after each
// residual add, after each partial branch sum and after the final
// / n_kernels; f32 rounds nowhere but in the products' TF32 split below.
//
// Bound on the H100: a V1 stage does 2*B*T*C^2*126 operations on one read of
// x and one write of the result, 63*C operations per byte (2016 at C=32),
// above the card's 295 bf16 (49 at the 3xTF32 rate) operations per byte,
// so every stage is bound by tensor-core operations.
//
// Design: an implicit GEMM per conv on warpgroup MMA (wgmma), both operands
// read from shared memory. A block owns 128 output positions x all C output
// channels: two consumer warpgroups of 64 positions each, one wgmma of width
// C per tap, k step and product, and one producer warp.
//  - Weights: the producer warp streams one [C_out, 64 bytes of C_in] box
//    per (input-channel chunk, tap) by TMA (SWIZZLE_64B, one 2D tensor map
//    over the conv's weight as [rows, C_in], built once per weight by
//    `mrf_weight_map`) into a 4-deep ring of shared memory, each stage behind
//    a full and an empty mbarrier.
//  - Activations: the consumers stream the input channels in 64-byte chunks
//    (32 bf16 or 16 f32) of the block's rows plus the (k-1)*dil halo:
//    cp.async, then leaky 0.1 (and in f32 the TF32 split) in place, zeros
//    outside [0, T). The tile is stored as four planes of 16-byte rows (one
//    per 16 bytes of channels), each plane's rows back to back. Then any 8
//    consecutive rows form an unswizzled core matrix, so a tap's shift by
//    tap*dil rows is a shift of the A descriptor's start address; a swizzled
//    tile could not move by a row. The next chunk's copy is in flight while
//    the taps of this one run; each step leaves its products in flight while
//    the next step issues (wgmma.wait_group 1) and frees the ring slot of the
//    step before.
//  - f32 as 3xTF32: each operand v is split into hi = tf32(v) and lo =
//    tf32(v - hi) (round to nearest, ties away); weights once at load time
//    (ops/mrf.py: the [2, k, C, C] layout), activations when a chunk lands.
//    Each k step issues lo*hi, hi*lo, then hi*hi into one f32 accumulator;
//    the dropped lo*lo term is below 2^-22 of the product.
//  - Epilogue through shared memory: the accumulators plus bias into a tile
//    where the ring was, then residual / running branch sum / average on
//    whole 16-byte vectors, with the rounding points as before.
// Shared memory at C=256, k=11, dil=5 (178 rows): bf16 64 KB ring + 23 KB
// input (two chunk tiles) = 88 KB; f32 128 KB ring + 46 KB (hi and lo) = 175 KB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;                     // output positions per block
constexpr int CONSUMERS = 256;              // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int STAGES = 4;                   // weight ring depth
constexpr int CHUNK_BYTES = 64;             // input channels per chunk: one SWIZZLE_64B row
constexpr int SMEM_LIMIT = 232448;

// epilogue flags
constexpr int kResidual = 1;  // v = res + v
constexpr int kAddSum = 2;    // v = out + v (running branch sum, in place)
constexpr int kAverage = 4;   // v = v / n_avg

__device__ __forceinline__ float leaky_f32(float v, float slope) { return v < 0.f ? v * slope : v; }

size_t smem_bytes(int C, bool f32, int k, int dil) {
  const size_t rows = BM + static_cast<size_t>(k - 1) * dil;
  const size_t split = f32 ? 2 : 1;
  return 1024 + STAGES * split * C * CHUNK_BYTES + 2 * split * rows * CHUNK_BYTES + 2 * STAGES * sizeof(uint64_t);
}

// x [B, T, C], w through `wmap`, bias [C] f32, res/out [B, T, C] of the
// element type. `res` and `out` may alias each other (element-wise in
// place); `x` must not alias `out` (its halo rows belong to other blocks).
template <int C, bool F32>
__device__ __forceinline__ void conv_body(const CUtensorMap& wmap, const void* x_, const float* __restrict__ bias,
                                          const void* res_, void* out_, int T, int k, int dil, int flags, int n_avg,
                                          float slope) {
  using E = typename std::conditional<F32, float, __nv_bfloat16>::type;
  constexpr int KC = CHUNK_BYTES / static_cast<int>(sizeof(E));  // input channels per chunk
  constexpr int VEC = 16 / static_cast<int>(sizeof(E));          // elements per 16-byte vector
  constexpr int N_CHUNKS = C / KC;
  constexpr int W_BYTES = C * CHUNK_BYTES;  // one weight box
  constexpr int SPLIT = F32 ? 2 : 1;
  constexpr int STAGE_BYTES = SPLIT * W_BYTES;
  const E* x = static_cast<const E*>(x_);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int span = (k - 1) * dil;
  const int pad = span / 2;
  const int rows = BM + span;
  const int plane = rows * 16;          // one 16-byte plane of an input chunk tile
  const int a_bytes = 4 * plane;        // one input chunk tile (in f32: hi, then lo after it)
  unsigned char* abuf = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(abuf + 2 * SPLIT * a_bytes);
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
    // producer: one weight box (two in f32: hi and lo) per (chunk, tap)
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        const int c = i / k, tap = i - c * k;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* dst = ring + s * STAGE_BYTES;
        tma_load_2d(dst, &wmap, &full[s], c * KC, tap * C);
        if (F32) tma_load_2d(dst + W_BYTES, &wmap, &full[s], c * KC, (k + tap) * C);
      }
    }
    return;
  }

  // consumers
  auto issue_chunk = [&](int c, int b) {
    unsigned char* dst = abuf + b * SPLIT * a_bytes;
    for (int i = tid; i < rows * 4; i += CONSUMERS) {
      const int r = i >> 2, v = i & 3;
      const int t = t0 - pad + r;
      unsigned char* d = dst + v * plane + r * 16;
      if (t >= 0 && t < T)
        cp_async16(d, x + base + static_cast<size_t>(t) * C + c * KC + v * VEC);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  // leaky 0.1 (and the TF32 split) on this thread's own vectors, then the
  // tile is complete for every consumer and visible to wgmma
  auto finish_chunk = [&](int b) {
    cp_async_wait<0>();
    unsigned char* dst = abuf + b * SPLIT * a_bytes;
    for (int i = tid; i < rows * 4; i += CONSUMERS) {
      uint4* p = reinterpret_cast<uint4*>(dst + (i & 3) * plane + (i >> 2) * 16);
      uint4 u = *p;
      if constexpr (F32) {
        float f[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z), __uint_as_float(u.w)};
        float hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = leaky_f32(f[j], slope);
          hi[j] = round_tf32(v);
          lo[j] = round_tf32(v - hi[j]);
        }
        *p = make_uint4(__float_as_uint(hi[0]), __float_as_uint(hi[1]), __float_as_uint(hi[2]),
                        __float_as_uint(hi[3]));
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(p) + a_bytes) =
            make_uint4(__float_as_uint(lo[0]), __float_as_uint(lo[1]), __float_as_uint(lo[2]),
                       __float_as_uint(lo[3]));
      } else {
        u.x = leaky2(u.x, slope);
        u.y = leaky2(u.y, slope);
        u.z = leaky2(u.z, slope);
        u.w = leaky2(u.w, slope);
        *p = u;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  };

  float acc[C / 2];
#pragma unroll
  for (int j = 0; j < C / 2; ++j) acc[j] = 0.f;

  // this warpgroup's 64 rows: A descriptors step 16 bytes a row, 2 planes a
  // k step; core matrices are a plane apart along K and 128 bytes along M
  const int wg = warp >> 2;

  issue_chunk(0, 0);
  finish_chunk(0);
  int it = 0;
  for (int c = 0; c < N_CHUNKS; ++c) {
    const int b = c & 1;
    if (c + 1 < N_CHUNKS) issue_chunk(c + 1, b ^ 1);
    const uint32_t tile = smem_u32(abuf + b * SPLIT * a_bytes) + wg * 64 * 16;
    for (int tap = 0; tap < k; ++tap, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t arow = tile + tap * dil * 16;
      const uint32_t wb = smem_u32(ring + s * STAGE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint64_t da = desc_plain(arow + ks * 2 * plane, plane, 128);
        const uint64_t dhi = desc_sw64(wb + ks * 32);
        if constexpr (F32) {
          const uint64_t dal = desc_plain(arow + a_bytes + ks * 2 * plane, plane, 128);
          const uint64_t dlo = desc_sw64(wb + W_BYTES + ks * 32);
          wgmma_ss<C, true>(acc, dal, dhi);
          wgmma_ss<C, true>(acc, da, dlo);
          wgmma_ss<C, true>(acc, da, dhi);
        } else {
          wgmma_ss<C, false>(acc, da, dhi);
        }
      }
      wgmma_commit();
      // the step before is done: its ring slot is free
      wgmma_wait<1>();
      if (tap > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    // the chunk's last products are done before its input tile is reused
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    if (c + 1 < N_CHUNKS) finish_chunk(b ^ 1);
  }
#pragma unroll
  for (int j = 0; j < C / 2; ++j) fence_operand(acc[j]);

  // epilogue, through shared memory so that global reads and writes are
  // whole 16-byte vectors of consecutive channels: once every consumer's
  // products are done (the barrier), the ring and the input tiles are free.
  // Pass 1: the accumulators plus bias (rounded to bf16 in bf16) into a
  // padded [BM, C] tile. Pass 2: residual, running branch sum and average
  // per vector; bf16 rounds after each.
  constexpr int ROW = C * static_cast<int>(sizeof(E)) + 16;  // padded tile row (bytes)
  constexpr int VPR = C * static_cast<int>(sizeof(E)) / 16;   // vectors per row
  unsigned char* tile_out = ring;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int J = 0; J < C / 8; ++J) {
    const int col = J * 8 + (lane & 3) * 2;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned char* dst = tile_out + (r0 + h * 8) * ROW + col * static_cast<int>(sizeof(E));
      const float v0 = acc[4 * J + 2 * h], v1 = acc[4 * J + 2 * h + 1];
      if constexpr (F32)
        *reinterpret_cast<float2*>(dst) = make_float2(__fadd_rn(v0, b0), __fadd_rn(v1, b1));
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0 + b0, v1 + b1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int i = tid; i < BM * VPR; i += CONSUMERS) {
    const int r = i / VPR, q = i - r * VPR;
    const int t = t0 + r;
    if (t >= T) continue;
    const size_t o = base + static_cast<size_t>(t) * C + q * VEC;
    const uint4 u = *reinterpret_cast<const uint4*>(tile_out + r * ROW + q * 16);
    if constexpr (F32) {
      const float* res = static_cast<const float*>(res_);
      float* out = static_cast<float*>(out_);
      float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z), __uint_as_float(u.w)};
      if (flags & kResidual) {
        const float4 a = *reinterpret_cast<const float4*>(res + o);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(av[j], v[j]);
      }
      if (flags & kAddSum) {
        const float4 a = *reinterpret_cast<const float4*>(out + o);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(av[j], v[j]);
      }
      if (flags & kAverage) {
        const float n = static_cast<float>(n_avg);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fdiv_rn(v[j], n);
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(res_);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(out_);
      float v[8];
      unpack_bf16x8(u, v);
      if (flags & kResidual) {
        float a[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(res + o), a);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = round_bf16(a[j] + v[j]);
      }
      if (flags & kAddSum) {
        float a[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(out + o), a);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = round_bf16(a[j] + v[j]);
      }
      if (flags & kAverage) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = v[j] / static_cast<float>(n_avg);
      }
      *reinterpret_cast<uint4*>(out + o) = pack_bf16x8(v);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, C <= 128 ? 2 : 1)
    mrf_conv_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap wmap, const void* x, const float* bias,
                               const void* res, void* out, int T, int k, int dil, int flags, int n_avg,
                               float slope) {
  conv_body<C, false>(wmap, x, bias, res, out, T, k, dil, flags, n_avg, slope);
}

template <int C>
__global__ void __launch_bounds__(THREADS, C <= 128 ? 2 : 1)
    mrf_conv_wgmma_tf32x3_kernel(const __grid_constant__ CUtensorMap wmap, const void* x, const float* bias,
                                 const void* res, void* out, int T, int k, int dil, int flags, int n_avg,
                                 float slope) {
  conv_body<C, true>(wmap, x, bias, res, out, T, k, dil, flags, n_avg, slope);
}

template <int C, bool F32>
cudaError_t launch(const CUtensorMap& map, const void* x, const void* bias, const void* res, void* out, int B, int T,
                   int k, int dil, int flags, int n_avg, float slope, cudaStream_t stream) {
  auto kernel = F32 ? mrf_conv_wgmma_tf32x3_kernel<C> : mrf_conv_wgmma_bf16_kernel<C>;
  const size_t smem = smem_bytes(C, F32, k, dil);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // the limit is set per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BM - 1) / BM, 1, B);
  kernel<<<grid, THREADS, smem, stream>>>(map, x, static_cast<const float*>(bias), res, out, T, k, dil, flags, n_avg,
                                          slope);
  return cudaGetLastError();
}

template <bool F32>
int dispatch(const void* map, const void* x, const void* bias, const void* res, void* out, int B, int T, int C,
             int k, int dil, int flags, int n_avg, float slope, void* stream) {
  if (map == nullptr || B < 1 || T < 1 || C < 32 || C % 32 != 0 || C > 256 || k < 1 || k % 2 == 0 || dil < 1 ||
      n_avg < 1 || ((flags & kResidual) && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (C) {
#define MRF_CASE(c) \
  case c:           \
    e = launch<c, F32>(m, x, bias, res, out, B, T, k, dil, flags, n_avg, slope, s); \
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

}  // namespace

// The TMA descriptor (128 bytes, written to `map_out`) of one conv's weight
// in the kernel's layout: bf16 [k, C_out, C_in] (f32 = 0) or the f32 TF32
// split [2, k, C_out, C_in] (every tap's hi, then every tap's lo, f32 = 1),
// seen as a 2D [rows, C_in] tensor cut into boxes of 64 bytes x C_out rows. Build it once
// per weight tensor; it holds the weight's address. Returns 0, or a
// cudaError_t / CUresult code.
extern "C" int mrf_weight_map(void* map_out, const void* w, int f32, int k, int C) {
  if (map_out == nullptr || w == nullptr || C < 32 || C % 32 != 0 || C > 256 || k < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>((f32 ? 2 : 1) * k * C)};
  const cuuint64_t strides[1] = {C * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(CHUNK_BYTES / elem), static_cast<cuuint32_t>(C)};
  const cuuint32_t estrides[2] = {1, 1};
  alignas(64) CUtensorMap m;
  const CUresult r = fn(&m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(w), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  memcpy(map_out, &m, sizeof(m));
  return 0;
}

// Returns a cudaError_t (0 on success). `map` is the weight's descriptor from
// `mrf_weight_map`; launches on `stream`, does not synchronise and allocates
// nothing.
extern "C" int mrf_conv(const void* map, const void* x, const void* bias, const void* res, void* out, int B, int T,
                        int C, int k, int dil, int flags, int n_avg, float slope, void* stream) {
  return dispatch<false>(map, x, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, stream);
}

// The f32 counterpart of `mrf_conv` (3xTF32), with the same arguments and
// flags; `map` describes the [2, k, C, C] split weight.
extern "C" int mrf_conv_f32(const void* map, const void* x, const void* bias, const void* res, void* out, int B,
                            int T, int C, int k, int dil, int flags, int n_avg, float slope, void* stream) {
  return dispatch<true>(map, x, bias, res, out, B, T, C, k, dil, flags, n_avg, slope, stream);
}
