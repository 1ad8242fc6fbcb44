// The train step's optimizer in two multi-tensor kernels for Hopper (sm_90a):
// the gradients' global norm, and the clip, weight decay and Adam (amsgrad)
// update applied to every parameter in place.
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's chain
// (`efficient_tts_tpu/train/optim.py:adam_warmup`), which XLA fuses. The
// port's per-tensor version (`train/optim.py:AdamWarmup.update`, then one
// add_ a leaf) runs about 23 launches a leaf, 4281 a step for the
// EFTS-Transformer's 186 leaves, and the host's launch rate, not the card,
// sets its time. Bound on the H100: bytes. The update reads g, p, mu, nu,
// nu_max and writes p, mu, nu, nu_max (36 bytes an element with amsgrad, 28
// without); the norm reads g once more (4 bytes): 1.70 GB for the
// EFTS-Transformer's 42.6M parameters, 0.51 ms at 3.35 TB/s.
//
// Design:
//  - A leaf table as a kernel parameter (`__grid_constant__`, copied at
//    launch, so the host can rewrite its arrays for the next step while
//    this one is queued): for each leaf its pointers, its element count and
//    the index of its first chunk of CHUNK elements. Tables of more than
//    kMaxLeaves leaves are split over launches by the wrapper.
//  - A persistent grid (the SMs times the blocks that fit on one): block b
//    walks chunks b, b + grid, ..., so the 119 leaves under 4096 elements
//    and the few of millions spread alike over the SMs. A chunk is 4096
//    elements, 4 float4 a thread, all loads of a pass in flight before any
//    arithmetic. A chunk whose arrays are all 16-byte aligned (every leaf
//    of a caching-allocator tensor) is read and written in float4, its
//    last len % 4 elements one at a time; any other chunk one at a time.
//  - The norm: each block sums its chunks' squares in f64 into one partial;
//    a one-block kernel adds the partials in index order and writes
//    sqrt as f32. The order is fixed by the table, so the norm repeats
//    exactly from run to run. The update reads it from device memory: the
//    host never waits for it.
//  - The arithmetic is the per-tensor version's, op for op in optax's
//    order, with every product, sum, quotient and square root rounded once
//    (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc may not contract
//    them into FMAs), and a division by a host number as PyTorch computes
//    it, a product with its f32 reciprocal. Given the same norm, the
//    parameters and moments equal the per-tensor version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;                 // elements, 4 float4 a thread
constexpr int kVecPerThread = kChunk / 4 / kThreads;
// kernel parameters may hold 32764 bytes since CUDA 12.1 (an older toolkit fails the static_assert below)
constexpr int kMaxLeaves = 256;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  float* nu_max[kMaxLeaves];                 // null without amsgrad
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];           // leaf l's chunks: [first_chunk[l], first_chunk[l + 1])
  int leaves;
};

struct GradLeaves {
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];
  int leaves;
};

// f32 constants of the update, each as PyTorch turns the host float into an
// operand: one_minus_b1 = f32(1 - b1), inv_bc1 = 1 / f32(bc1) in f32, ...
struct Hyper {
  float max_norm, weight_decay, b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, step_size;
};
constexpr int kHyperFloats = sizeof(Hyper) / sizeof(float);

static_assert(CUDART_VERSION >= 12010 && sizeof(Leaves) + sizeof(Hyper) + 2 * sizeof(void*) <= 32764,
              "the leaf table exceeds the kernel parameter space (CUDA 12.1 or later holds 32764 bytes)");

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// torch.maximum on floats: a NaN in either operand wins
__device__ __forceinline__ float maximum(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

// Leaf and element range of chunk c; `leaf` only moves forward, as a block's chunks do.
template <typename Table>
__device__ __forceinline__ void locate(const Table& t, int c, int& leaf, long long& start, int& len) {
  while (c >= t.first_chunk[leaf + 1]) ++leaf;
  start = static_cast<long long>(c - t.first_chunk[leaf]) * kChunk;
  len = static_cast<int>(min(static_cast<long long>(kChunk), t.n[leaf] - start));
}

// One element of the per-tensor chain (train/optim.py:AdamWarmup.update and
// the add_ of train/state.py:apply_updates).
template <bool kAmsgrad, bool kDecay>
__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, float& vmax, const Hyper& h, bool clip,
                                     float norm) {
  float x = clip ? __fmul_rn(__fdiv_rn(g, norm), h.max_norm) : g;   // where(norm < max_norm, g, g / norm * max_norm)
  if (kDecay) x = __fadd_rn(x, __fmul_rn(p, h.weight_decay));
  m = __fadd_rn(__fmul_rn(x, h.one_minus_b1), __fmul_rn(m, h.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(x, x), h.one_minus_b2), __fmul_rn(v, h.b2));
  float v_hat = __fmul_rn(v, h.inv_bc2);
  if (kAmsgrad) v_hat = vmax = maximum(vmax, v_hat);
  float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1), __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  p = __fadd_rn(p, __fmul_rn(u, h.step_size));
}

template <bool kAmsgrad, bool kDecay>
__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Leaves t, const Hyper h,
                                                        const float* __restrict__ norm) {
  const float nrm = norm ? *norm : 0.0f;
  const bool clip = norm && !(nrm < h.max_norm);
  const int total = t.first_chunk[t.leaves];
  int leaf = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    long long start;
    int len;
    locate(t, c, leaf, start, len);
    float* __restrict__ p = t.p[leaf] + start;
    const float* __restrict__ g = t.g[leaf] + start;
    float* __restrict__ mu = t.mu[leaf] + start;
    float* __restrict__ nu = t.nu[leaf] + start;
    float* __restrict__ vm = kAmsgrad ? t.nu_max[leaf] + start : nullptr;
    int scalar_from = 0;
    if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu) && (!kAmsgrad || aligned16(vm))) {
      const int nvec = len >> 2;
      float4 G[kVecPerThread], P[kVecPerThread], M[kVecPerThread], V[kVecPerThread], X[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < nvec) {
          G[k] = reinterpret_cast<const float4*>(g)[i];
          P[k] = reinterpret_cast<const float4*>(p)[i];
          M[k] = reinterpret_cast<const float4*>(mu)[i];
          V[k] = reinterpret_cast<const float4*>(nu)[i];
          if (kAmsgrad) X[k] = reinterpret_cast<const float4*>(vm)[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < nvec) {
          adam<kAmsgrad, kDecay>(G[k].x, P[k].x, M[k].x, V[k].x, X[k].x, h, clip, nrm);
          adam<kAmsgrad, kDecay>(G[k].y, P[k].y, M[k].y, V[k].y, X[k].y, h, clip, nrm);
          adam<kAmsgrad, kDecay>(G[k].z, P[k].z, M[k].z, V[k].z, X[k].z, h, clip, nrm);
          adam<kAmsgrad, kDecay>(G[k].w, P[k].w, M[k].w, V[k].w, X[k].w, h, clip, nrm);
          reinterpret_cast<float4*>(p)[i] = P[k];
          reinterpret_cast<float4*>(mu)[i] = M[k];
          reinterpret_cast<float4*>(nu)[i] = V[k];
          if (kAmsgrad) reinterpret_cast<float4*>(vm)[i] = X[k];
        }
      }
      scalar_from = nvec << 2;
    }
    for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = mu[i], vi = nu[i], xi = kAmsgrad ? vm[i] : 0.0f;
      adam<kAmsgrad, kDecay>(g[i], pi, mi, vi, xi, h, clip, nrm);
      p[i] = pi;
      mu[i] = mi;
      nu[i] = vi;
      if (kAmsgrad) vm[i] = xi;
    }
  }
}

__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.0;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;                                  // whole in thread 0
}

__global__ void __launch_bounds__(kThreads) norm_partials_kernel(const __grid_constant__ GradLeaves t,
                                                                 double* __restrict__ partials) {
  const int total = t.first_chunk[t.leaves];
  double acc = 0.0;
  int leaf = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    long long start;
    int len;
    locate(t, c, leaf, start, len);
    const float* __restrict__ g = t.g[leaf] + start;
    int scalar_from = 0;
    if (aligned16(g)) {
      const int nvec = len >> 2;
      float4 G[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        G[k] = i < nvec ? reinterpret_cast<const float4*>(g)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        acc = fma(static_cast<double>(G[k].x), static_cast<double>(G[k].x), acc);
        acc = fma(static_cast<double>(G[k].y), static_cast<double>(G[k].y), acc);
        acc = fma(static_cast<double>(G[k].z), static_cast<double>(G[k].z), acc);
        acc = fma(static_cast<double>(G[k].w), static_cast<double>(G[k].w), acc);
      }
      scalar_from = nvec << 2;
    }
    for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
      const double x = g[i];
      acc = fma(x, x, acc);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads) norm_finalize_kernel(const double* __restrict__ partials, int count,
                                                                 float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = static_cast<float>(sqrt(acc));
}

template <typename Table>
int fill_chunks(Table& t, const long long* n, const int* first_chunk, int leaves) {
  if (leaves < 1 || leaves > kMaxLeaves || first_chunk[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < leaves; ++l) {
    const long long chunks = (n[l] + kChunk - 1) / kChunk;
    if (n[l] < 0 || first_chunk[l + 1] - first_chunk[l] != chunks) return static_cast<int>(cudaErrorInvalidValue);
    t.n[l] = n[l];
  }
  memcpy(t.first_chunk, first_chunk, sizeof(int) * (leaves + 1));
  t.leaves = leaves;
  return 0;
}

template <bool kAmsgrad>
void launch_adam(const Leaves& t, const Hyper& h, bool decay, const float* norm, int grid, cudaStream_t s) {
  if (decay)
    adam_kernel<kAmsgrad, true><<<grid, kThreads, 0, s>>>(t, h, norm);
  else
    adam_kernel<kAmsgrad, false><<<grid, kThreads, 0, s>>>(t, h, norm);
}

}  // namespace

extern "C" int fused_adam_chunk(void) { return kChunk; }

extern "C" int fused_adam_max_leaves(void) { return kMaxLeaves; }

// The persistent grid of the current device: its SMs times the blocks of
// the costliest kernel (the amsgrad update with decay) that fit on one.
extern "C" int fused_adam_max_blocks(int* out) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel<true, true>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// partials[0 .. grid) of the leaves' sums of squares; g holds `leaves` device
// pointers, n their element counts, first_chunk their chunk starts
// (leaves + 1 entries, from 0, ceil(n / chunk) apart).
extern "C" int fused_norm_partials(const int64_t* g, const int64_t* n, const int32_t* first_chunk, int leaves,
                                   double* partials, int grid, void* stream) {
  GradLeaves t;
  int rc = fill_chunks(t, reinterpret_cast<const long long*>(n), first_chunk, leaves);
  if (rc) return rc;
  if (grid < 1 || !partials) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < leaves; ++l) t.g[l] = reinterpret_cast<const float*>(g[l]);
  norm_partials_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, partials);
  return static_cast<int>(cudaGetLastError());
}

// out = sqrt(the sum of partials[0 .. count)), as f32.
extern "C" int fused_norm_finalize(const double* partials, int count, float* out, void* stream) {
  if (count < 1 || !partials || !out) return static_cast<int>(cudaErrorInvalidValue);
  norm_finalize_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, count, out);
  return static_cast<int>(cudaGetLastError());
}

// One update of `leaves` leaves in place. ptrs: 5 rows of `leaves` device
// pointers (p, g, mu, nu, nu_max; nu_max's row ignored without amsgrad);
// hyper: the Hyper floats in order; norm: the device scalar the clip reads,
// or null for no clip.
extern "C" int fused_adam_update(const int64_t* ptrs, const int64_t* n, const int32_t* first_chunk, int leaves,
                                 const float* hyper, int amsgrad, int decay, const float* norm, int grid,
                                 void* stream) {
  Leaves t;
  int rc = fill_chunks(t, reinterpret_cast<const long long*>(n), first_chunk, leaves);
  if (rc) return rc;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < leaves; ++l) {
    t.p[l] = reinterpret_cast<float*>(ptrs[l]);
    t.g[l] = reinterpret_cast<const float*>(ptrs[leaves + l]);
    t.mu[l] = reinterpret_cast<float*>(ptrs[2 * leaves + l]);
    t.nu[l] = reinterpret_cast<float*>(ptrs[3 * leaves + l]);
    t.nu_max[l] = amsgrad ? reinterpret_cast<float*>(ptrs[4 * leaves + l]) : nullptr;
  }
  Hyper h;
  static_assert(sizeof(Hyper) == kHyperFloats * sizeof(float), "Hyper holds floats only");
  memcpy(&h, hyper, sizeof(Hyper));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (amsgrad)
    launch_adam<true>(t, h, decay != 0, norm, grid, s);
  else
    launch_adam<false>(t, h, decay != 0, norm, grid, s);
  return static_cast<int>(cudaGetLastError());
}
