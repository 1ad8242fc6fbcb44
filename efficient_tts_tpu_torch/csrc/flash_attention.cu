// Flash attention forward for Hopper (sm_90a), f32 in and out.
//
// Replaces the forward `pallas_call` of JAX's library TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, kernel body
// _flash_attention_kernel_single_batch), which the JAX package reaches
// through efficient_tts_tpu/nn/attention.py:_flash_attention for every
// eligible EFTS-Transformer self-attention. Per (batch, head):
//
//   o = softmax(q k^T * sm_scale + where(seg_q == seg_k, 0, mask_value)) v
//
// with no mask term when there are no segment ids, the scale applied after
// the product, the online softmax in f32 and the library's l == 0 guard.
// The Python wrapper is efficient_tts_tpu_torch/ops/flash_attention.py.
//
// Operand precision: TF32. Both products run on the tensor cores as
// mma.sync m16n8k8 TF32 with f32 accumulation; q, k, v and the softmax
// weights p are rounded to TF32 (cvt.rna, 10 explicit mantissa bits) as
// they enter an mma. Everything else (scale, mask, max, exp, sums, the
// rescaling and the final 1/l) is f32. The JAX reference computes in f32,
// so this is a stated rounding of about 2^-11 relative per operand; the
// port's plain version (flash_attention_reference) is f32 throughout.
//
// Bound on the H100: each of q, k, v and o is moved once, 16 bytes per
// head element, against 4*T*dk operations per query row. At the decoder's
// [B=16, H=4, T=512, dk=96] that is 50.3 MB and 6.44 GFLOP: 15.0 us by
// bytes at 3.35 TB/s against 13.0 us by operations at the TF32 peak of
// 495 TFLOP/s; at T=128 the bytes bound alone. The design is the simple
// one: one block of 4 warps per (batch, head, 64-row query tile), each
// warp owning 16 query rows, whose q it reads once from device memory into
// registers as TF32 fragments. 64-key K and V tiles stream through shared
// memory with cp.async, double-buffered: 100 KB at dk = 96, so two blocks
// share an SM. The score tile stays in registers and feeds the P.V product
// directly: the keys of each 8-key chunk are taken in the order 0,2,4,6,
// 1,3,5,7, which turns the accumulator layout of S into the operand
// layout of P with no shuffle, and V's rows are read in the same order.
// Rows of shared memory are padded to dk_pad + 4 floats, which makes
// every fragment load conflict-free. dk is padded with zero columns to 32,
// 64, 96 or 128. exp(x) is computed as exp2(x * log2 e).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* seg_q;
  const int* seg_kv;
  float* o;
  int H, Tq, Tk, dk;
  long long sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t;
  float sm_scale, mask_value;
};

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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A holds rows g
// and g+8 at columns t and t+4; B holds column g at rows t and t+4; the
// accumulator holds rows g and g+8 at columns 2t and 2t+1.
template <int DKP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LD = DKP + 4;  // padded shared row (floats)
  constexpr int KS = DKP / 8;  // k8 steps of q.k, n8 tiles of o
  constexpr int NT = BN / 8;   // n8 tiles of a score tile, k8 steps of p.v
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;  // [2][BN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * BM;
  const float* qb = p.q + b * p.sq_b + h * p.sq_h;
  const float* kb = p.k + b * p.sk_b + h * p.sk_h;
  const float* vb = p.v + b * p.sv_b + h * p.sv_h;
  const int vecs = p.dk / 4;  // 16-byte vectors per row

  // zero columns dk..DKP of every shared row once; cp.async never writes them
  const int padc = DKP - p.dk;
  for (int i = tid; i < 4 * BN * padc; i += THREADS) smem[(i / padc) * LD + p.dk + i % padc] = 0.f;

  auto load_rows = [&](float* dst, const float* src, long long stride, int row0) {
    for (int i = tid; i < 64 * vecs; i += THREADS) {
      const int r = i / vecs, c = (i - r * vecs) * 4;
      cp_async16(dst + r * LD + c, src + static_cast<long long>(row0 + r) * stride + c);
    }
  };
  load_rows(Ks, kb, p.sk_t, 0);
  load_rows(Vs, vb, p.sv_t, 0);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const bool seg = p.seg_q != nullptr;
  const int* skv = seg ? p.seg_kv + static_cast<size_t>(b) * p.Tk : nullptr;
  const int id_a = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_a] : 0;
  const int id_b = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_b] : 0;

  // this warp's Q rows as TF32 A fragments, read once straight from device
  // memory; zeros past dk
  uint32_t qf[KS][4];
  const float* qa = qb + static_cast<long long>(row_a) * p.sq_t;
  const float* qr = qb + static_cast<long long>(row_b) * p.sq_t;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bool in = ks * 8 < p.dk;
    qf[ks][0] = tf32(in ? qa[ks * 8 + t] : 0.f);
    qf[ks][1] = tf32(in ? qr[ks * 8 + t] : 0.f);
    qf[ks][2] = tf32(in ? qa[ks * 8 + t + 4] : 0.f);
    qf[ks][3] = tf32(in ? qr[ks * 8 + t + 4] : 0.f);
  }
  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const int n_tiles = p.Tk / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int buf = (j + 1) & 1;
      load_rows(Ks + buf * BN * LD, kb, p.sk_t, (j + 1) * BN);
      load_rows(Vs + buf * BN * LD, vb, p.sv_t, (j + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (j & 1) * BN * LD;
    const float* Vt = Vs + (j & 1) * BN * LD;

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = Kt + (nt * 8 + g) * LD + ks * 8 + t;
        mma_tf32(s[nt], qf[ks], tf32(kr[0]), tf32(kr[4]));
      }
    }

    // scale, then the segment mask, then the online softmax (rows g, g+8)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_a = s[nt][e] * p.sm_scale, x_b = s[nt][2 + e] * p.sm_scale;
        if (seg) {
          const int sk = skv[j * BN + nt * 8 + 2 * t + e];
          x_a += (id_a == sk) ? 0.f : p.mask_value;
          x_b += (id_b == sk) ? 0.f : p.mask_value;
        }
        s[nt][e] = x_a;
        s[nt][2 + e] = x_b;
        mx_a = fmaxf(mx_a, x_a);
        mx_b = fmaxf(mx_b, x_b);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // exp(x) as exp2(x * log2 e): one ex2 instead of expf's longer sequence
    const float al_a = exp2f((m_a - mn_a) * kLog2e), al_b = exp2f((m_b - mn_b) * kLog2e);
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f((s[nt][e] - mn_a) * kLog2e);
        s[nt][2 + e] = exp2f((s[nt][2 + e] - mn_b) * kLog2e);
        rs_a += s[nt][e];
        rs_b += s[nt][2 + e];
      }
    }
    l_a = al_a * l_a + quad_sum(rs_a);
    l_b = al_b * l_b + quad_sum(rs_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      acc[dn][0] *= al_a;
      acc[dn][1] *= al_a;
      acc[dn][2] *= al_b;
      acc[dn][3] *= al_b;
    }

    // o += p v: chunk kc's A column t is key 2t and column t+4 is key 2t+1
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      const uint32_t pa[4] = {tf32(s[kc][0]), tf32(s[kc][2]), tf32(s[kc][1]), tf32(s[kc][3])};
      const float* vr = Vt + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) mma_tf32(acc[dn], pa, tf32(vr[dn * 8]), tf32(vr[LD + dn * 8]));
    }
    __syncthreads();  // the next iteration's loads overwrite this tile's buffer
  }

  const float inv_a = (l_a == 0.f) ? 1.f : 1.f / l_a;
  const float inv_b = (l_b == 0.f) ? 1.f : 1.f / l_b;
  float* ob = p.o + b * p.so_b + h * p.so_h;
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (dn * 8 >= p.dk) break;
    *reinterpret_cast<float2*>(ob + row_a * p.so_t + col) = make_float2(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
    *reinterpret_cast<float2*>(ob + row_b * p.so_t + col) = make_float2(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
  }
}

template <int DKP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * BN) * (DKP + 4) * sizeof(float);
  // the limit is set per device, so it is set on every launch that needs it
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DKP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.Tq / BM, B * p.H);
  flash_fwd_kernel<DKP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// q, k, v: f32 [B, H, T, dk] with unit last stride and (b, h, t) strides in
// elements; seg_q [B, Tq] and seg_kv [B, Tk] int32, both null for no mask;
// o: f32, its own strides. Returns a cudaError_t (0 on success). Launches
// on `stream`, does not synchronise and allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                                   const void* seg_kv, void* o, int B, int H, int Tq, int Tk,
                                   int dk, long long sq_b, long long sq_h, long long sq_t,
                                   long long sk_b, long long sk_h, long long sk_t, long long sv_b,
                                   long long sv_h, long long sv_t, long long so_b, long long so_h,
                                   long long so_t, float sm_scale, float mask_value,
                                   void* stream) {
  const long long strides[] = {sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t};
  bool ok = B >= 1 && H >= 1 && B * H <= 65535 && Tq >= BM && Tq % BM == 0 && Tk >= BN &&
            Tk % BN == 0 && dk >= 8 && dk <= 128 && dk % 8 == 0 &&
            (seg_q == nullptr) == (seg_kv == nullptr) && aligned16(q) && aligned16(k) &&
            aligned16(v) && so_t % 2 == 0 && (reinterpret_cast<uintptr_t>(o) & 7u) == 0;
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const int*>(seg_q),
                 static_cast<const int*>(seg_kv), static_cast<float*>(o), H, Tq, Tk, dk,
                 sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t,
                 sm_scale, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk <= 32) return static_cast<int>(launch<32>(p, B, s));
  if (dk <= 64) return static_cast<int>(launch<64>(p, B, s));
  if (dk <= 96) return static_cast<int>(launch<96>(p, B, s));
  return static_cast<int>(launch<128>(p, B, s));
}
