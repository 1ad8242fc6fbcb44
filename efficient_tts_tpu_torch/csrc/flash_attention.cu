// Flash attention forward and backward for Hopper (sm_90a), f32 in and out.
//
// Replaces the three `pallas_call`s of JAX's library TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward,
// _flash_attention_kernel_single_batch; the backward's dkv kernel,
// _flash_attention_dkv_kernel; and its dq kernel, _flash_attention_dq_kernel),
// which the JAX package reaches through efficient_tts_tpu/nn/attention.py:
// _flash_attention for every eligible EFTS-Transformer self-attention, in
// inference and in training. Per (batch, head), with
// x = q k^T * sm_scale + where(seg_q == seg_k, 0, mask_value) (no mask term
// without segment ids):
//
//   forward  o = softmax(x) v, and when asked the row residuals
//            m = max(x) and l = sum(exp(x - m)), [B, H, Tq] f32;
//   dkv      p = exp(x - m) / l, dv = p^T do, ds = ((do v^T) - di) p sm_scale,
//            dk = ds^T q;
//   dq       the same p and ds, dq = ds k;
//
// with di = sum(o * do, -1) computed by the caller. The scale is applied
// after the product and again to ds, where the library's kernels apply it.
// The forward keeps the library's l == 0 guard; l is never 0 here because
// mask_value is finite, so the row's maximum contributes exp(0) = 1. Each
// backward kernel writes its outputs once, with no atomics, so the
// gradients are deterministic. The Python wrapper is
// efficient_tts_tpu_torch/ops/flash_attention.py.
//
// Operand precision: TF32. Every product runs on the tensor cores as
// mma.sync m16n8k8 TF32 with f32 accumulation; q, k, v, do, the softmax
// weights p and ds are rounded to TF32 (cvt.rna, 10 explicit mantissa bits)
// as they enter an mma. Everything else (scale, mask, max, exp, di, sums,
// the rescaling and 1/l) is f32. The JAX reference computes in f32, so this
// is a stated rounding of about 2^-11 relative per operand; the port's
// plain versions are f32 throughout.
//
// Bound on the H100: the forward moves each of q, k, v and o once, 16 bytes
// per head element, against 4*T*dk operations per query row. At the
// decoder's [B=16, H=4, T=512, dk=96] that is 50.3 MB and 6.44 GFLOP: 15.0
// us by bytes at 3.35 TB/s against 13.0 us by operations at the TF32 peak
// of 495 TFLOP/s. The dkv kernel does 4 products per (query, key) pair and
// the dq kernel 3, so both are bound by operations at T = 512.
//
// Design, the simple one: mma.sync with the operands staged in shared
// memory by cp.async, the streamed tiles double-buffered. Rows of shared
// memory are padded to dk_pad + 4 floats, which makes every fragment load
// conflict-free; dk is padded with zero columns to 32, 64, 96 or 128. A
// score tile stays in registers and feeds the next product directly: the
// keys (or queries) of each 8-wide chunk are taken in the order 0,2,4,6,
// 1,3,5,7, which turns the accumulator layout into the A-operand layout with
// no shuffle, and the B operand's rows are read in the same order. exp(x)
// is computed as exp2(x * log2 e).
//   forward: one block of 4 warps per (batch, head, 64-row query tile), each
//     warp owning 16 query rows, whose q it reads once from device memory
//     into registers as TF32 fragments; 64-key K and V tiles stream through
//     shared memory (100 KB at dk = 96, two blocks per SM).
//   dkv: one block of 4 warps per (batch, head, 64-key tile), each warp
//     owning 16 keys, with the block's K and V held in shared memory; 32-row
//     q and do tiles stream past. Per tile the warp forms s^T = k q^T and
//     dp^T = v do^T, then p^T and ds^T in registers, and accumulates
//     dv += p^T do and dk += ds^T q in registers (100 KB, two blocks per SM).
//   dq: one block of 4 warps per (batch, head, 64-row query tile), with the
//     block's q and do in shared memory; 32-key K and V tiles stream past.
//     Per tile the warp forms s = q k^T and dp = do v^T, then ds, and
//     accumulates dq += ds k (100 KB, two blocks per SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // forward: query rows per block
constexpr int BN = 64;        // forward: keys per K/V tile
constexpr int BKV = 64;       // dkv: keys per block
constexpr int BQ = 32;        // dkv: queries per q/do tile
constexpr int BQD = 64;       // dq: query rows per block
constexpr int BKD = 32;       // dq: keys per K/V tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* seg_q;
  const int* seg_kv;
  float* o;
  float* m_out;  // [B, H, Tq] row maxima, or null
  float* l_out;  // [B, H, Tq] row sums, or null
  int H, Tq, Tk, dk;
  long long sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t;
  float sm_scale, mask_value;
};

// (b, h, t) strides in elements of q, k, v, do and the three gradients
struct Strides {
  long long b, h, t;
};

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* m;   // [B, H, Tq]
  const float* l;   // [B, H, Tq]
  const float* di;  // [B, H, Tq]
  const int* seg_q;
  const int* seg_kv;
  float* dq;
  float* dk;
  float* dv;
  int H, Tq, Tk, hd;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
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

// Copy `nrows` rows of `vecs` 16-byte vectors from device memory (row stride
// `stride` floats, first row `row0`) into shared rows of LD floats.
template <int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int row0,
                                          int nrows, int vecs, int tid) {
  for (int i = tid; i < nrows * vecs; i += THREADS) {
    const int r = i / vecs, c = (i - r * vecs) * 4;
    cp_async16(dst + r * LD + c, src + static_cast<long long>(row0 + r) * stride + c);
  }
}

// Zero columns dk..DKP of `rows` shared rows once; cp.async never writes them.
template <int DKP>
__device__ __forceinline__ void zero_pad_columns(float* smem, int rows, int dk, int tid) {
  constexpr int LD = DKP + 4;
  const int padc = DKP - dk;
  for (int i = tid; i < rows * padc; i += THREADS) smem[(i / padc) * LD + dk + i % padc] = 0.f;
}

// A fragment (16x8, rows g and g+8, columns t and t+4) of 16 shared rows.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float* rows, int ks, int g, int t) {
  const float* r = rows + g * LD + ks * 8 + t;
  a[0] = tf32(r[0]);
  a[1] = tf32(r[8 * LD]);
  a[2] = tf32(r[4]);
  a[3] = tf32(r[8 * LD + 4]);
}

// Accumulator (rows g, g+8 at columns 2t, 2t+1) as an A fragment whose k
// order is 0,2,4,6,1,3,5,7; the B operand's rows must follow that order.
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&c)[4]) {
  a[0] = tf32(c[0]);
  a[1] = tf32(c[2]);
  a[2] = tf32(c[1]);
  a[3] = tf32(c[3]);
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

  zero_pad_columns<DKP>(smem, 4 * BN, p.dk, tid);
  load_rows<LD>(Ks, kb, p.sk_t, 0, BN, vecs, tid);
  load_rows<LD>(Vs, vb, p.sv_t, 0, BN, vecs, tid);
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
      load_rows<LD>(Ks + buf * BN * LD, kb, p.sk_t, (j + 1) * BN, BN, vecs, tid);
      load_rows<LD>(Vs + buf * BN * LD, vb, p.sv_t, (j + 1) * BN, BN, vecs, tid);
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
      uint32_t pa[4];
      acc_as_a(pa, s[kc]);
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
  // the residuals of the backward; the quad's four threads hold the same m, l
  if (p.m_out != nullptr && t == 0) {
    const size_t base = static_cast<size_t>(blockIdx.y) * p.Tq;
    p.m_out[base + row_a] = m_a;
    p.m_out[base + row_b] = m_b;
    p.l_out[base + row_a] = l_a;
    p.l_out[base + row_b] = l_b;
  }
}

// dk and dv for one (batch, head, 64-key tile); this warp owns keys
// k0 + 16 * warp + (g, g+8) and works on the transposed scores s^T.
template <int DKP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = DKP + 4;
  constexpr int KS = DKP / 8;  // k8 steps over the head dim, n8 tiles of dk and dv
  constexpr int NQ = BQ / 8;   // n8 tiles of a score tile, k8 steps of the dk/dv products
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BKV][LD]
  float* Vs = Ks + BKV * LD;     // [BKV][LD]
  float* Qs = Vs + BKV * LD;     // [2][BQ][LD]
  float* Ds = Qs + 2 * BQ * LD;  // [2][BQ][LD], do

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * BKV;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* db = p.dout + b * p.sdo.b + h * p.sdo.h;
  const size_t rows = static_cast<size_t>(blockIdx.y) * p.Tq;  // m, l, di of this (b, h)
  const float* mq = p.m + rows;
  const float* lq = p.l + rows;
  const float* dq_i = p.di + rows;
  const int vecs = p.hd / 4;

  zero_pad_columns<DKP>(smem, 2 * BKV + 4 * BQ, p.hd, tid);
  load_rows<LD>(Ks, kb, p.sk.t, k0, BKV, vecs, tid);
  load_rows<LD>(Vs, vb, p.sv.t, k0, BKV, vecs, tid);
  load_rows<LD>(Qs, qb, p.sq.t, 0, BQ, vecs, tid);
  load_rows<LD>(Ds, db, p.sdo.t, 0, BQ, vecs, tid);
  cp_async_commit();

  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;
  const bool seg = p.seg_q != nullptr;
  const int* sq = seg ? p.seg_q + static_cast<size_t>(b) * p.Tq : nullptr;
  const int id_a = seg ? p.seg_kv[static_cast<size_t>(b) * p.Tk + key_a] : 0;
  const int id_b = seg ? p.seg_kv[static_cast<size_t>(b) * p.Tk + key_b] : 0;
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  const int n_tiles = p.Tq / BQ;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int buf = (j + 1) & 1;
      load_rows<LD>(Qs + buf * BQ * LD, qb, p.sq.t, (j + 1) * BQ, BQ, vecs, tid);
      load_rows<LD>(Ds + buf * BQ * LD, db, p.sdo.t, (j + 1) * BQ, BQ, vecs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (j & 1) * BQ * LD;
    const float* Dt = Ds + (j & 1) * BQ * LD;

    // s^T = k q^T and dp^T = v do^T for this warp's 16 keys and 32 queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      a_frag<LD>(ka, Kw, ks, g, t);
      a_frag<LD>(va, Vw, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const float* qr = Qt + (nt * 8 + g) * LD + ks * 8 + t;
        mma_tf32(s[nt], ka, tf32(qr[0]), tf32(qr[4]));
        const float* dr = Dt + (nt * 8 + g) * LD + ks * 8 + t;
        mma_tf32(dp[nt], va, tf32(dr[0]), tf32(dr[4]));
      }
    }

    // p^T = exp(x - m) / l and ds^T = ((dp - di) p) * scale, per query column
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = j * BQ + nt * 8 + 2 * t + e;
        const float m_q = mq[qi], inv_l = 1.f / lq[qi], di = dq_i[qi];
        float x_a = s[nt][e] * p.sm_scale, x_b = s[nt][2 + e] * p.sm_scale;
        if (seg) {
          const int id_q = sq[qi];
          x_a += (id_a == id_q) ? 0.f : p.mask_value;
          x_b += (id_b == id_q) ? 0.f : p.mask_value;
        }
        const float p_a = exp2f((x_a - m_q) * kLog2e) * inv_l;
        const float p_b = exp2f((x_b - m_q) * kLog2e) * inv_l;
        s[nt][e] = p_a;
        s[nt][2 + e] = p_b;
        dp[nt][e] = ((dp[nt][e] - di) * p_a) * p.sm_scale;
        dp[nt][2 + e] = ((dp[nt][2 + e] - di) * p_b) * p.sm_scale;
      }
    }

    // dv += p^T do and dk += ds^T q: chunk kc's A column t is query 2t and
    // column t+4 is query 2t+1
#pragma unroll
    for (int kc = 0; kc < NQ; ++kc) {
      uint32_t pa[4], sa[4];
      acc_as_a(pa, s[kc]);
      acc_as_a(sa, dp[kc]);
      const float* dr = Dt + (kc * 8 + 2 * t) * LD + g;
      const float* qr = Qt + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        mma_tf32(dva[dn], pa, tf32(dr[dn * 8]), tf32(dr[LD + dn * 8]));
        mma_tf32(dka[dn], sa, tf32(qr[dn * 8]), tf32(qr[LD + dn * 8]));
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this tile's buffer
  }

  float* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  float* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (dn * 8 >= p.hd) break;
    *reinterpret_cast<float2*>(dkb + key_a * p.sdk.t + col) = make_float2(dka[dn][0], dka[dn][1]);
    *reinterpret_cast<float2*>(dkb + key_b * p.sdk.t + col) = make_float2(dka[dn][2], dka[dn][3]);
    *reinterpret_cast<float2*>(dvb + key_a * p.sdv.t + col) = make_float2(dva[dn][0], dva[dn][1]);
    *reinterpret_cast<float2*>(dvb + key_b * p.sdv.t + col) = make_float2(dva[dn][2], dva[dn][3]);
  }
}

// dq for one (batch, head, 64-row query tile); this warp owns rows
// q0 + 16 * warp + (g, g+8).
template <int DKP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = DKP + 4;
  constexpr int KS = DKP / 8;  // k8 steps over the head dim, n8 tiles of dq
  constexpr int NK = BKD / 8;  // n8 tiles of a score tile, k8 steps of ds.k
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQD][LD]
  float* Ds = Qs + BQD * LD;      // [BQD][LD], do
  float* Ks = Ds + BQD * LD;      // [2][BKD][LD]
  float* Vs = Ks + 2 * BKD * LD;  // [2][BKD][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * BQD;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* db = p.dout + b * p.sdo.b + h * p.sdo.h;
  const int vecs = p.hd / 4;

  zero_pad_columns<DKP>(smem, 2 * BQD + 4 * BKD, p.hd, tid);
  load_rows<LD>(Qs, qb, p.sq.t, q0, BQD, vecs, tid);
  load_rows<LD>(Ds, db, p.sdo.t, q0, BQD, vecs, tid);
  load_rows<LD>(Ks, kb, p.sk.t, 0, BKD, vecs, tid);
  load_rows<LD>(Vs, vb, p.sv.t, 0, BKD, vecs, tid);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const size_t rows = static_cast<size_t>(blockIdx.y) * p.Tq;
  const float m_a = p.m[rows + row_a], m_b = p.m[rows + row_b];
  const float inv_la = 1.f / p.l[rows + row_a], inv_lb = 1.f / p.l[rows + row_b];
  const float di_a = p.di[rows + row_a], di_b = p.di[rows + row_b];
  const bool seg = p.seg_q != nullptr;
  const int* skv = seg ? p.seg_kv + static_cast<size_t>(b) * p.Tk : nullptr;
  const int id_a = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_a] : 0;
  const int id_b = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_b] : 0;
  const float* Qw = Qs + warp * 16 * LD;
  const float* Dw = Ds + warp * 16 * LD;

  float dqa[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  const int n_tiles = p.Tk / BKD;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int buf = (j + 1) & 1;
      load_rows<LD>(Ks + buf * BKD * LD, kb, p.sk.t, (j + 1) * BKD, BKD, vecs, tid);
      load_rows<LD>(Vs + buf * BKD * LD, vb, p.sv.t, (j + 1) * BKD, BKD, vecs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (j & 1) * BKD * LD;
    const float* Vt = Vs + (j & 1) * BKD * LD;

    // s = q k^T and dp = do v^T for this warp's 16 rows and 32 keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      a_frag<LD>(qa, Qw, ks, g, t);
      a_frag<LD>(da, Dw, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const float* kr = Kt + (nt * 8 + g) * LD + ks * 8 + t;
        mma_tf32(s[nt], qa, tf32(kr[0]), tf32(kr[4]));
        const float* vr = Vt + (nt * 8 + g) * LD + ks * 8 + t;
        mma_tf32(dp[nt], da, tf32(vr[0]), tf32(vr[4]));
      }
    }

    // ds = ((dp - di) p) * scale with p = exp(x - m) / l, kept in s
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_a = s[nt][e] * p.sm_scale, x_b = s[nt][2 + e] * p.sm_scale;
        if (seg) {
          const int sk = skv[j * BKD + nt * 8 + 2 * t + e];
          x_a += (id_a == sk) ? 0.f : p.mask_value;
          x_b += (id_b == sk) ? 0.f : p.mask_value;
        }
        const float p_a = exp2f((x_a - m_a) * kLog2e) * inv_la;
        const float p_b = exp2f((x_b - m_b) * kLog2e) * inv_lb;
        s[nt][e] = ((dp[nt][e] - di_a) * p_a) * p.sm_scale;
        s[nt][2 + e] = ((dp[nt][2 + e] - di_b) * p_b) * p.sm_scale;
      }
    }

    // dq += ds k: chunk kc's A column t is key 2t and column t+4 is key 2t+1
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      uint32_t sa[4];
      acc_as_a(sa, s[kc]);
      const float* kr = Kt + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) mma_tf32(dqa[dn], sa, tf32(kr[dn * 8]), tf32(kr[LD + dn * 8]));
    }
    __syncthreads();  // the next iteration's loads overwrite this tile's buffer
  }

  float* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (dn * 8 >= p.hd) break;
    *reinterpret_cast<float2*>(dqb + row_a * p.sdq.t + col) = make_float2(dqa[dn][0], dqa[dn][1]);
    *reinterpret_cast<float2*>(dqb + row_b * p.sdq.t + col) = make_float2(dqa[dn][2], dqa[dn][3]);
  }
}

// Launch `kernel` on a (tiles, B * H) grid with `rows_smem` shared rows of
// DKP + 4 floats; the dynamic shared memory limit is set per device, so it
// is set on every launch that needs it.
template <int DKP, typename P>
cudaError_t launch(void (*kernel)(P), const P& p, int tiles, int BH, int rows_smem,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows_smem) * (DKP + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(tiles, BH), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t s) {
  return launch<DKP>(flash_fwd_kernel<DKP>, p, p.Tq / BM, B * p.H, 4 * BN, s);
}

template <int DKP>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t s) {
  return launch<DKP>(flash_bwd_dkv_kernel<DKP>, p, p.Tk / BKV, B * p.H, 2 * BKV + 4 * BQ, s);
}

template <int DKP>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  return launch<DKP>(flash_bwd_dq_kernel<DKP>, p, p.Tq / BQD, B * p.H, 2 * BQD + 4 * BKD, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }
bool aligned8(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 7u) == 0; }

// The shapes every kernel takes: T a multiple of 64, dk a multiple of 8 up to 128.
bool shapes_ok(int B, int H, int Tq, int Tk, int dk, const void* seg_q, const void* seg_kv) {
  return B >= 1 && H >= 1 && B * H <= 65535 && Tq >= 64 && Tq % 64 == 0 && Tk >= 64 &&
         Tk % 64 == 0 && dk >= 8 && dk <= 128 && dk % 8 == 0 &&
         (seg_q == nullptr) == (seg_kv == nullptr);
}

// Operands read with cp.async need 16-byte rows; outputs are written as float2.
bool bwd_layout_ok(const BwdParams& p) {
  const Strides in[] = {p.sq, p.sk, p.sv, p.sdo};
  const Strides out[] = {p.sdq, p.sdk, p.sdv};
  bool ok = aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.dout) &&
            aligned8(p.dq) && aligned8(p.dk) && aligned8(p.dv);
  for (const Strides& s : in) ok = ok && s.b % 4 == 0 && s.h % 4 == 0 && s.t % 4 == 0;
  for (const Strides& s : out) ok = ok && s.t % 2 == 0;
  return ok;
}

template <typename F>
int dispatch(int dk, F&& f) {
  if (dk <= 32) return static_cast<int>(f(std::integral_constant<int, 32>{}));
  if (dk <= 64) return static_cast<int>(f(std::integral_constant<int, 64>{}));
  if (dk <= 96) return static_cast<int>(f(std::integral_constant<int, 96>{}));
  return static_cast<int>(f(std::integral_constant<int, 128>{}));
}

BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout, const void* m,
                     const void* l, const void* di, const void* seg_q, const void* seg_kv,
                     void* dq, void* dk, void* dv, int H, int Tq, int Tk, int hd,
                     const long long* st, float sm_scale, float mask_value) {
  return BwdParams{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const float*>(dout),
                   static_cast<const float*>(m), static_cast<const float*>(l),
                   static_cast<const float*>(di), static_cast<const int*>(seg_q),
                   static_cast<const int*>(seg_kv), static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, hd,
                   {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
                   {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
                   {st[18], st[19], st[20]}, sm_scale, mask_value};
}

}  // namespace

// q, k, v: f32 [B, H, T, dk] with unit last stride and (b, h, t) strides in
// elements; seg_q [B, Tq] and seg_kv [B, Tk] int32, both null for no mask;
// o: f32, its own strides; m_out and l_out: f32 [B, H, Tq] contiguous, both
// null unless the backward's residuals are wanted. Returns a cudaError_t (0
// on success). Launches on `stream`, does not synchronise and allocates
// nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                                   const void* seg_kv, void* o, void* m_out, void* l_out, int B,
                                   int H, int Tq, int Tk, int dk, long long sq_b, long long sq_h,
                                   long long sq_t, long long sk_b, long long sk_h, long long sk_t,
                                   long long sv_b, long long sv_h, long long sv_t, long long so_b,
                                   long long so_h, long long so_t, float sm_scale,
                                   float mask_value, void* stream) {
  const long long strides[] = {sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t};
  bool ok = shapes_ok(B, H, Tq, Tk, dk, seg_q, seg_kv) && (m_out == nullptr) == (l_out == nullptr) &&
            aligned16(q) && aligned16(k) && aligned16(v) && so_t % 2 == 0 && aligned8(o);
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const int*>(seg_q),
                 static_cast<const int*>(seg_kv), static_cast<float*>(o),
                 static_cast<float*>(m_out), static_cast<float*>(l_out), H, Tq, Tk, dk,
                 sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b, so_h, so_t,
                 sm_scale, mask_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dk, [&](auto c) { return launch_fwd<decltype(c)::value>(p, B, s); });
}

// The backward's two kernels, one entry each. q, k, v and do: f32 [B, H, T,
// dk] with unit last stride; m, l and di: f32 [B, H, Tq] contiguous; seg_q
// and seg_kv as for the forward; dq, dk and dv: f32 outputs. `strides` holds
// the (b, h, t) strides in elements of q, k, v, do, dq, dk and dv, in that
// order (21 values). flash_attention_bwd_dkv writes dk and dv,
// flash_attention_bwd_dq writes dq; each reads the other's outputs as
// nothing. Return, stream and allocation as for the forward.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* di, const void* seg_q, const void* seg_kv,
                                       void* dk, void* dv, int B, int H, int Tq, int Tk, int hd,
                                       const long long* strides, float sm_scale,
                                       float mask_value, void* stream) {
  const BwdParams p = bwd_params(q, k, v, dout, m, l, di, seg_q, seg_kv, dk /* unused dq */, dk, dv,
                                 H, Tq, Tk, hd, strides, sm_scale, mask_value);
  if (!shapes_ok(B, H, Tq, Tk, hd, seg_q, seg_kv) || !bwd_layout_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, [&](auto c) { return launch_dkv<decltype(c)::value>(p, B, s); });
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* m, const void* l,
                                      const void* di, const void* seg_q, const void* seg_kv,
                                      void* dq, int B, int H, int Tq, int Tk, int hd,
                                      const long long* strides, float sm_scale, float mask_value,
                                      void* stream) {
  const BwdParams p = bwd_params(q, k, v, dout, m, l, di, seg_q, seg_kv, dq, dq /* unused dk */,
                                 dq /* unused dv */, H, Tq, Tk, hd, strides, sm_scale, mask_value);
  if (!shapes_ok(B, H, Tq, Tk, hd, seg_q, seg_kv) || !bwd_layout_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, [&](auto c) { return launch_dq<decltype(c)::value>(p, B, s); });
}
