// Flash attention forward and backward for Hopper (sm_90a), f32 in and out.
//
// Replaces the three `pallas_call`s of JAX's library TPU flash attention
// (jax 0.9.0, jax/experimental/pallas/ops/tpu/flash_attention.py: the
// forward, _flash_attention_kernel_single_batch, its call at :758; the
// backward's dkv kernel, _flash_attention_dkv_kernel (:796), its call at
// :1121; and its dq kernel, _flash_attention_dq_kernel (:1146), its call at
// :1456), which the JAX package reaches through efficient_tts_tpu/nn/
// attention.py:_flash_attention for every eligible EFTS-Transformer
// self-attention, in inference and in training. Per (batch, head), with
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
// mask_value is finite, so the row's maximum contributes exp(0) = 1, and a
// row whose keys are all in other segments gets p = exp(0) / l, not NaN.
// Each backward kernel writes its outputs once, with no atomics, so the
// gradients are deterministic. The Python wrapper is
// efficient_tts_tpu_torch/ops/flash_attention.py.
//
// Operand precision: TF32. Every product runs on the tensor cores with f32
// accumulation; q, k, v, do, the softmax weights p and ds are rounded to
// TF32 to nearest, ties away (10 explicit mantissa bits: `round_tf32` in
// shared memory before the first wgmma reads a tile, since a wgmma would
// otherwise truncate; cvt.rna for the forward's p in registers). Everything else
// (scale, mask, max, exp, di, sums, the rescaling and 1/l) is f32. The JAX
// reference computes in f32, so this is a stated rounding of about 2^-11
// relative per operand; the port's plain versions are f32 throughout.
//
// Bounds on the H100 (utils/roofline.py: operations at the TF32 peak of 495
// TFLOP/s, bytes at 3.35 TB/s). The forward moves each of q, k, v and o
// once against 4*T*dk operations per query row: at the decoder's [B=16,
// H=4, T=512, dk=96], 15.0 us by bytes. The dkv kernel does 4 products per
// (query, key) pair and the dq kernel 3: at the training shape [64, 4, 512,
// 96] they are bound by operations, 104 us and 78 us; at the text
// encoder's [64, 4, 128, 96] by bytes, 22.7 us and 18.9 us.
//
// Forward design: warp-specialized wgmma blocks, one per (batch, head, NC
// x 64 query rows), NC consumer warpgroups (2 when the grid of 128-row
// blocks fills the card's SMs, else 1) and a producer warpgroup.
//  - The producer: one thread asks TMA for each consumer's 64 rows of q
//    once, and for each BN-key tile (64 keys up to dk_pad 96, 32 at 128) of
//    K into a 3-slot ring and of V into one of 2 landing tiles, as boxes of
//    32 columns in the 128-byte-swizzled layout (head-dim padding
//    zero-filled). As a tile lands the warpgroup rounds K to TF32 in place,
//    writes V's transpose, rounded, into one of 2 stages and copies the
//    keys' segment ids beside it; then the thread asks for the tile after
//    next, so two tiles load while one is consumed. The transpose is needed
//    because a TF32 wgmma reads B K-major only (no transpose bit for .tf32,
//    and TMA does not transpose 4-byte elements) and o = p v contracts over
//    the keys; its rows are stored in the order 0,2,4,6,1,3,5,7, which makes
//    the s accumulator the A fragment of p v with no shuffle.
//  - A consumer rounds its q tile in place once, then per tile: s = q k^T
//    by SS wgmma (M = 64, N = BN, K = DKP, both operands K-major as they
//    land); the scale, segment mask (ids per key column) and online softmax
//    in f32 on the accumulator registers; p rounded by cvt.rna into A
//    fragments; o = alpha o, then o += p v^T by RS wgmma (N = DKP, K = BN).
//    Each product is waited for (wgmma.wait_group 0) before its registers
//    are read or changed: the p fragments stay untouched while in flight,
//    and the rescaling of o waits for the product before it.
// Shared memory at DKP = 96 with NC = 2: 223,296 bytes (K 72 KB, the V
// landing tiles 48 KB, q 48 KB, V^T 48.5 KB); one block per SM. Per 64 x 64
// (query, key) tile a consumer reads q, K and V^T from shared memory (72
// KB), and the producer lands, rounds and transposes K and V once for the
// NC consumers (144 KB a tile): shared memory, not the tensor cores, bounds
// this design as it bounds the backward's.
//
// Backward design: warp-specialized wgmma blocks of 256 threads, one per
// (batch, head, 64-key block) for dkv and per (batch, head, 64-row query
// block) for dq; 32-row tiles of the other side stream past the block's
// resident 64 rows.
//  - A producer warpgroup: one thread keeps S - 1 tiles in flight by TMA
//    (q and do for dkv, k and v for dq, and their row data by bulk copy)
//    into a ring of S stages behind full, empty and landed mbarriers. The
//    tensor maps (`plane_map`, 4 per call, made on the host at each launch:
//    the operands are strided views, new at every call) cut an R-row tile
//    straight into the plane layout below and fill the head-dim padding
//    with zeros. As a tile lands the warpgroup rounds it to TF32 in place
//    (a TF32 wgmma would otherwise truncate) and writes the transposes the
//    second products need: a TF32 wgmma reads both shared operands K-major
//    only (no transpose bit for .tf32, and TMA does not transpose 4-byte
//    elements), and those products contract over the 32 streamed rows.
//  - A consumer warpgroup: per tile the first two products (s and dp, or
//    their transposes; M = 64, N = 32, K = DKP) read both operands from
//    shared memory as stored (SS form); p and ds are formed in f32 in the
//    accumulator registers and rounded; the second products (N = DKP, K =
//    32) take them as the A operand straight from those registers (RS
//    form), the transposes as B. The transposes store each 8 rows in the
//    order 0,2,4,6,1,3,5,7, which makes the accumulator registers the A
//    fragment as they are. The A registers are not touched again until
//    wgmma.wait_group has seen those products complete.
// Tiles are unswizzled plane layouts (`plane_desc`): any 8 rows of a
// 16-byte plane are a core matrix, and the transposes' padded plane stride
// keeps their scattered writes conflict-free. One tile size (64 x 32)
// serves both training shapes: a dkv block runs 16 tiles at T = 512 and 4
// at T = 128, 2048 and 512 blocks. Per tile a dkv block moves about 150 KB
// through shared memory (72 KB of first-product operands, 72 KB to land,
// round and transpose q and do): that, not the tensor cores, bounds this
// design.
// Budget at DKP = 96: dkv 199,120 bytes of shared memory (k, v 48 KB; three
// stages of q, do, their transposes and row data, 48.8 KB each) and 157
// registers a thread (dk and dv 96, s and dp 32); dq 160,720 bytes (q, do
// 48 KB; three stages of k, v, k^T and segment ids, 36.3 KB each) and 108
// registers; no spills at DKP = 32-128 (dkv 194 registers at 128). One
// block per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// (b, h, t) strides in elements of q, k, v, do, o and the three gradients
struct Strides {
  long long b, h, t;
};

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
  Strides sq, sk, sv, so;
  float sm_scale, mask_value;
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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// The backward kernels: warpgroup MMA (wgmma), operand tiles by TMA

constexpr int BKV = 64;              // dkv: keys per block (the wgmma's M)
constexpr int BQ = 32;               // dkv: queries per streamed q/do tile
constexpr int BQD = 64;              // dq: query rows per block (the wgmma's M)
constexpr int BKD = 32;              // dq: keys per streamed k/v tile
constexpr int WG = 128;              // threads of a warpgroup
constexpr int BWD_THREADS = 2 * WG;  // a consumer warpgroup (wgmma) and a producer warpgroup

// Shared operand tiles are K-major and unswizzled, stored as planes: a tile
// of R rows x DKP columns is DKP/4 planes, each R rows of 16 bytes (4
// columns) back to back, so any 8 rows of a plane are one core matrix. A
// wgmma k step (8 TF32 columns) is two planes: core matrices a plane apart
// along K and 128 bytes apart along M or N.
__device__ __forceinline__ uint64_t plane_desc(const float* tile, int k_step, int plane_floats) {
  const uint32_t pb = static_cast<uint32_t>(plane_floats) * 4u;
  return desc_plain(smem_u32(tile) + k_step * 2 * pb, pb, 128);
}

// D[64 x N] += A[64 x 8] B[N x 8]^T for one warpgroup, TF32, A from
// registers (`a`: this thread's four TF32 values in the mma.sync m16n8k8
// A layout of its warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4)), B K-major in shared memory. The A registers must not change
// until a wgmma.wait_group shows this wgmma complete.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float* d, const uint32_t (&a)[4], uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<96>(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// generic-proxy writes to shared memory made visible to the next wgmma or TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The TMA maps of a backward call's operands (`plane_map`): boxes of one
// tile each, in the plane layout.
struct TileMaps {
  CUtensorMap q, k, v, dout;
};

// One box of a `plane_map` (rows [row, row + R) of head h of batch b) into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map, uint64_t* bar, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, "
      "%7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(0), "r"(h), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float4 round_tf32x4(float4 v) {
  return make_float4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
}

// round the N floats of a tile to TF32 in place, one warpgroup
template <int N>
__device__ __forceinline__ void round_planes(float* tile, int tid) {
#pragma unroll
  for (int it = 0; it < N / (4 * WG); ++it) {
    float4* p = reinterpret_cast<float4*>(tile) + tid + it * WG;
    *p = round_tf32x4(*p);
  }
}

// Round a 32-row plane tile to TF32 in place and write its transpose into
// `tr`: column c of the tile becomes row c of `tr`, a tile of DKP rows whose
// 8 planes hold 4 of the 32 rows each, the B operand of a product whose A
// comes from a wgmma accumulator. An accumulator holds columns 2t and 2t + 1
// of each 8 where the A fragment wants t and t + 4, so each 8 rows r0..r7 of
// the tile are stored in the order r0, r2, r4, r6 | r1, r3, r5, r7 (two
// planes), which makes the accumulator registers the A fragment as they
// are. A warp takes one plane's 32 rows; the transpose's planes are DKP * 4
// + 4 floats apart, so the 8 planes a warp writes fall on different banks.
template <int DKP>
__device__ __forceinline__ void round_transpose(float* tile, float* tr, int tid) {
  constexpr int PT = DKP * 4 + 4;
  float4 v[DKP / 16];
#pragma unroll
  for (int it = 0; it < DKP / 16; ++it) {
    float4* s = reinterpret_cast<float4*>(tile) + tid + it * WG;
    v[it] = round_tf32x4(*s);
    *s = v[it];
  }
#pragma unroll
  for (int it = 0; it < DKP / 16; ++it) {
    const int i = tid + it * WG, r = i & 31, pl = i >> 5;
    float* d = tr + ((r >> 3) * 2 + (r & 1)) * PT + pl * 16 + ((r >> 1) & 3);
    d[0] = v[it].x;
    d[4] = v[it].y;
    d[8] = v[it].z;
    d[12] = v[it].w;
  }
}

// Columns 8j..8j+7 of a 64 x 32 wgmma accumulator (d[4j + 2h + e] at row
// 16 warp + g + 8h, column 8j + 2t + e), already rounded, as the A fragment
// of a k step whose B rows are in `round_transpose`'s order
__device__ __forceinline__ void acc_a_frag(uint32_t (&a)[4], const float (&d)[16], int j) {
  a[0] = __float_as_uint(d[4 * j]);
  a[1] = __float_as_uint(d[4 * j + 2]);
  a[2] = __float_as_uint(d[4 * j + 1]);
  a[3] = __float_as_uint(d[4 * j + 3]);
}

// Store a 64 x DKP accumulator's rows (row0 + 16 warp + g, + 8) to a
// [T, hd] output with row stride `st`, the columns below hd only.
template <int DKP>
__device__ __forceinline__ void store_rows(float* out, long long st, const float* acc, int row0, int hd, int warp,
                                           int g, int t) {
  const int ra = row0 + 16 * warp + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j) {
    if (j * 8 >= hd) break;
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + ra * st + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + rb * st + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The start of dynamic shared memory, rounded up to 128 bytes (TMA's
// alignment); the kernels ask for 128 bytes more than their layout.
__device__ __forceinline__ float* smem_base() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return reinterpret_cast<float*>(smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u));
}

// Shared memory of the backward kernels, in floats; every tile starts on
// 128 bytes. dkv: the resident k and v (64 rows each); S stages, each a
// 32-query tile of q and do, their transposes and their row data (m, 1/l,
// di, segment ids); the mbarriers (full, empty and landed per stage, one
// for k and v). At DKP = 96 that is 199,120 bytes with S = 3; DKP = 128
// keeps S = 2 (198,328 bytes).
template <int DKP>
struct DkvLayout {
  static constexpr int PT = DKP * 4 + 4;
  static constexpr int S = DKP <= 96 ? 3 : 2;
  static constexpr int KV = BKV * DKP;      // one of k, v
  static constexpr int QD = BQ * DKP;       // one of a stage's q, do
  static constexpr int TR = (BQ / 4) * PT;  // one transposed tile
  static constexpr int STAGE = 2 * QD + 2 * TR + 4 * BQ;
  static constexpr int BYTES = (2 * KV + S * STAGE) * 4 + (3 * S + 1) * 8 + 128;
};

// dq: the resident q and do (64 rows each); S stages, each a 32-key tile of
// k and v, the transpose of k and the keys' segment ids; the mbarriers.
// 160,720 bytes at DKP = 96, 213,968 at 128.
template <int DKP>
struct DqLayout {
  static constexpr int PT = DKP * 4 + 4;
  static constexpr int S = 3;
  static constexpr int QD = BQD * DKP;       // one of q, do
  static constexpr int KV = BKD * DKP;       // one of a stage's k, v
  static constexpr int TR = (BKD / 4) * PT;  // the transposed k tile
  static constexpr int STAGE = 2 * KV + TR + BKD;
  static constexpr int BYTES = (2 * QD + S * STAGE) * 4 + (3 * S + 1) * 8 + 128;
};

// dk and dv for one (batch, head, 64-key block). One producer thread keeps
// S - 1 tiles of q and do (and their m, l, di and segment ids) in flight by
// TMA; as each lands, the producer warpgroup rounds it to TF32 in place and
// writes the transposes of q and do. The consumer warpgroup, per tile:
// s^T = k q^T and dp^T = v do^T (M = 64 keys, N = 32 queries, K = DKP,
// both operands in shared memory), p^T and ds^T in registers, rounded to
// TF32, then dv += p^T do and dk += ds^T q (M = 64 keys, N = DKP, K = 32
// queries) with p^T and ds^T as the A operand in registers and the
// transposes as B.
template <int DKP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const BwdParams p, const __grid_constant__ TileMaps maps) {
  using L = DkvLayout<DKP>;
  constexpr int S = L::S;
  float* Ks = smem_base();
  float* Vs = Ks + L::KV;
  float* ring = Vs + L::KV;  // stage s: q, do, q^T, do^T, row data
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::STAGE);
  uint64_t* empty = full + S;
  uint64_t* landed = empty + S;
  uint64_t* resident = landed + S;
  auto q_of = [&](int s) { return ring + s * L::STAGE; };
  auto do_of = [&](int s) { return ring + s * L::STAGE + L::QD; };
  auto qt_of = [&](int s) { return ring + s * L::STAGE + 2 * L::QD; };
  auto dt_of = [&](int s) { return ring + s * L::STAGE + 2 * L::QD + L::TR; };
  auto stat_of = [&](int s) { return ring + s * L::STAGE + 2 * L::QD + 2 * L::TR; };

  const int tid = threadIdx.x, lt = tid & (WG - 1);
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int k0 = blockIdx.x * BKV;
  const int n_tiles = p.Tq / BQ;
  const bool seg = p.seg_q != nullptr;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], WG);
      mbar_init(&empty[s], WG);
      mbar_init(&landed[s], 1);
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised

  const bool producer = tid >= WG;
  const size_t rows = static_cast<size_t>(blockIdx.y) * p.Tq;  // m, l, di of this (b, h)
  // tile j's q and do (a box each) and its m, l, di and segment ids (32 values each)
  auto issue = [&](int j) {
    const int s = j % S;
    uint64_t* bar = &landed[s];
    float* st = stat_of(s);
    mbar_expect_tx(bar, 2 * L::QD * 4 + (seg ? 4 : 3) * BQ * 4);
    tma_tile(q_of(s), &maps.q, bar, j * BQ, h, b);
    tma_tile(do_of(s), &maps.dout, bar, j * BQ, h, b);
    bulk_load(st, p.m + rows + j * BQ, BQ * 4, bar);
    bulk_load(st + BQ, p.l + rows + j * BQ, BQ * 4, bar);
    bulk_load(st + 2 * BQ, p.di + rows + j * BQ, BQ * 4, bar);
    if (seg) bulk_load(st + 3 * BQ, p.seg_q + static_cast<size_t>(b) * p.Tq + j * BQ, BQ * 4, bar);
  };

  if (producer) {
    if (lt == 0) {
      mbar_expect_tx(resident, 2 * L::KV * 4);
      tma_tile(Ks, &maps.k, resident, k0, h, b);
      tma_tile(Vs, &maps.v, resident, k0, h, b);
      for (int j = 0; j < S - 1 && j < n_tiles; ++j) issue(j);
    }
    mbar_wait(resident, 0);
    round_planes<L::KV>(Ks, lt);
    round_planes<L::KV>(Vs, lt);
    fence_proxy_async();
  }
  __syncthreads();  // k and v are rounded

  if (producer) {
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      mbar_wait(&landed[s], (j / S) & 1);
      round_transpose<DKP>(q_of(s), qt_of(s), lt);
      round_transpose<DKP>(do_of(s), dt_of(s), lt);
      if (lt < BQ / 4) {  // l -> 1 / l, once per query
        float4* lq = reinterpret_cast<float4*>(stat_of(s) + BQ) + lt;
        const float4 v = *lq;
        *lq = make_float4(1.f / v.x, 1.f / v.y, 1.f / v.z, 1.f / v.w);
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
      // tile j + S - 1 goes where tile j - 1 was, once the consumer has read it
      const int jn = j + S - 1;
      if (lt == 0 && jn < n_tiles) {
        if (jn >= S) mbar_wait(&empty[jn % S], (jn / S - 1) & 1);
        issue(jn);
      }
    }
    return;
  }

  // consumer
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  const int id_a = seg ? p.seg_kv[static_cast<size_t>(b) * p.Tk + key_a] : 0;
  const int id_b = seg ? p.seg_kv[static_cast<size_t>(b) * p.Tk + key_b] : 0;
  float dka[DKP / 2], dva[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    mbar_wait(&full[st], (j / S) & 1);
    const float* stat = stat_of(st);

    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DKP / 8; ++ks) {
      wgmma_ss<BQ, true>(s, plane_desc(Ks, ks, BKV * 4), plane_desc(q_of(st), ks, BQ * 4));
      wgmma_ss<BQ, true>(dp, plane_desc(Vs, ks, BKV * 4), plane_desc(do_of(st), ks, BQ * 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_operand(s[i]);
      fence_operand(dp[i]);
    }

    // p^T = exp(x - m) / l and ds^T = ((dp - di) p) * scale, per query column
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int qc = 8 * jn + 2 * t;
      const float2 m2 = *reinterpret_cast<const float2*>(stat + qc);
      const float2 il2 = *reinterpret_cast<const float2*>(stat + BQ + qc);
      const float2 di2 = *reinterpret_cast<const float2*>(stat + 2 * BQ + qc);
      const int2 id2 = seg ? *reinterpret_cast<const int2*>(stat + 3 * BQ + qc) : make_int2(0, 0);
      const float mq[2] = {m2.x, m2.y}, il[2] = {il2.x, il2.y}, di[2] = {di2.x, di2.y};
      const int idq[2] = {id2.x, id2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_a = s[4 * jn + e] * p.sm_scale, x_b = s[4 * jn + 2 + e] * p.sm_scale;
        if (seg) {
          x_a += (id_a == idq[e]) ? 0.f : p.mask_value;
          x_b += (id_b == idq[e]) ? 0.f : p.mask_value;
        }
        const float p_a = exp2f((x_a - mq[e]) * kLog2e) * il[e];
        const float p_b = exp2f((x_b - mq[e]) * kLog2e) * il[e];
        s[4 * jn + e] = round_tf32(p_a);
        s[4 * jn + 2 + e] = round_tf32(p_b);
        dp[4 * jn + e] = round_tf32(((dp[4 * jn + e] - di[e]) * p_a) * p.sm_scale);
        dp[4 * jn + 2 + e] = round_tf32(((dp[4 * jn + 2 + e] - di[e]) * p_b) * p.sm_scale);
      }
    }
    // p^T and ds^T stay in registers as the A operand (RS form); they are
    // not touched again until the wait below
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int ks = 0; ks < BQ / 8; ++ks) {
      acc_a_frag(pa[ks], s, ks);
      acc_a_frag(sa[ks], dp, ks);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BQ / 8; ++ks) wgmma_rs_tf32<DKP>(dva, pa[ks], plane_desc(dt_of(st), ks, L::PT));
#pragma unroll
    for (int ks = 0; ks < BQ / 8; ++ks) wgmma_rs_tf32<DKP>(dka, sa[ks], plane_desc(qt_of(st), ks, L::PT));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);  // the stage is read
  }
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) {
    fence_operand(dka[i]);
    fence_operand(dva[i]);
  }
  store_rows<DKP>(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.t, dka, k0, p.hd, warp, g, t);
  store_rows<DKP>(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.t, dva, k0, p.hd, warp, g, t);
}

// dq for one (batch, head, 64-row query block). One producer thread keeps
// S - 1 tiles of k and v (and their segment ids) in flight by TMA; as each
// lands, the producer warpgroup rounds it to TF32 in place and writes the
// transpose of k. The consumer warpgroup, per tile: s = q k^T and dp = do
// v^T (M = 64 queries, N = 32 keys, K = DKP, both operands in shared
// memory), ds in registers, rounded to TF32, then dq += ds k (M = 64
// queries, N = DKP, K = 32 keys) with ds as the A operand in registers and
// the transpose of k as B.
template <int DKP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const BwdParams p, const __grid_constant__ TileMaps maps) {
  using L = DqLayout<DKP>;
  constexpr int S = L::S;
  float* Qs = smem_base();
  float* Ds = Qs + L::QD;
  float* ring = Ds + L::QD;  // stage s: k, v, k^T, the keys' segment ids
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::STAGE);
  uint64_t* empty = full + S;
  uint64_t* landed = empty + S;
  uint64_t* resident = landed + S;
  auto k_of = [&](int s) { return ring + s * L::STAGE; };
  auto v_of = [&](int s) { return ring + s * L::STAGE + L::KV; };
  auto kt_of = [&](int s) { return ring + s * L::STAGE + 2 * L::KV; };
  auto seg_of = [&](int s) { return reinterpret_cast<const int*>(ring + s * L::STAGE + 2 * L::KV + L::TR); };

  const int tid = threadIdx.x, lt = tid & (WG - 1);
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * BQD;
  const int n_tiles = p.Tk / BKD;
  const bool seg = p.seg_q != nullptr;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], WG);
      mbar_init(&empty[s], WG);
      mbar_init(&landed[s], 1);
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised

  const bool producer = tid >= WG;
  // tile j's k and v (a box each) and the keys' segment ids
  auto issue = [&](int j) {
    const int s = j % S;
    uint64_t* bar = &landed[s];
    mbar_expect_tx(bar, 2 * L::KV * 4 + (seg ? BKD * 4 : 0));
    tma_tile(k_of(s), &maps.k, bar, j * BKD, h, b);
    tma_tile(v_of(s), &maps.v, bar, j * BKD, h, b);
    if (seg)
      bulk_load(const_cast<int*>(seg_of(s)), p.seg_kv + static_cast<size_t>(b) * p.Tk + j * BKD, BKD * 4, bar);
  };

  if (producer) {
    if (lt == 0) {
      mbar_expect_tx(resident, 2 * L::QD * 4);
      tma_tile(Qs, &maps.q, resident, q0, h, b);
      tma_tile(Ds, &maps.dout, resident, q0, h, b);
      for (int j = 0; j < S - 1 && j < n_tiles; ++j) issue(j);
    }
    mbar_wait(resident, 0);
    round_planes<L::QD>(Qs, lt);
    round_planes<L::QD>(Ds, lt);
    fence_proxy_async();
  }
  __syncthreads();  // q and do are rounded

  if (producer) {
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      mbar_wait(&landed[s], (j / S) & 1);
      round_transpose<DKP>(k_of(s), kt_of(s), lt);
      round_planes<L::KV>(v_of(s), lt);
      fence_proxy_async();
      mbar_arrive(&full[s]);
      const int jn = j + S - 1;
      if (lt == 0 && jn < n_tiles) {
        if (jn >= S) mbar_wait(&empty[jn % S], (jn / S - 1) & 1);
        issue(jn);
      }
    }
    return;
  }

  // consumer
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  const size_t rows = static_cast<size_t>(blockIdx.y) * p.Tq;
  const float m_a = p.m[rows + row_a], m_b = p.m[rows + row_b];
  const float inv_la = 1.f / p.l[rows + row_a], inv_lb = 1.f / p.l[rows + row_b];
  const float di_a = p.di[rows + row_a], di_b = p.di[rows + row_b];
  const int id_a = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_a] : 0;
  const int id_b = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_b] : 0;
  float dqa[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) dqa[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    mbar_wait(&full[st], (j / S) & 1);

    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DKP / 8; ++ks) {
      wgmma_ss<BKD, true>(s, plane_desc(Qs, ks, BQD * 4), plane_desc(k_of(st), ks, BKD * 4));
      wgmma_ss<BKD, true>(dp, plane_desc(Ds, ks, BQD * 4), plane_desc(v_of(st), ks, BKD * 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_operand(s[i]);
      fence_operand(dp[i]);
    }

    // ds = ((dp - di) p) * scale with p = exp(x - m) / l, kept in s
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int2 id2 = seg ? *reinterpret_cast<const int2*>(seg_of(st) + 8 * jn + 2 * t) : make_int2(0, 0);
      const int idk[2] = {id2.x, id2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_a = s[4 * jn + e] * p.sm_scale, x_b = s[4 * jn + 2 + e] * p.sm_scale;
        if (seg) {
          x_a += (id_a == idk[e]) ? 0.f : p.mask_value;
          x_b += (id_b == idk[e]) ? 0.f : p.mask_value;
        }
        const float p_a = exp2f((x_a - m_a) * kLog2e) * inv_la;
        const float p_b = exp2f((x_b - m_b) * kLog2e) * inv_lb;
        s[4 * jn + e] = round_tf32(((dp[4 * jn + e] - di_a) * p_a) * p.sm_scale);
        s[4 * jn + 2 + e] = round_tf32(((dp[4 * jn + 2 + e] - di_b) * p_b) * p.sm_scale);
      }
    }
    // ds stays in registers as the A operand (RS form); it is not touched
    // again until the wait below
    uint32_t sa[4][4];
#pragma unroll
    for (int ks = 0; ks < BKD / 8; ++ks) acc_a_frag(sa[ks], s, ks);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKD / 8; ++ks) wgmma_rs_tf32<DKP>(dqa, sa[ks], plane_desc(kt_of(st), ks, L::PT));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);  // the stage is read
  }
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) fence_operand(dqa[i]);
  store_rows<DKP>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.t, dqa, q0, p.hd, warp, g, t);
}

// ---------------------------------------------------------------------------
// The forward kernel: warpgroup MMA (wgmma), K and V tiles by TMA

constexpr int FWD_BM = 64;  // forward: query rows per consumer warpgroup (the wgmma's M)

// Forward tiles come by TMA in the 128-byte-swizzled K-major layout: an
// R-row tile of DKP columns is DKP / 32 chunks, each R rows of 128 bytes (32
// floats) in TMA's SWIZZLE_128B order (16-byte unit u of row r stored at
// unit u ^ (r % 8)), chunks R * 32 floats apart, each on a 1024-byte
// boundary. (A box of the backward's plane layout is 16 bytes wide, which
// TMA moves as many small requests.) A wgmma k step (8 columns, 32 bytes)
// starts (k % 4) * 32 bytes into chunk k / 4.
__device__ __forceinline__ uint64_t sw128_desc(const float* tile, int k_step, int rows) {
  return desc_sw128(smem_u32(tile + (k_step >> 2) * rows * 32) + (k_step & 3) * 32);
}

// One R-row tile (rows [row, row + R) of head h of batch b) of a
// `swizzled_map`, DKP / 32 boxes of 32 columns, into shared memory, its
// bytes counted on `bar`; columns past the head width come as zeros.
template <int DKP>
__device__ __forceinline__ void tma_rows(float* dst, const CUtensorMap* map, uint64_t* bar, int rows, int row,
                                         int h, int b) {
#pragma unroll
  for (int i = 0; i < DKP / 32; ++i)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
        "%6}], [%2];\n" ::"r"(smem_u32(dst + i * rows * 32)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(32 * i), "r"(row), "r"(h), "r"(b)
        : "memory");
}

// `round_transpose`'s transpose, rounded, out of place, from an R-row
// swizzled tile: each 8 rows r0..r7 of `tile` become columns r0, r2, r4, r6
// | r1, r3, r5, r7 of `tr` (two planes), a plane tile of DKP rows and R / 4
// planes, DKP * 4 + 4 floats apart. A warp takes one 16-byte column unit of
// 32 rows: its reads fall on 8 different units of each 8 rows, its writes
// on 32 different banks.
template <int R, int DKP>
__device__ __forceinline__ void transpose_rows(const float* tile, float* tr, int tid) {
  constexpr int PT = DKP * 4 + 4;
#pragma unroll
  for (int it = 0; it < R * DKP / (4 * WG); ++it) {
    const int i = tid + it * WG, r = i % R, pl = i / R;
    const float* s = tile + (pl >> 3) * R * 32 + r * 32 + (((pl & 7) ^ (r & 7)) << 2);
    const float4 v = round_tf32x4(*reinterpret_cast<const float4*>(s));
    float* d = tr + ((r >> 3) * 2 + (r & 1)) * PT + pl * 16 + ((r >> 1) & 3);
    d[0] = v.x;
    d[4] = v.y;
    d[8] = v.z;
    d[12] = v.w;
  }
}

// keeps the compiler from reusing an A fragment's registers before the
// wgmma that reads them is complete
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// `n` threads (whole warps) meet at named barrier `id` (1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory of the forward, in floats, from a 1024-byte boundary: a
// ring of 3 BN-key K tiles (swizzled, rounded to TF32 in place: a tile is
// held from its load until the consumers are done with it); 2 landing
// tiles of V (held until transposed); NC consumers' q tiles (64 rows each,
// swizzled); 2 stages of V's transpose (rounded, rows in `transpose_rows`'
// order) and the keys' segment ids; the mbarriers (per K slot: done; per
// landing tile: landed; per stage: full; q's). 223,296 bytes at DKP = 96
// with NC = 2; 181,824 at DKP = 128 (BN = 32).
template <int DKP, int NC>
struct FwdLayout {
  static constexpr int BN = DKP <= 96 ? 64 : 32;
  static constexpr int RK = 3;  // K slots
  static constexpr int S = 2;   // V landing tiles, and stages of V^T
  static constexpr int PT = DKP * 4 + 4;
  static constexpr int Q = FWD_BM * DKP;  // one consumer's q
  static constexpr int KV = BN * DKP;     // one K or V tile
  static constexpr int VT = (BN / 4) * PT;
  static constexpr int BYTES = ((RK + S) * KV + NC * Q + S * (VT + BN)) * 4 + (RK + 2 * S + 1) * 8 + 1024;
};

// The TMA maps of a forward call's operands (`swizzled_map`): q in boxes
// of 64 rows, K and V in boxes of BN rows
struct FwdMaps {
  CUtensorMap q, k, v;
};

// o (and m, l) for one (batch, head, NC x 64 query rows); the design is in
// the header. Consumer warpgroups 0..NC-1, the producer warpgroup NC; a
// consumer whose rows lie past Tq leaves at once. Tile j: K in slot j % 3,
// V in landing tile j % 2, V^T and ids in stage j % 2. The producer issues
// tile j + 2 once tile j + 1 is processed and the consumers are done with
// tile j - 1 (its K slot), so two tiles load while one is consumed.
template <int DKP, int NC>
__global__ void __launch_bounds__((NC + 1) * WG, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ FwdMaps maps) {
  using L = FwdLayout<DKP, NC>;
  constexpr int BN = L::BN, RK = L::RK, S = L::S;
  extern __shared__ __align__(128) unsigned char fwd_smem[];  // rounded up to 1024 bytes: BYTES holds the slack
  float* Ks = reinterpret_cast<float*>(fwd_smem + ((1024u - (smem_u32(fwd_smem) & 1023u)) & 1023u));
  float* land_v = Ks + RK * L::KV;
  float* Qs = land_v + S * L::KV;
  float* VTs = Qs + NC * L::Q;
  int* segs = reinterpret_cast<int*>(VTs + S * L::VT);
  uint64_t* done = reinterpret_cast<uint64_t*>(segs + S * BN);  // [RK]: the consumers are done with a K slot
  uint64_t* landed = done + RK;                                  // [S]: tile j's K and V have landed
  uint64_t* full = landed + S;                                   // [S]: tile j is rounded and transposed
  uint64_t* q_bar = full + S;
  auto k_of = [&](int j) { return Ks + (j % RK) * L::KV; };
  auto vt_of = [&](int j) { return VTs + (j % S) * L::VT; };
  auto seg_of = [&](int j) { return segs + (j % S) * BN; };
  // wait until the consumers are done with tile i
  auto wait_done = [&](int i) { mbar_wait(&done[i % RK], (i / RK) & 1); };

  const int tid = threadIdx.x, lt = tid & (WG - 1), wg = tid / WG;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * (NC * FWD_BM);
  const int n_act = min(NC, (p.Tq - q0) / FWD_BM);  // consumers with rows
  const int n_tiles = p.Tk / BN;
  const bool seg = p.seg_q != nullptr;
  if (tid == 0) {
    for (int s = 0; s < RK; ++s) mbar_init(&done[s], n_act * WG);
    for (int s = 0; s < S; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], WG);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised

  if (wg == NC) {  // producer
    auto issue = [&](int j) {
      uint64_t* bar = &landed[j % S];
      mbar_expect_tx(bar, 2 * L::KV * 4);
      tma_rows<DKP>(k_of(j), &maps.k, bar, BN, j * BN, h, b);
      tma_rows<DKP>(land_v + (j % S) * L::KV, &maps.v, bar, BN, j * BN, h, b);
    };
    if (lt == 0) {
      mbar_expect_tx(q_bar, n_act * L::Q * 4);
      for (int w = 0; w < n_act; ++w) tma_rows<DKP>(Qs + w * L::Q, &maps.q, q_bar, FWD_BM, q0 + w * FWD_BM, h, b);
      for (int j = 0; j < S && j < n_tiles; ++j) issue(j);
    }
    const int* skv = seg ? p.seg_kv + static_cast<size_t>(b) * p.Tk : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&landed[j % S], (j / S) & 1);
      if (j >= S) wait_done(j - S);  // stage j % S (V^T, ids) is free
      round_planes<L::KV>(k_of(j), lt);
      transpose_rows<BN, DKP>(land_v + (j % S) * L::KV, vt_of(j), lt);
      if (seg && lt < BN) seg_of(j)[lt] = skv[j * BN + lt];
      fence_proxy_async();
      named_barrier(NC + 1, WG);  // the landing tile is read
      mbar_arrive(&full[j % S]);
      // tile j + 2 goes into landing tile j % 2 and K slot (j + 2) % 3,
      // which held tile j - 1
      if (lt == 0 && j + S < n_tiles) {
        if (j >= 1) wait_done(j - 1);
        issue(j + S);
      }
    }
    return;
  }
  if (wg >= n_act) return;

  // consumer: its q tile, rounded in place once
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Qw = Qs + wg * L::Q;
  mbar_wait(q_bar, 0);
  round_planes<L::Q>(Qw, lt);
  fence_proxy_async();
  named_barrier(1 + wg, WG);

  const int row_a = q0 + wg * FWD_BM + 16 * warp + g, row_b = row_a + 8;
  const int id_a = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_a] : 0;
  const int id_b = seg ? p.seg_q[static_cast<size_t>(b) * p.Tq + row_b] : 0;
  float o[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(&full[j % S], (j / S) & 1);

    // s = q k^T: rows g and g + 8 of this warp's 16, columns 8 jn + 2 t + e
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DKP / 8; ++ks)
      wgmma_ss<BN, true>(s, sw128_desc(Qw, ks, FWD_BM), sw128_desc(k_of(j), ks, BN));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(s[i]);

    // scale, then the segment mask, then the online softmax
    const int* sk = seg_of(j);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int2 id2 = seg ? *reinterpret_cast<const int2*>(sk + 8 * jn + 2 * t) : make_int2(0, 0);
      const int idk[2] = {id2.x, id2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x_a = s[4 * jn + e] * p.sm_scale, x_b = s[4 * jn + 2 + e] * p.sm_scale;
        if (seg) {
          x_a += (id_a == idk[e]) ? 0.f : p.mask_value;
          x_b += (id_b == idk[e]) ? 0.f : p.mask_value;
        }
        s[4 * jn + e] = x_a;
        s[4 * jn + 2 + e] = x_b;
        mx_a = fmaxf(mx_a, x_a);
        mx_b = fmaxf(mx_b, x_b);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // exp(x) as exp2(x * log2 e): one ex2 instead of expf's longer sequence
    const float al_a = exp2f((m_a - mn_a) * kLog2e), al_b = exp2f((m_b - mn_b) * kLog2e);
    float rs_a = 0.f, rs_b = 0.f;
    // p in f32 for the sums, rounded (cvt.rna) into the A fragments of p v,
    // whose B rows are in `transpose_rows`' order
    uint32_t pa[BN / 8][4];
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * jn + e] = exp2f((s[4 * jn + e] - mn_a) * kLog2e);
        s[4 * jn + 2 + e] = exp2f((s[4 * jn + 2 + e] - mn_b) * kLog2e);
        rs_a += s[4 * jn + e];
        rs_b += s[4 * jn + 2 + e];
      }
      pa[jn][0] = tf32(s[4 * jn]);
      pa[jn][1] = tf32(s[4 * jn + 2]);
      pa[jn][2] = tf32(s[4 * jn + 1]);
      pa[jn][3] = tf32(s[4 * jn + 3]);
    }
    l_a = al_a * l_a + quad_sum(rs_a);
    l_b = al_b * l_b + quad_sum(rs_b);
    m_a = mn_a;
    m_b = mn_b;
    // o was complete at the last wait: rescale it, then o += p v
#pragma unroll
    for (int jd = 0; jd < DKP / 8; ++jd) {
      o[4 * jd] *= al_a;
      o[4 * jd + 1] *= al_a;
      o[4 * jd + 2] *= al_b;
      o[4 * jd + 3] *= al_b;
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) wgmma_rs_tf32<DKP>(o, pa[ks], plane_desc(vt_of(j), ks, L::PT));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DKP / 2; ++i) fence_operand(o[i]);
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_operand(pa[ks][i]);
    }
    mbar_arrive(&done[j % RK]);  // tile j's K slot and stage are read
  }

  const float inv_a = (l_a == 0.f) ? 1.f : 1.f / l_a;
  const float inv_b = (l_b == 0.f) ? 1.f : 1.f / l_b;
  float* ob = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int jd = 0; jd < DKP / 8; ++jd) {
    if (jd * 8 >= p.dk) break;
    const int col = jd * 8 + 2 * t;
    *reinterpret_cast<float2*>(ob + row_a * p.so.t + col) = make_float2(o[4 * jd] * inv_a, o[4 * jd + 1] * inv_a);
    *reinterpret_cast<float2*>(ob + row_b * p.so.t + col) =
        make_float2(o[4 * jd + 2] * inv_b, o[4 * jd + 3] * inv_b);
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

// Launch `kernel` on a (tiles, B * H) grid of `threads` with `smem` bytes of
// dynamic shared memory; the limit is set per device, so it is set on every
// launch that needs it.
template <typename... A>
cudaError_t launch(void (*kernel)(A...), int tiles, int BH, int threads, size_t smem, cudaStream_t stream,
                   const A&... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(tiles, BH), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The TMA map of one [B, H, T, hd] f32 operand (element strides `st`, unit
// last stride) whose box is an R-row tile in the plane layout: dims (4
// floats, T rows, hd / 4 planes, H, B), box (4, R, DKP / 4, 1, 1); the
// planes past hd / 4 come as zeros.
CUresult plane_map(CUtensorMap* map, const float* x, int B, int H, int T, int hd, const Strides& st, int R,
                   int DKP) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[5] = {4, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(hd / 4),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(st.t) * 4, 16, static_cast<cuuint64_t>(st.h) * 4,
                                 static_cast<cuuint64_t>(st.b) * 4};
  const cuuint32_t box[5] = {4, static_cast<cuuint32_t>(R), static_cast<cuuint32_t>(DKP / 4), 1, 1};
  const cuuint32_t estrides[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(x), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of q, k, v and do, with boxes of rq rows for q and do and rk
// rows for k and v
CUresult tile_maps(TileMaps* maps, const BwdParams& p, int B, int rq, int rk, int DKP) {
  CUresult r = plane_map(&maps->q, p.q, B, p.H, p.Tq, p.hd, p.sq, rq, DKP);
  if (r == CUDA_SUCCESS) r = plane_map(&maps->dout, p.dout, B, p.H, p.Tq, p.hd, p.sdo, rq, DKP);
  if (r == CUDA_SUCCESS) r = plane_map(&maps->k, p.k, B, p.H, p.Tk, p.hd, p.sk, rk, DKP);
  if (r == CUDA_SUCCESS) r = plane_map(&maps->v, p.v, B, p.H, p.Tk, p.hd, p.sv, rk, DKP);
  return r;
}

template <int DKP>
int launch_dkv(const BwdParams& p, int B, cudaStream_t s) {
  TileMaps maps;
  const CUresult r = tile_maps(&maps, p, B, BQ, BKV, DKP);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  return static_cast<int>(launch(flash_bwd_dkv_wgmma_kernel<DKP>, p.Tk / BKV, B * p.H, BWD_THREADS,
                                 DkvLayout<DKP>::BYTES, s, p, maps));
}

template <int DKP>
int launch_dq(const BwdParams& p, int B, cudaStream_t s) {
  TileMaps maps;
  const CUresult r = tile_maps(&maps, p, B, BQD, BKD, DKP);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  return static_cast<int>(launch(flash_bwd_dq_wgmma_kernel<DKP>, p.Tq / BQD, B * p.H, BWD_THREADS,
                                 DqLayout<DKP>::BYTES, s, p, maps));
}

// The TMA map of one [B, H, T, hd] f32 operand (element strides `st`,
// unit last stride) whose box is 32 columns x R rows with SWIZZLE_128B:
// dims (hd, T, H, B), box (32, R, 1, 1); columns past hd come as zeros.
CUresult swizzled_map(CUtensorMap* map, const float* x, int B, int H, int T, int hd, const Strides& st, int R) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 4, static_cast<cuuint64_t>(st.h) * 4,
                                 static_cast<cuuint64_t>(st.b) * 4};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(R), 1, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The forward is a few tens of microseconds on the card, so its host path is
// kept short: the shared-memory limit is set once per device and kernel
// (devices 0-63), not at every launch as `launch` does.
template <int DKP, int NC>
int launch_fwd_nc(const Params& p, int B, int dev, cudaStream_t s) {
  using L = FwdLayout<DKP, NC>;
  static std::atomic<unsigned long long> limit_set{0};
  FwdMaps maps;
  CUresult r = swizzled_map(&maps.q, p.q, B, p.H, p.Tq, p.dk, p.sq, FWD_BM);
  if (r == CUDA_SUCCESS) r = swizzled_map(&maps.k, p.k, B, p.H, p.Tk, p.dk, p.sk, L::BN);
  if (r == CUDA_SUCCESS) r = swizzled_map(&maps.v, p.v, B, p.H, p.Tk, p.dk, p.sv, L::BN);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DKP, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int tiles = (p.Tq + NC * FWD_BM - 1) / (NC * FWD_BM);
  flash_fwd_kernel<DKP, NC><<<dim3(tiles, B * p.H), (NC + 1) * WG, L::BYTES, s>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

// Two consumer warpgroups per block (128 query rows, each K/V tile landed
// once for both) when such blocks fill the card's SMs; else one, which
// doubles the blocks of a small grid.
template <int DKP>
int launch_fwd(const Params& p, int B, cudaStream_t s) {
  static std::atomic<int> sms_of[64];  // SMs per device, 0 until asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = dev < 64 ? sms_of[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (dev < 64) sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const long long blocks = static_cast<long long>(B) * p.H * ((p.Tq + 2 * FWD_BM - 1) / (2 * FWD_BM));
  return blocks >= sms ? launch_fwd_nc<DKP, 2>(p, B, dev, s) : launch_fwd_nc<DKP, 1>(p, B, dev, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }
bool aligned8(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 7u) == 0; }

// The shapes every kernel takes: T a multiple of 64, dk a multiple of 8 up to 128.
bool shapes_ok(int B, int H, int Tq, int Tk, int dk, const void* seg_q, const void* seg_kv) {
  return B >= 1 && H >= 1 && B * H <= 65535 && Tq >= 64 && Tq % 64 == 0 && Tk >= 64 &&
         Tk % 64 == 0 && dk >= 8 && dk <= 128 && dk % 8 == 0 &&
         (seg_q == nullptr) == (seg_kv == nullptr);
}

// The backward's operands come by TMA and bulk copies: 16-byte aligned
// bases, strides in whole 16 bytes (m, l, di and the segment ids are read
// 128 bytes at a time); outputs are written as float2.
bool bwd_layout_ok(const BwdParams& p) {
  const Strides in[] = {p.sq, p.sk, p.sv, p.sdo};
  const Strides out[] = {p.sdq, p.sdk, p.sdv};
  bool ok = aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.dout) && aligned16(p.m) &&
            aligned16(p.l) && aligned16(p.di) && aligned16(p.seg_q) && aligned16(p.seg_kv) &&
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
                 {sq_b, sq_h, sq_t}, {sk_b, sk_h, sk_t}, {sv_b, sv_h, sv_t}, {so_b, so_h, so_t},
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
