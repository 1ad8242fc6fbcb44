// Matmul rate probe for Hopper (sm_90a): out = x @ w applied `repeat`
// times per row, x [M, 128], w [128, 128] ([K, N]: row k holds the
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
// 1979 TOP/s). The bytes still take 58% of that time, so loads and stores
// must overlap the products.
//
// Design: warpgroup MMA (wgmma) fed by TMA, one persistent block per SM
// walking over 64-row tiles (tile i of the block: blockIdx.x + i*gridDim.x).
//  - w lands once per block by TMA (one unswizzled [128 x 128] box) in a
//    staging area, and the consumers write its transpose, [N][K] with K
//    contiguous in the 128-byte-swizzled K-major layout that the B operand
//    reads (an 8-bit wgmma reads B K-major only; bf16 takes the same path).
//  - A producer warp lands x tiles (64 rows x 128, 128-byte-swizzled
//    boxes, zero-filled past M) into a ring of 6 slots behind full and
//    empty mbarriers.
//  - Three consumer warpgroups, each one tile at a time: the first product
//    in SS form (A = the x tile in shared memory), after which the slot is
//    free; products 2..repeat in RS form, the accumulator rounded to bf16
//    (or wrapped to int8) becoming the A registers of the next product. In
//    bf16 the m64nNk16 f32 accumulator holds, per 16 columns, exactly the
//    bf16 A fragment. In int8 the k32 A fragment wants 4 consecutive k
//    bytes per thread where the accumulator holds pairs, so the k order
//    inside each 32-column chunk is permuted (`int8_logical_k`) in the A
//    registers and in a second, permuted shared copy of w alike, which
//    leaves the product unchanged; the first product reads the copy in
//    natural order. Each product is waited for (wgmma.wait_group 0) before
//    its accumulator is converted, so A registers never change while a
//    wgmma reads them; the other two warpgroups' products keep the tensor
//    cores busy meanwhile.
//  - Epilogue: the result rounded (bf16) or wrapped (int8) into the
//    warpgroup's own 128-byte-swizzled output tile, then one TMA store
//    (clipped at M) that runs while the warpgroup's next tile is computed.
// Shared memory: 32 KB of w copies, 6 x 16 KB (bf16) or 6 x 8 KB (int8) of
// ring, 3 x 16 KB or 3 x 8 KB of output tiles (w's staging area overlays
// them): 177 KB in bf16, 105 KB in int8, one block per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int K = 128;                      // = N
constexpr int BM = 64;                      // rows per tile: one wgmma M
constexpr int CONSUMERS = 3;                // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int SLOTS = 6;                    // x ring depth
constexpr int W_BYTES = 32768;              // the shared copies of w (bf16: one; int8: natural and permuted)

template <bool INT8>
struct Mode {
  static constexpr int ELEM = INT8 ? 1 : 2;
  static constexpr int TILE = BM * K * ELEM;  // bytes of a 64-row tile
  static constexpr int BOXES = K * ELEM / 128;  // 128-byte-wide boxes per tile row
  static constexpr int KSTEPS = K * ELEM / 32;  // 32-byte k steps per product
  static constexpr int SMEM = 1024 + W_BYTES + SLOTS * TILE + CONSUMERS * TILE + (2 * SLOTS + 1) * 8;
};

// logical k (inside a 32-column chunk) of physical column p for the int8
// A fragment built from accumulators: logical 4*tig + b holds physical
// 2*tig + b (b < 2) or 8 + 2*tig + b - 2 (b >= 2), per 16-column half
__device__ __forceinline__ int int8_logical_k(int k) {
  const int chunk = k & ~31, p = k & 31, h = p >> 4, q = p & 15;
  const int tig = (q < 8 ? q : q - 8) >> 1, b = (q & 1) + (q < 8 ? 0 : 2);
  return chunk + 16 * h + 4 * tig + b;
}

// byte offset of (row, byte column c) in a tile of 128-byte rows written with
// the 128-byte swizzle (16-byte chunk c/16 of row r lands at chunk c/16 ^ r%8)
__device__ __forceinline__ int sw128(int row, int c) {
  return row * 128 + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// keep the compiler from moving reads of an accumulator across a wgmma wait
__device__ __forceinline__ void fence_acc(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_acc(float& r) { fence_operand(r); }

// ---------------------------------------------------------------------------
// wgmma at m64n128: D[64 x 128] (+)= A B^T, B K-major in shared memory
// (`desc_b`), A K-major in shared memory (SS) or in registers (RS: this
// thread's fragment of its warp's 16 rows, as mma.sync's m16n8k16 bf16 or
// m16n8k32 s8 A fragment). `acc` 0 overwrites D. d[4j..4j+3] hold columns
// 8j..8j+7 as in `wgmma_ss`.

#define D64_REGS                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define D8(X, i) X(i), X(i + 1), X(i + 2), X(i + 3), X(i + 4), X(i + 5), X(i + 6), X(i + 7)
#define D64(X) D8(X, 0), D8(X, 8), D8(X, 16), D8(X, 24), D8(X, 32), D8(X, 40), D8(X, 48), D8(X, 56)
#define OUT_F(i) "+f"(d[i])
#define OUT_R(i) "+r"(d[i])

__device__ __forceinline__ void wgmma_bf16_ss(float* d, uint64_t desc_a, uint64_t desc_b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"
               : D64(OUT_F)
               : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_rs(float* d, const uint32_t (&a)[4], uint64_t desc_b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64_REGS
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : D64(OUT_F)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_s8_ss(int* d, uint64_t desc_a, uint64_t desc_b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D64_REGS ", %64, %65, p;\n}\n"
               : D64(OUT_R)
               : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t (&a)[4], uint64_t desc_b, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " D64_REGS ", {%64, %65, %66, %67}, %68, p;\n}\n"
               : D64(OUT_R)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

#undef D64_REGS
#undef D8
#undef D64
#undef OUT_F
#undef OUT_R

// ---------------------------------------------------------------------------
// TMA stores (bulk async group of the issuing thread)

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// the stores issued so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// the stores issued so far are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
    probe_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap, int n_tiles, int repeat) {
  using P = Mode<INT8>;
  using Acc = std::conditional_t<INT8, int, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* wt = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // w's shared copies
  unsigned char* ring = wt + W_BYTES;
  unsigned char* outb = ring + SLOTS * P::TILE;  // one output tile per consumer; w's staging first
  uint64_t* full = reinterpret_cast<uint64_t*>(outb + CONSUMERS * P::TILE);
  uint64_t* empty = full + SLOTS;
  uint64_t* wbar = empty + SLOTS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: w once, then the block's x tiles into the ring
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      mbar_expect_tx(wbar, K * K * P::ELEM);
      tma_load_2d(outb, &wmap, wbar, 0, 0);
      for (int i = 0;; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile >= n_tiles) break;
        const int s = i % SLOTS;
        mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::TILE);
        for (int b = 0; b < P::BOXES; ++b)
          tma_load_2d(ring + s * P::TILE + b * BM * 128, &xmap, &full[s], b * 128 / P::ELEM, tile * BM);
      }
    }
    return;
  }

  // consumers: w's transpose into the B layout, [N][K] in 128-byte-swizzled
  // rows (bf16: K in two 64-column blocks of 16 KB; int8: the natural copy,
  // then the permuted one)
  mbar_wait(wbar, 0);
  for (int i = tid; i < K * K; i += CONSUMERS * 128) {
    const int k = i / K, n = i % K;
    if constexpr (INT8) {
      const unsigned char v = outb[i];
      wt[sw128(n, k)] = v;
      wt[16384 + sw128(n, int8_logical_k(k))] = v;
    } else {
      const uint16_t v = reinterpret_cast<const uint16_t*>(outb)[i];
      *reinterpret_cast<uint16_t*>(wt + (k >> 6) * 16384 + sw128(n, (k & 63) * 2)) = v;
    }
  }
  fence_async_smem();
  named_bar(1, CONSUMERS * 128);

  const int wg = warp >> 2, wtid = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  const uint32_t wt_u = smem_u32(wt);
  unsigned char* mine = outb + wg * P::TILE;
  // the B descriptor of k step ks: bf16 in two 16 KB column blocks; int8
  // natural (perm 0) or permuted (perm 1)
  auto desc_w = [&](int ks, int perm) -> uint64_t {
    return desc_sw128(INT8 ? wt_u + perm * 16384 + ks * 32 : wt_u + (ks >> 2) * 16384 + (ks & 3) * 32);
  };

  Acc d[64];
  for (int i = wg;; i += CONSUMERS) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= n_tiles) break;
    const int s = i % SLOTS;
    mbar_wait(&full[s], (i / SLOTS) & 1);
    // product 1: A from the ring slot (k step ks: box ks/4, 32 bytes each)
    const uint32_t xa = smem_u32(ring + s * P::TILE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KSTEPS; ++ks) {
      const uint64_t da = desc_sw128(xa + (ks >> 2) * BM * 128 + (ks & 3) * 32);
      if constexpr (INT8)
        wgmma_s8_ss(d, da, desc_w(ks, 0), ks);
      else
        wgmma_bf16_ss(d, da, desc_w(ks, 0), ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) fence_acc(d[j]);
    if (lane == 0) mbar_arrive(&empty[s]);

    // products 2..repeat: A from the accumulator (converted only once the
    // product before is complete)
    for (int rep = 1; rep < repeat; ++rep) {
      uint32_t a[P::KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < P::KSTEPS; ++ks) {
        if constexpr (INT8) {
          const int* q = d + 16 * ks;
          a[ks][0] = pack_s8(q[0], q[1], q[4], q[5]);
          a[ks][1] = pack_s8(q[2], q[3], q[6], q[7]);
          a[ks][2] = pack_s8(q[8], q[9], q[12], q[13]);
          a[ks][3] = pack_s8(q[10], q[11], q[14], q[15]);
        } else {
          const float* q = d + 8 * ks;
          a[ks][0] = pack_bf16(q[0], q[1]);
          a[ks][1] = pack_bf16(q[2], q[3]);
          a[ks][2] = pack_bf16(q[4], q[5]);
          a[ks][3] = pack_bf16(q[6], q[7]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P::KSTEPS; ++ks) {
        if constexpr (INT8)
          wgmma_s8_rs(d, a[ks], desc_w(ks, 1), ks);
        else
          wgmma_bf16_rs(d, a[ks], desc_w(ks, 0), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_acc(d[j]);
    }

    // epilogue: this warpgroup's previous store has read its tile; write the
    // result into it (128-byte swizzle) and store it by TMA (clipped at M)
    if (wtid == 0) bulk_wait_read();
    named_bar(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if constexpr (INT8) {
          const int* q = d + 4 * j + 2 * h;
          const uint16_t v = static_cast<uint16_t>((static_cast<uint32_t>(q[0]) & 0xffu) |
                                                   ((static_cast<uint32_t>(q[1]) & 0xffu) << 8));
          *reinterpret_cast<uint16_t*>(mine + sw128(r, 8 * j + 2 * t)) = v;
        } else {
          const float* q = d + 4 * j + 2 * h;
          const int c = ((8 * j) & 63) * 2 + 4 * t;  // byte column inside the 64-column box
          *reinterpret_cast<uint32_t*>(mine + (j >> 3) * BM * 128 + sw128(r, c)) = pack_bf16(q[0], q[1]);
        }
      }
    }
    fence_async_smem();
    named_bar(2 + wg, 128);
    if (wtid == 0) {
      for (int b = 0; b < P::BOXES; ++b) tma_store_2d(&omap, mine + b * BM * 128, b * 128 / P::ELEM, tile * BM);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

// SMs of the current device, asked once per device
int sm_count(int* sms) {
  static std::atomic<int> sms_of[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaErrorInvalidDevice);
  int n = dev < 64 ? sms_of[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (dev < 64) sms_of[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

// a 2D tensor map of a row-major [rows, 128] tensor of 1- or 2-byte elements
int encode(CUtensorMap* m, EncodeTiled fn, const void* p, int rows, int elem, int box_rows, bool swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(swizzle ? 128 / elem : K), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = fn(m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(p), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(r);
}

template <bool INT8>
int launch(const void* x, const void* w, void* out, int M, int repeat, cudaStream_t stream) {
  using P = Mode<INT8>;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  alignas(64) CUtensorMap xmap, wmap, omap;
  int rc = encode(&xmap, fn, x, M, P::ELEM, BM, true);
  if (rc == 0) rc = encode(&wmap, fn, w, K, P::ELEM, K, false);
  if (rc == 0) rc = encode(&omap, fn, out, M, P::ELEM, BM, true);
  int sms = 0;
  if (rc == 0) rc = sm_count(&sms);
  if (rc != 0) return rc;
  // the limit is set per device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(probe_wgmma_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (M + BM - 1) / BM;
  probe_wgmma_kernel<INT8><<<n_tiles < sms ? n_tiles : sms, THREADS, P::SMEM, stream>>>(xmap, wmap, omap, n_tiles,
                                                                                        repeat);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// mode 0: bf16, mode 1: int8. M a multiple of 16; x, w and out contiguous
// and 16-byte aligned. Returns a cudaError_t or CUresult (0 on success);
// launches on `stream`, does not synchronise, allocates nothing.
extern "C" int probe_matmul(const void* x, const void* w, void* out, int M, int repeat, int mode,
                            void* stream) {
  if (M < 16 || M % 16 != 0 || repeat < 1 || (mode != 0 && mode != 1) || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch<false>(x, w, out, M, repeat, s) : launch<true>(x, w, out, M, repeat, s);
}
