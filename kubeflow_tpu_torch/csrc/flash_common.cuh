// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu) and of
// flash_decode.cu (the fp32 / bf16 conversions).
//
// Two routes. bf16 operands take the tensor-core kernels: tiles arrive by
// TMA (cp.async.bulk.tensor) into a ring of shared memory stages guarded by
// mbarriers, a producer (a warpgroup for the forward and dq, thread 0 for
// dk/dv) issues the copies, and consumer warpgroups multiply with wgmma
// (Hopper's warpgroup MMA, bf16 operands, fp32 accumulators). The forward
// and dq stream K/V tiles past a resident query tile; dk/dv streams Q/dO/O
// tiles past resident K/V. fp32 operands take the scalar kernels, which
// stage tiles as fp32 in shared memory and multiply with fp32 FMAs.
//
// Shared-memory tiles of the tensor-core route are bf16 rows of 128 bytes
// (64 head-dim columns, or 64 keys), in "slabs" of R rows x 64 columns with
// the 128-byte swizzle that TMA writes and wgmma reads: 16-byte chunk c of
// row r sits at chunk c ^ (r % 8). A D-128 tile is two slabs. Each slab
// starts on a 1024-byte boundary, so the swizzle's 8-row atoms line up.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

// ---- the scalar route: fp32 staging from either operand type

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to T, as the plain version's .to(dtype): bf16 rounds, fp32 keeps.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// ---- the tensor-core route

constexpr int BK = 64;                // keys a tile (forward, dq)
constexpr int QROWS = 64;             // query rows a ring tile (dk/dv)
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int SLAB_K = BK * 128;      // bytes of one 64-column slab of a K or V tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `parity` has completed. A phase
// that has not completed after 2 s never will (a tile takes microseconds):
// trap, so the launch fails with an error instead of spinning for ever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A box of the 4-D tensor map (d, head, position, batch) into shared memory
// at dst; completion counts its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d,
                                         int head, int pos, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(head), "r"(pos),
         "r"(batch), "r"(bar)
      : "memory");
}

// Named barrier over `threads` threads (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (rows of
// the contraction dim): lbo unused, sbo = 1024 bytes between 8-row groups.
// MN-major operands (rows of the output dim, read transposed): lbo = bytes
// between 64-column slabs, sbo = 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of the 64 x 16 K-major piece of a tile for k-step kk: slab
// kk / 4, 32 bytes a step inside the 128-byte row.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int slab_bytes, int kk) {
  return desc(tile + (kk / 4) * slab_bytes + (kk % 4) * 32, 16, 1024);
}

// Descriptor of the 16 x N MN-major piece of a [BK, D] tile (keys x head
// dim) for k-step kk: 16 key rows a step.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, SLAB_K, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- what the tensor-core kernels share: the tile ranges, the masks, the
// barriers and the forward's and dq's producer

// The key tiles query rows q0 .. q0 + rows - 1 can see: causal skips tiles
// above the diagonal, the window those left of the first row's window.
// count is 0 when no row sees a key.
struct KeyTiles {
  int first, count;
};

__device__ __forceinline__ KeyTiles key_tiles(int q0, int rows, int Sq, int Sk, int causal,
                                              int window) {
  const int k_hi = causal ? min(Sk - 1, min(q0 + rows - 1, Sq - 1)) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  return {k_lo / BK, k_hi >= k_lo ? k_hi / BK - k_lo / BK + 1 : 0};
}

// Query row `row` sees key kp.
__device__ __forceinline__ bool visible(int kp, int row, int Sk, int causal, int window) {
  return kp < Sk && (!causal || (kp <= row && (window <= 0 || kp > row - window)));
}

// No row r0 .. r1 (r0 < Sq) sees a key of the tile at k0: the warpgroup skips it.
__device__ __forceinline__ bool tile_hidden(int k0, int r0, int r1, int Sq, int causal,
                                            int window) {
  return r0 >= Sq || (causal && (k0 > r1 || (window > 0 && k0 + BK - 1 <= r0 - window)));
}

// Some row r0 .. r1 misses some key of the tile at k0 (the diagonal, the
// window's edge or Sk crosses it): only such tiles are masked.
__device__ __forceinline__ bool tile_edge(int k0, int r0, int r1, int Sk, int causal,
                                          int window) {
  return k0 + BK > Sk || (causal && (k0 + BK - 1 > r0 || (window > 0 && k0 <= r1 - window)));
}

// The query tiles (QROWS rows) that can see keys k0 .. k0 + keys - 1 (the
// dk/dv kernel's counterpart of key_tiles): causal starts at the diagonal,
// the window ends window - 1 rows after the last key (Sk cuts it).
struct QueryTiles {
  int first, count;
};

__device__ __forceinline__ QueryTiles query_tiles(int k0, int keys, int Sq, int Sk, int causal,
                                                  int window) {
  const int k_last = min(k0 + keys - 1, Sk - 1);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = (causal && window > 0) ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  return {q_lo / QROWS, q_hi >= q_lo ? q_hi / QROWS - q_lo / QROWS + 1 : 0};
}

// The transposed tile of dk/dv: no query row q0 .. q0 + 63 (q0 < Sq) sees a
// key kc0 .. kc0 + 63: the warpgroup skips it.
__device__ __forceinline__ bool qtile_hidden(int kc0, int q0, int Sq, int Sk, int causal,
                                             int window) {
  const int q1 = min(q0 + QROWS - 1, Sq - 1);
  return kc0 >= Sk || (causal && (kc0 > q1 || (window > 0 && kc0 + 63 <= q0 - window)));
}

// Some (key, query) pair of the transposed tile is not visible (the
// diagonal, the window's edge, Sq or Sk crosses it): only such tiles mask.
__device__ __forceinline__ bool qtile_edge(int kc0, int q0, int Sq, int Sk, int causal,
                                           int window) {
  return q0 + QROWS > Sq || kc0 + 64 > Sk ||
         (causal && (kc0 + 63 > q0 || (window > 0 && kc0 <= q0 + QROWS - 1 - window)));
}

// The block's mbarriers, from bar_q on: the resident tiles' (Q and dO of
// the forward and dq, K and V of dk/dv), then full[STAGES] (one arrival and
// the tile's bytes) and empty[STAGES] (one arrival from each of the
// `consumers` threads). One thread initialises them.
__device__ __forceinline__ uint32_t bar_full(uint32_t bar_q, int st) { return bar_q + 8 + 8 * st; }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bar_q, int st) {
  return bar_q + 8 + 8 * STAGES + 8 * st;
}

__device__ __forceinline__ void init_barriers(uint32_t bar_q, int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bar_q, s), 1);
      mbar_init(bar_empty(bar_q, s), consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The producer thread's loop: K and V tiles kt.first .. of kv head kvh and
// batch row b into the ring (ns 64-column slabs a tile, stage st at
// k_smem / v_smem + st * ns * SLAB_K), each stage refilled once its
// consumers have released it.
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                           uint32_t k_smem, uint32_t v_smem, int ns,
                                           uint32_t bar_q, KeyTiles kt, int kvh, int b) {
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    mbar_wait(bar_empty(bar_q, st), ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(bar_full(bar_q, st), 2 * ns * SLAB_K);
    for (int s = 0; s < ns; ++s) {
      tma_load(k_smem + (st * ns + s) * SLAB_K, tk, 64 * s, kvh, k0, b, bar_full(bar_q, st));
      tma_load(v_smem + (st * ns + s) * SLAB_K, tv, 64 * s, kvh, k0, b, bar_full(bar_q, st));
    }
  }
}

// Accumulator fragments of m64nN (fp32): warp w of the warpgroup holds rows
// 16w .. 16w + 15; lane (g = lane / 4, t = lane % 4) holds, for each 8-column
// block j, d[4j + 2i + e] = D[16w + g + 8i][8j + 2t + e], i, e in {0, 1}.
// The A fragment of a register operand for k-step kk (columns 16kk .. +15)
// is the same four pairs, packed: {d[8kk..+1], d[8kk+2..+3], d[8kk+4..+5],
// d[8kk+6..+7]}, so a score tile becomes the next product's A operand
// without a trip through shared memory.

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in registers (bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 [B, S, heads, D] array as the 4-D tensor
// (D, heads, S, B), boxes of 64 columns x `rows` positions of one head and
// batch row. Each batch row is its own dimension, so a box that runs past S
// is zero-filled and never reads the next batch row.
inline int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace flash

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
