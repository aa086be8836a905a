// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu) and of
// flash_decode.cu (the fp32 / bf16 conversions, from hopper_common.cuh).
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
// The generic Hopper pieces (mbarriers, TMA, descriptors, wgmma wrappers,
// the tensor-map encoder) live in hopper_common.cuh; here are the
// attention-specific ones. A tile row is 64 head-dim columns (or 64 keys)
// of bf16, 128 bytes, in 128-byte-swizzled slabs; a D-128 tile is two slabs.

#pragma once

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

// ---- the scalar route: 256 threads as a 16 x 16 grid over a TILE x TILE
// score tile, each thread R = TILE / 16 rows and R columns of it

// R (4 or 2) consecutive fp32 values of shared memory (4R-byte aligned)
template <int R>
__device__ __forceinline__ void ld_run(const float* p, float (&v)[R]) {
  static_assert(R == 4 || R == 2, "runs of 4 or 2 floats");
  if constexpr (R == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

// ---- the tensor-core route

constexpr int BK = 64;                // keys a tile (forward, dq)
constexpr int QROWS = 64;             // query rows a ring tile (dk/dv)
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int SLAB_K = BK * 128;      // bytes of one 64-column slab of a K or V tile
constexpr float LOG2E = 1.4426950408889634f;

// Descriptor of the 16 x N MN-major piece of a [BK, D] tile (keys x head
// dim) for k-step kk: 16 key rows a step.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, SLAB_K, 1024);
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

}  // namespace flash

