// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu) and of
// flash_decode.cuh (the fp32 / bf16 conversions, from hopper_common.cuh).
//
// Two routes. bf16 operands take the tensor-core kernels: tiles arrive by
// TMA (cp.async.bulk.tensor) into a ring of shared memory stages guarded by
// mbarriers, a producer (a warpgroup for the forward and dq, thread 0 for
// dk/dv and for the forward at head width 512) issues the copies, and
// consumer warpgroups multiply with wgmma (Hopper's warpgroup MMA, bf16
// operands, fp32 accumulators). The forward and dq stream K/V tiles past a
// resident query tile; dk/dv streams Q/dO/O tiles past resident K/V (at head
// width 256 in tiles of 48 query rows, its two consumer warpgroups owning dV
// and dK). At head width 512 an accumulator of 64 rows would take a thread's
// every register: the forward's two warpgroups each own 256 of O's columns
// and both compute the scores over all 512; dq and dk/dv run their width-256
// kernels on the two column halves as a cluster of two blocks, which swap
// their partial score products (the pair pieces below), so every score
// product is computed once. fp32 operands take the FMA
// kernels (flash_fwd_fma, flash_dq_fma, flash_dkv_fma): the same walks with
// register-tiled fp32 FMA products (the fma32 pieces below) fed by the same
// kind of TMA ring, thread 0 issuing the copies between its own products;
// at width 512 the fp32 forward, dq and dk/dv are pairs of width-256 blocks
// too.
//
// The generic Hopper pieces (mbarriers, TMA, descriptors, wgmma wrappers,
// the tensor-map encoder) live in hopper_common.cuh; here are the
// attention-specific ones. A bf16 tile row is 64 head-dim columns (or 64
// keys), 128 bytes, in 128-byte-swizzled slabs; a D-128 tile is two slabs, a
// D-256 tile four, a D-512 tile eight. An fp32 tile row is 32 columns a slab.

#pragma once

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

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

// acc [64, D] += A [64 x 16] * rows 16kk .. 16kk + 15 of a [BK, D] tile read
// MN-major: O += P V (forward) and dQ += dS K (dq), A the bf16 fragments of
// P or dS from registers. One wgmma spans all D columns: the descriptor's
// leading offset steps over the tile's D / 64 slabs.
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&acc)[D / 2], const uint32_t (&a)[4],
                                              uint32_t tile, int kk) {
  static_assert(D == 64 || D == 128 || D == 256, "head widths 64, 128 and 256");
  if constexpr (D == 256)
    wgmma_rs_n256(acc, a, desc_mn(tile, kk), 1);
  else if constexpr (D == 128)
    wgmma_rs_n128(acc, a, desc_mn(tile, kk), 1);
  else
    wgmma_rs_n64(acc, a, desc_mn(tile, kk), 1);
}

// ---- what the tensor-core kernels share: the tile ranges, the masks, the
// barriers and the forward's and dq's producer

// The key tiles (of TK keys: BK, or 32 for the fp32 forward at width 256)
// query rows q0 .. q0 + rows - 1 can see: causal skips tiles above the
// diagonal, the window those left of the first row's window. count is 0 when
// no row sees a key.
struct KeyTiles {
  int first, count;
};

template <int TK = BK>
__device__ __forceinline__ KeyTiles key_tiles(int q0, int rows, int Sq, int Sk, int causal,
                                              int window) {
  const int k_hi = causal ? min(Sk - 1, min(q0 + rows - 1, Sq - 1)) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  return {k_lo / TK, k_hi >= k_lo ? k_hi / TK - k_lo / TK + 1 : 0};
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

// Some row r0 .. r1 misses some key of the TK-key tile at k0 (the diagonal,
// the window's edge or Sk crosses it): only such tiles are masked.
template <int TK = BK>
__device__ __forceinline__ bool tile_edge(int k0, int r0, int r1, int Sk, int causal,
                                          int window) {
  return k0 + TK > Sk || (causal && (k0 + TK - 1 > r0 || (window > 0 && k0 <= r1 - window)));
}

// The query tiles (ROWS rows: QROWS, or 48 for dk/dv at width 256) that can
// see keys k0 .. k0 + keys - 1 (the dk/dv kernels' counterpart of
// key_tiles): causal starts at the diagonal, the window ends window - 1 rows
// after the last key (Sk cuts it).
struct QueryTiles {
  int first, count;
};

template <int ROWS = QROWS>
__device__ __forceinline__ QueryTiles query_tiles(int k0, int keys, int Sq, int Sk, int causal,
                                                  int window) {
  const int k_last = min(k0 + keys - 1, Sk - 1);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = (causal && window > 0) ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  return {q_lo / ROWS, q_hi >= q_lo ? q_hi / ROWS - q_lo / ROWS + 1 : 0};
}

// The transposed tile of dk/dv: no query row q0 .. q0 + ROWS - 1 (q0 < Sq)
// sees a key kc0 .. kc0 + 63: the warpgroup skips it.
template <int ROWS = QROWS>
__device__ __forceinline__ bool qtile_hidden(int kc0, int q0, int Sq, int Sk, int causal,
                                             int window) {
  const int q1 = min(q0 + ROWS - 1, Sq - 1);
  return kc0 >= Sk || (causal && (kc0 > q1 || (window > 0 && kc0 + 63 <= q0 - window)));
}

// Some (key, query) pair of the transposed tile of KEYS keys from kc0 and
// ROWS rows from q0 is not visible (the diagonal, the window's edge, Sq or
// Sk crosses it): only such tiles mask.
template <int ROWS = QROWS, int KEYS = 64>
__device__ __forceinline__ bool qtile_edge(int kc0, int q0, int Sq, int Sk, int causal,
                                           int window) {
  return q0 + ROWS > Sq || kc0 + KEYS > Sk ||
         (causal && (kc0 + KEYS - 1 > q0 || (window > 0 && kc0 <= q0 + ROWS - 1 - window)));
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
// batch row b into the ring (ns 64-column slabs a tile from column d0, stage
// st at k_smem / v_smem + st * ns * SLAB_K), each stage refilled once its
// consumers have released it.
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                           uint32_t k_smem, uint32_t v_smem, int ns,
                                           uint32_t bar_q, KeyTiles kt, int kvh, int b,
                                           int d0 = 0) {
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    mbar_wait(bar_empty(bar_q, st), ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(bar_full(bar_q, st), 2 * ns * SLAB_K);
    for (int s = 0; s < ns; ++s) {
      tma_load(k_smem + (st * ns + s) * SLAB_K, tk, d0 + 64 * s, kvh, k0, b, bar_full(bar_q, st));
      tma_load(v_smem + (st * ns + s) * SLAB_K, tv, d0 + 64 * s, kvh, k0, b, bar_full(bar_q, st));
    }
  }
}

// Thread 0's side of a TMA ring of `count` items: issue item `must` (waiting
// until its stage is released) and the next ones whose stages are already
// free, at most STAGES - 1 ahead; issue(j, stage) arms the stage's full
// barrier and starts item j's copies.
template <class Issue>
__device__ __forceinline__ void refill(int& issued, int count, int must, uint32_t bar,
                                       Issue&& issue) {
  while (issued < count && issued < must + STAGES) {
    const int j = issued, sj = j % STAGES;
    const int parity = ((j / STAGES) & 1) ^ 1;
    if (j > must && !mbar_try_wait(bar_empty(bar, sj), parity)) break;
    mbar_wait(bar_empty(bar, sj), parity);
    issue(j, sj);
    ++issued;
  }
}

// ---- the pair: dq and dk/dv at head width 512, and the fp32 forward there
//
// Block c = 0, 1 of a cluster of two holds columns c DL .. c DL + DL - 1
// (DL = 256) of every operand it reads and runs the width-256 kernel's tiles
// on them, so its score products are partial sums over its columns. After
// each tile's products a slot's threads (a warpgroup of the bf16 kernels and
// of the fp32 dk/dv, all 256 of the fp32 forward and dq) swap their fp32
// partials with their twins in the other block (the same threadIdx there
// holds the same elements) and add them: fp32 addition commutes, so both
// blocks hold the same bits of S0 + S1, and masking, exp, the forward's
// online softmax and dS follow the sum. A receive
// slot of T threads holds float4s, thread tid's j-th at j * T + tid. Two
// mbarriers guard it: `full` in the receiver (armed with the bytes by one of
// its threads, counted down by the sender's st.async) and `free` in the
// sender (one arrival from each of the receiver's T / 32 warps once they
// read the slot, through mbar_arrive_remote). Both blocks of a pair walk the
// same tiles, so they swap the same number of times.
struct Pair {
  uint32_t full, free;              // this block's barriers
  uint32_t peer_rx, peer_full;      // the peer's slot and full barrier (shared::cluster)
  uint32_t peer_free;               // the peer's free barrier (shared::cluster)
};

// One side of a pair (a warpgroup's, or the whole block's for the fp32
// forward and dq): rx, full and free are this block's shared-memory
// addresses of that side's slot and barriers; the peer's are the same
// addresses in the other block.
__device__ __forceinline__ Pair pair_at(uint32_t rx, uint32_t full, uint32_t free) {
  const uint32_t peer = cluster_rank() ^ 1;
  return {full, free, mapa(rx, peer), mapa(full, peer), mapa(free, peer)};
}

// Step 1 of swap number seq (at = 0): once the peer has read the last one,
// arm this block's full barrier with the bytes the peer sends (the slot's
// thread tid 0) and send this thread's N partials to the peer's slot, float4
// `at` on. A later call with at > 0 sends more of the same swap.
template <int N, int T = 128>
__device__ __forceinline__ void pair_send(const Pair& pr, const float (&x)[N], int seq, int tid,
                                          int bytes, int at = 0) {
  static_assert(N % 4 == 0, "partials go by float4");
  if (at == 0) {
    mbar_wait_cluster(pr.free, (seq & 1) ^ 1);
    if (tid == 0) mbar_expect_tx(pr.full, bytes);
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 v = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    st_async_u4(pr.peer_rx + ((at + j) * T + tid) * 16, *reinterpret_cast<const uint4*>(&v),
                pr.peer_full);
  }
}

// Step 1b: one float more of the swap step 1 began (its bytes counted
// there), to the peer's shared::cluster address peer_at.
__device__ __forceinline__ void pair_send_one(const Pair& pr, uint32_t peer_at, float v) {
  st_async_b32(peer_at, __float_as_uint(v), pr.peer_full);
}

// Step 2: wait for the peer's partials of swap seq (at = 0) and add those
// of this block's slot rx, float4 `at` on, to this thread's.
template <int N, int T = 128>
__device__ __forceinline__ void pair_add(const Pair& pr, float (&x)[N], const float4* rx, int seq,
                                         int tid, int at = 0) {
  if (at == 0) mbar_wait(pr.full, seq & 1);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 r = rx[(at + j) * T + tid];
    x[4 * j] += r.x;
    x[4 * j + 1] += r.y;
    x[4 * j + 2] += r.z;
    x[4 * j + 3] += r.w;
  }
}

// Step 3: this warp has read the slot; the peer may send the next swap.
__device__ __forceinline__ void pair_release(const Pair& pr) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive_remote(pr.peer_free);
}

// ---- the fp32 FMA route: threads as GS row groups g (16 of a block's 256
// threads, or 8 of a warpgroup's 128) by 16 lanes x, the 16 lanes of a group
// one half of a warp. fp32 tiles arrive by TMA in slabs of 32 columns
// (128-byte rows, 128-byte swizzle): row r of a slab holds its 16-byte chunk
// c at c ^ (r % 8). A thread's rows are g + GS i (all of one r % 8 = g % 8),
// its columns of a product x + 16 j, and its columns of an accumulator
// 4 x + 64 h .. + 3 (chunk x % 8 of slab x / 8 + 2 h).

namespace fma32 {

// acc[p][i][j] += A[p][g + GS i] . B[p][x + 16 j] for each of NP products,
// over the NS slabs of their tiles (A[p] and B[p] the first slabs; the A
// tiles' slabs a_slab floats apart, the B tiles' b_slab): per 16-byte chunk,
// J loads of B and R of A feed 4 R J FMAs a product, A's a broadcast within
// the half warp. dq runs its two products (S and dP) in one loop, two
// independent FMA streams, which ran faster on an H100 than a loop each.
template <int NS, int R, int J, int GS = 16, int NP = 1>
__device__ __forceinline__ void dot_rows(float (&acc)[NP][R][J], const float* const (&A)[NP],
                                         int a_slab, const float* const (&B)[NP], int b_slab,
                                         int g, int x) {
  const int kg = g & 7, kx = x & 7;
#pragma unroll 1
  for (int sl = 0; sl < NS; ++sl) {
    const int ao = sl * a_slab + g * 32, bo = sl * b_slab + x * 32;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float4 bv[NP][J];
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          bv[p][j] = *reinterpret_cast<const float4*>(B[p] + bo + j * 16 * 32 + 4 * (c ^ kx));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float4 av[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          av[p] = *reinterpret_cast<const float4*>(A[p] + ao + i * GS * 32 + 4 * (c ^ kg));
#pragma unroll
        for (int j = 0; j < J; ++j) {
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[p][i][j] = fmaf(av[p].x, bv[p][j].x, acc[p][i][j]);
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[p][i][j] = fmaf(av[p].y, bv[p][j].y, acc[p][i][j]);
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[p][i][j] = fmaf(av[p].z, bv[p][j].z, acc[p][i][j]);
#pragma unroll
          for (int p = 0; p < NP; ++p) acc[p][i][j] = fmaf(av[p].w, bv[p][j].w, acc[p][i][j]);
        }
      }
    }
  }
}

// This thread's J values of one row of an fp32 [rows][16 J] tile (a row of
// P, dS, P^T or dS^T): column x + 16 j at position J x + j, the row's
// 16-byte chunks swizzled by kg = row % 8.
template <int J>
__device__ __forceinline__ void put_row(float* row, const float (&v)[J], int x, int kg) {
  static_assert(J == 4 || J == 2, "rows of 64 or 32 columns");
  if constexpr (J == 4)
    *reinterpret_cast<float4*>(row + 4 * (x ^ kg)) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(row + 4 * ((x >> 1) ^ kg) + 2 * (x & 1)) = make_float2(v[0], v[1]);
}

// The values put_row<J> wrote at this thread's positions of a row.
template <int J>
__device__ __forceinline__ void get_row(const float* row, float (&v)[J], int x, int kg) {
  if constexpr (J == 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + 4 * (x ^ kg));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(row + 4 * ((x >> 1) ^ kg) + 2 * (x & 1));
    v[0] = t.x, v[1] = t.y;
  }
}

// acc[i][4 h + e] += sum over c of P[g + GS i][c] V[c][4 x + 64 h + e]: P
// the [.., 16 J] tile of put_row (the rows this thread's half warp wrote), V
// a tile of 16 J rows in slabs v_slab floats apart. Position 4 q + e of a P
// row is column q + 16 e (J 4) or 2 q + e / 2 + 16 (e % 2) (J 2); per 4
// positions, R loads of P and 4 DH of V feed 16 R DH FMAs. The loop is
// unrolled whole, which ran faster on an H100 than unrolling it by 2.
template <int R, int J, int DH, int GS = 16>
__device__ __forceinline__ void acc_rows(float (&acc)[R][4 * DH], const float* P,
                                         const float* V, int v_slab, int g, int x) {
  static_assert(J == 4 || J == 2, "rows of 64 or 32 columns");
  constexpr int N = 16 * J;
  const int kg = g & 7, kx = x & 7;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (g + GS * i) * N + 4 * (q ^ kg));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = J == 4 ? q + 16 * e : 2 * q + (e >> 1) + 16 * (e & 1);
      float4 vv[DH];
#pragma unroll
      for (int h = 0; h < DH; ++h)
        vv[h] = *reinterpret_cast<const float4*>(V + ((x >> 3) + 2 * h) * v_slab + c * 32 +
                                                 4 * (kx ^ (c & 7)));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          acc[i][4 * h] = fmaf(p, vv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(p, vv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(p, vv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(p, vv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// This thread's columns 4 x + 64 h .. + 3 of one O row (DH float4s from
// device memory, the row's D floats at o; nullptr past Sq gives zeros).
template <int DH>
__device__ __forceinline__ void load_row(float4 (&v)[DH], const float* o, int x) {
#pragma unroll
  for (int h = 0; h < DH; ++h)
    v[h] = o ? __ldg(reinterpret_cast<const float4*>(o + 4 * x + 64 * h))
             : make_float4(0.f, 0.f, 0.f, 0.f);
}

// delta = rowsum(dO . O) of a row, over the 16 lanes of its group: dO the
// row of a resident tile (row r at r * 32 floats of each slab, slabs `slab`
// floats apart, r % 8 = kg), ov this thread's columns of the O row. The
// shuffles take the whole warp: both half warps call it together.
template <int DH>
__device__ __forceinline__ float row_delta(const float* dO, int slab, const float4 (&ov)[DH],
                                           int x, int kg) {
  float sum = 0.f;
#pragma unroll
  for (int h = 0; h < DH; ++h) {
    const float4 d = *reinterpret_cast<const float4*>(dO + ((x >> 3) + 2 * h) * slab +
                                                      4 * ((x & 7) ^ kg));
    sum = fmaf(d.x, ov[h].x, sum);
    sum = fmaf(d.y, ov[h].y, sum);
    sum = fmaf(d.z, ov[h].z, sum);
    sum = fmaf(d.w, ov[h].w, sum);
  }
#pragma unroll
  for (int off = 1; off < 16; off *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// delta = rowsum(dO . O) of a row read whole from device memory (its D =
// 64 DH floats at d and at o; nullptr past Sq gives 0), over the 16 lanes of
// its group, the same sum in both blocks of a pair. Both half warps call it
// together.
template <int DH>
__device__ __forceinline__ float row_delta_global(const float* d, const float* o, int x) {
  float4 dv[DH], ov[DH];
  load_row<DH>(dv, d, x);
  load_row<DH>(ov, o, x);
  float sum = 0.f;
#pragma unroll
  for (int h = 0; h < DH; ++h) {
    sum = fmaf(dv[h].x, ov[h].x, sum);
    sum = fmaf(dv[h].y, ov[h].y, sum);
    sum = fmaf(dv[h].z, ov[h].z, sum);
    sum = fmaf(dv[h].w, ov[h].w, sum);
  }
#pragma unroll
  for (int off = 1; off < 16; off *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

}  // namespace fma32

}  // namespace flash

