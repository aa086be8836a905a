// Flash-attention backward, dq, for Hopper (sm_90a): fp32 math.
//
// Replaces the Pallas kernel _dq_kernel (kubeflow_tpu/ops/pallas_attention.py:290).
// Layout: q, o, do [B, Sq, H, D], k/v [B, Sk, KV, D], all contiguous;
// lse [B, H, Sq] fp32 (+inf on rows that see no key); dq [B, Sq, H, D] in
// fp32 (out_f32) or the operands' type. Query head h reads kv head
// h / (H / KV). delta = rowsum(do * o) is computed per row in fp32 inside
// the kernel (the TPU kernel's _init); no [B, H, S] delta array exists.
// p = exp(s * scale - lse); ds = p * (dp - delta) * scale, rounded to the
// operands' type before the ds k product, as the TPU kernel rounds it to k's
// dtype. Key tiles above the causal diagonal and left of the sliding window
// are never loaded (the TPU kernel's _kv_valid, pallas_attention.py:104-116).
//
// Bound at the training shape (B4 H8 S2048 D128, causal): FLOPs, three
// causal matmuls (q k^T, do v^T, ds k) = 5.2e10 FLOP, 0.052 ms at the card's
// 989 TFLOP/s bf16 peak, against ~84 MB of bf16 operands (at D 256 1.0e11
// FLOP, 0.104 ms).
//
// bf16 operands: the tensor-core kernel flash_dq_wgmma, built as the forward
// (flash_attention_fwd.cu): one block per (head, batch row, query tile of
// 64 * NWG rows), heaviest causal tiles first; a producer warpgroup loads
// the Q and dO tiles once and keeps K/V tiles of 64 keys in flight by TMA
// through a 2-stage mbarrier ring; each consumer warpgroup owns 64 query
// rows and per key tile computes S = Q K^T and dP = dO V^T with wgmma from
// shared memory (K and V stored [keys, D] are K-major for both), p and ds in
// fp32 registers (masks only on edge tiles; ds written over s), and dQ += dS
// K with dS's bf16 A fragments taken from the accumulator registers and K
// read MN-major from the same tile, one wgmma of N = D a 16-key step. dQ
// stays in fp32 registers across the key loop.
//
// Head width 256 (bf16): <256, 1, 1>, one consumer warpgroup beside the
// producer in 256 threads, no setmaxnreg: dQ (128 fp32), S and dP (32 each)
// take 192 of the 255 registers a thread may hold there (168 beside two
// consumers). Shared memory 197,928 bytes: Q and dO resident (64 KiB), two
// stages of K and V (128 KiB), delta.
//
// Head width 512 (bf16): flash_dq_wgmma<512, 1, 2>. dQ of 64 rows would
// take 256 fp32 registers a thread, and Q and dO resident 128 KiB. So the
// width-256 kernel runs on each column half, as a cluster of two blocks a
// query tile (grid (H, B, 2 x query tiles)): block c holds columns 256 c ..
// 256 c + 255 of Q, dO, K and V (the width-256 layout, 64-key tiles) and
// owns those of dQ. Its S and dP are partial sums over its columns; after
// each tile's products the consumer warpgroup sends its fp32 partials to its
// twin in the other block by st.async through distributed shared memory and
// adds the twin's (S0 + S1 in both: fp32 addition commutes; S's partials
// travel while dP's product runs), then masks, exponentiates and forms dS
// as at width 256. Every score product is
// computed once, m64n64k16 steps: exactly the bound's FLOPs (5.2e10 at the
// heads-of-512 training shape, B4 S2048 H2; 0.052 ms), where the first
// port's two warpgroups each recomputed S and dP over all 512 columns in
// m64n16k16 steps (5/3 of them). The 32 KiB receive slot brings the block to
// 230,712 bytes. delta = rowsum(dO * O) is read over all 512 columns by
// both blocks, the same sum in both.
//
// fp32 operands: flash_dq_fma, the bf16 route's walk with register-tiled fp32
// FMA products (no TF32: the route exists to match the plain version's
// full-fp32 products; bound three causal matmuls at the 67 TF/s fp32 peak,
// 0.770 ms at the training shape). The grid and the heaviest-first order
// are the bf16 route's; 256 threads as 16 row groups g by 16 lanes x hold
// the scores S = Q K^T and dP = dO V^T of rows g + 16 i and keys x + 16 j
// (one loop for both products) and dQ of the same rows, columns 4 x + 64 h
// .. + 3 (the fma32 pieces of flash_common.cuh). Q and dO stay resident; K
// and V tiles stream through a 2-stage TMA ring of fp32 boxes of 32 columns,
// thread 0 issuing the copies between its own products. delta =
// rowsum(dO * O) and lse of the thread's rows are taken once, before the
// walk, from the resident dO and one read of the O rows. dS = P (dP -
// delta) * scale stays in registers and passes through the warp's own rows
// of one fp32 tile (behind a __syncwarp: no block barrier in a key tile) to
// dQ += dS K, K read from the ring again. Only edge tiles mask. Q, dO, two
// stages and the dS tile fill the block: D 64 and 128 take 64 query rows and
// 64-key tiles (214,056 bytes at D 128), D 256 32 rows and 32-key tiles
// (201,768 bytes). The TPU kernel's rounding of ds to the operands' type is
// the identity in fp32. What bounds it on an H100 (a clock64-stamped scratch
// copy, not committed): the two FMA loops take nearly all of a warp's
// cycles, below the fp32 issue rate; 128 rows and 32-key tiles, a warpgroup
// each for S and dP (8 x 4 scores a thread, dS handed between them) and that
// split with one half of dQ a tile late all ran slower.
//
// Head width 512 (fp32): flash_dq_fma<512, 32, 32, 2>. Q and dO resident at
// 512 columns would leave room for 16 rows and 16-key tiles only (a thread's
// one score of S and of dP fed 2 FMAs a shared-memory load, where 32 x 32
// feeds 4). So, as the bf16 pair, the width-256 kernel runs on each column
// half as a cluster of two blocks a query tile (grid (H, B, 2 x query
// tiles)): block c holds columns 256 c .. 256 c + 255 of Q, dO, K and V and
// owns those of dQ; after each tile's S and dP (partial over its columns) all
// 256 threads send their 8 fp32 partials to their twins by st.async (one
// 8 KiB slot of 256 threads, its free barrier counting eight warps) and add
// the twins', then mask, exponentiate and form dS as at width 256. delta is
// read over all 512 columns of dO and O from device memory by both blocks
// (the same bits in both) before the walk. 209,976 bytes; exactly the
// bound's FLOPs (each score product once).

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::to_f;

// ---- the fp32 route: register-tiled fp32 FMAs fed by TMA

namespace dq32 {

constexpr int THR = 256;

// Shared memory of flash_dq_fma<D, BQ, BK, CL>, in bytes from a 1024-aligned
// base: the Q and dO tiles (DL / 32 slabs of BQ rows of 32 fp32 columns
// each, resident; DL = D / CL the block's columns), STAGES ring stages (the
// K tile's DL / 32 slabs of BK rows, then the V tile's), the fp32 dS tile
// [BQ][BK], at CL 2 the receive slot of the peer's partial S and dP
// ([2][THR] float4: the block's 256 threads, 8 partials each), then the
// mbarriers: Q/dO, full[STAGES], empty[STAGES], and at CL 2 the slot's full
// and free. `bytes` adds the slack for aligning the dynamic base;
// ops/pallas_attention.py (_fma_bwd_bytes) sums the same and the launcher
// checks it.
template <int D, int BQ, int BK, int CL>
struct Layout {
  static constexpr int DL = D / CL;
  static constexpr int NS = DL / 32;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int SLAB_K = BK * 128;
  static constexpr int STAGE = 2 * NS * SLAB_K;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NS * SLAB_Q;
  static constexpr int KV = DO + NS * SLAB_Q;
  static constexpr int DS = KV + flash::STAGES * STAGE;
  static constexpr int RX = DS + BQ * BK * 4;
  static constexpr int BAR = RX + (CL > 1 ? 2 * BQ * BK * 4 : 0);
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES) + (CL > 1 ? 16 : 0);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
  static_assert(CL == 1 || (DL == 256 && BQ * BK == 4 * THR), "a pair swaps 8 partials a thread");
};

// One block per (head, batch row, query tile of BQ rows), heaviest causal
// tiles first; thread (g, x) holds S and dP of rows g + 16 i and keys
// x + 16 j (R x J) and dQ of the same rows (R x 4 DH). CL 2 (head width
// 512): block c of a cluster of two holds columns c DL .. of Q, dO, K and V
// and owns those of dQ; both walk the same query tile and key tiles, and
// after each tile's S and dP (partial over DL columns) all 256 threads swap
// them with their twins in the other block (the pair pieces of
// flash_common.cuh, one slot of THR threads) before p and dS. delta is read
// over all D columns from device memory by both blocks: the same bits.
template <int D, int BQ, int BK, int CL>
__global__ void __launch_bounds__(THR, 1)
flash_dq_fma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ o, const float* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ dq, int Sq, int Sk, int H, int KV,
             int causal, int window, float scale) {
  using namespace flash;
  using L = Layout<D, BQ, BK, CL>;
  constexpr int NS = L::NS;
  constexpr int R = BQ / 16;      // rows a thread
  constexpr int J = BK / 16;      // keys a thread of each score tile
  constexpr int DH = L::DL / 64;  // 4-column groups of dQ a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const float* fs = reinterpret_cast<const float*>(smem);
  float* dss = reinterpret_cast<float*>(smem + L::DS);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::BAR;
  const uint32_t rx_full = bar_q + 8 * (1 + 2 * STAGES), rx_free = rx_full + 8;

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest causal tiles first; a pair's two blocks take one query tile
  const int q0 = (gridDim.z / CL - 1 - blockIdx.z / CL) * BQ;
  const int q1 = min(q0 + BQ - 1, Sq - 1);
  const int d0 = CL > 1 ? (int)cluster_rank() * L::DL : 0;   // the block's columns
  const int kvh = h / (H / KV);
  const KeyTiles kt = key_tiles<BK>(q0, BQ, Sq, Sk, causal, window);
  if (CL > 1 && threadIdx.x == 0) {
    mbar_init(rx_full, 1);
    mbar_init(rx_free, THR / 32);
  }
  init_barriers(bar_q, THR / 32);                      // empty: one arrival a warp
  if constexpr (CL > 1) cluster_sync();   // both blocks' barriers exist before a remote store

  int issued = 0;
  auto issue = [&](int j, int sj) {
    const int k0 = (kt.first + j) * BK;
    const uint32_t dst = s_base + L::KV + sj * L::STAGE;
    mbar_expect_tx(bar_full(bar_q, sj), L::STAGE);
    for (int s = 0; s < NS; ++s) {
      tma_load(dst + s * L::SLAB_K, &tk, d0 + 32 * s, kvh, k0, b, bar_full(bar_q, sj));
      tma_load(dst + (NS + s) * L::SLAB_K, &tv, d0 + 32 * s, kvh, k0, b, bar_full(bar_q, sj));
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * NS * L::SLAB_Q);
    for (int s = 0; s < NS; ++s) {
      tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, d0 + 32 * s, h, q0, b, bar_q);
      tma_load(s_base + L::DO + s * L::SLAB_Q, &tdo, d0 + 32 * s, h, q0, b, bar_q);
    }
    refill(issued, kt.count, 0, bar_q, issue);
  }
  __syncwarp();

  const int g = threadIdx.x >> 4, x = threadIdx.x & 15, lane = threadIdx.x & 31;
  const int kg = g & 7;
  const float sl2 = scale * LOG2E;

  // delta = rowsum(dO * O) and lse * log2(e) of rows g + 16 i, once: from
  // the resident dO, or at CL 2 over all D columns from device memory
  if constexpr (CL == 1) mbar_wait(bar_q, 0);
  float delta[R], lse2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + g + 16 * i;
    const size_t off = (((size_t)b * Sq + row) * H + h) * D;
    if constexpr (CL > 1) {
      delta[i] = fma32::row_delta_global<D / 64>(row < Sq ? dout + off : nullptr,
                                                 row < Sq ? o + off : nullptr, x);
    } else {
      float4 ov[DH];
      fma32::load_row<DH>(ov, row < Sq ? o + off : nullptr, x);
      delta[i] = fma32::row_delta<DH>(fs + L::DO / 4 + (g + 16 * i) * 32, L::SLAB_Q / 4, ov, x, kg);
    }
    // a row past Sq, or one that sees no key (lse +inf), gives p = 0
    lse2[i] = row < Sq ? lse[((size_t)b * H + h) * Sq + row] * LOG2E : INFINITY;
  }
  if constexpr (CL > 1) mbar_wait(bar_q, 0);

  Pair pr{};
  if constexpr (CL > 1) pr = pair_at(s_base + L::RX, rx_full, rx_free);
  const float4* rx = reinterpret_cast<const float4*>(smem + L::RX);

  float acc[R][4 * DH];           // dQ
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * DH; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);
    __syncwarp();
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    const float* Kt = fs + (L::KV + st * L::STAGE) / 4;
    const float* Vt = Kt + NS * L::SLAB_K / 4;

    // S = Q K^T and dP = dO V^T in one loop: rows g + 16 i, keys x + 16 j
    float sd[2][R][J];
    auto& s = sd[0];
    auto& dp = sd[1];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = dp[i][j] = 0.f;
    fma32::dot_rows<NS, R, J, 16, 2>(sd, {fs + L::Q / 4, fs + L::DO / 4}, L::SLAB_Q / 4, {Kt, Vt},
                                     L::SLAB_K / 4, g, x);
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);   // if free by now
    __syncwarp();
    if constexpr (CL > 1) {
      // S = S0 + S1 and dP = dP0 + dP1 over the pair's column halves
      float part[2 * R * J];
#pragma unroll
      for (int e = 0; e < 2 * R * J; ++e) part[e] = sd[e / (R * J)][e / J % R][e % J];
      pair_send<2 * R * J, THR>(pr, part, it, threadIdx.x, 2 * BQ * BK * 4);
      pair_add<2 * R * J, THR>(pr, part, rx, it, threadIdx.x);
      pair_release(pr);
#pragma unroll
      for (int e = 0; e < 2 * R * J; ++e) sd[e / (R * J)][e / J % R][e % J] = part[e];
    }

    // dS = P (dP - delta) * scale, P = exp(S * scale - lse); masks only on
    // edge tiles (masked scores and rows with lse = +inf give p = 0)
    const bool edge = tile_edge<BK>(k0, q0, q1, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool keep = !edge || visible(k0 + x + 16 * j, q0 + g + 16 * i, Sk, causal, window);
        const float p = keep ? exp2f(fmaf(s[i][j], sl2, -lse2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - delta[i]) * scale;
      }
      fma32::put_row<J>(dss + (g + 16 * i) * BK, s[i], x, kg);
    }
    __syncwarp();

    // dQ += dS K, K read again from the stage
    fma32::acc_rows<R, J, DH>(acc, dss, Kt, L::SLAB_K / 4, g, x);
    __syncwarp();                  // this warp's dS reads and stage reads are done
    if (lane == 0) mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + g + 16 * i;
    if (row >= Sq) continue;
    float* drow = dq + (((size_t)b * Sq + row) * H + h) * D + d0;
#pragma unroll
    for (int hh = 0; hh < DH; ++hh)
      *reinterpret_cast<float4*>(drow + 4 * x + 64 * hh) =
          make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
  }
  // the peer may still arrive on this block's free barrier: neither block
  // exits before both are done with the other's shared memory
  if constexpr (CL > 1) cluster_sync();
}

}  // namespace dq32

// ---- the tensor-core route (bf16)

// Shared memory of flash_dq_wgmma, in bytes from a 1024-aligned base: the Q
// and dO tiles (DL / 64 slabs of BQ rows each, DL = D / CL the block's
// columns), STAGES K and STAGES V tiles, delta [BQ] fp32, at CL 2 the
// receive slot of the peer's partial S and dP ([2][8][128] float4: 32 KiB),
// then the mbarriers: Q/dO, full[STAGES], empty[STAGES], and at CL 2 the
// slot's full and free. ops/pallas_attention.py (_wgmma_sums) computes the
// same bytes; the launcher checks them.
template <int D, int NWG, int CL>
struct DqLayout {
  static constexpr int BQ = 64 * NWG;
  static constexpr int DL = D / CL;
  static constexpr int NS = DL / 64;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NS * SLAB_Q;
  static constexpr int K = DO + NS * SLAB_Q;
  static constexpr int V = K + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int DELTA = V + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int RX = DELTA + 4 * BQ;
  static constexpr int BAR = RX + (CL > 1 ? 2 * 64 * flash::BK * 4 : 0);
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES) + (CL > 1 ? 16 : 0);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
};

// CL 2 (head width 512): block c of a cluster of two holds columns c DL ..
// of Q, dO, K and V and owns those of dQ; both walk the same query tile and
// key tiles, and after each tile's S and dP (partial over DL columns) the
// consumer warpgroup swaps them with its twin in the other block (the pair
// pieces of flash_common.cuh) before p and dS: each score product once,
// m64n64k16 steps as at width 256.
template <int D, int NWG, int CL>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, void* __restrict__ dq, int Sq, int Sk, int H,
               int KV, int causal, int window, float scale, int out_f32) {
  using namespace flash;
  using L = DqLayout<D, NWG, CL>;
  constexpr int NS = L::NS, DL = L::DL;
  static_assert(CL == 1 || (NWG == 1 && DL == 256), "a pair runs the width-256 tiles");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  const uint32_t bar_q = s_base + L::BAR;
  const uint32_t rx_full = bar_q + 8 * (1 + 2 * STAGES), rx_free = rx_full + 8;

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest causal tiles first; a pair's two blocks take one query tile
  const int q0 = (gridDim.z / CL - 1 - blockIdx.z / CL) * L::BQ;
  const int d0 = CL > 1 ? (int)cluster_rank() * DL : 0;   // the block's columns
  const int kvh = h / (H / KV);
  const KeyTiles kt = key_tiles(q0, L::BQ, Sq, Sk, causal, window);
  if (CL > 1 && threadIdx.x == 0) {
    mbar_init(rx_full, 1);
    mbar_init(rx_free, 4);
  }
  init_barriers(bar_q, NWG * 128);
  if constexpr (CL > 1) cluster_sync();   // both blocks' barriers exist before a remote store

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    if (NWG > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * NS * L::SLAB_Q);
      for (int s = 0; s < NS; ++s) {
        tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, d0 + 64 * s, h, q0, b, bar_q);
        tma_load(s_base + L::DO + s * L::SLAB_Q, &tdo, d0 + 64 * s, h, q0, b, bar_q);
      }
      produce_kv(&tk, &tv, s_base + L::K, s_base + L::V, NS, bar_q, kt, kvh, b, d0);
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows r0 .. r0 + 63
  if (NWG > 1) setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * c;
  const int r1 = min(r0 + 63, Sq - 1);
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const float sl2 = scale * LOG2E;

  // delta of the warpgroup's rows over all D columns (both blocks of a pair
  // the same bits): two threads a row, D / 2 columns each
  {
    const int rr = tid / 2, half = tid % 2;
    const int qp = r0 + rr;
    float sum = 0.f;
    if (qp < Sq) {
      const size_t off = (((size_t)b * Sq + qp) * H + h) * D + half * (D / 2);
#pragma unroll 8
      for (int x = 0; x < D / 2; x += 8) {
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + x);
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + x);
        const bf16* dp = reinterpret_cast<const bf16*>(&dv);
        const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += to_f(dp[e]) * to_f(op[e]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) delta_s[64 * c + rr] = sum;
    named_sync(1 + c, 128);
  }
  float delta[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] = delta_s[64 * c + 16 * warp + g + 8 * i];
    lse2[i] = row[i] < Sq ? lse[((size_t)b * H + h) * Sq + row[i]] * LOG2E : INFINITY;
  }

  Pair pr{};
  if constexpr (CL > 1) pr = pair_at(s_base + L::RX, rx_full, rx_free);
  const float4* rx = reinterpret_cast<const float4*>(smem + L::RX);

  const uint32_t q_tile = s_base + L::Q + c * 64 * 128;
  const uint32_t do_tile = s_base + L::DO + c * 64 * 128;
  float acc[DL / 2];              // dQ [64, DL]: DL / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < DL / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    // a pair's one warpgroup sees every tile of its walk: none is hidden
    if (CL > 1 || !tile_hidden(k0, r0, r1, Sq, causal, window)) {
      const uint32_t k_tile = s_base + L::K + st * NS * SLAB_K;
      const uint32_t v_tile = s_base + L::V + st * NS * SLAB_K;
      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DL / 16; ++kk)
        wgmma_ss_n64(s, desc_k(q_tile, L::SLAB_Q, kk), desc_k(k_tile, SLAB_K, kk), kk > 0);
      if constexpr (CL > 1) wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DL / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(do_tile, L::SLAB_Q, kk), desc_k(v_tile, SLAB_K, kk), kk > 0);
      wgmma_commit();
      if constexpr (CL > 1) {
        // S = S0 + S1 and dP = dP0 + dP1 over the pair's column halves; S's
        // partials travel while dP's product runs
        wgmma_wait<1>();
        fence_regs(s);
        pair_send(pr, s, it, tid, 2 * 64 * BK * 4);
        wgmma_wait_all();
        fence_regs(dp);
        pair_send(pr, dp, it, tid, 0, BK / 8);
        pair_add(pr, s, rx, it, tid);
        pair_add(pr, dp, rx, it, tid, BK / 8);
        pair_release(pr);
      } else {
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
      }

      const bool edge = tile_edge(k0, r0, r1, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const bool keep = !edge || visible(k0 + 8 * j + 2 * t + e, row[i], Sk, causal, window);
            // masked scores and rows with lse = +inf give p = 0
            const float p = keep ? exp2f(fmaf(s[x], sl2, -lse2[i])) : 0.f;
            s[x] = p * (dp[x] - delta[i]) * scale;
          }
      uint32_t da[BK / 16][4];    // dS in bf16: the A operand of dS K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = flash::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_tile<DL>(acc, da[kk], k_tile, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const size_t off = (((size_t)b * Sq + row[i]) * H + h) * D + d0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DL / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i], x1 = acc[4 * j + 2 * i + 1];
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + off + 8 * j) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dq) + off + 8 * j) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
  // the peer may still arrive on this block's free barrier: neither block
  // exits before both are done with the other's shared memory
  if constexpr (CL > 1) cluster_sync();
}

template <int D, int NWG, int CL>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int causal,
                 int window, float scale, int out_f32, int smem, cudaStream_t stream) {
  using L = DqLayout<D, NWG, CL>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, L::BQ);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, L::BQ);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, flash::BK);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, flash::BK);
  if (err) return err;
  auto kernel = flash_dq_wgmma<D, NWG, CL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, CL * ((Sq + L::BQ - 1) / L::BQ));
  cfg.blockDim = dim3(128 * (NWG + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = CL;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, tdo, static_cast<const bf16*>(o),
                         static_cast<const bf16*>(dout), static_cast<const float*>(lse), dq, Sq,
                         Sk, H, KV, causal, window, scale, out_f32);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D, int BQ, int BK, int CL>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* lse,
               const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int causal,
               int window, float scale, int out_f32, int smem, cudaStream_t stream) {
  using L = dq32::Layout<D, BQ, BK, CL>;
  if (smem != L::bytes || !out_f32) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, BQ, true);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, BQ, true);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, BK, true);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, BK, true);
  if (err) return err;
  auto kernel = dq32::flash_dq_fma<D, BQ, BK, CL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, CL * ((Sq + BQ - 1) / BQ));
  cfg.blockDim = dim3(dq32::THR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = CL;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, tdo, static_cast<const float*>(o),
                         static_cast<const float*>(dout), static_cast<const float*>(lse),
                         static_cast<float*>(dq), Sq, Sk, H, KV, causal, window, scale);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32. bf16 takes the tensor-core kernel:
// block_q 64 or 128 at D 64 and 128, 64 at D 256 and 512; fp32 the FMA
// kernel: block_q 64 at D 64 and 128 (64-key tiles), 32 at D 256 and 512
// (32-key tiles), dq in fp32. At D 512 both routes launch a cluster of two
// blocks a query tile, each owning half of dQ. smem: the plan's
// shared-memory bytes, checked against the kernel's own layout.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int D,
    int causal, int window, float scale, int out_f32, int f32, int block_q, int smem,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || (f32 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, dout, dq, B, Sq, Sk, H, KV, causal, window, scale, out_f32, smem, s
  if (f32) {
    if (D == 512 && block_q == 32) return launch_fma<512, 32, 32, 2>(ARGS);
    if (D == 256 && block_q == 32) return launch_fma<256, 32, 32, 1>(ARGS);
    if (D == 128 && block_q == 64) return launch_fma<128, 64, 64, 1>(ARGS);
    if (D == 64 && block_q == 64) return launch_fma<64, 64, 64, 1>(ARGS);
  } else {
    if (D == 512 && block_q == 64) return launch_wgmma<512, 1, 2>(ARGS);
    if (D == 256 && block_q == 64) return launch_wgmma<256, 1, 1>(ARGS);
    if (D == 128 && block_q == 128) return launch_wgmma<128, 2, 1>(ARGS);
    if (D == 128 && block_q == 64) return launch_wgmma<128, 1, 1>(ARGS);
    if (D == 64 && block_q == 128) return launch_wgmma<64, 2, 1>(ARGS);
    if (D == 64 && block_q == 64) return launch_wgmma<64, 1, 1>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
