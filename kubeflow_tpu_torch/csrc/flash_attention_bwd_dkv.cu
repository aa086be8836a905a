// Flash-attention backward, dk and dv, for Hopper (sm_90a): fp32 math.
//
// Replaces the Pallas kernel _dkv_kernel (kubeflow_tpu/ops/pallas_attention.py:336).
// Layout: q, o, do [B, Sq, H, D], k/v [B, Sk, KV, D], all contiguous, one type;
// lse [B, H, Sq] fp32 (+inf on rows that see no key); dk, dv [B, Sk, KV, D]
// in fp32 (out_f32) or the operands' type. Query head h reads kv head h / (H / KV).
//
// For one kv head and its keys, over every query head of the GQA group and
// every query tile that can see those keys (from the diagonal to the
// sliding window's far edge, the TPU kernel's _q_valid, :119-130):
// dV += P^T dO and dK += dS^T Q, with P = exp(S * scale - lse) and dS = P *
// (dP - delta) * scale. delta = rowsum(do * o) is recomputed in fp32 from the
// do and o tiles (the TPU kernel does the same, :352-355), so the launch
// takes no delta array. P is rounded to the operands' type only as the
// operand of P^T dO, dS only as the operand of dS^T Q, and dS is formed from
// the fp32 P (the TPU kernel's rounding points, :363-372; in fp32 both
// roundings are the identity).
//
// The TPU kernel's grid runs per query head, so under GQA it writes
// [B, H, Sk, D] fp32 partials and sums them afterwards (:428-456). Here one
// block owns the kv head and sums its group in fp32 registers: no partials,
// no atomics, and the result is deterministic.
//
// Bound at the flagship training shape (B4 H8 S2048 D128, causal): FLOPs,
// four causal matmuls (k q^T, v do^T, p^T do, ds^T q) = 6.9e10 FLOP, 0.070 ms
// at the card's 989 TFLOP/s bf16 peak, against ~84 MB of bf16 operands
// (0.025 ms at 3.35 TB/s); at D 256 1.4e11 FLOP, 0.139 ms.
//
// bf16 operands at head widths 64 and 128: the tensor-core kernel
// flash_dkv_wgmma, FA3's backward shape without dQ
// (flash_attention_bwd_dq.cu computes dq). One block per
// (kv head, batch row, 64 * NWG keys), the lowest keys (the most query tiles
// under a causal mask) first. Thread 0 loads the block's K and V tiles once
// by TMA (they stay resident) and walks the (query head, 64-row query tile)
// pairs that can see them, feeding the Q, dO and O tiles through a 2-stage
// mbarrier ring: it refills a stage as soon as both warpgroups released it,
// polling at the top of each tile and while the tile's last products run.
// Each of the NWG consumer warpgroups owns 64 keys and per tile computes
// S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory (K, V, Q and dO
// stored [rows, D] are K-major for both), delta and lse of the tile's 64
// queries while those run, P^T and dS^T in fp32 registers (the queries are
// the accumulators' columns; masks only on edge tiles), and dV += P^T dO,
// dK += dS^T Q with P^T's and dS^T's bf16 A fragments taken from the
// accumulator registers and dO, Q read MN-major from the same tiles. dK and
// dV stay in fp32 registers across the whole walk.
//
// Registers are the design question: at D 128 a consumer thread holds dK 64
// + dV 64 + S^T 32 + dP^T 32 fp32 accumulators (255 registers in all, no
// spills). A producer warpgroup beside two consumers (the forward's and
// dq's shape) puts three warps on each of the SM's four register files, and
// CUDA 12.8's ptxas then caps every thread at 168 registers whatever
// setmaxnreg asks for at run time: that build spilled 804 bytes, serialised
// its wgmmas (C7512) and took 0.94 ms at the training shape on an H100 80GB
// HBM3. Without it, two warps a register file may take 255.
//
// bf16 at head width 256: the kernel above would hold dK, dV, S^T and dP^T
// (320 fp32 registers a thread, past 255) and needs 264,232 bytes of shared
// memory (past 232,448). flash_dkv_wgmma_pair splits the accumulators across
// its two consumer warpgroups instead: one block per (kv head, batch row, 64
// keys), 256 threads, thread 0 producing as above; K and V resident (64 KiB),
// the Q, dO and O tiles in 48-row tiles through the 2-stage ring (144 KiB;
// 226,744 bytes in all). Warpgroup 0 owns dV: per tile S^T = K Q^T (m64n48k16
// from shared memory), P^T = exp(S^T * scale - lse) in fp32 registers, P^T
// written to the exchange slot in shared memory in its own fragment order,
// then dV += P^T dO with P^T's bf16 fragments from registers. Warpgroup 1 owns
// dK: dP^T = V dO^T, delta of the tile's 48 rows from the dO and O tiles while
// it runs, then, once the slot is full, dS^T = P^T (dP^T - delta) * scale from
// the fp32 P^T it reads back thread for thread (the same fragment layout: no
// bank conflicts), and dK += dS^T Q. Each warpgroup runs two of the tile's
// four products and holds 128 + 24 accumulators a thread (212 registers in
// all, no spills); the slot is guarded by two mbarriers (full: warpgroup 0's
// 128 arrivals, empty: warpgroup 1's). What bounds it on an H100 (a clock64
// breakdown of an instrumented copy): the issue of the narrow score products,
// which take the tensor cores several times their FLOPs' share, and each
// tile's chain of products, exponentials, delta and exchange; neither the
// tiles' traffic, the launch order nor the ring's depth moved it.
//
// bf16 at head width 512: dK and dV of 64 keys would take 2 x 64 x 512 fp32,
// the SM's whole register file, and K and V resident 128 KiB. So
// flash_dkv_wgmma_pair<512, 2> runs the pair kernel on each column half, as a
// cluster of two blocks a 64-key block (grid (KV, B, 2 x key blocks)): block
// c holds columns 256 c .. 256 c + 255 of K, V, Q and dO (64 KiB resident,
// 48-row tiles) and owns those of dK and dV. Its S^T and dP^T are partial
// sums over its columns; after each tile's score product a warpgroup sends
// its fp32 partials to its twin in the other block by st.async through
// distributed shared memory and adds the twin's (the same sum in both),
// then proceeds as at width 256. Every score product is computed once,
// m64n48k16 steps: exactly the bound's FLOPs (6.9e10 at the heads-of-512
// training shape, B4 S2048 H2; 0.070 ms), where the first port's grid axis
// of two halves recomputed S^T and dP^T over all 512 columns in m64n16k16
// steps (1.5x). O stays out of the ring (two more stages would pass the
// block's shared memory): one O tile of the block's columns, which
// warpgroup 1's first thread reloads by TMA for the next ring item once the
// warpgroup's delta pass has read it; the partial delta, formed with the
// ring's dO while the score product runs, is swapped with the partials
// (226,976 bytes with the 24 KiB of receive slots).
//
// fp32 operands: flash_dkv_fma, the bf16 route's walk with register-tiled
// fp32 FMA products (no TF32; bound four causal matmuls at the 67 TF/s fp32
// peak, 1.026 ms at the training shape). One block per (kv head, batch row,
// BK keys), the lowest keys first. K and V stay resident; the Q and dO
// tiles of every query head of the group and every tile that can see the
// keys stream through a 2-stage TMA ring of fp32 boxes of 32 columns,
// thread 128 issuing the copies between its own products. The two
// warpgroups split the products as flash_dkv_wgmma_pair does: warpgroup 0
// S^T = K Q^T, P^T and dV += P^T dO, warpgroup 1 dP^T = V dO^T, dS^T and dK
// += dS^T Q, each thread 8 keys (g + 8 i) by 4 query rows (x + 16 j) of its
// score tile and the same 8 keys of its accumulator, columns 4 x + 64 h ..
// + 3 (the fma32 pieces of flash_common.cuh), in fp32 registers across the
// whole walk. A thread doing both products of 4 x 4 scores (the first
// design) fed 8 FMAs a shared-memory load in the score products and 10.7 in
// the accumulations; the split feeds the forward's 10.7 and 16, and ran
// faster on an H100. P^T passes from a warpgroup 0 thread
// to its twin in warpgroup 1 through an fp32 tile behind two mbarriers; each
// warpgroup's dS^T or P^T goes through its warps' own rows to its
// accumulation. O would not fit a stage, so delta = rowsum(dO * O) of a
// tile's rows is taken half by each warpgroup from the stage's dO and O
// rows read from device memory (loaded before the score product, used after
// it), and shared through the stage's delta row under
// the P^T barrier. Only edge tiles mask. D 64 and 128 take 64 keys and
// 64-row tiles (230,968 bytes at D 128), D 256 32 and 32 (206,136 bytes).
// The TPU kernel's roundings of P and dS to the operands' type are the
// identity in fp32. What bounds it on an H100 (a clock64-stamped scratch
// copy, not committed): the two FMA loops take most of a warp's cycles,
// below the fp32 issue rate, and each tile's P^T step most of the rest.
//
// Head width 512 (fp32): flash_dkv_fma<512, 32, 32, 2>. K and V resident at
// 512 columns would leave room for 16 keys and 16-row tiles only (2 keys by
// 1 row of scores a thread). So, as the bf16 pair, the width-256 kernel runs
// on each column half as a cluster of two blocks a 32-key block (grid (KV,
// B, 2 x key blocks)): block c holds columns 256 c .. 256 c + 255 of K, V,
// Q and dO and owns those of dK and dV. After each ring item's score
// product, partial over its columns, each warpgroup sends its 8 fp32
// partials a thread (S^T from warpgroup 0, dP^T from 1) to its twin
// warpgroup in the other block by st.async, forms the partial delta of its
// half of the rows (O's rows of the block's columns from device memory)
// while they travel, sends that too (one float a row), and adds the twin's
// partials and partial delta: the same bits of S^T, dP^T and delta in both
// blocks. Then P^T, dS^T and the accumulations as at width 256. 214,488
// bytes; exactly the bound's FLOPs.

#include "flash_common.cuh"

namespace {

using flash::bf16;

// ---- the fp32 route: register-tiled fp32 FMAs fed by TMA, one warpgroup
// owning dV and one dK

namespace dkv32 {

constexpr int THR = 256;
constexpr int GS = 8;             // row groups of a warpgroup (16 lanes each)

// Shared memory of flash_dkv_fma<D, BK, BQ, CL>, in bytes from a 1024-aligned
// base: the K and V tiles (DL / 32 slabs of BK rows of 32 fp32 columns each,
// resident; DL = D / CL the block's columns), STAGES ring stages (the Q
// tile's DL / 32 slabs of BQ rows, then the dO tile's), the fp32 P^T and
// dS^T tiles [BK][BQ], each stage's delta row [STAGES][BQ], at CL 2 each
// warpgroup's receive slot of the peer's partial S^T or dP^T ([2][128]
// float4) and the peer's partial delta row [BQ], then the mbarriers: K/V,
// full[STAGES], empty[STAGES], P full, P empty, and at CL 2 each
// warpgroup's receive full and free. `bytes` adds the slack for aligning the
// dynamic base; ops/pallas_attention.py (_fma_bwd_bytes) sums the same and
// the launcher checks it.
template <int D, int BK, int BQ, int CL>
struct Layout {
  static constexpr int DL = D / CL;
  static constexpr int NS = DL / 32;
  static constexpr int SLAB_K = BK * 128;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int STAGE = 2 * NS * SLAB_Q;
  static constexpr int K = 0;
  static constexpr int V = K + NS * SLAB_K;
  static constexpr int RING = V + NS * SLAB_K;
  static constexpr int P = RING + flash::STAGES * STAGE;
  static constexpr int DS = P + BK * BQ * 4;
  static constexpr int ROWS = DS + BK * BQ * 4;
  static constexpr int RX = ROWS + flash::STAGES * BQ * 4;
  static constexpr int RX_DELTA = RX + 2 * BK * BQ * 4;
  static constexpr int BAR = RX + (CL > 1 ? 2 * BK * BQ * 4 + BQ * 4 : 0);
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES + 2) + (CL > 1 ? 32 : 0);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
  static_assert(CL == 1 || (DL == 256 && BK * BQ == 1024), "a pair swaps 8 partials a thread");
};

// One block per (kv head, batch row, BK keys), the lowest keys first. Thread
// (g, x) of warpgroup wg holds keys g + 8 i (R of them) and query rows x + 16
// j (J): warpgroup 0 S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1 dP^T =
// V dO^T, dS^T = P^T (dP^T - delta) * scale from the P^T its twin thread of
// warpgroup 0 wrote, and dK += dS^T Q. Each runs one score product and one
// accumulation a tile, of the forward's shapes (8 x 4 scores, 8 x 8 of the
// accumulator at D 128), in its own registers; the roles differ only in
// their tiles' addresses and the P^T step. CL 2 (head width 512): block c of
// a cluster of two holds columns c DL .. of K, V, Q and dO and owns those of
// dK and dV; both walk the same ring items, and after each item's S^T or
// dP^T (partial over DL columns) each warpgroup swaps it, and the partial
// delta of its half of the rows, with its twin in the other block (the pair
// pieces of flash_common.cuh), the delta's partial formed while the
// partials travel.
template <int D, int BK, int BQ, int CL>
__global__ void __launch_bounds__(THR, 1)
flash_dkv_fma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ o, const float* __restrict__ lse, float* __restrict__ dk,
              float* __restrict__ dv, int Sq, int Sk, int H, int KV, int causal, int window,
              float scale) {
  using namespace flash;
  using L = Layout<D, BK, BQ, CL>;
  constexpr int NS = L::NS;
  constexpr int R = BK / GS;      // keys a thread
  constexpr int J = BQ / 16;      // query rows a thread of each score tile
  constexpr int DH = L::DL / 64;  // 4-column groups of dK or dV a thread
  constexpr int U = BQ / 2 / GS;  // delta rows a thread (each warpgroup half the tile's)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const float* fs = reinterpret_cast<const float*>(smem);
  float* pts = reinterpret_cast<float*>(smem + L::P);
  float* dts = reinterpret_cast<float*>(smem + L::DS);
  float* rows_s = reinterpret_cast<float*>(smem + L::ROWS);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_kv = s_base + L::BAR;
  const uint32_t p_full = bar_kv + 8 * (1 + 2 * STAGES), p_empty = p_full + 8;
  const uint32_t rx_full = p_empty + 8, rx_free = rx_full + 16;   // [2] each, a warpgroup's

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z / CL) * BK;   // the lowest keys, the heaviest causal blocks, first
  const int d0 = CL > 1 ? (int)cluster_rank() * L::DL : 0;   // the block's columns
  const int group = H / KV;
  // every tile of the walk holds a query that sees one of the block's keys
  // (tests/test_torch_flash_plan.py), so none is skipped
  const QueryTiles qt = query_tiles<BQ>(k0, BK, Sq, Sk, causal, window);
  const int n = group * qt.count;      // (query head, query tile) pairs, head by head
  if (threadIdx.x == 0) {
    mbar_init(p_full, THR / 32);       // every warp, once its delta rows (and P^T) are in
    mbar_init(p_empty, THR / 64);      // warpgroup 1's warps, once they read P^T
    if (CL > 1)
      for (int w = 0; w < 2; ++w) {
        mbar_init(rx_full + 8 * w, 1);
        mbar_init(rx_free + 8 * w, 4);
      }
  }
  init_barriers(bar_kv, THR / 32);     // empty: one arrival a warp
  if constexpr (CL > 1) cluster_sync();   // both blocks' barriers exist before a remote store

  int issued = 0;
  auto issue = [&](int j, int sj) {
    const int h = kvh * group + j / qt.count;
    const int q0 = (qt.first + j % qt.count) * BQ;
    const uint32_t dst = s_base + L::RING + sj * L::STAGE;
    mbar_expect_tx(bar_full(bar_kv, sj), L::STAGE);
    for (int s = 0; s < NS; ++s) {
      tma_load(dst + s * L::SLAB_Q, &tq, d0 + 32 * s, h, q0, b, bar_full(bar_kv, sj));
      tma_load(dst + (NS + s) * L::SLAB_Q, &tdo, d0 + 32 * s, h, q0, b, bar_full(bar_kv, sj));
    }
  };
  // thread 128 (warpgroup 1's first) issues the copies: warpgroup 0's P^T
  // gates warpgroup 1 every tile, so its warps carry no producer's work
  constexpr int PT = 128;
  if (threadIdx.x == PT) {
    mbar_expect_tx(bar_kv, 2 * NS * L::SLAB_K);
    for (int s = 0; s < NS; ++s) {
      tma_load(s_base + L::K + s * L::SLAB_K, &tk, d0 + 32 * s, kvh, k0, b, bar_kv);
      tma_load(s_base + L::V + s * L::SLAB_K, &tv, d0 + 32 * s, kvh, k0, b, bar_kv);
    }
    refill(issued, n, 0, bar_kv, issue);
  }
  __syncwarp();

  // the role comes from a shuffled index, which the compiler knows is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;
  const int g = tid >> 4, x = threadIdx.x & 15, lane = threadIdx.x & 31;
  const int kg = g & 7;
  const float sl2 = scale * LOG2E;
  const float* A = fs + (wg ? L::V : L::K) / 4;      // K (S^T) or V (dP^T), resident
  float* X = wg ? dts : pts;                          // this warpgroup's P^T or dS^T tile
  Pair pr{};
  if constexpr (CL > 1)
    pr = pair_at(s_base + L::RX + wg * BK * BQ * 4, rx_full + 8 * wg, rx_free + 8 * wg);
  const float4* rx = reinterpret_cast<const float4*>(smem + L::RX + wg * BK * BQ * 4);
  const float* rx_delta = reinterpret_cast<const float*>(smem + L::RX_DELTA);
  const uint32_t peer_delta = CL > 1 ? mapa(s_base + L::RX_DELTA, cluster_rank() ^ 1) : 0;
  float acc[R][4 * DH];                               // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * DH; ++c) acc[i][c] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const int h = kvh * group + it / qt.count;
    const int q0 = (qt.first + it % qt.count) * BQ;
    if (threadIdx.x == PT) refill(issued, n, it, bar_kv, issue);
    __syncwarp();
    // loaded now, used after the score product: lse * log2(e) of rows
    // x + 16 j (warpgroup 0), this thread's columns of the O rows of its
    // warpgroup's half of delta, rows BQ / 2 wg + g + 8 u
    float lse2[J];
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int qp = q0 + x + 16 * j;
        // a row past Sq, or one that sees no key (lse +inf), gives p = 0
        lse2[j] = qp < Sq ? __ldg(lse + ((size_t)b * H + h) * Sq + qp) * LOG2E : INFINITY;
      }
    }
    float4 ov[U][DH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int qp = q0 + BQ / 2 * wg + g + GS * u;
      fma32::load_row<DH>(ov[u], qp < Sq ? o + (((size_t)b * Sq + qp) * H + h) * D + d0 : nullptr,
                          x);
    }
    mbar_wait(bar_full(bar_kv, st), (it / STAGES) & 1);
    const float* Qt = fs + (L::RING + st * L::STAGE) / 4;
    const float* dOt = Qt + NS * L::SLAB_Q / 4;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): keys g + 8 i, rows x + 16 j
    float sp[1][R][J];
    auto& s = sp[0];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.f;
    fma32::dot_rows<NS, R, J, GS>(sp, {A}, L::SLAB_K / 4, {wg ? dOt : Qt}, L::SLAB_Q / 4, g, x);
    if (threadIdx.x == PT) refill(issued, n, it, bar_kv, issue);   // if free by now
    __syncwarp();

    // S^T = S0^T + S1^T or dP^T = dP0^T + dP1^T over the pair's column
    // halves: the partials leave first, then this warpgroup's half of the
    // tile's delta = rowsum(dO * O) (at CL 2 the block's columns' partial,
    // which follows them) is formed while they travel
    float part[R * J];
    if constexpr (CL > 1) {
#pragma unroll
      for (int e = 0; e < R * J; ++e) part[e] = s[e / J][e % J];
      pair_send(pr, part, it, tid, BK * BQ * 4 + BQ / 2 * 4);
    }
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = BQ / 2 * wg + g + GS * u;
      d[u] = fma32::row_delta<DH>(dOt + r * 32, L::SLAB_Q / 4, ov[u], x, kg);
      if (CL > 1 && x == 0) pair_send_one(pr, peer_delta + 4 * r, d[u]);
    }
    if constexpr (CL > 1) {
      pair_add(pr, part, rx, it, tid);
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] += rx_delta[BQ / 2 * wg + g + GS * u];
      pair_release(pr);
#pragma unroll
      for (int e = 0; e < R * J; ++e) s[e / J][e % J] = part[e];
    }
    // into the stage's row
    float* rows = rows_s + st * BQ;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (x == 0) rows[BQ / 2 * wg + g + GS * u] = d[u];
    if (wg == 0) {
      // P^T = exp(S^T * scale - lse), masks only on edge tiles, into the P^T
      // tile once warpgroup 1 read the last one
      const bool edge = qtile_edge<BQ, BK>(k0, q0, Sq, Sk, causal, window);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int qp = q0 + x + 16 * j;
          const bool keep = !edge || (qp < Sq && visible(k0 + g + GS * i, qp, Sk, causal, window));
          s[i][j] = keep ? exp2f(fmaf(s[i][j], sl2, -lse2[j])) : 0.f;
        }
      mbar_wait(p_empty, (it & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < R; ++i) fma32::put_row<J>(pts + (g + GS * i) * BQ, s[i], x, kg);
      __syncwarp();
      if (lane == 0) mbar_arrive(p_full);
    } else {
      // dS^T = P^T (dP^T - delta) * scale, P^T from warpgroup 0's twin thread
      __syncwarp();
      if (lane == 0) mbar_arrive(p_full);
      mbar_wait(p_full, it & 1);
      float delta[J];
#pragma unroll
      for (int j = 0; j < J; ++j) delta[j] = rows[x + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float pv[J];
        fma32::get_row<J>(pts + (g + GS * i) * BQ, pv, x, kg);
#pragma unroll
        for (int j = 0; j < J; ++j) s[i][j] = pv[j] * (s[i][j] - delta[j]) * scale;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(p_empty);
#pragma unroll
      for (int i = 0; i < R; ++i) fma32::put_row<J>(dts + (g + GS * i) * BQ, s[i], x, kg);
      __syncwarp();
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), from the warp's own rows
    fma32::acc_rows<R, J, DH, GS>(acc, X, wg ? Qt : dOt, L::SLAB_Q / 4, g, x);
    __syncwarp();                  // this warp's tile reads and stage reads are done
    if (lane == 0) mbar_arrive(bar_empty(bar_kv, st));
  }

  // keys past Sk are never stored; a block no query sees stores zeros
  float* out = wg ? dk : dv;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + g + GS * i;
    if (kp >= Sk) continue;
    float* orow = out + (((size_t)b * Sk + kp) * KV + kvh) * D + d0 + 4 * x;
#pragma unroll
    for (int hh = 0; hh < DH; ++hh)
      *reinterpret_cast<float4*>(orow + 64 * hh) =
          make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
  }
  // the peer may still arrive on this block's free barriers: neither block
  // exits before both are done with the other's shared memory
  if constexpr (CL > 1) cluster_sync();
}

}  // namespace dkv32

// ---- the tensor-core route (bf16)

// Shared memory of flash_dkv_wgmma, in bytes from a 1024-aligned base: the
// block's K and V tiles (D / 64 slabs of BKB rows each, resident), STAGES
// Q, dO and O tiles (D / 64 slabs of 64 rows each), each consumer
// warpgroup's two [delta 64 | lse * log2(e) 64] fp32 rows, then the
// mbarriers: K/V, full[STAGES], empty[STAGES]. ops/pallas_attention.py
// (_plan) computes the same bytes; the launcher checks them.
template <int D, int NWG>
struct DkvLayout {
  static constexpr int BKB = 64 * NWG;
  static constexpr int NS = D / 64;
  static constexpr int SLAB_KB = BKB * 128;
  static constexpr int SLAB_Q = flash::QROWS * 128;
  static constexpr int K = 0;
  static constexpr int V = K + NS * SLAB_KB;
  static constexpr int Q = V + NS * SLAB_KB;
  static constexpr int DO = Q + flash::STAGES * NS * SLAB_Q;
  static constexpr int O = DO + flash::STAGES * NS * SLAB_Q;
  static constexpr int ROWS = O + flash::STAGES * NS * SLAB_Q;
  static constexpr int BAR = ROWS + NWG * 2 * 2 * flash::QROWS * 4;
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tout,
                const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                void* __restrict__ dk, void* __restrict__ dv, int Sq, int Sk, int H, int KV,
                int causal, int window, float scale, int out_f32) {
  using namespace flash;
  using L = DkvLayout<D, NWG>;
  constexpr int NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_kv = s_base + L::BAR;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * L::BKB;  // the lowest keys, the heaviest causal blocks, first
  const int group = H / KV;
  const QueryTiles qt = query_tiles(k0, L::BKB, Sq, Sk, causal, window);
  const int n = group * qt.count;      // (query head, query tile) pairs, head by head
  init_barriers(bar_kv, NWG * 128);

  // ---- thread 0 also produces: ring tile j (query head kvh * group + j /
  // count) goes into stage j % STAGES once the consumers of tile j - STAGES
  // released it. It blocks only for the tile its own warpgroup needs next,
  // `must`, and otherwise issues what is free, at most STAGES - 1 ahead.
  int issued = 0;
  auto refill = [&](int must) {
    while (issued < n && issued < must + STAGES) {
      const int j = issued, sj = j % STAGES;
      const uint32_t empty = bar_empty(bar_kv, sj), full = bar_full(bar_kv, sj);
      const int parity = ((j / STAGES) & 1) ^ 1;
      if (j > must && !mbar_try_wait(empty, parity)) break;
      mbar_wait(empty, parity);
      const int h = kvh * group + j / qt.count;
      const int q0 = (qt.first + j % qt.count) * QROWS;
      mbar_expect_tx(full, 3 * NS * L::SLAB_Q);
      for (int s = 0; s < NS; ++s) {
        const uint32_t off = (sj * NS + s) * L::SLAB_Q;
        tma_load(s_base + L::Q + off, &tq, 64 * s, h, q0, b, full);
        tma_load(s_base + L::DO + off, &tdo, 64 * s, h, q0, b, full);
        tma_load(s_base + L::O + off, &tout, 64 * s, h, q0, b, full);
      }
      ++issued;
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * NS * L::SLAB_KB);
    for (int s = 0; s < NS; ++s) {
      tma_load(s_base + L::K + s * L::SLAB_KB, &tk, 64 * s, kvh, k0, b, bar_kv);
      tma_load(s_base + L::V + s * L::SLAB_KB, &tv, 64 * s, kvh, k0, b, bar_kv);
    }
    refill(0);
  }
  __syncwarp();

  // ---- consumers: warpgroup c owns keys kc0 .. kc0 + 63
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kc0 = k0 + 64 * c;
  const int key[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};
  const float sl2 = scale * LOG2E;
  const uint32_t k_tile = s_base + L::K + c * 64 * 128;
  const uint32_t v_tile = s_base + L::V + c * 64 * 128;
  float* rows_c = reinterpret_cast<float*>(smem + L::ROWS) + c * 2 * 2 * QROWS;

  float acc_dk[D / 2], acc_dv[D / 2];  // dK, dV [64, D]: D / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  int done = 0;                        // tiles this warpgroup computed: picks its rows buffer
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const int h = kvh * group + it / qt.count;
    const int q0 = (qt.first + it % qt.count) * QROWS;
    if (threadIdx.x == 0) refill(it);
    __syncwarp();
    mbar_wait(bar_full(bar_kv, st), (it / STAGES) & 1);
    if (!qtile_hidden(kc0, q0, Sq, Sk, causal, window)) {
      const int qr = q0 + (threadIdx.x % 128) / 2;   // this thread's row of the delta pass
      const float lse2_r = qr < Sq ? lse[((size_t)b * H + h) * Sq + qr] * LOG2E : INFINITY;
      const uint32_t q_tile = s_base + L::Q + st * NS * L::SLAB_Q;
      const uint32_t do_tile = s_base + L::DO + st * NS * L::SLAB_Q;
      const uint32_t o_tile = s_base + L::O + st * NS * L::SLAB_Q;
      float s[QROWS / 2], dp[QROWS / 2];   // S^T, dP^T [64 keys, 64 queries]
#pragma unroll
      for (int i = 0; i < QROWS / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_k(k_tile, L::SLAB_KB, kk), desc_k(q_tile, L::SLAB_Q, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(v_tile, L::SLAB_KB, kk), desc_k(do_tile, L::SLAB_Q, kk), kk > 0);
      wgmma_commit();

      // while they run: delta = rowsum(dO * O) and lse * log2(e) of the
      // tile's 64 query rows, two threads a row, from the swizzled tiles
      float* rows = rows_c + (done++ & 1) * 2 * QROWS;
      {
        const int i = threadIdx.x % 128, r = i / 2, half = i % 2;
        const uint8_t* do_row = smem + (do_tile - s_base) + r * 128;
        const uint8_t* o_row = smem + (o_tile - s_base) + r * 128;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const int cc = half * (D / 16) + u;   // 16-byte chunk of the row
          const int off = (cc / 8) * L::SLAB_Q + (((cc % 8) ^ (r % 8)) << 4);
          const uint4 d4 = *reinterpret_cast<const uint4*>(do_row + off);
          const uint4 o4 = *reinterpret_cast<const uint4*>(o_row + off);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(d2[e]), y = __bfloat1622float2(o2[e]);
            sum = fmaf(x.x, y.x, sum);
            sum = fmaf(x.y, y.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (half == 0) {
          rows[r] = sum;
          rows[QROWS + r] = lse2_r;
        }
        named_sync(1 + c, 128);
      }
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // columns are queries: element x = 4j + 2i + e is (key[i], query
      // q0 + 8j + 2t + e); p and ds in place, from the fp32 p. Only edge
      // tiles test each pair: a test per element on every tile cost a
      // quarter of the kernel's time.
      if (qtile_edge(kc0, q0, Sq, Sk, causal, window)) {
#pragma unroll
        for (int j = 0; j < QROWS / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 delta = *reinterpret_cast<const float2*>(rows + col);
          const float2 lse2 = *reinterpret_cast<const float2*>(rows + QROWS + col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e, qp = q0 + col + e;
              const bool keep = qp < Sq && visible(key[i], qp, Sk, causal, window);
              // masked pairs, queries past Sq and rows with lse = +inf give p = 0
              const float p = keep ? exp2f(fmaf(s[x], sl2, -(e ? lse2.y : lse2.x))) : 0.f;
              s[x] = p;
              dp[x] = p * (dp[x] - (e ? delta.y : delta.x)) * scale;
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < QROWS / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 delta = *reinterpret_cast<const float2*>(rows + col);
          const float2 lse2 = *reinterpret_cast<const float2*>(rows + QROWS + col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              // a row with lse = +inf gives p = 0
              const float p = exp2f(fmaf(s[x], sl2, -(e ? lse2.y : lse2.x)));
              s[x] = p;
              dp[x] = p * (dp[x] - (e ? delta.y : delta.x)) * scale;
            }
        }
      }
      uint32_t pa[QROWS / 16][4], da[QROWS / 16][4];   // P^T, dS^T in bf16: A operands
#pragma unroll
      for (int kk = 0; kk < QROWS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QROWS / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128(acc_dv, pa[kk], desc_mn(do_tile, kk), 1);
        else
          wgmma_rs_n64(acc_dv, pa[kk], desc_mn(do_tile, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < QROWS / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128(acc_dk, da[kk], desc_mn(q_tile, kk), 1);
        else
          wgmma_rs_n64(acc_dk, da[kk], desc_mn(q_tile, kk), 1);
      }
      wgmma_commit();
      if (threadIdx.x == 0) refill(it);   // while they run
      __syncwarp();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    mbar_arrive(bar_empty(bar_kv, st));
  }

  // keys past Sk are never stored; a block no query sees stores zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key[i]) * KV + kvh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int x = 4 * j + 2 * i;
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + off + 8 * j) =
            make_float2(acc_dk[x], acc_dk[x + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + off + 8 * j) =
            make_float2(acc_dv[x], acc_dv[x + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dk) + off + 8 * j) =
            __floats2bfloat162_rn(acc_dk[x], acc_dk[x + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dv) + off + 8 * j) =
            __floats2bfloat162_rn(acc_dv[x], acc_dv[x + 1]);
      }
    }
  }
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                 int causal, int window, float scale, int out_f32, int smem,
                 cudaStream_t stream) {
  using L = DkvLayout<D, NWG>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tout, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, flash::QROWS);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, flash::QROWS);
  if (!err) err = flash::make_map(&tout, o, D, H, Sq, B, flash::QROWS);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, L::BKB);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, L::BKB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_wgmma<D, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(KV, B, (Sk + L::BKB - 1) / L::BKB);
  flash_dkv_wgmma<D, NWG><<<grid, 128 * NWG, smem, stream>>>(
      tq, tk, tv, tout, tdo, static_cast<const float*>(lse), dk, dv, Sq, Sk, H, KV, causal,
      window, scale, out_f32);
  return (int)cudaGetLastError();
}

// ---- the tensor-core route at head widths 256 and 512 (bf16): two
// warpgroups, one owning dV and one dK; at 512 a cluster of two such blocks
// a key block, one a column half

// Shared memory of flash_dkv_wgmma_pair<D, CL>, in bytes from a 1024-aligned
// base: K and V (DL / 64 slabs of 64 keys each, resident; DL = D / CL the
// block's columns), STAGES Q and dO tiles of QR rows (DL / 64 slabs each),
// STAGES O tiles at CL 1 (one at CL 2), the exchange slot of fp32 P^T [64
// keys, QR queries] in the accumulators' fragment order, two delta rows of
// QR, at CL 2 the receive slots of the peer's partial S^T and dP^T ([QR /
// 8][128] float4 each) and its partial delta row, then the mbarriers: K/V,
// full[STAGES], empty[STAGES], slot full, slot empty, and at CL 2 each
// warpgroup's receive full and free and the O tile's.
// ops/pallas_attention.py (_wgmma_sums) computes the same bytes; the
// launcher checks them. QR 48 is the most rows whose two stages fit beside
// K and V; on an H100, 32-row tiles (with two slots) ran slower: the score
// products' N = QR sets their rate more than their FLOPs do. At CL 2 O stays
// out of the ring (its two stages and the receive slots would pass a
// block's 227 KiB): one O tile, which warpgroup 1 reloads for the next ring
// item once its delta pass has read it.
template <int D, int CL>
struct DkvPairLayout {
  static constexpr int DL = D / CL;
  static constexpr int NS = DL / 64;
  static constexpr int QR = 48;                 // query rows a ring tile
  static constexpr int SLAB_KB = 64 * 128;
  static constexpr int SLAB_Q = QR * 128;
  static constexpr int K = 0;
  static constexpr int V = K + NS * SLAB_KB;
  static constexpr int Q = V + NS * SLAB_KB;
  static constexpr int DO = Q + flash::STAGES * NS * SLAB_Q;
  static constexpr int O = DO + flash::STAGES * NS * SLAB_Q;
  static constexpr int X = O + (CL == 1 ? flash::STAGES : 1) * NS * SLAB_Q;
  static constexpr int ROWS = X + 64 * QR * 4;
  static constexpr int RX = ROWS + 2 * QR * 4;
  static constexpr int RX_DELTA = RX + 2 * 64 * QR * 4;   // the peer's partial delta row
  static constexpr int BAR = RX + (CL > 1 ? 2 * 64 * QR * 4 + QR * 4 : 0);
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES + 2) + (CL > 1 ? 40 : 0);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
};

// One block per (kv head, batch row, 64 keys), the lowest keys first, 256
// threads, thread 0 producing. CL 2 (head width 512): block c of a cluster
// of two holds columns c DL .. of K, V, Q and dO and owns those of dK and
// dV; after each tile's S^T (warpgroup 0) and dP^T (warpgroup 1), partial
// over its columns, each warpgroup swaps them with its twin in the other
// block (warpgroup 1 its partial delta row too) before P^T and dS^T (the pair
// pieces of flash_common.cuh): each score product once, m64n48k16 steps.
// O's tile of the block's columns comes by TMA into one buffer, issued by
// warpgroup 1's first thread for ring item it + 1 once the delta pass of
// item it has read it.
template <int D, int CL>
__global__ void __launch_bounds__(256, 1)
flash_dkv_wgmma_pair(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tout,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                     void* __restrict__ dk, void* __restrict__ dv,
                     int Sq, int Sk, int H, int KV, int causal, int window, float scale,
                     int out_f32) {
  using namespace flash;
  using L = DkvPairLayout<D, CL>;
  constexpr int NS = L::NS, QR = L::QR, DL = L::DL;
  static_assert(DL == 256, "the pair's warpgroups hold 256 columns of dV or dK");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_kv = s_base + L::BAR;
  const uint32_t slot_full = bar_kv + 8 * (1 + 2 * STAGES), slot_empty = slot_full + 8;
  const uint32_t rx_full = slot_empty + 8, rx_free = rx_full + 16;   // [2] each, a warpgroup's
  const uint32_t bar_o = rx_free + 16;                                 // the O tile (CL 2)

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z / CL) * 64;   // the lowest keys, the heaviest causal blocks, first
  const int d0 = CL > 1 ? (int)cluster_rank() * DL : 0;   // the block's columns
  const int group = H / KV;
  // every tile of the walk holds a query that sees one of the block's keys
  // (tests/test_torch_flash_plan.py), so none is skipped
  const QueryTiles qt = query_tiles<QR>(k0, 64, Sq, Sk, causal, window);
  const int n = group * qt.count;      // (query head, query tile) pairs, head by head
  if (threadIdx.x == 0) {
    mbar_init(slot_full, 128);
    mbar_init(slot_empty, 128);
    if (CL > 1)
      for (int w = 0; w < 2; ++w) {
        mbar_init(rx_full + 8 * w, 1);
        mbar_init(rx_free + 8 * w, 4);
      }
    if (CL > 1) mbar_init(bar_o, 1);
  }
  init_barriers(bar_kv, 256);
  if constexpr (CL > 1) cluster_sync();   // both blocks' barriers exist before a remote store

  // ---- thread 0 also produces, as flash_dkv_wgmma's does
  int issued = 0;
  auto issue = [&](int j, int sj) {
    const int h = kvh * group + j / qt.count;
    const int q0 = (qt.first + j % qt.count) * QR;
    const uint32_t full = bar_full(bar_kv, sj);
    mbar_expect_tx(full, (CL == 1 ? 3 : 2) * NS * L::SLAB_Q);
    for (int s = 0; s < NS; ++s) {
      const uint32_t off = (sj * NS + s) * L::SLAB_Q;
      tma_load(s_base + L::Q + off, &tq, d0 + 64 * s, h, q0, b, full);
      tma_load(s_base + L::DO + off, &tdo, d0 + 64 * s, h, q0, b, full);
      if (CL == 1) tma_load(s_base + L::O + off, &tout, 64 * s, h, q0, b, full);
    }
  };
  // CL 2: ring item j's O tile (its rows, the block's columns) into the one O buffer
  auto load_o = [&](int j) {
    const int h = kvh * group + j / qt.count;
    const int q0 = (qt.first + j % qt.count) * QR;
    mbar_expect_tx(bar_o, NS * L::SLAB_Q);
    for (int s = 0; s < NS; ++s)
      tma_load(s_base + L::O + s * L::SLAB_Q, &tout, d0 + 64 * s, h, q0, b, bar_o);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * NS * L::SLAB_KB);
    for (int s = 0; s < NS; ++s) {
      tma_load(s_base + L::K + s * L::SLAB_KB, &tk, d0 + 64 * s, kvh, k0, b, bar_kv);
      tma_load(s_base + L::V + s * L::SLAB_KB, &tv, d0 + 64 * s, kvh, k0, b, bar_kv);
    }
    refill(issued, n, 0, bar_kv, issue);
  }
  if (CL > 1 && threadIdx.x == 128 && n > 0) load_o(0);
  __syncwarp();

  // ---- warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO; warpgroup 1: dP^T =
  // V dO^T, delta, dS^T, dK += dS^T Q. Every wgmma is the same instruction
  // in both, on other tiles; the role comes from a shuffled index, which
  // ptxas knows is warp-uniform (a branch on threadIdx.x serialises wgmma).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float sl2 = scale * LOG2E;
  const uint32_t a_tile = s_base + (wg ? L::V : L::K);
  float4* xs = reinterpret_cast<float4*>(smem + L::X) + tid;     // [QR / 8][128] float4
  float* delta_rows = reinterpret_cast<float*>(smem + L::ROWS);  // [2][QR]
  Pair pr{};
  if constexpr (CL > 1)
    pr = pair_at(s_base + L::RX + wg * 64 * QR * 4, rx_full + 8 * wg, rx_free + 8 * wg);
  const float4* rx = reinterpret_cast<const float4*>(smem + L::RX + wg * 64 * QR * 4);
  const float* rx_delta = reinterpret_cast<const float*>(smem + L::RX_DELTA);

  float acc[DL / 2];   // dV (warpgroup 0) or dK (1) [64, DL]: DL / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < DL / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, lap = it & 1;
    const int h = kvh * group + it / qt.count;
    const int q0 = (qt.first + it % qt.count) * QR;
    if (threadIdx.x == 0) refill(issued, n, it, bar_kv, issue);
    __syncwarp();
    mbar_wait(bar_full(bar_kv, st), (it / STAGES) & 1);
    const uint32_t q_tile = s_base + L::Q + st * NS * L::SLAB_Q;
    const uint32_t do_tile = s_base + L::DO + st * NS * L::SLAB_Q;
    const uint32_t o_tile = s_base + L::O + (CL == 1 ? st * NS * L::SLAB_Q : 0);
    const uint32_t b_tile = wg ? do_tile : q_tile;
    float* rows = delta_rows + lap * QR;
    float s[QR / 2];   // S^T or dP^T [64 keys, QR queries]
#pragma unroll
    for (int i = 0; i < QR / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DL / 16; ++kk)
      wgmma_ss_n48(s, desc_k(a_tile, L::SLAB_KB, kk), desc_k(b_tile, L::SLAB_Q, kk), kk > 0);
    wgmma_commit();

    // while it runs: lse * log2(e) (warpgroup 0) or delta (1) of this
    // thread's columns (queries q0 + 8j + 2t + e) into col[2j + e]
    float col[QR / 4];
    if (wg == 0) {
      const float* lse_h = lse + ((size_t)b * H + h) * Sq;
#pragma unroll
      for (int j = 0; j < QR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + 8 * j + 2 * t + e;
          col[2 * j + e] = qp < Sq ? __ldg(lse_h + qp) * LOG2E : INFINITY;
        }
    } else {
      // delta = rowsum(dO * O) of the tile's QR rows (at CL 2 the partial
      // sum over the block's columns) from the swizzled tiles, four threads
      // a row, each one 64-column slab, 32 rows a pass
      if constexpr (CL > 1) mbar_wait(bar_o, it & 1);
      const int part = tid % 4;
#pragma unroll
      for (int r0 = 0; r0 < QR; r0 += 32) {
        const int r = r0 + tid / 4;
        float sum = 0.f;
        if (r < QR) {
          const uint8_t* do_row = smem + (do_tile - s_base) + part * L::SLAB_Q + r * 128;
          const uint8_t* o_row = smem + (o_tile - s_base) + part * L::SLAB_Q + r * 128;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int off = (u ^ (r % 8)) << 4;
            const uint4 d4 = *reinterpret_cast<const uint4*>(do_row + off);
            const uint4 o4 = *reinterpret_cast<const uint4*>(o_row + off);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
            const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = __bfloat1622float2(d2[e]), y = __bfloat1622float2(o2[e]);
              sum = fmaf(x.x, y.x, sum);
              sum = fmaf(x.y, y.y, sum);
            }
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (r < QR && part == 0) rows[r] = sum;
      }
      named_sync(1, 128);
      if constexpr (CL == 1) {
#pragma unroll
        for (int j = 0; j < QR / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
          col[2 * j] = d.x;
          col[2 * j + 1] = d.y;
        }
      } else if (tid == 0 && it + 1 < n) {
        load_o(it + 1);              // every thread of the warpgroup has read this one
      }
    }
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (CL > 1) {
      // S^T = S0^T + S1^T (warpgroup 0) or dP^T = dP0^T + dP1^T and delta =
      // delta0 + delta1 (1) over the pair's column halves
      pair_send(pr, s, it, tid, 64 * QR * 4 + (wg ? QR * 4 : 0));
      if (wg == 1 && tid < QR / 4)
        st_async_u4(mapa(s_base + L::RX_DELTA, cluster_rank() ^ 1) + 16 * tid,
                    *reinterpret_cast<const uint4*>(rows + 4 * tid), pr.peer_full);
      pair_add(pr, s, rx, it, tid);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < QR / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
          const float2 e = *reinterpret_cast<const float2*>(rx_delta + 8 * j + 2 * t);
          col[2 * j] = d.x + e.x;
          col[2 * j + 1] = d.y + e.y;
        }
      }
      pair_release(pr);
    }

    // element x = 4j + 2i + e is (key[i], query q0 + 8j + 2t + e)
    if (wg == 0) {
      // P^T = exp(S^T * scale - lse) in place; only edge tiles test each
      // pair (masked pairs, queries past Sq, rows with lse = +inf give 0)
      if (qtile_edge<QR>(k0, q0, Sq, Sk, causal, window)) {
#pragma unroll
        for (int j = 0; j < QR / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e, qp = q0 + 8 * j + 2 * t + e;
              const bool keep = qp < Sq && visible(key[i], qp, Sk, causal, window);
              s[x] = keep ? exp2f(fmaf(s[x], sl2, -col[2 * j + e])) : 0.f;
            }
      } else {
#pragma unroll
        for (int x = 0; x < QR / 2; ++x)
          s[x] = exp2f(fmaf(s[x], sl2, -col[2 * (x / 4) + x % 2]));
      }
      // the fp32 P^T to warpgroup 1, once it has read the last one
      mbar_wait(slot_empty, lap ^ 1);
#pragma unroll
      for (int j = 0; j < QR / 8; ++j)
        xs[j * 128] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      mbar_arrive(slot_full);
    } else {
      // dS^T = P^T (dP^T - delta) * scale, from the fp32 P^T
      mbar_wait(slot_full, lap);
#pragma unroll
      for (int j = 0; j < QR / 8; ++j) {
        const float4 p4 = xs[j * 128];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
          s[4 * j + m] = p[m] * (s[4 * j + m] - col[2 * j + m % 2]) * scale;
      }
      mbar_arrive(slot_empty);
    }
    uint32_t a[QR / 16][4];   // P^T or dS^T in bf16: the A operand
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // dV += P^T dO or dK += dS^T Q, dO and Q read MN-major: one wgmma of
    // N = DL a 16-query step
    const uint32_t c_tile = wg ? q_tile : do_tile;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk)
      wgmma_rs_n256(acc, a[kk], desc(c_tile + kk * 16 * 128, L::SLAB_Q, 1024), 1);
    wgmma_commit();
    if (threadIdx.x == 0) refill(issued, n, it, bar_kv, issue);   // while it runs
    __syncwarp();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty(bar_kv, st));
  }

  // keys past Sk are never stored; a block no query sees stores zeros
  void* out = wg ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    const size_t off = (((size_t)b * Sk + key[i]) * KV + kvh) * D + d0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DL / 8; ++j) {
      const int x = 4 * j + 2 * i;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off + 8 * j) =
            make_float2(acc[x], acc[x + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off + 8 * j) =
            __floats2bfloat162_rn(acc[x], acc[x + 1]);
    }
  }
  // the peer may still arrive on this block's free barriers: neither block
  // exits before both are done with the other's shared memory
  if constexpr (CL > 1) cluster_sync();
}

template <int D, int CL>
int launch_wgmma_pair(const void* q, const void* k, const void* v, const void* o, const void* lse,
                      const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                      int causal, int window, float scale, int out_f32, int smem,
                      cudaStream_t stream) {
  using L = DkvPairLayout<D, CL>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tout, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, L::QR);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, L::QR);
  if (!err) err = flash::make_map(&tout, o, D, H, Sq, B, L::QR);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, 64);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, 64);
  if (err) return err;
  auto kernel = flash_dkv_wgmma_pair<D, CL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B, CL * ((Sk + 63) / 64));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = CL;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, tout, tdo, static_cast<const float*>(lse), dk,
                         dv, Sq, Sk, H, KV, causal, window, scale, out_f32);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D, int BK, int BQ, int CL>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* lse,
               const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int causal, int window, float scale, int out_f32, int smem, cudaStream_t stream) {
  using L = dkv32::Layout<D, BK, BQ, CL>;
  if (smem != L::bytes || !out_f32) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, BQ, true);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, BQ, true);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, BK, true);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, BK, true);
  if (err) return err;
  auto kernel = dkv32::flash_dkv_fma<D, BK, BQ, CL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B, CL * ((Sk + BK - 1) / BK));
  cfg.blockDim = dim3(dkv32::THR);
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
                         static_cast<const float*>(lse), static_cast<float*>(dk),
                         static_cast<float*>(dv), Sq, Sk, H, KV, causal, window, scale);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32 (which gives dk and dv in fp32).
// bf16 takes the tensor-core kernels: at D 64 and 128 flash_dkv_wgmma
// (block_k 64 or 128 keys a block), at D 256 flash_dkv_wgmma_pair (block_k
// 64), at D 512 the same as a cluster of two blocks a key block (block_k 64);
// fp32 the FMA kernel (block_k 64 keys at D 64 and 128 with 64-row tiles, 32
// and 32 at D 256, and at D 512 as a cluster of two blocks a key block).
// smem: the plan's shared-memory bytes, checked against the kernel's own
// layout.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
    int D, int causal, int window, float scale, int out_f32, int f32, int block_k,
    int smem, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || (f32 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, dout, dk, dv, B, Sq, Sk, H, KV, causal, window, scale, out_f32, smem, s
  if (f32) {
    if (D == 512 && block_k == 32) return launch_fma<512, 32, 32, 2>(ARGS);
    if (D == 256 && block_k == 32) return launch_fma<256, 32, 32, 1>(ARGS);
    if (D == 128 && block_k == 64) return launch_fma<128, 64, 64, 1>(ARGS);
    if (D == 64 && block_k == 64) return launch_fma<64, 64, 64, 1>(ARGS);
  } else {
    if (D == 512 && block_k == 64) return launch_wgmma_pair<512, 2>(ARGS);
    if (D == 256 && block_k == 64) return launch_wgmma_pair<256, 1>(ARGS);
    if (D == 128 && block_k == 128) return launch_wgmma<128, 2>(ARGS);
    if (D == 128 && block_k == 64) return launch_wgmma<128, 1>(ARGS);
    if (D == 64 && block_k == 128) return launch_wgmma<64, 2>(ARGS);
    if (D == 64 && block_k == 64) return launch_wgmma<64, 1>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
