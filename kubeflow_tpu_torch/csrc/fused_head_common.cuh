// Shared pieces of the three fused tied-head kernels (fused_head_fwd.cu,
// fused_head_bwd_dh.cu, fused_head_bwd_de.cu).
//
// The forward's bf16 route (wgmma fed by TMA, the softmax fold in registers)
// lives in fused_head_fwd.cu; its fp32 route (fused_head_scalar.cuh) folds
// fp32 logits tiles with fold_tile below.
//
// The backward (dh and dE, one kernel template mirrored): wgmma fed by TMA,
// with E split across the blocks of a thread-block cluster so that the
// logits are computed once. See head_bwd_wgmma below. fp32 operands take
// the scalar kernels of fused_head_scalar.cuh.

#pragma once

#include "hopper_common.cuh"

namespace fused_head {

using namespace hopper;

constexpr int BV = 64;          // vocabulary rows per tile of the fp32 forward
constexpr int LDL = BV + 4;     // fp32 leading dim of its logits tile
constexpr int THREADS = 256;    // 8 warps

// The fp32 forward's fold of one [64, 64] logits tile (ls, after a barrier) into
// row r's running max m, sum s and gold logit, kept by the four threads q
// of the row: m starts at -inf, s rescales by exp(m_old - m_new).
__device__ __forceinline__ void fold_tile(const float* ls, int r, int q, int v0, int V,
                                          int target, float& m, float& s, float& gsum) {
  const float* row = ls + r * LDL;
  float mx = -INFINITY, gl = 0.f;
#pragma unroll
  for (int i = 0; i < BV / 4; ++i) {
    const int c = i * 4 + q, col = v0 + c;
    if (col < V) {
      mx = fmaxf(mx, row[c]);
      if (col == target) gl += row[c];
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  // column v0 < V is in every tile, so m_new is finite
  const float m_new = fmaxf(m, mx);
  float se = 0.f;
#pragma unroll
  for (int i = 0; i < BV / 4; ++i) {
    const int c = i * 4 + q;
    if (v0 + c < V) se += expf(row[c] - m_new);
  }
  se += __shfl_xor_sync(0xffffffffu, se, 1);
  se += __shfl_xor_sync(0xffffffffu, se, 2);
  gl += __shfl_xor_sync(0xffffffffu, gl, 1);
  gl += __shfl_xor_sync(0xffffffffu, gl, 2);
  s = s * expf(m - m_new) + se;
  m = m_new;
  gsum += gl;
}

// dlogits of one logit in fp32: dlse * exp(logit - lse) + dgold * [col ==
// tgt]. No fused multiply-add: the product and the sum round apart, as in
// the plain version. The caller rounds it to the operand type (round_to<T>),
// as the TPU kernels round it before both products.
__device__ __forceinline__ float dlogit(float logit, float lse, float dlse, float dgold,
                                       int col, int tgt) {
  return __fadd_rn(__fmul_rn(dlse, expf(logit - lse)), col == tgt ? dgold : 0.f);
}

// ---- the backward's tensor-core route: bf16, E a multiple of 8
//
// One kernel computes dh (DE false) or dE (DE true). A block keeps a
// "resident" operand (the h rows of BM tokens for dh, the emb rows of BM
// vocabulary entries for dE) and streams 64-row tiles of the other (emb for
// dh, h for dE) past it. Per streamed tile:
//
//   S  = R X^T          [BM, 64] logits (dh: tokens x vocab; dE: vocab x tokens)
//   dP = bf16(dlogit(S)) masked to 0 past T and V
//   acc += dP X         [BM, N] fp32, the block's columns of dh or dE
//
// E is split across the C blocks of a thread-block cluster (C = min(8,
// ceil(E / 256))): block c owns columns [c W, (c + 1) W), W = 256 (or, at
// C = 1, E rounded up to 64, 128 or 256), and computes only the *partial*
// logits over its own columns, the slice its product needs anyway; TMA
// zero-fills columns past E. The partials are summed through distributed
// shared memory, so the logits are computed once: 2 T V E FLOP for S and 2
// T V E for the product, the bound's 4 T V E. The exchange, once a tile:
//
//   1. each block sends its fp32 partial rows to the block that owns them
//      (block b owns rows [ceil(b BM / C), ceil((b + 1) BM / C)) of the
//      tile), into that block's receive buffer, one slot a sender;
//   2. each block sums its rows' C partials in block order (the same sum on
//      every run: no atomics), forms their dlogits, masks and rounds them to
//      bf16, and sends the rows into every block's dP tile, in the 128-byte
//      swizzle wgmma reads;
//   3. every block multiplies its own dP copy with its own X tile.
//
// Data moves by st.async (16 bytes a thread and store), which counts its
// bytes on an mbarrier in the receiving block (bar_rx for the partials,
// bar_dp for the dP rows): the receiver waits for its byte count, the
// sender never waits. One cluster barrier a tile, arrived at once a block's
// product is done and waited for before it sends the next tile's partials,
// keeps every buffer from being overwritten while its block still reads it.
// While a tile's partials travel and are summed, the next tile's S runs on
// the tensor cores (one pass only). At C = 1 there is no cluster and no
// exchange: block barriers order the block's own stores.
//
// Every wait of the kernel on an mbarrier or a flag traps after 2 s, and
// barrier.cluster waits only for threads that have not exited, so a
// protocol bug ends the launch with an error, not a hang.
//
// Clusters. At one block an SM only 30 clusters of 4 fit on an H100 (the
// GPCs leave 12 SMs over), so one cluster a row tile runs dh's 64 row tiles
// of the MoE flagship in 3 waves, the last 4 clusters alone. One pass
// therefore launches at most the clusters that fit at once and splits the
// (row tile, streamed tile) steps evenly between them: a cluster walks its
// row tiles in turn, reloading the resident slice at each, and a row tile
// split between clusters is summed by the cluster holding its first steps,
// which adds the others' sums (left in a scratch buffer, one slot a
// cluster and block, behind a release/acquire flag) in cluster order: the
// same sum on every run. Such a launch is cooperative, so that it starts
// only with all its clusters resident: one cluster waits for another's flag.
//
// Above E 2048 a block's slice exceeds 256 columns: P = ceil(E / 2048)
// passes (at most 4, E <= 8192), W = 256 P, C = ceil(E / W) <= 8, BM = 64.
// Pass p accumulates the slice's columns [256 p, 256 p + 256) and recomputes
// the partial logits over the whole slice, walking its P sub-slices of 256
// (the ring carries one sub-slice of a streamed tile a stage, the pass's own
// last, kept for the product): (2 P + 2) T V E FLOP, 1.5x the bound at E
// 4096.
//
// Thread 0 issues the TMA loads (the resident slice once, the ring's stages
// as they free up, up to STAGES - 1 ahead), as in flash_dkv_wgmma: with no
// producer warpgroup a consumer thread may take 255 registers (acc 128, S
// 32 and the next tile's S 32 at N 256).

constexpr int XROWS = 64;           // rows of a streamed tile
constexpr int SUB = 256;            // E columns of a pass
constexpr int LDS = 72;             // fp32 leading dim of the receive buffer
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may take

// Shared memory of head_bwd_wgmma, in bytes from a 1024-aligned base: the
// resident slice (P * NS slabs of BM rows), STAGES ring stages (NS slabs of
// 64 rows; 3 where they fit, else 2), the bf16 dP tile (one slab of BM
// rows), the fp32 receive buffer [BM + 8][LDS] (C slots of ceil(BM / C)
// rows), the row vectors (lse, dlse, dgold, tgt: 4 x 128), then the
// mbarriers: resident, full[STAGES], empty[STAGES], and the exchange's two
// arrivals (partials, dP). ops/fused_head_loss.py (_plan) computes the same
// bytes; the launcher checks them.
template <int NWG, int NS, int P>
struct BwdLayout {
  static constexpr int BM = 64 * NWG;
  static constexpr int SLAB_R = BM * 128;
  static constexpr int SLAB_X = XROWS * 128;
  static constexpr int FIXED = 1024 + P * NS * SLAB_R + BM * 128 + (BM + 8) * LDS * 4 + 2048;
  static constexpr int STAGES = FIXED + 3 * NS * SLAB_X + 8 * 9 <= SMEM_LIMIT ? 3 : 2;
  static constexpr int R = 0;
  static constexpr int X = R + P * NS * SLAB_R;
  static constexpr int DP = X + STAGES * NS * SLAB_X;
  static constexpr int RX = DP + BM * 128;
  static constexpr int ROWS = RX + (BM + 8) * LDS * 4;
  static constexpr int BAR = ROWS + 4 * 128 * 4;
  static constexpr int bytes = 1024 + BAR + 8 * (3 + 2 * STAGES);
  static_assert(DP % 1024 == 0, "the dP slab must be 1024-aligned for the swizzle");
  static_assert(bytes <= SMEM_LIMIT, "the layout must fit a block's shared memory");
};

template <int N>
__device__ __forceinline__ void product_t(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256)
    wgmma_ss_t_n256(acc, da, db, 1);
  else if constexpr (N == 128)
    wgmma_ss_t_n128(acc, da, db, 1);
  else
    wgmma_ss_t_n64(acc, da, db, 1);
}

// 16 bytes to shared-memory address `addr` of block `rank` of the cluster:
// this block's own by a plain store, another's by st.async, which counts the
// bytes on that block's mbarrier at (this block's address) bar.
__device__ __forceinline__ void push16(uint8_t* smem, uint32_t s_base, uint32_t addr, int rank,
                                       int self, uint4 v, uint32_t bar) {
  if (rank != self)
    st_async_u4(mapa(addr, rank), v, mapa(bar, rank));
  else
    *reinterpret_cast<uint4*>(smem + (addr - s_base)) = v;
}

template <bool DE, int NWG, int NS, int P>
__global__ void __launch_bounds__(128 * NWG, 1)
head_bwd_wgmma(const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tx,
               const int* __restrict__ tgt, const float* __restrict__ lse,
               const float* __restrict__ dlse, const float* __restrict__ dgold,
               float* __restrict__ out, int T, int V, int E, int C, int G,
               float* __restrict__ ws, int* __restrict__ flags) {
  using L = BwdLayout<NWG, NS, P>;
  constexpr int BM = L::BM, THR = 128 * NWG, N = NS * 64, ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_r = s_base + L::BAR;
  auto bar_full = [&](int st) { return bar_r + 8 + 8 * st; };
  auto bar_empty = [&](int st) { return bar_r + 8 + 8 * ST + 8 * st; };
  const uint32_t bar_rx = bar_r + 8 + 16 * ST, bar_dp = bar_rx + 8;   // the exchange's arrivals
  const uint32_t rx = s_base + L::RX;
  const float* RX = reinterpret_cast<const float*>(smem + L::RX);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROWS);
  float* dlse_s = lse_s + 128;
  float* dgold_s = dlse_s + 128;
  int* tgt_s = reinterpret_cast<int*>(dgold_s + 128);

  const int R_rows = DE ? V : T, X_rows = DE ? T : V;
  const int cr = (int)cluster_rank();
  const int cid = blockIdx.x / C;                     // this cluster
  const int e_base = cr * P * N;
  const int nx = (X_rows + XROWS - 1) / XROWS;
  // one pass: cluster cid takes steps [lo, hi) of the nrt * nx (row tile,
  // streamed tile) steps, row tile by row tile; passes: one row tile
  const int nrt = (R_rows + BM - 1) / BM;
  const long long nsteps = (long long)nrt * nx;
  const int lo = P == 1 ? (int)(nsteps * cid / G) : cid * nx;
  const int hi = P == 1 ? (int)(nsteps * (cid + 1) / G) : (cid + 1) * nx;
  const int n = P == 1 ? hi - lo : P * nx * P;        // ring items
  int r0 = (lo / nx) * BM;                            // the current row tile's first row
  // row r of a tile belongs to block r C / BM; slots of SH rows a sender
  const int SH = (BM + C - 1) / C;
  const int rb0 = (BM * cr + C - 1) / C, rb1 = (BM * (cr + 1) + C - 1) / C;

  if (threadIdx.x == 0) {
    mbar_init(bar_r, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), THR);
    }
    mbar_init(bar_rx, 1);
    mbar_init(bar_dp, 1);
    fence_barrier_init();
  }
  if (C > 1)
    cluster_sync();   // every block has started before any remote store
  else
    __syncthreads();

  // item j: pass p, streamed tile xt, sub-slice q; the pass's own sub-slice
  // comes last, so its stage is still there for the product
  auto decode = [&](int j, int& p, int& xt, int& i, int& q) {
    if (P == 1) {
      p = i = q = 0;
      xt = (lo + j) % nx;
      return;
    }
    p = j / (nx * P);
    const int rem = j % (nx * P);
    xt = rem / P;
    i = rem % P;
    q = (p + 1 + i) % P;
  };

  // ---- thread 0 also produces (flash_dkv_wgmma's refill)
  int issued = 0;
  auto refill = [&](int must) {
    while (issued < n && issued < must + ST) {
      const int j = issued, sj = j % ST;
      const int parity = ((j / ST) & 1) ^ 1;
      if (j > must && !mbar_try_wait(bar_empty(sj), parity)) break;
      mbar_wait(bar_empty(sj), parity);
      int p, xt, i, q;
      decode(j, p, xt, i, q);
      mbar_expect_tx(bar_full(sj), NS * L::SLAB_X);
      for (int s = 0; s < NS; ++s)
        tma_load(s_base + L::X + (sj * NS + s) * L::SLAB_X, &tx, e_base + q * SUB + 64 * s, 0,
                 xt * XROWS, 0, bar_full(sj));
      ++issued;
    }
  };
  // the resident slice of the row tile at r0, and (dh) its tokens' row
  // vectors; the caller waits on bar_r
  auto load_resident = [&]() {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_r, P * NS * L::SLAB_R);
      for (int q = 0; q < P; ++q)
        for (int s = 0; s < NS; ++s)
          tma_load(s_base + L::R + (q * NS + s) * L::SLAB_R, &tr, e_base + q * SUB + 64 * s, 0,
                   r0, 0, bar_r);
    }
    if (!DE && threadIdx.x < BM) {
      const int t = r0 + threadIdx.x;
      const bool ok = t < T;
      lse_s[threadIdx.x] = ok ? lse[t] : 0.f;
      dlse_s[threadIdx.x] = ok ? dlse[t] : 0.f;
      dgold_s[threadIdx.x] = ok ? dgold[t] : 0.f;
      tgt_s[threadIdx.x] = ok ? tgt[t] : -1;
    }
  };
  load_resident();
  if (threadIdx.x == 0) refill(0);
  __syncwarp();

  // ---- consumers: warpgroup w owns resident rows 64 w .. 64 w + 63
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_lo = wg * 64 + 16 * warp + g;     // this thread's rows: row_lo, row_lo + 8
  const uint32_t dp_tile = s_base + L::DP;
  // after the shuffle in the exchange a thread holds 4 columns of one of its rows
  const bool odd = t4 & 1;
  const int my_row = row_lo + (odd ? 8 : 0);
  const int my_owner = my_row * C / BM;
  const uint32_t my_slot =
      rx + ((cr * SH + my_row - (BM * my_owner + C - 1) / C) * LDS + 2 * (t4 & 2)) * 4;

  float acc[N / 2];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) acc[x] = 0.f;
  float s[32], s2[32];

  // S (+)= R_q X^T on stage st, asynchronous (the caller waits)
  auto issue_s = [&](float (&sx)[32], int st, int q) {
    const uint32_t x_tile = s_base + L::X + st * NS * L::SLAB_X;
    const uint32_t r_tile = s_base + L::R + q * NS * L::SLAB_R + wg * 64 * 128;
    fence_regs(sx);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS * 4; ++kk)
      wgmma_ss_n64(sx, desc_k(r_tile, L::SLAB_R, kk), desc_k(x_tile, L::SLAB_X, kk), 1);
    wgmma_commit();
  };

  // dE: the row vectors of tile xt's tokens (thread t < 64 holds token t's)
  float rv[3];
  int rt;
  auto load_rows = [&](int xt) {
    rv[0] = rv[1] = rv[2] = 0.f;
    rt = -1;
    if (DE && threadIdx.x < XROWS && xt * XROWS + threadIdx.x < T) {
      const int t = xt * XROWS + threadIdx.x;
      rv[0] = lse[t]; rv[1] = dlse[t]; rv[2] = dgold[t]; rt = tgt[t];
    }
  };
  auto store_rows = [&]() {
    if (DE && threadIdx.x < XROWS) {
      lse_s[threadIdx.x] = rv[0];
      dlse_s[threadIdx.x] = rv[1];
      dgold_s[threadIdx.x] = rv[2];
      tgt_s[threadIdx.x] = rt;
    }
  };

  // ---- 1. the partial rows to their owners' receive buffers, in the
  // slot of this block: its own by plain stores, the others' by st.async,
  // which counts the bytes on the owner's bar_rx. Element x = 4j + 2ii + e
  // of s is (row_lo + 8 ii, 8 j + 2 t4 + e); lanes t4 and t4 ^ 1 swap halves
  // so that each holds 4 consecutive columns of one row: the even lane
  // row_lo, columns 8 j + 2 t4 .. + 3; the odd lane row_lo + 8, columns
  // 8 j + 2 (t4 - 1) .. + 3.
  auto push_partials = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x0 = s[4 * j], x1 = s[4 * j + 1], x2 = s[4 * j + 2], x3 = s[4 * j + 3];
      const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
      const float y2 = __shfl_xor_sync(0xffffffffu, x2, 1);
      const float y3 = __shfl_xor_sync(0xffffffffu, x3, 1);
      if (odd) {
        x0 = y2;
        x1 = y3;
      } else {
        x2 = y0;
        x3 = y1;
      }
      const float4 v4 = make_float4(x0, x1, x2, x3);
      push16(smem, s_base, my_slot + 32 * j, my_owner, cr, *reinterpret_cast<const uint4*>(&v4),
             bar_rx);
    }
  };

  // the bf16 dlogits of row r, columns 8k .. 8k + 7 of tile xt, from their
  // summed logits v: 0 past T and V
  auto dlogit_row = [&](const float (&v)[8], int xt, int r, int k) {
    uint32_t packed[4];
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * k + 2 * e2 + e;
        // dh: row = token, column = vocabulary entry; dE the other way
        const int tok = DE ? xt * XROWS + col : r0 + r;
        const int voc = DE ? r0 + r : xt * XROWS + col;
        const int sr = DE ? col : r;
        d[e] = (tok < T && voc < V)
            ? dlogit(v[2 * e2 + e], lse_s[sr], dlse_s[sr], dgold_s[sr], voc, tgt_s[sr])
            : 0.f;
      }
      packed[e2] = pack_bf16(d[0], d[1]);
    }
    return make_uint4(packed[0], packed[1], packed[2], packed[3]);
  };

  // ---- 2. this block's rows of tile xt: the cluster's sum in block order,
  // the dlogits, bf16 rows into every block's dP (its own by plain stores,
  // the others' by st.async counted on their bar_dp)
  auto reduce_rows = [&](int xt) {
    for (int w = threadIdx.x; w < (rb1 - rb0) * 8; w += THR) {
      const int lr = w / 8, r = rb0 + lr, k = w % 8;     // row r, columns 8k .. 8k + 7
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll 4
      for (int b = 0; b < C; ++b) {
        const float* src = RX + (b * SH + lr) * LDS + 8 * k;
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 c4 = *reinterpret_cast<const float4*>(src + 4);
        v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
        v[4] += c4.x; v[5] += c4.y; v[6] += c4.z; v[7] += c4.w;
      }
      const uint4 pk = dlogit_row(v, xt, r, k);
      const uint32_t dst = dp_tile + r * 128 + ((k ^ (r % 8)) << 4);
#pragma unroll 1
      for (int b = 0; b < C; ++b) push16(smem, s_base, dst, b, cr, pk, bar_dp);
    }
  };

  // The exchange of tile xt, the seq-th of the launch, up to the dP rows'
  // arrival. `overlap` (the next tile's S) runs while the partials travel.
  // Every block waits at the cluster barrier (arrived at after its previous
  // product) before it stores into another block, so no buffer is
  // overwritten while its block still reads it.
  auto exchange = [&](int xt, int seq, auto&& overlap) {
    if (C > 1) {
      cluster_wait();
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar_rx, (C - 1) * (rb1 - rb0) * 64 * 4);
        mbar_expect_tx(bar_dp, (BM - (rb1 - rb0)) * 128);
      }
    }
    push_partials();
    store_rows();
    named_sync(1, THR);             // this block's own slot and row vectors
    overlap();
    if (C > 1) mbar_wait(bar_rx, seq & 1);
    reduce_rows(xt);
    fence_proxy_async_cta();        // the dP stores before the wgmma reads them
    named_sync(1, THR);
    if (C > 1) mbar_wait(bar_dp, seq & 1);
  };

  // acc += dP X_p: dP K-major (one slab), X_p MN-major (its e contiguous)
  auto issue_product = [&](int st) {
    const uint32_t x_tile = s_base + L::X + st * NS * L::SLAB_X;
    fence_proxy_async_cta();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      product_t<N>(acc, desc_k(dp_tile + wg * 64 * 128, 0, kk),
                   desc(x_tile + kk * 16 * 128, L::SLAB_X, 1024));
    wgmma_commit();
  };

  // the pass is done: store its columns of rows row_lo and row_lo + 8
  auto store_pass = [&](int p) {
    const int ce = e_base + p * SUB + 2 * t4;   // E is even: col < E covers col + 1
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = r0 + row_lo + 8 * ii;
      float* o = out + (size_t)min(row, R_rows - 1) * E;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        if (row < R_rows && ce + 8 * j < E)
          *reinterpret_cast<float2*>(o + ce + 8 * j) =
              make_float2(acc[4 * j + 2 * ii], acc[4 * j + 2 * ii + 1]);
    }
#pragma unroll
    for (int x = 0; x < N / 2; ++x) acc[x] = 0.f;
  };

  // A row tile split between clusters (one pass, G below the row tiles'
  // count): the clusters holding its later steps leave their sums in ws, a
  // slot a (cluster, block), and raise their flag; the cluster holding its
  // first step waits for those flags and adds the slots in cluster order,
  // so the sum does not depend on timing. ws is laid out [slot][x][thread]
  // (coalesced).
  auto leave_partial = [&]() {
    float* my_ws = ws + (size_t)(cid * C + cr) * (N / 2) * THR + threadIdx.x;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      my_ws[(size_t)x * THR] = acc[x];
      acc[x] = 0.f;
    }
    __threadfence();
    named_sync(1, THR);
    if (threadIdx.x == 0) flag_release(flags + cid * C + cr);
  };
  auto add_partial = [&](int c2) {
    if (threadIdx.x == 0) flag_wait(flags + c2 * C + cr);
    named_sync(1, THR);
    const float* src = ws + (size_t)(c2 * C + cr) * (N / 2) * THR + threadIdx.x;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) acc[x] += __ldcg(src + (size_t)x * THR);
  };

  if (C > 1) cluster_arrive_relaxed();   // as if a tile before the first had ended
  if constexpr (P == 1) {
    // Row tile by row tile (segments of this cluster's steps); within one,
    // the next tile's S runs on the tensor cores while this tile's partials
    // travel.
    int it = 0;                     // ring items consumed = steps done
    for (int seg = 0; lo + it < hi; ++seg) {
      const int step0 = lo + it, r = step0 / nx;
      const int x0 = step0 % nx, x1 = min(nx, hi - r * nx);   // this segment's streamed tiles
      if (seg > 0) {
        r0 = r * BM;
        load_resident();
      }
      mbar_wait(bar_r, seg & 1);
      if (threadIdx.x == 0) refill(it);
      __syncwarp();
      load_rows(x0);
      mbar_wait(bar_full(it % ST), (it / ST) & 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.f;
      issue_s(s, it % ST, 0);
      wgmma_wait_all();
      fence_regs(s);
      for (int xt = x0; xt < x1; ++xt, ++it) {
        const int st = it % ST;
        const bool next = xt + 1 < x1;
        exchange(xt, it, [&]() {
          if (next) {
            const int sn = (it + 1) % ST;
            if (threadIdx.x == 0) refill(it + 1);
            __syncwarp();
            mbar_wait(bar_full(sn), ((it + 1) / ST) & 1);
#pragma unroll
            for (int x = 0; x < 32; ++x) s2[x] = 0.f;
            issue_s(s2, sn, 0);
          }
        });
        issue_product(st);
        if (threadIdx.x == 0) refill(it);   // while it runs
        __syncwarp();
        if (next) load_rows(xt + 1);
        wgmma_wait_all();
        fence_regs(acc);
        // this block's reads of its buffers are done (their values are in
        // registers or the accumulators): a relaxed arrival suffices
        if (C > 1) cluster_arrive_relaxed();
        mbar_arrive(bar_empty(st));
        if (next) {
          fence_regs(s2);
#pragma unroll
          for (int x = 0; x < 32; ++x) s[x] = s2[x];
        }
      }
      if (x0 > 0) {
        leave_partial();            // the row tile began in an earlier cluster
      } else {
        // later clusters whose first steps finish this row tile
        for (int c2 = cid + 1; c2 < G && (int)(nsteps * c2 / G) < (r + 1) * nx; ++c2)
          add_partial(c2);
        store_pass(0);
      }
    }
  } else {
    // Passes: the tile's S over P sub-slices through the ring, then the
    // exchange and the product on the pass's own sub-slice.
    mbar_wait(bar_r, 0);
    int it = 0;                     // ring items consumed
    for (int p = 0; p < P; ++p) {
      for (int xt = 0; xt < nx; ++xt) {
        load_rows(xt);
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = 0.f;
#pragma unroll
        for (int i = 0; i < P; ++i, ++it) {
          const int st = it % ST;
          if (threadIdx.x == 0) refill(it);
          __syncwarp();
          mbar_wait(bar_full(st), (it / ST) & 1);
          issue_s(s, st, (p + 1 + i) % P);
          wgmma_wait_all();
          fence_regs(s);
          if (i < P - 1) mbar_arrive(bar_empty(st));   // more of the slice to sum
        }
        const int st = (it - 1) % ST;   // the stage of the pass's own sub-slice
        exchange(xt, p * nx + xt, []() {});
        issue_product(st);
        if (threadIdx.x == 0) refill(it - 1);   // while it runs
        __syncwarp();
        wgmma_wait_all();
        fence_regs(acc);
        if (C > 1) cluster_arrive_relaxed();
        mbar_arrive(bar_empty(st));
      }
      store_pass(p);
    }
  }
  if (C > 1) cluster_wait();        // pairs the last arrival; nothing is in flight after it
}

// Launch head_bwd_wgmma<DE, ...>: h [T, E] and emb [V, E] bf16 (E % 8 == 0),
// out [T or V, E] fp32. C blocks a cluster along E; smem must equal the
// layout's bytes. Passes launch one cluster a row tile. One pass launches
// one cluster a row tile too where all fit on the card at once, else G =
// min(fit, cap) clusters, which walk the row tiles in turn: ws (cap * C * BM
// * NS * 64 fp32) and flags (cap * C int32, zero) hold the sums of the row
// tiles split between clusters. Returns a CUDA error code.
template <bool DE, int NWG, int NS, int P>
int launch_bwd_wgmma(const void* h, const void* emb, const void* tgt, const void* lse,
                     const void* dlse, const void* dgold, void* out, int T, int V, int E,
                     int C, int smem, int cap, void* ws, void* flags, cudaStream_t stream) {
  using L = BwdLayout<NWG, NS, P>;
  if (smem != L::bytes || E % 8 != 0 || C < 1 || C > 8 || C * P * NS * 64 < E ||
      (C - 1) * P * NS * 64 >= E)
    return (int)cudaErrorInvalidValue;
  auto kernel = head_bwd_wgmma<DE, NWG, NS, P>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(128 * NWG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;   // not one cluster fits
  const int nrt = ((DE ? V : T) + L::BM - 1) / L::BM;
  const int G = P > 1 || fit >= nrt ? nrt : min(fit, cap);
  if (G < 1 || (G < nrt && (!ws || !flags))) return (int)cudaErrorInvalidValue;
  CUtensorMap tr, tx;
  int err = make_map(&tr, DE ? emb : h, E, 1, DE ? V : T, 1, L::BM);
  if (!err) err = make_map(&tx, DE ? h : emb, E, 1, DE ? T : V, 1, XROWS);
  if (err) return err;
  cfg.gridDim = dim3(C * G);
  // a split launch's clusters wait on each other's flags: cooperative, so
  // that it fails to launch rather than start without all of them resident
  cfg.numAttrs = (C > 1 ? 1 : 0) + (G < nrt ? 1 : 0);
  if (C == 1) cfg.attrs = attr + 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tr, tx, static_cast<const int*>(tgt),
                         static_cast<const float*>(lse), static_cast<const float*>(dlse),
                         static_cast<const float*>(dgold), static_cast<float*>(out), T, V, E, C,
                         G, static_cast<float*>(ws), static_cast<int*>(flags));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan's (cluster, slabs, passes, rows) -> the instantiation.
template <bool DE>
int launch_bwd_route(const void* h, const void* emb, const void* tgt, const void* lse,
                     const void* dlse, const void* dgold, void* out, int T, int V, int E,
                     int C, int slabs, int passes, int rows, int smem, int cap, void* ws,
                     void* flags, cudaStream_t s) {
#define ROUTE(NWG, NS, P)                                                                     \
  return launch_bwd_wgmma<DE, NWG, NS, P>(h, emb, tgt, lse, dlse, dgold, out, T, V, E, C,   \
                                          smem, cap, ws, flags, s)
  if (rows == 128 && passes == 1) {
    if (slabs == 4) ROUTE(2, 4, 1);
    if (slabs == 2 && C == 1) ROUTE(2, 2, 1);
    if (slabs == 1 && C == 1) ROUTE(2, 1, 1);
  }
  if (rows == 64 && slabs == 4 && C > 1) {
    if (passes == 2) ROUTE(1, 4, 2);
    if (passes == 3) ROUTE(1, 4, 3);
    if (passes == 4) ROUTE(1, 4, 4);
  }
#undef ROUTE
  return (int)cudaErrorInvalidValue;
}

}  // namespace fused_head
