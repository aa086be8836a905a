// The fused tied head's fp32 backward (dh and dE, one kernel template
// mirrored, as head_bwd_wgmma in fused_head_common.cuh): fp32 h and emb, any
// T and V, E a multiple of 4 (the wrapper zero-pads other E), any E.
//
// What bounds it: operations. The logits once and the product once are 4 T V
// E FLOP, and on fp32 operands they run as fp32 FMAs (no TF32, 3xTF32
// included: the route exists to match the plain version's full-fp32
// products), whose peak is 67 TF/s: 16.0 ms at T 8192, V 32000, E 1024.
//
// The design is the bf16 route's skeleton with fp32 FMA main loops:
//
// - A block keeps a resident slice of one operand (the h rows of 128 tokens
//   for dh, the emb rows of 128 vocabulary entries for dE; W = 128 columns)
//   and streams 64-row tiles of the other through a 3-stage TMA ring (fp32
//   boxes of 32 columns, 128-byte swizzle; columns past E and rows past T or
//   V arrive as zeros).
// - E is split across the C = ceil(E / 128) <= 8 blocks of a thread-block
//   cluster. Block c computes only the partial logits over its own slice,
//   the cluster sums them through distributed shared memory in block order
//   (st.async counted on mbarriers), the owner of each row forms its fp32
//   dlogits (not rounded: astype(emb.dtype) is the identity on fp32) and
//   sends them to every block's dP tile, and each block multiplies its dP
//   copy by its own streamed slice. So no block recomputes another's slice:
//   up to E 1024 the launch does the bound's 4 T V E. The next tile's
//   partial logits run in two halves, one while this tile's partials travel,
//   one while its dP rows do.
// - The products are register-tiled: 256 threads, a thread holds 8 x 4 of
//   the [128, 64] logits tile and 8 x 8 of the [128, 128] accumulator, and
//   reads its operands as float4 laid out so that a warp's loads of the
//   operand it shares broadcast and the others hit 8 distinct 16-byte bank
//   groups: a 128-bit load feeds 11 (logits) or 16 (product) FMAs of its
//   thread, and shared memory moves one 16-byte chunk for every 32 or 43
//   FMAs of a warp.
// - The logits tile's columns travel in a fixed permutation (position 4 g +
//   j of a row holds column g + 16 j, g < 16), the order in which a thread
//   holds them, so nothing is transposed: the product walks the same
//   positions with the matching streamed rows.
// - The cluster co-residency split of the bf16 route: one pass launches at
//   most the clusters that fit at once and splits the (row tile, streamed
//   tile) steps evenly between them, a row tile split between clusters
//   summed in cluster order through a scratch buffer behind release/acquire
//   flags.
// - Above E 1024 (the widest single pass: 8 blocks of 128 columns) a
//   block's slice is W = 128 P columns, P = ceil(E / 1024) passes, C =
//   ceil(E / W) <= 8, 64 rows a row tile. Pass p accumulates columns [128 p,
//   128 p + 128) of the slice and recomputes its partial logits over the
//   whole slice; both operands stream, a ring item being the row tile's and
//   the streamed tile's 128 columns of one sub-slice (the pass's own last,
//   kept for the product). (2 P + 2) T V E FLOP; E is not limited.
//
// Every fp32 dh and dE element is a fixed-order sum: no atomics, the same
// bits on every run.

#pragma once

#include "fused_head_common.cuh"

namespace fused_head {
namespace fp32 {

constexpr int W = 128;        // E columns a block accumulates in one pass
constexpr int SLABS = W / 32; // 32-column fp32 slabs (128-byte rows) of a tile
constexpr int THR = 256;

// Shared memory of head_bwd_fma, in bytes from a 1024-aligned base: the
// resident slice (BM 128: [128 rows][128 columns]; none with passes), the
// ring's stages (the streamed [64][128] tile, with passes also the row
// tile's [64][128]; 3 stages where they fit, else 2), the fp32 dP tile [BM
// rows][64 positions], the receive buffer of the cluster's partial logits
// (C slots of ceil(BM / C) rows of 64), then the mbarriers: resident,
// full[stages], empty[stages], and the exchange's two arrivals.
// ops/fused_head_loss.py (_fma_smem) sums the same bytes; the launcher
// checks them.
struct Layout {
  int stage_bytes, stages, SH, R, X, DP, RX, BAR, bytes;
  __host__ __device__ Layout(int BM, int C) {
    const int resident = BM == 128 ? BM * W * 4 : 0;
    stage_bytes = (BM == 128 ? 0 : BM * W * 4) + XROWS * W * 4;
    SH = (BM + C - 1) / C;
    const int dp = BM * XROWS * 4;
    const int rx = C * SH * XROWS * 4;
    const int fixed = 1024 + resident + dp + rx;
    stages = fixed + 3 * stage_bytes + 8 * 9 <= SMEM_LIMIT ? 3 : 2;
    R = 0;
    X = resident;
    DP = X + stages * stage_bytes;
    RX = DP + dp;
    BAR = RX + rx;
    bytes = 1024 + BAR + 8 * (3 + 2 * stages);
  }
};

// BM 128: one pass (E <= 1024), the resident slice, the co-residency split.
// BM 64: P passes, both operands streamed, one cluster a row tile.
template <bool DE, int BM>
__global__ void __launch_bounds__(THR, 1)
head_bwd_fma(const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tx,
             const int* __restrict__ tgt, const float* __restrict__ lse,
             const float* __restrict__ dlse, const float* __restrict__ dgold,
             float* __restrict__ out, int T, int V, int E, int C, int P, int G,
             float* __restrict__ ws, int* __restrict__ flags) {
  constexpr bool ONE = BM == 128;
  constexpr int MI = BM / 16;          // logits rows a thread
  constexpr int AI = BM / 64;          // accumulator row quads a thread
  constexpr int NACC = AI * 32;        // accumulators a thread
  constexpr int RSLAB = BM * 32;       // floats of a row-tile slab
  constexpr int XSLAB = XROWS * 32;    // floats of a streamed slab
  const Layout L(BM, C);
  const int ST = L.stages, SH = L.SH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const float* fs = reinterpret_cast<const float*>(smem);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_r = s_base + L.BAR;
  auto bar_full = [&](int st) { return bar_r + 8 + 8 * st; };
  auto bar_empty = [&](int st) { return bar_r + 8 + 8 * ST + 8 * st; };
  const uint32_t bar_rx = bar_r + 8 + 16 * ST, bar_dp = bar_rx + 8;   // the exchange's arrivals

  const int R_rows = DE ? V : T, X_rows = DE ? T : V;
  const int cr = (int)cluster_rank();
  const int cid = blockIdx.x / C;                     // this cluster
  const int e_base = cr * P * W;
  const int nx = (X_rows + XROWS - 1) / XROWS;
  // one pass: cluster cid takes steps [lo, hi) of the nrt * nx (row tile,
  // streamed tile) steps, row tile by row tile; passes: one row tile
  const int nrt = (R_rows + BM - 1) / BM;
  const long long nsteps = (long long)nrt * nx;
  const int lo = ONE ? (int)(nsteps * cid / G) : cid * nx;
  const int hi = ONE ? (int)(nsteps * (cid + 1) / G) : (cid + 1) * nx;
  const int n = ONE ? hi - lo : P * nx * P;           // ring items
  int r0 = (lo / nx) * BM;                            // the current row tile's first row
  // row r of a tile belongs to block r C / BM; slots of SH rows a sender
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

  // item j: streamed tile xt, sub-slice q (passes: pass p's own last)
  auto decode = [&](int j, int& xt, int& q) {
    if (ONE) {
      q = 0;
      xt = (lo + j) % nx;
      return;
    }
    const int p = j / (nx * P), rem = j % (nx * P);
    xt = rem / P;
    q = (p + 1 + rem % P) % P;
  };
  auto stage = [&](int st) { return L.X + st * L.stage_bytes; };   // passes: row tile first

  // ---- thread 0 also produces (head_bwd_wgmma's refill)
  int issued = 0;
  auto refill = [&](int must) {
    while (issued < n && issued < must + ST) {
      const int j = issued, sj = j % ST;
      const int parity = ((j / ST) & 1) ^ 1;
      if (j > must && !mbar_try_wait(bar_empty(sj), parity)) break;
      mbar_wait(bar_empty(sj), parity);
      int xt, q;
      decode(j, xt, q);
      const int col = e_base + q * W;
      const uint32_t dst = s_base + stage(sj);
      mbar_expect_tx(bar_full(sj), L.stage_bytes);
      const uint32_t xdst = ONE ? dst : dst + RSLAB * SLABS * 4;
      for (int s = 0; s < SLABS; ++s) {
        if (!ONE) tma_load(dst + s * RSLAB * 4, &tr, col + 32 * s, 0, r0, 0, bar_full(sj));
        tma_load(xdst + s * XSLAB * 4, &tx, col + 32 * s, 0, xt * XROWS, 0, bar_full(sj));
      }
      ++issued;
    }
  };
  // one pass: the resident slice of the row tile at r0; the caller waits on bar_r
  auto load_resident = [&]() {
    if (ONE && threadIdx.x == 0) {
      mbar_expect_tx(bar_r, BM * W * 4);
      for (int s = 0; s < SLABS; ++s)
        tma_load(s_base + L.R + s * RSLAB * 4, &tr, e_base + 32 * s, 0, r0, 0, bar_r);
    }
  };
  load_resident();
  if (threadIdx.x == 0) refill(0);
  __syncwarp();

  // A thread's logits: rows g + 16 i (i < MI), columns x + 16 j (j < 4); its
  // accumulators: rows 4 g + 64 a + ii (a < AI, ii < 4), E columns 4 x + 64
  // h + jj (h < 2, jj < 4) of the pass.
  const int g = threadIdx.x >> 4, x = threadIdx.x & 15;
  float s[MI][4];
  float acc[NACC];   // acc[(4 a + ii) * 8 + 4 h + jj]
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  // s (+)= R X^T over slabs [sl0, sl1) of one (row tile, streamed tile)
  // pair, e in order. Row r of a slab holds its 16-byte chunk c at c ^ (r %
  // 8): a thread's rows share r % 8 (g % 8 and x % 8), so the swizzle is one
  // XOR a thread; a warp's two g broadcast, its 16 x hit 8 bank groups twice.
  auto logits = [&](int r_off, int x_off, bool add, int sl0 = 0, int sl1 = SLABS) {
    const float* Rt = fs + r_off / 4 + g * 32;
    const float* Xt = fs + x_off / 4 + x * 32;
    const int kr = g & 7, kx = x & 7;
    if (!add) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 1
    for (int sl = sl0; sl < sl1; ++sl) {
      const float* Rs = Rt + sl * RSLAB;
      const float* Xs = Xt + sl * XSLAB;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float4 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = *reinterpret_cast<const float4*>(Xs + j * 16 * 32 + 4 * (c ^ kx));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float4 rv = *reinterpret_cast<const float4*>(Rs + i * 16 * 32 + 4 * (c ^ kr));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(rv.x, xv[j].x, s[i][j]);
            s[i][j] = fmaf(rv.y, xv[j].y, s[i][j]);
            s[i][j] = fmaf(rv.z, xv[j].z, s[i][j]);
            s[i][j] = fmaf(rv.w, xv[j].w, s[i][j]);
          }
        }
      }
    }
  };

  // ---- 1. the partial rows to their owners' receive buffers, in this
  // block's slot (its own by plain stores, the others' by st.async counted
  // on the owner's bar_rx): row g + 16 i, positions 4 x .. 4 x + 3.
  auto push_partials = [&]() {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = g + 16 * i, owner = r * C / BM;
      const int lr = r - (BM * owner + C - 1) / C;
      const float4 v4 = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      push16(smem, s_base, s_base + L.RX + ((cr * SH + lr) * XROWS + 4 * x) * 4, owner, cr,
             *reinterpret_cast<const uint4*>(&v4), bar_rx);
    }
  };

  // The row vectors (lse, dlse, dgold, tgt) of the tokens of this thread's
  // first reduce item (w = threadIdx.x below), loaded before the exchange's
  // waits: dh's token is its row's, dE's the four of its columns.
  float pv[4][3];
  int pt[4];
  auto prefetch = [&](int xt) {
    const int w = threadIdx.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tok = DE ? xt * XROWS + (w & 15) + 16 * j : r0 + rb0 + (w >> 4);
      const bool ok = w < (rb1 - rb0) * 16 && tok < T;
      pv[j][0] = ok ? __ldg(lse + tok) : 0.f;
      pv[j][1] = ok ? __ldg(dlse + tok) : 0.f;
      pv[j][2] = ok ? __ldg(dgold + tok) : 0.f;
      pt[j] = ok ? __ldg(tgt + tok) : -1;
    }
  };

  // ---- 2. this block's rows of tile xt: the cluster's sum in block order,
  // the fp32 dlogits (0 past T and V), and the rows into every block's dP
  // tile (its own by plain stores, the others' by st.async counted on their
  // bar_dp). dP row r holds its 16-byte chunk k at k ^ ((r / 4) % 8), so the
  // product's two row quads of a warp read distinct bank groups.
  auto reduce_rows = [&](int xt) {
    const float* RX = fs + L.RX / 4;
    for (int w = threadIdx.x; w < (rb1 - rb0) * 16; w += THR) {
      const int lr = w >> 4, k = w & 15, r = rb0 + lr;   // row r, positions 4k .. 4k + 3
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int b = 0; b < C; ++b) {
        const float4 a = *reinterpret_cast<const float4*>(RX + (b * SH + lr) * XROWS + 4 * k);
        v[0] += a.x;
        v[1] += a.y;
        v[2] += a.z;
        v[3] += a.w;
      }
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // dh: row = token, column = vocabulary entry; dE the other way
        const int col = xt * XROWS + k + 16 * j;
        const int tok = DE ? col : r0 + r, voc = DE ? r0 + r : col;
        if (tok >= T || voc >= V)
          d[j] = 0.f;
        else if (w == threadIdx.x)
          d[j] = dlogit(v[j], pv[j][0], pv[j][1], pv[j][2], voc, pt[j]);
        else
          d[j] = dlogit(v[j], __ldg(lse + tok), __ldg(dlse + tok), __ldg(dgold + tok), voc,
                        __ldg(tgt + tok));
      }
      const float4 d4 = make_float4(d[0], d[1], d[2], d[3]);
      const uint32_t dst = s_base + L.DP + (r * XROWS + 4 * (k ^ ((r >> 2) & 7))) * 4;
#pragma unroll 1
      for (int b = 0; b < C; ++b)
        push16(smem, s_base, dst, b, cr, *reinterpret_cast<const uint4*>(&d4), bar_dp);
    }
  };

  // The exchange of tile xt, the seq-th of the launch, up to the dP rows'
  // arrival. overlap(0) (the next tile's logits over half its slabs) runs
  // while the partials travel, overlap(1) (the other half) while the dP rows
  // do. Every block waits at the cluster barrier (arrived at after its
  // previous product) before it stores into another block, so no buffer is
  // overwritten while its block still reads it.
  auto exchange = [&](int xt, int seq, auto&& overlap) {
    if (C > 1) {
      cluster_wait();
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar_rx, (C - 1) * (rb1 - rb0) * XROWS * 4);
        mbar_expect_tx(bar_dp, (BM - (rb1 - rb0)) * XROWS * 4);
      }
    }
    prefetch(xt);
    push_partials();
    named_sync(1, THR);             // this block's own slot
    overlap(0);
    if (C > 1) mbar_wait(bar_rx, seq & 1);
    reduce_rows(xt);
    overlap(1);
    named_sync(1, THR);
    if (C > 1) mbar_wait(bar_dp, seq & 1);
  };

  // acc += dP X over the 64 positions of the tile: position 4 k + j is
  // streamed row k + 16 j, so (k + 16 j) % 8 = k % 8 sets the swizzle.
  auto product = [&](int x_off) {
    const float* DP = fs + L.DP / 4 + (4 * g) * XROWS;
    const float* Xc = fs + x_off / 4 + (x >> 3) * XSLAB;   // columns 4x..: slab x / 8 (+ 2 for h 1)
    const int kd = g & 7, cq = x & 7;
#pragma unroll 1
    for (int k8 = 0; k8 < 16; k8 += 8) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int k = k8 + kk;
        float dv[AI * 4][4];
#pragma unroll
        for (int a = 0; a < AI; ++a)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float4 t4 = *reinterpret_cast<const float4*>(DP + (64 * a + ii) * XROWS +
                                                                4 * (k ^ kd));
            dv[4 * a + ii][0] = t4.x;
            dv[4 * a + ii][1] = t4.y;
            dv[4 * a + ii][2] = t4.z;
            dv[4 * a + ii][3] = t4.w;
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* xr = Xc + (k + 16 * j) * 32 + 4 * (cq ^ kk);
          const float4 x0 = *reinterpret_cast<const float4*>(xr);
          const float4 x1 = *reinterpret_cast<const float4*>(xr + 2 * XSLAB);
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int q = 0; q < AI * 4; ++q)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[q * 8 + c] = fmaf(dv[q][j], xv[c], acc[q * 8 + c]);
        }
      }
    }
  };

  // the pass is done: store its columns of this thread's rows
  auto store_pass = [&](int p) {
#pragma unroll
    for (int q = 0; q < AI * 4; ++q) {
      const int row = r0 + 4 * g + 64 * (q / 4) + q % 4;
      if (row >= R_rows) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = e_base + p * W + 4 * x + 64 * hh;   // E % 4 == 0: col < E covers col + 3
        if (col < E)
          *reinterpret_cast<float4*>(out + (size_t)row * E + col) =
              make_float4(acc[q * 8 + 4 * hh], acc[q * 8 + 4 * hh + 1], acc[q * 8 + 4 * hh + 2],
                          acc[q * 8 + 4 * hh + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  };

  // A row tile split between clusters (one pass, G below the row tiles'
  // count): as head_bwd_wgmma, the clusters holding its later steps leave
  // their sums in ws ([slot][accumulator][thread]) behind a flag, and the
  // cluster holding its first step adds them in cluster order.
  auto leave_partial = [&]() {
    float* my_ws = ws + (size_t)(cid * C + cr) * NACC * THR + threadIdx.x;
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      my_ws[(size_t)k * THR] = acc[k];
      acc[k] = 0.f;
    }
    __threadfence();
    named_sync(1, THR);
    if (threadIdx.x == 0) flag_release(flags + cid * C + cr);
  };
  auto add_partial = [&](int c2) {
    if (threadIdx.x == 0) flag_wait(flags + c2 * C + cr);
    named_sync(1, THR);
    const float* src = ws + (size_t)(c2 * C + cr) * NACC * THR + threadIdx.x;
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] += __ldcg(src + (size_t)k * THR);
  };

  if (C > 1) cluster_arrive_relaxed();   // as if a tile before the first had ended
  if constexpr (ONE) {
    // Row tile by row tile (segments of this cluster's steps); within one,
    // the next tile's logits run while this tile's partials travel.
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
      mbar_wait(bar_full(it % ST), (it / ST) & 1);
      logits(L.R, stage(it % ST), false);
      for (int xt = x0; xt < x1; ++xt, ++it) {
        const int st = it % ST;
        const bool next = xt + 1 < x1;
        exchange(xt, it, [&](int half) {
          if (next) {
            const int sn = (it + 1) % ST;
            if (half == 0) {
              if (threadIdx.x == 0) refill(it + 1);
              __syncwarp();
              mbar_wait(bar_full(sn), ((it + 1) / ST) & 1);
            }
            logits(L.R, stage(sn), half == 1, half * SLABS / 2, (half + 1) * SLABS / 2);
          }
        });
        product(stage(st));
        // this block's reads of its buffers are done (their values are in
        // registers): a relaxed arrival suffices
        if (C > 1) cluster_arrive_relaxed();
        mbar_arrive(bar_empty(st));
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
    // Passes: the tile's logits over P sub-slices through the ring, then the
    // exchange and the product on the pass's own sub-slice.
    int it = 0;                     // ring items consumed
    for (int p = 0; p < P; ++p) {
      for (int xt = 0; xt < nx; ++xt) {
        for (int i = 0; i < P; ++i, ++it) {
          const int st = it % ST;
          if (threadIdx.x == 0) refill(it);
          __syncwarp();
          mbar_wait(bar_full(st), (it / ST) & 1);
          logits(stage(st), stage(st) + RSLAB * SLABS * 4, i > 0);
          if (i < P - 1) mbar_arrive(bar_empty(st));   // more of the slice to sum
        }
        const int st = (it - 1) % ST;   // the stage of the pass's own sub-slice
        exchange(xt, p * nx + xt, [](int) {});
        product(stage(st) + RSLAB * SLABS * 4);
        if (C > 1) cluster_arrive_relaxed();
        mbar_arrive(bar_empty(st));
      }
      store_pass(p);
    }
  }
  if (C > 1) cluster_wait();        // pairs the last arrival; nothing is in flight after it
}

// Launch head_bwd_fma<DE, BM>: h [T, E] and emb [V, E] fp32 (E % 4 == 0),
// out [T or V, E] fp32. C blocks a cluster along E, P passes (BM 128: one;
// BM 64: more); smem must equal the layout's bytes. Scratch and the cluster
// count as launch_bwd_wgmma's: one pass launches G = min(fit, cap) clusters
// where fewer than one a row tile fit at once; ws (cap * C * BM * 128 fp32)
// and flags (cap * C int32, zero) hold the sums of the row tiles split
// between clusters. Returns a CUDA error code.
template <bool DE, int BM>
int launch_fma(const void* h, const void* emb, const void* tgt, const void* lse, const void* dlse,
               const void* dgold, void* out, int T, int V, int E, int C, int P, int smem, int cap,
               void* ws, void* flags, cudaStream_t stream) {
  const Layout L(BM, C);
  if (smem != L.bytes || E % 4 != 0 || C < 1 || C > 8 || P < 1 || (BM == 128) != (P == 1) ||
      (long long)C * P * W < E || (long long)(C - 1) * P * W >= E)
    return (int)cudaErrorInvalidValue;
  auto kernel = head_bwd_fma<DE, BM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THR);
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
  const int nrt = ((DE ? V : T) + BM - 1) / BM;
  const int G = BM == 64 || fit >= nrt ? nrt : min(fit, cap);
  if (G < 1 || (G < nrt && (!ws || !flags))) return (int)cudaErrorInvalidValue;
  CUtensorMap tr, tx;
  int err = make_map(&tr, DE ? emb : h, E, 1, DE ? V : T, 1, BM, true);
  if (!err) err = make_map(&tx, DE ? h : emb, E, 1, DE ? T : V, 1, XROWS, true);
  if (err) return err;
  cfg.gridDim = dim3(C * G);
  // a split launch's clusters wait on each other's flags: cooperative, so
  // that it fails to launch rather than start without all of them resident
  cfg.numAttrs = (C > 1 ? 1 : 0) + (G < nrt ? 1 : 0);
  if (C == 1) cfg.attrs = attr + 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tr, tx, static_cast<const int*>(tgt),
                         static_cast<const float*>(lse), static_cast<const float*>(dlse),
                         static_cast<const float*>(dgold), static_cast<float*>(out), T, V, E, C,
                         P, G, static_cast<float*>(ws), static_cast<int*>(flags));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan's (cluster, passes, rows) -> the instantiation.
template <bool DE>
int launch_bwd(const void* h, const void* emb, const void* tgt, const void* lse, const void* dlse,
               const void* dgold, void* out, int T, int V, int E, int C, int passes, int rows,
               int smem, int cap, void* ws, void* flags, cudaStream_t s) {
  if (rows == 128 && passes == 1)
    return launch_fma<DE, 128>(h, emb, tgt, lse, dlse, dgold, out, T, V, E, C, 1, smem, cap, ws,
                               flags, s);
  if (rows == 64 && passes > 1)
    return launch_fma<DE, 64>(h, emb, tgt, lse, dlse, dgold, out, T, V, E, C, passes, smem, cap,
                              ws, flags, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fp32
}  // namespace fused_head
