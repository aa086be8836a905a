// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v
// and lse, fp32 softmax.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/pallas_attention.py:160).
// Layout: q [B, Sq, H, D], k/v [B, Sk, KV, D], o [B, Sq, H, D], all contiguous;
// lse [B, H, Sq] fp32. Query head h reads kv head h / (H / KV); grouped K/V
// are never expanded. A row that sees no key gives o = 0 and lse = +inf.
//
// Bound: FLOPs at the training shape (B4 S2048 H8 D128 causal: two causal
// matmuls, 3.4e10 FLOP, 0.035 ms at 989 TFLOP/s bf16; at D 256 6.9e10 FLOP,
// 0.070 ms); HBM bytes at the serving prefill (B4 S128 H8 KV4), where launch
// latency dominates.
//
// bf16 operands: the tensor-core kernel flash_fwd_wgmma. One block per
// (head, batch row, query tile of 64 * NWG rows), heaviest causal tiles
// first. Warpgroup 0 is the producer: one thread loads the block's Q tile,
// then keeps K and V tiles of 64 keys in flight by TMA through a 2-stage
// ring of shared memory (full/empty mbarriers); beside two consumer
// warpgroups it gives up registers (setmaxnreg) to them. Each of the NWG
// consumer warpgroups owns 64 query rows. Per key tile a consumer computes
// S = Q K^T with wgmma from shared memory (K stored [keys, D] is K-major),
// the online softmax in fp32 with exp2 (scale * log2 e folded in), masks
// only on tiles that cross the diagonal, the window's edge or the ragged
// end, and O += P V with P's bf16 A fragments taken straight from S's
// accumulator registers and V read MN-major (transposed) from the same
// swizzled tile, one wgmma of N = D a 16-key step. P is rounded to bf16
// before P V and the row sum l is taken from the unrounded p, the TPU
// kernel's rounding points.
//
// Head width 256 (bf16): <256, 1>, one consumer warpgroup beside the
// producer, 256 threads under __launch_bounds__(256, 1) and no setmaxnreg,
// so a thread may hold 255 registers: O (128 fp32) and S (32) fit, where
// two consumers beside a producer cap a thread at 168. Shared memory
// 164,904 bytes (Q 32 KiB, two stages of K and V 128 KiB).
//
// Head width 512 (bf16): flash_fwd_wgmma_halves. O of 64 rows would take
// 256 fp32 registers a thread (past 255), so two warpgroups on the same 64
// rows own 256 columns of O each, thread 0 producing between its own
// products (no producer warpgroup: beside it ptxas caps a thread at 168
// registers). Both compute S over all 512 columns: 1.5x the forward's FLOPs
// (bound at the heads-of-512 training shape, B4 S2048 H2: the same 3.4e10
// FLOP as D 128 H8, 0.035 ms; with the recomputed S 0.052 ms). K and V in
// 32-key tiles: Q (64 KiB) and two stages (128 KiB), 197,672 bytes.
//
// fp32 operands: flash_fwd_fma, the same walk with register-tiled fp32 FMA
// products (no TF32: the route exists to match the plain version's full-fp32
// products; bound 2 causal matmuls at the 67 TF/s fp32 peak, 0.513 ms at
// the training shape). The grid, the heaviest-first order and the masking of
// only the edge tiles are the bf16 route's; Q stays resident, K and V tiles
// stream through a 2-stage TMA ring of fp32 boxes of 32 columns (128-byte
// swizzle), thread 0 issuing the copies between its own products. Q, two
// stages and the fp32 P tile fill the block: D 64 and 128 take 128 query
// rows and 64-key tiles (230,440 bytes at D 128), D 256 64 rows and 32-key
// tiles (205,864 bytes). P is not rounded (the TPU kernel's astype of p to
// the operands' type is the identity in fp32) and l sums the same p.
//
// Head width 512 (fp32): flash_fwd_fma<512, 64, 32, 2>. Q resident at 512
// columns would leave room for 32 rows and 16-key tiles only (a thread's 2 x 1
// scores fed 2.7 FMAs a shared-memory load, where 64-row, 32-key tiles feed
// 5.3).
// So, as the width-512 dq and dk/dv pairs, the width-256 kernel runs on each
// column half as a cluster of two blocks a query tile (grid (H, B, 2 x query
// tiles)): block c holds columns 256 c .. 256 c + 255 of Q, K and V and owns
// those of O; after each tile's S (partial over its columns) all 256 threads
// send their 8 fp32 partials to their twins by st.async (one 8 KiB slot, its
// free barrier counting eight warps) and add the twins'. fp32 addition
// commutes, so both blocks hold the same bits of S, and the mask, the online
// softmax and P follow the sum alike in both; each block multiplies P by its
// own 256 columns of V. Block 0 writes lse. 214,072 bytes; exactly the
// bound's FLOPs (each score product once).

#include "flash_common.cuh"

namespace {

using flash::bf16;

// ---- the tensor-core route (bf16)

// Shared memory of flash_fwd_wgmma, in bytes from a 1024-aligned base: the Q
// tile (D / 64 slabs of BQ rows), STAGES K tiles, STAGES V tiles (D / 64
// slabs of BK rows each), then the mbarriers: Q, full[STAGES], empty[STAGES].
// `bytes` adds the slack for aligning the dynamic base; ops/pallas_attention.py
// (_plan) computes the same number and the launcher checks it.
template <int D, int NWG>
struct FwdLayout {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NS = D / 64;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + NS * SLAB_Q;
  static constexpr int V = K + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int BAR = V + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
                int window, float scale) {
  using namespace flash;
  using L = FwdLayout<D, NWG>;
  constexpr int NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::BAR;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::BQ;  // heaviest causal tiles first
  const int kvh = h / (H / KV);
  const KeyTiles kt = key_tiles(q0, L::BQ, Sq, Sk, causal, window);
  init_barriers(bar_q, NWG * 128);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer
    if (NWG > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, NS * L::SLAB_Q);
      for (int s = 0; s < NS; ++s)
        tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, 64 * s, h, q0, b, bar_q);
      produce_kv(&tk, &tv, s_base + L::K, s_base + L::V, NS, bar_q, kt, kvh, b);
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows r0 .. r0 + 63
  if (NWG > 1) setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * c;
  const int r1 = min(r0 + 63, Sq - 1);
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const float sl2 = scale * LOG2E;
  const uint32_t q_tile = s_base + L::Q + c * 64 * 128;

  float acc[D / 2];               // O [64, D]: D / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};        // this thread's part of the row sums

  mbar_wait(bar_q, 0);
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    if (!tile_hidden(k0, r0, r1, Sq, causal, window)) {
      const uint32_t k_tile = s_base + L::K + st * NS * SLAB_K;
      const uint32_t v_tile = s_base + L::V + st * NS * SLAB_K;
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_k(q_tile, L::SLAB_Q, kk), desc_k(k_tile, SLAB_K, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (tile_edge(k0, r0, r1, Sk, causal, window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!visible(k0 + 8 * j + 2 * t + e, row[i], Sk, causal, window))
                s[4 * j + 2 * i + e] = -INFINITY;
      }

      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row that has seen no key yet keeps m = -inf: its p is 0 and its
        // correction 0 (acc and l are still 0)
        const float m_use = mx == -INFINITY ? 0.f : mx;
        corr[i] = exp2f((m[i] - m_use) * sl2);
        const float off = m_use * sl2;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * j + 2 * i + e], sl2, -off));
            s[4 * j + 2 * i + e] = p;
            rs += p;
          }
        l[i] = l[i] * corr[i] + rs;
        m[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      uint32_t pa[BK / 16][4];    // P in bf16: the A operand of P V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = flash::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_tile<D>(acc, pa[kk], v_tile, kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= Sq) continue;
    // a row that saw no key gives 0 (and lse +inf), the TPU kernel's l_safe
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    bf16* orow = o + (((size_t)b * Sq + row[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (t == 0)
      lse[((size_t)b * H + h) * Sq + row[i]] = l[i] == 0.f ? INFINITY : m[i] * scale + logf(l[i]);
  }
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
                 int Sk, int H, int KV, int causal, int window, float scale, int smem,
                 cudaStream_t stream) {
  using L = FwdLayout<D, NWG>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = flash::make_map(&tq, q, D, H, Sq, B, L::BQ);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, flash::BK);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, flash::BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<D, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + L::BQ - 1) / L::BQ);
  flash_fwd_wgmma<D, NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// ---- the tensor-core route at head width 512 (bf16): two warpgroups on
// the same 64 rows, each owning half of O's columns

// Shared memory of flash_fwd_wgmma_halves, in bytes from a 1024-aligned
// base: the Q tile (D / 64 slabs of 64 rows), STAGES K tiles and STAGES V
// tiles of HK keys (D / 64 slabs of HK rows each), then the mbarriers: Q,
// full[STAGES], empty[STAGES]. ops/pallas_attention.py (_wgmma_sums)
// computes the same bytes; the launcher checks them. 64-key tiles would
// take 256 KiB for two stages beside Q's 64 KiB, past a block's 227 KiB.
template <int D>
struct FwdHalvesLayout {
  static constexpr int HK = 32;                 // keys a K or V tile
  static constexpr int NS = D / 64;
  static constexpr int SLAB_Q = 64 * 128;
  static constexpr int SLAB_K = HK * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + NS * SLAB_Q;
  static constexpr int V = K + flash::STAGES * NS * SLAB_K;
  static constexpr int BAR = V + flash::STAGES * NS * SLAB_K;
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES);
};

// One block per (head, batch row, 64 query rows), heaviest causal tiles
// first, 256 threads: no producer warpgroup (beside two consumers ptxas caps
// a thread at 168 registers, fewer than the 128 of O's half and the scores
// beside it); thread 0 loads Q and keeps K/V tiles in flight between its
// own products, blocking only for the tile its warpgroup needs next, as
// flash_dkv_wgmma_pair does. Both warpgroups compute S = Q K^T over all D
// columns and the same online softmax (the same instructions on the same
// tiles: the same bits in both), and warpgroup c multiplies O[:, c D / 2 ..]
// += P V[:, c D / 2 ..], one m64n256k16 a 16-key step. Recomputing S costs
// half the kernel's FLOPs again, and keeps the warpgroups apart: no
// exchange and no barrier between them inside a tile.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_fwd_wgmma_halves(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
                       int window, float scale) {
  using namespace flash;
  using L = FwdHalvesLayout<D>;
  constexpr int NS = L::NS, HK = L::HK, DH = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::BAR;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;   // heaviest causal tiles first
  const int kvh = h / (H / KV);
  // every tile of the walk holds a key that one of the block's rows sees
  const KeyTiles kt = key_tiles<HK>(q0, 64, Sq, Sk, causal, window);
  init_barriers(bar_q, 256);

  int issued = 0;
  auto issue = [&](int j, int sj) {
    const int k0 = (kt.first + j) * HK;
    mbar_expect_tx(bar_full(bar_q, sj), 2 * NS * L::SLAB_K);
    for (int s = 0; s < NS; ++s) {
      tma_load(s_base + L::K + (sj * NS + s) * L::SLAB_K, &tk, 64 * s, kvh, k0, b,
               bar_full(bar_q, sj));
      tma_load(s_base + L::V + (sj * NS + s) * L::SLAB_K, &tv, 64 * s, kvh, k0, b,
               bar_full(bar_q, sj));
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, NS * L::SLAB_Q);
    for (int s = 0; s < NS; ++s)
      tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, 64 * s, h, q0, b, bar_q);
    refill(issued, kt.count, 0, bar_q, issue);
  }
  __syncwarp();

  // warpgroup c owns O's columns c DH .. c DH + DH - 1 of rows q0 .. q0 + 63
  const int c = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r1 = min(q0 + 63, Sq - 1);
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float sl2 = scale * LOG2E;

  float acc[DH / 2];              // O [64, DH]: DH / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};        // this thread's part of the row sums

  mbar_wait(bar_q, 0);
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * HK;
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);
    __syncwarp();
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    const uint32_t k_tile = s_base + L::K + st * NS * L::SLAB_K;
    const uint32_t v_tile = s_base + L::V + st * NS * L::SLAB_K;
    float s[HK / 2];
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(s, desc_k(s_base + L::Q, L::SLAB_Q, kk), desc_k(k_tile, L::SLAB_K, kk), kk > 0);
    wgmma_commit();
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);   // while it runs
    __syncwarp();
    wgmma_wait_all();
    fence_regs(s);

    if (tile_edge<HK>(k0, q0, r1, Sk, causal, window)) {
#pragma unroll
      for (int j = 0; j < HK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!visible(k0 + 8 * j + 2 * t + e, row[i], Sk, causal, window))
              s[4 * j + 2 * i + e] = -INFINITY;
    }

    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < HK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps m = -inf: its p is 0 and its
      // correction 0 (acc and l are still 0)
      const float m_use = mx == -INFINITY ? 0.f : mx;
      corr[i] = exp2f((m[i] - m_use) * sl2);
      const float off = m_use * sl2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < HK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * j + 2 * i + e], sl2, -off));
          s[4 * j + 2 * i + e] = p;
          rs += p;
        }
      l[i] = l[i] * corr[i] + rs;
      m[i] = mx;
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    uint32_t pa[HK / 16][4];      // P in bf16: the A operand of P V
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O[:, c DH ..] += P V[:, c DH ..], V read MN-major from its slabs c NS / 2 ..
    const uint32_t v_half = v_tile + c * (NS / 2) * L::SLAB_K;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk)
      wgmma_rs_n256(acc, pa[kk], desc(v_half + kk * 16 * 128, L::SLAB_K, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= Sq) continue;
    // a row that saw no key gives 0 (and lse +inf), the TPU kernel's l_safe
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    bf16* orow = o + (((size_t)b * Sq + row[i]) * H + h) * D + c * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (t == 0 && c == 0)
      lse[((size_t)b * H + h) * Sq + row[i]] = l[i] == 0.f ? INFINITY : m[i] * scale + logf(l[i]);
  }
}

template <int D>
int launch_wgmma_halves(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int Sq, int Sk, int H, int KV, int causal, int window, float scale,
                        int smem, cudaStream_t stream) {
  using L = FwdHalvesLayout<D>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = flash::make_map(&tq, q, D, H, Sq, B, 64);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, L::HK);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, L::HK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_halves<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + 63) / 64);
  flash_fwd_wgmma_halves<D><<<grid, 256, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, KV, causal, window,
      scale);
  return (int)cudaGetLastError();
}

// ---- the fp32 route: register-tiled fp32 FMAs fed by TMA

namespace fwd32 {

constexpr int THR = 256;

// Shared memory of flash_fwd_fma<D, BQ, BK, CL>, in bytes from a
// 1024-aligned base: the Q tile (DL / 32 slabs of BQ rows of 32 fp32
// columns, 128-byte rows; DL = D / CL the block's columns), STAGES ring
// stages (the K tile's DL / 32 slabs of BK rows, then the V tile's), the
// fp32 P tile [BQ][BK], at CL 2 the receive slot of the peer's partial S
// ([2][THR] float4: the block's 256 threads, 8 partials each), then the
// mbarriers: Q, full[STAGES], empty[STAGES], and at CL 2 the slot's full and
// free. `bytes` adds the slack for aligning the dynamic base;
// ops/pallas_attention.py (_fma_fwd_bytes) sums the same and the launcher
// checks it.
template <int D, int BQ, int BK, int CL>
struct Layout {
  static constexpr int DL = D / CL;
  static constexpr int NS = DL / 32;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int SLAB_K = BK * 128;
  static constexpr int STAGE = 2 * NS * SLAB_K;
  static constexpr int Q = 0;
  static constexpr int KV = Q + NS * SLAB_Q;
  static constexpr int P = KV + flash::STAGES * STAGE;
  static constexpr int RX = P + BQ * BK * 4;
  static constexpr int BAR = RX + (CL > 1 ? BQ * BK * 4 : 0);
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES) + (CL > 1 ? 16 : 0);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
  static_assert(CL == 1 || (DL == 256 && BQ * BK == 8 * THR), "a pair swaps 8 partials a thread");
};

// One block per (head, batch row, query tile of BQ rows), heaviest causal
// tiles first; 256 threads as 16 row groups g by 16 column lanes x, the 16
// lanes of a group one half of a warp. Thread (g, x) holds scores of rows
// g + 16 i and keys x + 16 j (R x J), and O of the same rows and columns
// 4 x + 64 h .. + 3 (R x 4 DH): the rows' online softmax (max by four
// shuffles over the group, exp2 with scale * log2 e folded in) rescales its
// own accumulators, and the P rows it multiplies by V are the ones its group
// wrote, so P passes through a warp's own rows of the P tile behind a
// __syncwarp and no block barrier. Only thread 0 (issuing the copies) and
// the ring's mbarriers join the warps. CL 2 (head width 512): block c of a
// cluster of two holds columns c DL .. of Q, K and V and owns those of O;
// both walk the same query tile and key tiles, and after each tile's S
// (partial over DL columns) all 256 threads swap it with their twins in the
// other block (the pair pieces of flash_common.cuh, one slot of THR
// threads) before the mask and the softmax. Block 0 writes lse.
template <int D, int BQ, int BK, int CL>
__global__ void __launch_bounds__(THR, 1)
flash_fwd_fma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal, int window,
              float scale) {
  using namespace flash;
  using L = Layout<D, BQ, BK, CL>;
  constexpr int NS = L::NS;
  constexpr int R = BQ / 16;      // rows a thread
  constexpr int J = BK / 16;      // keys a thread of each score tile
  constexpr int DH = L::DL / 64;  // 4-column groups of O a thread
  static_assert(J == 4 || J == 2, "tiles of 64 or 32 keys");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const float* fs = reinterpret_cast<const float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + L::P);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::BAR;
  const uint32_t rx_full = bar_q + 8 * (1 + 2 * STAGES), rx_free = rx_full + 8;

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest causal tiles first; a pair's two blocks take one query tile
  const int q0 = (gridDim.z / CL - 1 - blockIdx.z / CL) * BQ;
  const int q1 = min(q0 + BQ - 1, Sq - 1);
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int d0 = rank * L::DL;                         // the block's columns
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
    mbar_expect_tx(bar_q, NS * L::SLAB_Q);
    for (int s = 0; s < NS; ++s)
      tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, d0 + 32 * s, h, q0, b, bar_q);
    refill(issued, kt.count, 0, bar_q, issue);
  }
  __syncwarp();

  const int g = threadIdx.x >> 4, x = threadIdx.x & 15, lane = threadIdx.x & 31;
  const int kg = g & 7;
  const float sl2 = scale * LOG2E;
  Pair pr{};
  if constexpr (CL > 1) pr = pair_at(s_base + L::RX, rx_full, rx_free);
  const float4* rx = reinterpret_cast<const float4*>(smem + L::RX);
  float acc[R][4 * DH];
  float m[R], l[R];               // l: this thread's part of the row sums
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DH; ++c) acc[i][c] = 0.f;
  }

  mbar_wait(bar_q, 0);
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);
    __syncwarp();
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    const float* Kt = fs + (L::KV + st * L::STAGE) / 4;
    const float* Vt = Kt + NS * L::SLAB_K / 4;

    // S = Q K^T: rows g + 16 i, keys x + 16 j, d in order
    float sp[1][R][J];
    auto& s = sp[0];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.f;
    fma32::dot_rows<NS, R, J>(sp, {fs + L::Q / 4}, L::SLAB_Q / 4, {Kt}, L::SLAB_K / 4, g, x);
    // the next tile, if its stage is free by now
    if (threadIdx.x == 0) refill(issued, kt.count, it, bar_q, issue);
    __syncwarp();
    if constexpr (CL > 1) {
      // S = S0 + S1 over the pair's column halves
      float part[R * J];
#pragma unroll
      for (int e = 0; e < R * J; ++e) part[e] = s[e / J][e % J];
      pair_send<R * J, THR>(pr, part, it, threadIdx.x, BQ * BK * 4);
      pair_add<R * J, THR>(pr, part, rx, it, threadIdx.x);
      pair_release(pr);
#pragma unroll
      for (int e = 0; e < R * J; ++e) s[e / J][e % J] = part[e];
    }

    if (tile_edge<BK>(k0, q0, q1, Sk, causal, window)) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (!visible(k0 + x + 16 * j, q0 + g + 16 * i, Sk, causal, window))
            s[i][j] = -INFINITY;
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < J; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // a row that has seen no key yet keeps m = -inf: its p is 0 and its
      // correction 0 (acc and l are still 0)
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float corr = exp2f((m[i] - m_use) * sl2);
      const float off = m_use * sl2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], sl2, -off));
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * DH; ++c) acc[i][c] *= corr;
      fma32::put_row<J>(ps + (g + 16 * i) * BK, s[i], x, kg);
    }
    __syncwarp();

    // O += P V, V read in the row order of P's positions
    fma32::acc_rows<R, J, DH>(acc, ps, Vt, L::SLAB_K / 4, g, x);
    __syncwarp();                  // this warp's P reads and stage reads are done
    if (lane == 0) mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + g + 16 * i;
    if (row >= Sq) continue;
    // a row that saw no key gives 0 (and lse +inf), the TPU kernel's l_safe
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = o + (((size_t)b * Sq + row) * H + h) * D + d0;
#pragma unroll
    for (int hh = 0; hh < DH; ++hh)
      *reinterpret_cast<float4*>(orow + 4 * x + 64 * hh) =
          make_float4(acc[i][4 * hh] * inv, acc[i][4 * hh + 1] * inv, acc[i][4 * hh + 2] * inv,
                      acc[i][4 * hh + 3] * inv);
    if (x == 0 && rank == 0)
      lse[((size_t)b * H + h) * Sq + row] = l[i] == 0.f ? INFINITY : m[i] * scale + logf(l[i]);
  }
  // the peer may still arrive on this block's free barrier: neither block
  // exits before both are done with the other's shared memory
  if constexpr (CL > 1) cluster_sync();
}

}  // namespace fwd32

template <int D, int BQ, int BK, int CL>
int launch_fma(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
               int Sk, int H, int KV, int causal, int window, float scale, int smem,
               cudaStream_t stream) {
  using L = fwd32::Layout<D, BQ, BK, CL>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = flash::make_map(&tq, q, D, H, Sq, B, BQ, true);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, BK, true);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, BK, true);
  if (err) return err;
  auto kernel = fwd32::flash_fwd_fma<D, BQ, BK, CL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, CL * ((Sq + BQ - 1) / BQ));
  cfg.blockDim = dim3(fwd32::THR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = CL;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, static_cast<float*>(o),
                         static_cast<float*>(lse), Sq, Sk, H, KV, causal, window, scale);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32. bf16 takes the tensor-core kernel:
// block_q 64 or 128 at D 64 and 128, 64 at D 256 and 512 (at 512 the two
// warpgroups' halves of O); fp32 the FMA kernel: block_q 128 at D 64 and 128
// (64-key tiles), 64 at D 256 and 512 (32-key tiles; at 512 a cluster of two
// blocks a query tile, each owning half of O).
// smem: the plan's shared-memory bytes, checked against the kernel's own
// layout.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KV, int D, int causal, int window, float scale,
    int f32, int block_q, int smem, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, smem, s
  if (f32) {
    if (D == 512 && block_q == 64) return launch_fma<512, 64, 32, 2>(ARGS);
    if (D == 256 && block_q == 64) return launch_fma<256, 64, 32, 1>(ARGS);
    if (D == 128 && block_q == 128) return launch_fma<128, 128, 64, 1>(ARGS);
    if (D == 64 && block_q == 128) return launch_fma<64, 128, 64, 1>(ARGS);
  } else {
    if (D == 512 && block_q == 64) return launch_wgmma_halves<512>(ARGS);
    if (D == 256 && block_q == 64) return launch_wgmma<256, 1>(ARGS);
    if (D == 128 && block_q == 128) return launch_wgmma<128, 2>(ARGS);
    if (D == 128 && block_q == 64) return launch_wgmma<128, 1>(ARGS);
    if (D == 64 && block_q == 128) return launch_wgmma<64, 2>(ARGS);
    if (D == 64 && block_q == 64) return launch_wgmma<64, 1>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
