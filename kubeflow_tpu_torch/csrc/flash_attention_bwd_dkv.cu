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
// (0.025 ms at 3.35 TB/s).
//
// bf16 operands: the tensor-core kernel flash_dkv_wgmma, FA3's backward
// shape without dQ (flash_attention_bwd_dq.cu computes dq). One block per
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
// fp32 operands, and both types at head width 256: the scalar kernel
// flash_bwd_dkv_kernel (the first port's design): one block per (key tile,
// kv head, batch row), 256 threads as a 16 x 16 grid, tiles staged as fp32
// in shared memory, fp32 FMAs; thread (ty, tx) owns keys ty*R .. ty*R+R-1
// and columns c*64 + tx*4 .. +3 of dk and dv. Tiles of 64 keys and 64 query
// rows (R 4; 222,720 bytes at D 128); at D 256, 32 and 32 (R 2; 217,856
// bytes, where 64 would need 427,520). P and dS are rounded to the
// operands' type as the operands of their products (the identity in fp32).

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::from_f;
using flash::round_to;
using flash::to_f;

// ---- the scalar route (fp32 operands; bf16 at width 256)

namespace scalar {

constexpr int THREADS = 256;    // a 16 x 16 grid over the TILE x TILE score tile

// shared floats of a block at head width d, TILE keys a block and TILE
// query rows a tile: k^T, v^T, q^T, do^T [d][LD]; q, do [TILE][d]; p^T / ds^T
// [TILE][LD]; delta, lse [TILE], LD = TILE + 4; ops/pallas_attention.py
// (_plan) computes the same sum
__host__ __device__ constexpr size_t smem_floats(int d, int tile) {
  return (size_t)4 * d * (tile + 4) + (size_t)2 * tile * d + (size_t)tile * (tile + 4) + 2 * tile;
}

template <int DC, int TILE>
__device__ __forceinline__ void accumulate(const float* __restrict__ pt,
                                           const float* __restrict__ rows,
                                           float (&acc)[TILE / 16][DC * 4], int tx, int ty) {
  // acc[key][col] += sum_q pt[q][key] * rows[q][col]
  constexpr int D = DC * 64, LD = TILE + 4, R = TILE / 16;
#pragma unroll 4
  for (int qq = 0; qq < TILE; ++qq) {
    float pv[R];
    flash::ld_run<R>(&pt[qq * LD + ty * R], pv);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 r4 = *reinterpret_cast<const float4*>(&rows[qq * D + c * 64 + tx * 4]);
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][c * 4 + e] = fmaf(pv[i], rv[e], acc[i][c * 4 + e]);
    }
  }
}

template <int D, int TILE, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     void* __restrict__ dk, void* __restrict__ dv,
                     int Sq, int Sk, int H, int KV, int causal, int window,
                     float scale, int out_f32) {
  constexpr int BQ = TILE, BK = TILE, LD = TILE + 4;
  constexpr int R = TILE / 16;  // keys (and query rows) of the score tile a thread owns
  constexpr int PARTS = THREADS / BQ;   // threads that sum one row's delta
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + D * LD;
  float* qt = vt + D * LD;
  float* dot = qt + D * LD;
  float* qs = dot + D * LD;
  float* dos = qs + BQ * D;
  float* pt = dos + BQ * D;
  float* delta_s = pt + BQ * LD;
  float* lse_s = delta_s + BQ;

  constexpr int DC = D / 64;    // float4 column chunks per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const int g = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const size_t q_stride = (size_t)H * D;    // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const size_t kv_base = ((size_t)b * Sk * KV + g) * D;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int c = i / D, d = i % D;
    const int kp = k0 + c;
    const bool in = kp < Sk;
    kt[d * LD + c] = in ? to_f(k[kv_base + kp * kv_stride + d]) : 0.f;
    vt[d * LD + c] = in ? to_f(v[kv_base + kp * kv_stride + d]) : 0.f;
  }

  // query rows that can see any key of this tile: causal starts at the
  // diagonal, the window ends window - 1 rows after the tile's last key
  const int k_last = min(k0 + BK - 1, Sk - 1);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = (causal && window > 0) ? min(Sq - 1, k_last + window - 1) : Sq - 1;

  float acc_dk[R][DC * 4], acc_dv[R][DC * 4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const size_t q_base = ((size_t)b * Sq * H + h) * D;
    for (int q0 = (q_lo / BQ) * BQ; q0 <= q_hi; q0 += BQ) {
      __syncthreads();  // the k/v tiles are in; the previous tile's reads are done
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const int qp = q0 + r;
        float qq = 0.f, gg = 0.f;
        if (qp < Sq) {
          qq = to_f(q[q_base + qp * q_stride + d]);
          gg = to_f(dout[q_base + qp * q_stride + d]);
        }
        qt[d * LD + r] = qq;
        dot[d * LD + r] = gg;
        qs[r * D + d] = qq;
        dos[r * D + d] = gg;
      }
      {
        // delta of row r from PARTS neighbouring lanes of a warp
        const int r = tid / PARTS, part = tid % PARTS;
        const int qp = q0 + r;
        float acc = 0.f;
        if (qp < Sq) {
          for (int d = part; d < D; d += PARTS)
            acc += to_f(dout[q_base + qp * q_stride + d]) *
                   to_f(o[q_base + qp * q_stride + d]);
        }
#pragma unroll
        for (int off = 1; off < PARTS; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (part == 0) {
          delta_s[r] = acc;
          lse_s[r] = qp < Sq ? lse[((size_t)b * H + h) * Sq + qp] : INFINITY;
        }
      }
      __syncthreads();

      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], av[R], gv[R];
        flash::ld_run<R>(&kt[d * LD + ty * R], kv);
        flash::ld_run<R>(&vt[d * LD + ty * R], vv);
        flash::ld_run<R>(&qt[d * LD + tx * R], av);
        flash::ld_run<R>(&dot[d * LD + tx * R], gv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(kv[i], av[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }

      // p^T into shared memory now, ds^T after dv has read p^T
      float ds[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = tx * R + j;
          const int qp = q0 + r;
          bool keep = kp < Sk && qp < Sq;
          if (causal) keep = keep && kp <= qp && (window <= 0 || kp > qp - window);
          // masked scores and rows with lse = +inf give p = 0 explicitly
          const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ds[i][j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
          pt[r * LD + ty * R + i] = round_to<T>(p);
        }
      }
      __syncthreads();
      accumulate<DC, TILE>(pt, dos, acc_dv, tx, ty);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) pt[(tx * R + j) * LD + ty * R + i] = ds[i][j];
      __syncthreads();
      accumulate<DC, TILE>(pt, qs, acc_dk, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    if (kp >= Sk) continue;
    const size_t row = kv_base + kp * kv_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (out_f32) {
          static_cast<float*>(dk)[row + col] = acc_dk[i][c * 4 + e];
          static_cast<float*>(dv)[row + col] = acc_dv[i][c * 4 + e];
        } else {
          static_cast<T*>(dk)[row + col] = from_f<T>(acc_dk[i][c * 4 + e]);
          static_cast<T*>(dv)[row + col] = from_f<T>(acc_dv[i][c * 4 + e]);
        }
      }
  }
}

}  // namespace scalar

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

template <int D, int TILE, typename T>
int launch_scalar(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                  int causal, int window, float scale, int out_f32, int smem,
                  cudaStream_t stream) {
  using scalar::flash_bwd_dkv_kernel;
  if (smem != (int)(scalar::smem_floats(D, TILE) * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, TILE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + TILE - 1) / TILE, KV, B);
  flash_bwd_dkv_kernel<D, TILE, T><<<grid, scalar::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const T*>(dout), dk, dv, Sq, Sk, H, KV, causal, window, scale, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32. D 64 and 128: bf16 takes the
// tensor-core kernel (block_k 64 or 128 keys a block), fp32 the scalar
// kernel (block_k 64, dk and dv in fp32); D 256: the scalar kernel in both
// types (block_k 32; fp32 operands give dk and dv in fp32). smem: the plan's
// shared-memory bytes, checked against the kernel's own layout.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
    int D, int causal, int window, float scale, int out_f32, int f32, int block_k,
    int smem, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || (f32 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, dout, dk, dv, B, Sq, Sk, H, KV, causal, window, scale, out_f32, smem, s
  if (D == 256 && block_k == 32)
    return f32 ? launch_scalar<256, 32, float>(ARGS) : launch_scalar<256, 32, bf16>(ARGS);
  if (f32) {
    if (D == 128 && block_k == 64) return launch_scalar<128, 64, float>(ARGS);
    if (D == 64 && block_k == 64) return launch_scalar<64, 64, float>(ARGS);
  } else {
    if (D == 128 && block_k == 128) return launch_wgmma<128, 2>(ARGS);
    if (D == 128 && block_k == 64) return launch_wgmma<128, 1>(ARGS);
    if (D == 64 && block_k == 128) return launch_wgmma<64, 2>(ARGS);
    if (D == 64 && block_k == 64) return launch_wgmma<64, 1>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
