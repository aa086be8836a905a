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
// 989 TFLOP/s bf16 peak, against ~84 MB of bf16 operands.
//
// bf16 operands: the tensor-core kernel flash_dq_wgmma, built as the forward
// (flash_attention_fwd.cu): one block per (head, batch row, query tile of
// 64 * NWG rows), heaviest causal tiles first; a producer warpgroup loads
// the Q and dO tiles once and keeps K/V tiles of 64 keys in flight by TMA
// through a 2-stage mbarrier ring; each consumer warpgroup owns 64 query
// rows and per key tile computes S = Q K^T and dP = dO V^T with wgmma from
// shared memory (K and V stored [keys, D] are K-major for both), p and ds in
// fp32 registers (masks only on edge tiles), and dQ += dS K with dS's bf16 A
// fragments taken from the accumulator registers and K read MN-major from
// the same tile. dQ stays in fp32 registers across the key loop.
//
// fp32 operands, and both types at head width 256: the scalar kernel
// flash_bwd_dq_scalar (the first port's design): 256 threads as a 16 x 16
// grid over a query tile of 64 rows (32 at D 256, where 64 would need
// 361,472 bytes of shared memory; 32 take 184,832), tiles staged as fp32,
// fp32 FMAs; ds is rounded to the operands' type before ds k (the identity
// in fp32).

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::from_f;
using flash::round_to;
using flash::to_f;

// ---- the scalar route (fp32 operands; bf16 at width 256)

namespace scalar {

constexpr int THREADS = 256;    // a 16 x 16 grid over the TILE x TILE score tile

// shared floats of a block at head width d and TILE-row tiles: q^T, do^T,
// k^T, v^T [d][LD]; k [TILE][d]; ds^T [TILE][LD], LD = TILE + 4;
// ops/pallas_attention.py (_plan) computes the same sum
__host__ __device__ constexpr size_t smem_floats(int d, int tile) {
  return (size_t)4 * d * (tile + 4) + (size_t)tile * d + (size_t)tile * (tile + 4);
}

template <int D, int TILE, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_scalar(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    void* __restrict__ dq, int Sq, int Sk, int H, int KV,
                    int causal, int window, float scale, int out_f32) {
  constexpr int BQ = TILE, BK = TILE, LD = TILE + 4;
  constexpr int R = TILE / 16;  // rows (and keys) of the score tile a thread owns
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + D * LD;
  float* kt = dot + D * LD;
  float* vt = kt + D * LD;
  float* ks = vt + D * LD;
  float* dst = ks + BK * D;

  constexpr int DC = D / 64;    // float4 column chunks per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * D;    // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const size_t q_base = ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    const bool in = qp < Sq;
    qt[d * LD + r] = in ? to_f(q[q_base + qp * q_stride + d]) : 0.f;
    dot[d * LD + r] = in ? to_f(dout[q_base + qp * q_stride + d]) : 0.f;
  }

  // delta and lse of this thread's rows; the 16 threads of a row share them
  float delta[R], row_lse[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    float acc = 0.f;
    if (qp < Sq) {
      for (int d = tx; d < D; d += 16)
        acc += to_f(dout[q_base + qp * q_stride + d]) *
               to_f(o[q_base + qp * q_stride + d]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
    row_lse[i] = qp < Sq ? lse[((size_t)b * H + h) * Sq + qp] : INFINITY;
  }

  // keys any row of this tile can see: causal skips tiles above the
  // diagonal, the window skips tiles left of the first row's window
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  float acc[R][DC * 4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // the q tile is in; the previous tile's reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int kp = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (kp < Sk) {
        kk = to_f(kb[kp * kv_stride + d]);
        vv = to_f(vb[kp * kv_stride + d]);
      }
      kt[d * LD + c] = kk;
      vt[d * LD + c] = vv;
      ks[c * D + d] = kk;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float av[R], gv[R], kv[R], vv[R];
      flash::ld_run<R>(&qt[d * LD + ty * R], av);
      flash::ld_run<R>(&dot[d * LD + ty * R], gv);
      flash::ld_run<R>(&kt[d * LD + tx * R], kv);
      flash::ld_run<R>(&vt[d * LD + tx * R], vv);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx * R + j;
        bool keep = qp < Sq && kp < Sk;
        if (causal) keep = keep && kp <= qp && (window <= 0 || kp > qp - window);
        // masked scores and rows with lse = +inf give p = 0 explicitly
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta[i]) * scale;
        dst[(tx * R + j) * LD + ty * R + i] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[R];
      flash::ld_run<R>(&dst[kk * LD + ty * R], dsv);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[kk * D + c * 64 + tx * 4]);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(dsv[i], kv[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= Sq) continue;
    const size_t row = q_base + qp * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (out_f32)
          static_cast<float*>(dq)[row + col] = acc[i][c * 4 + e];
        else
          static_cast<T*>(dq)[row + col] = from_f<T>(acc[i][c * 4 + e]);
      }
  }
}


}  // namespace scalar

// ---- the tensor-core route (bf16)

// Shared memory of flash_dq_wgmma, in bytes from a 1024-aligned base: the Q
// and dO tiles (D / 64 slabs of BQ rows each), STAGES K and STAGES V tiles,
// delta [BQ] fp32, then the mbarriers: Q/dO, full[STAGES], empty[STAGES].
// ops/pallas_attention.py (_plan) computes the same bytes; the launcher
// checks them.
template <int D, int NWG>
struct DqLayout {
  static constexpr int BQ = 64 * NWG;
  static constexpr int NS = D / 64;
  static constexpr int SLAB_Q = BQ * 128;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NS * SLAB_Q;
  static constexpr int K = DO + NS * SLAB_Q;
  static constexpr int V = K + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int DELTA = V + flash::STAGES * NS * flash::SLAB_K;
  static constexpr int BAR = DELTA + 4 * BQ;
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * flash::STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, void* __restrict__ dq, int Sq, int Sk, int H,
               int KV, int causal, int window, float scale, int out_f32) {
  using namespace flash;
  using L = DqLayout<D, NWG>;
  constexpr int NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
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
      mbar_expect_tx(bar_q, 2 * NS * L::SLAB_Q);
      for (int s = 0; s < NS; ++s) {
        tma_load(s_base + L::Q + s * L::SLAB_Q, &tq, 64 * s, h, q0, b, bar_q);
        tma_load(s_base + L::DO + s * L::SLAB_Q, &tdo, 64 * s, h, q0, b, bar_q);
      }
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

  // delta of the warpgroup's rows: two threads a row, D / 2 columns each
  {
    const int i = threadIdx.x % 128, rr = i / 2, half = i % 2;
    const int qp = r0 + rr;
    float sum = 0.f;
    if (qp < Sq) {
      const size_t off = (((size_t)b * Sq + qp) * H + h) * D + half * (D / 2);
#pragma unroll
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

  const uint32_t q_tile = s_base + L::Q + c * 64 * 128;
  const uint32_t do_tile = s_base + L::DO + c * 64 * 128;
  float acc[D / 2];               // dQ [64, D]: D / 8 column blocks of 4
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < kt.count; ++it) {
    const int st = it % STAGES;
    const int k0 = (kt.first + it) * BK;
    mbar_wait(bar_full(bar_q, st), (it / STAGES) & 1);
    if (!tile_hidden(k0, r0, r1, Sq, causal, window)) {
      const uint32_t k_tile = s_base + L::K + st * NS * SLAB_K;
      const uint32_t v_tile = s_base + L::V + st * NS * SLAB_K;
      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_k(q_tile, L::SLAB_Q, kk), desc_k(k_tile, SLAB_K, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k(do_tile, L::SLAB_Q, kk), desc_k(v_tile, SLAB_K, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

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
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128(acc, da[kk], desc_mn(k_tile, kk), 1);
        else
          wgmma_rs_n64(acc, da[kk], desc_mn(k_tile, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty(bar_q, st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const size_t off = (((size_t)b * Sq + row[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[4 * j + 2 * i], x1 = acc[4 * j + 2 * i + 1];
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + off + 8 * j) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dq) + off + 8 * j) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int causal,
                 int window, float scale, int out_f32, int smem, cudaStream_t stream) {
  using L = DqLayout<D, NWG>;
  if (smem != L::bytes) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int err = flash::make_map(&tq, q, D, H, Sq, B, L::BQ);
  if (!err) err = flash::make_map(&tdo, dout, D, H, Sq, B, L::BQ);
  if (!err) err = flash::make_map(&tk, k, D, KV, Sk, B, flash::BK);
  if (!err) err = flash::make_map(&tv, v, D, KV, Sk, B, flash::BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_dq_wgmma<D, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + L::BQ - 1) / L::BQ);
  flash_dq_wgmma<D, NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), dq, Sq, Sk, H, KV, causal, window, scale, out_f32);
  return (int)cudaGetLastError();
}

template <int D, int TILE, typename T>
int launch_scalar(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int causal,
                  int window, float scale, int out_f32, int smem, cudaStream_t stream) {
  if (smem != (int)(scalar::smem_floats(D, TILE) * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      scalar::flash_bwd_dq_scalar<D, TILE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  scalar::flash_bwd_dq_scalar<D, TILE, T><<<grid, scalar::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const T*>(dout), dq, Sq, Sk, H, KV, causal, window, scale, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32. D 64 and 128: bf16 takes the
// tensor-core kernel (block_q 64 or 128), fp32 the scalar kernel (block_q 64,
// dq in fp32); D 256: the scalar kernel in both types (block_q 32; fp32
// operands give dq in fp32). smem: the plan's shared-memory bytes, checked
// against the kernel's own layout.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int D,
    int causal, int window, float scale, int out_f32, int f32, int block_q, int smem,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || (f32 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, dout, dq, B, Sq, Sk, H, KV, causal, window, scale, out_f32, smem, s
  if (D == 256 && block_q == 32)
    return f32 ? launch_scalar<256, 32, float>(ARGS) : launch_scalar<256, 32, bf16>(ARGS);
  if (f32) {
    if (D == 128 && block_q == 64) return launch_scalar<128, 64, float>(ARGS);
    if (D == 64 && block_q == 64) return launch_scalar<64, 64, float>(ARGS);
  } else {
    if (D == 128 && block_q == 128) return launch_wgmma<128, 2>(ARGS);
    if (D == 128 && block_q == 64) return launch_wgmma<128, 1>(ARGS);
    if (D == 64 && block_q == 128) return launch_wgmma<64, 2>(ARGS);
    if (D == 64 && block_q == 64) return launch_wgmma<64, 1>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
