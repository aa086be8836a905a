// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v
// and lse, fp32 softmax.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/pallas_attention.py:160).
// Layout: q [B, Sq, H, D], k/v [B, Sk, KV, D], o [B, Sq, H, D], all contiguous;
// lse [B, H, Sq] fp32. Query head h reads kv head h / (H / KV); grouped K/V
// are never expanded. A row that sees no key gives o = 0 and lse = +inf.
//
// Bound: FLOPs at the training shape (B4 S2048 H8 D128 causal: two causal
// matmuls, 3.4e10 FLOP, 0.035 ms at 989 TFLOP/s bf16); HBM bytes at the
// serving prefill (B4 S128 H8 KV4), where launch latency dominates.
//
// bf16 operands: the tensor-core kernel flash_fwd_wgmma. One block per
// (head, batch row, query tile of 64 * NWG rows), heaviest causal tiles
// first. Warpgroup 0 is the producer: one thread loads the block's Q tile,
// then keeps K and V tiles of 64 keys in flight by TMA through a 2-stage
// ring of shared memory (full/empty mbarriers); it gives up registers
// (setmaxnreg) to the NWG consumer warpgroups, each of which owns 64 query
// rows. Per key tile a consumer computes S = Q K^T with wgmma from shared
// memory (K stored [keys, D] is K-major), the online softmax in fp32 with
// exp2 (scale * log2 e folded in), masks only on tiles that cross the
// diagonal, the window's edge or the ragged end, and O += P V with P's bf16
// A fragments taken straight from S's accumulator registers and V read
// MN-major (transposed) from the same swizzled tile. P is rounded to bf16
// before P V and the row sum l is taken from the unrounded p, the TPU
// kernel's rounding points.
//
// fp32 operands, and both types at head width 256: the scalar kernel
// flash_fwd_scalar (the first port's design): one block per (64-row query
// tile, head, batch row), 256 threads as a 16 x 16 grid, tiles staged as
// fp32 in shared memory (222,208 bytes at D 256), fp32 FMAs; p is rounded
// to the operands' type before P V (the identity in fp32). At D 256 the
// tensor-core kernel's accumulators would not fit beside its producer
// warpgroup (ops/pallas_attention.py _wgmma_sums).

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::from_f;
using flash::round_to;
using flash::to_f;

// ---- the scalar route (fp32 operands; bf16 at width 256)

namespace scalar {

constexpr int THREADS = 256;    // a 16 x 16 grid over the TILE x TILE score tile

// shared floats of a block at head width d and TILE-row tiles: q^T [d][LD],
// k^T [d][LD], v [TILE][d], p^T [TILE][LD], LD = TILE + 4 (keeps the runs
// of a thread aligned); ops/pallas_attention.py (_plan) computes the same sum
__host__ __device__ constexpr size_t smem_floats(int d, int tile) {
  return (size_t)2 * d * (tile + 4) + (size_t)tile * d + (size_t)tile * (tile + 4);
}

template <int D, int TILE, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_scalar(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float scale) {
  constexpr int BQ = TILE, BK = TILE, LD = TILE + 4;
  constexpr int R = TILE / 16;  // rows (and keys) of the score tile a thread owns
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + D * LD;
  float* vs = kt + D * LD;
  float* pt = vs + BK * D;

  constexpr int DC = D / 64;    // float4 column chunks per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * D;    // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    qt[d * LD + r] = qp < Sq ? to_f(qb[qp * q_stride + d]) : 0.f;
  }

  // keys any row of this tile can see: causal skips tiles above the
  // diagonal, the window skips tiles left of the first row's window
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  float acc[R][DC * 4];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;
  }

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
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float av[R], cv[R];
      flash::ld_run<R>(&qt[d * LD + ty * R], av);
      flash::ld_run<R>(&kt[d * LD + tx * R], cv);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx * R + j;
        bool keep = kp < Sk;
        if (causal) keep = keep && kp <= qp && (window <= 0 || kp > qp - window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps m = -inf: its p is 0, its
      // correction 1 (acc and l are still 0)
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        pt[(tx * R + j) * LD + ty * R + i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R];
      flash::ld_run<R>(&pt[kk * LD + ty * R], pv);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[kk * D + c * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(pv[i], vv[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= Sq) continue;
    // a row that saw no key gives 0 (and lse +inf), the TPU kernel's l_safe
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)b * Sq * H + h) * D + qp * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c * 64 + tx * 4 + e] = from_f<T>(acc[i][c * 4 + e] / l_safe);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + qp] =
          l[i] == 0.f ? INFINITY : m[i] + logf(l_safe);
  }
}


}  // namespace scalar

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
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], desc_mn(v_tile, kk), 1);
        else
          wgmma_rs_n64(acc, pa[kk], desc_mn(v_tile, kk), 1);
      }
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

template <int D, int TILE, typename T>
int launch_scalar(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                  int Sq, int Sk, int H, int KV, int causal, int window, float scale, int smem,
                  cudaStream_t stream) {
  if (smem != (int)(scalar::smem_floats(D, TILE) * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      scalar::flash_fwd_scalar<D, TILE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + TILE - 1) / TILE, H, B);
  scalar::flash_fwd_scalar<D, TILE, T><<<grid, scalar::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32. D 64 and 128: bf16 takes the
// tensor-core kernel (block_q 64 or 128), fp32 the scalar kernel (block_q 64);
// D 256: the scalar kernel in both types (block_q 64). smem: the plan's
// shared-memory bytes, checked against the kernel's own layout.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KV, int D, int causal, int window, float scale,
    int f32, int block_q, int smem, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, smem, s
  if (D == 256 && block_q == 64)
    return f32 ? launch_scalar<256, 64, float>(ARGS) : launch_scalar<256, 64, bf16>(ARGS);
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
