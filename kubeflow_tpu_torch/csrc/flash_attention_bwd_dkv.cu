// Flash-attention backward, dk and dv, for Hopper (sm_90a): bf16 or fp32
// operands (the same scalar kernel for both), fp32 math.
//
// Replaces the Pallas kernel _dkv_kernel (kubeflow_tpu/ops/pallas_attention.py:336).
// Layout: q, o, do [B, Sq, H, D], k/v [B, Sk, KV, D], all contiguous, one type;
// lse [B, H, Sq] fp32 (+inf on rows that see no key); dk, dv [B, Sk, KV, D]
// in fp32 (out_f32) or the operands' type. Query head h reads kv head h / (H / KV).
//
// One thread block per (64-key tile, KV head, batch row), 256 threads as a
// 16 x 16 grid. The k and v tiles stay in shared memory for the whole block.
// The block loops over the group's H / KV query heads and, for each head,
// over the query tiles that can see its keys: from the diagonal to the
// sliding window's far edge (the TPU kernel's _q_valid, :119-130). Thread
// (ty, tx) owns keys ty*4 .. ty*4+3: per query tile it computes the 4 x 4
// transposed scores s^T = k q^T and dp^T = v do^T of those keys against query
// rows tx*4 .. tx*4+3, and it accumulates dk and dv of those keys in columns
// c*64 + tx*4 .. +3 (c < D/64) in fp32 registers across every head and tile.
// delta = rowsum(do * o) is recomputed per query tile from the do and o tiles
// (the TPU kernel does the same, :352-355). p = exp(s * scale - lse) is
// rounded to the operands' type before p^T do, and ds = p * (dp - delta) *
// scale before ds^T q, as the TPU kernel rounds them to do's and q's dtype
// (in fp32 both roundings are the identity).
//
// The TPU kernel's grid runs per query head, so under GQA it writes
// [B, H, Sk, D] fp32 partials and sums them afterwards (:428-456). Here one
// block owns the kv head and sums its group in registers: no partials, no
// atomics, and the result is deterministic.
//
// Bound at the flagship training shape (B4 H8 S2048 D128, causal): FLOPs,
// four causal matmuls (k q^T, v do^T, p^T do, ds^T q) = 6.9e10 FLOP, 0.070 ms
// at the card's 989 TFLOP/s bf16 peak, against ~84 MB of bf16 operands
// (0.025 ms at 3.35 TB/s). These scalar fp32 FMAs from shared memory cannot
// approach the tensor cores' rate; what the design does is hold k, v and the
// accumulators on chip for the whole block, read each visible q/do tile once
// per kv head, and skip masked tiles. Tensor-core tiles are later work.
//
// Shared memory at D = 128: k^T, v^T, q^T, do^T [D][68] and q, do [64][D] in
// fp32, one p/ds^T tile and per-row delta and lse: 222,720 bytes, under the
// 227 KB a block may take, through the dynamic shared-memory attribute.

#include "flash_common.cuh"

namespace {

using flash::from_f;
using flash::round_to;
using flash::to_f;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per block
constexpr int THREADS = 256;
constexpr int LD = 64 + 4;      // leading dim of the transposed tiles; keeps float4 alignment

__host__ __device__ constexpr size_t smem_floats(int d) {
  // k^T, v^T, q^T, do^T [D][LD]; q, do [BQ][D]; p^T / ds^T [BQ][LD]; delta, lse [BQ]
  return (size_t)4 * d * LD + (size_t)2 * BQ * d + (size_t)BQ * LD + 2 * BQ;
}

template <int DC>
__device__ __forceinline__ void accumulate(const float* __restrict__ pt,
                                           const float* __restrict__ rows,
                                           float (&acc)[4][DC * 4], int tx, int ty) {
  // acc[key][col] += sum_q pt[q][key] * rows[q][col]
  constexpr int D = DC * 64;
#pragma unroll 4
  for (int qq = 0; qq < BQ; ++qq) {
    const float4 p4 = *reinterpret_cast<const float4*>(&pt[qq * LD + ty * 4]);
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 r4 = *reinterpret_cast<const float4*>(&rows[qq * D + c * 64 + tx * 4]);
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][c * 4 + e] = fmaf(pv[i], rv[e], acc[i][c * 4 + e]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     void* __restrict__ dk, void* __restrict__ dv,
                     int Sq, int Sk, int H, int KV, int causal, int window,
                     float scale, int out_f32) {
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

  float acc_dk[4][DC * 4], acc_dv[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
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
        // delta of row r from four threads (lanes 4r' .. 4r'+3 of a warp)
        const int r = tid / 4, part = tid % 4;
        const int qp = q0 + r;
        float acc = 0.f;
        if (qp < Sq) {
          for (int d = part; d < D; d += 4)
            acc += to_f(dout[q_base + qp * q_stride + d]) *
                   to_f(o[q_base + qp * q_stride + d]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (part == 0) {
          delta_s[r] = acc;
          lse_s[r] = qp < Sq ? lse[((size_t)b * H + h) * Sq + qp] : INFINITY;
        }
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kc = *reinterpret_cast<const float4*>(&kt[d * LD + ty * 4]);
        const float4 vc = *reinterpret_cast<const float4*>(&vt[d * LD + ty * 4]);
        const float4 a = *reinterpret_cast<const float4*>(&qt[d * LD + tx * 4]);
        const float4 gd = *reinterpret_cast<const float4*>(&dot[d * LD + tx * 4]);
        const float kv[4] = {kc.x, kc.y, kc.z, kc.w};
        const float vv[4] = {vc.x, vc.y, vc.z, vc.w};
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {gd.x, gd.y, gd.z, gd.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], av[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }

      // p^T into shared memory now, ds^T after dv has read p^T
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx * 4 + j;
          const int qp = q0 + r;
          bool keep = kp < Sk && qp < Sq;
          if (causal) keep = keep && kp <= qp && (window <= 0 || kp > qp - window);
          // masked scores and rows with lse = +inf give p = 0 explicitly
          const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ds[i][j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
          pt[r * LD + ty * 4 + i] = round_to<T>(p);
        }
      }
      __syncthreads();
      accumulate<DC>(pt, dos, acc_dv, tx, ty);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pt[(tx * 4 + j) * LD + ty * 4 + i] = ds[i][j];
      __syncthreads();
      accumulate<DC>(pt, qs, acc_dk, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
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

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dk, void* dv, int B, int Sq,
           int Sk, int H, int KV, int causal, int window, float scale,
           int out_f32, int smem, cudaStream_t stream) {
  if (smem != (int)(smem_floats(D) * sizeof(float))) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + BK - 1) / BK, KV, B);
  flash_bwd_dkv_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
      dk, dv, Sq, Sk, H, KV, causal, window, scale, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32 (dk and dv in fp32); block_k: 64,
// the keys a block owns; smem: the plan's shared-memory bytes, checked
// against the kernel's own layout.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
    int D, int causal, int window, float scale, int out_f32, int f32, int block_k,
    int smem, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || block_k != BK ||
      (f32 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, dout, dk, dv, B, Sq, Sk, H, KV, causal, window, scale, out_f32, smem, s
  if (D == 128) return f32 ? launch<128, float>(ARGS) : launch<128, flash::bf16>(ARGS);
  if (D == 64) return f32 ? launch<64, float>(ARGS) : launch<64, flash::bf16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
