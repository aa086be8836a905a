// Flash-attention forward for Hopper (sm_90a): bf16 in and out, fp32 softmax.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/pallas_attention.py:160).
// Layout: q [B, Sq, H, D], k/v [B, Sk, KV, D], o [B, Sq, H, D], all contiguous;
// optional lse [B, H, Sq] fp32. Query head h reads kv head h / (H / KV).
//
// One thread block per (64-row query tile, head, batch row), 256 threads as a
// 16 x 16 grid. Thread (ty, tx) owns query rows ty*4 .. ty*4+3: in each key
// tile it computes the 4 x 4 scores of those rows against keys tx*4 .. tx*4+3,
// and it accumulates the context of those rows in output columns
// c*64 + tx*4 .. +3 (c < D/64). The 16 threads of a row sit in one half-warp,
// so row max and row sum are shuffles. The loop over 64-key tiles (staged in
// shared memory as fp32) takes the place of the TPU kernel's sequential ik
// grid axis; m, l and the accumulator stay in registers across it.
//
// Bound: HBM bytes at the serving path's prefill shapes; FLOPs at long
// prompts, where these scalar FMAs run far below the tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int LD = 64 + 4;      // leading dim of the transposed tiles; keeps float4 alignment

__host__ __device__ constexpr size_t smem_floats(int d) {
  // q^T [D][LD], k^T [D][LD], v [BK][D], p^T [BK][LD]
  return (size_t)2 * d * LD + (size_t)BK * d + (size_t)BK * LD;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float scale) {
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
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    qt[d * LD + r] = qp < Sq ? __bfloat162float(qb[qp * q_stride + d]) : 0.f;
  }

  // keys any row of this tile can see: causal skips tiles above the
  // diagonal, the window skips tiles left of the first row's window
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  float acc[4][DC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
        kk = __bfloat162float(kb[kp * kv_stride + d]);
        vv = __bfloat162float(vb[kp * kv_stride + d]);
      }
      kt[d * LD + c] = kk;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
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
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        pt[(tx * 4 + j) * LD + ty * 4 + i] = bf16_round(p);
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
      const float4 p4 = *reinterpret_cast<const float4*>(&pt[kk * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[kk * D + c * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(pv[i], vv[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    // a row that saw no key gives 0 (and lse +inf), the TPU kernel's l_safe
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* orow = o + ((size_t)b * Sq * H + h) * D + qp * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c * 64 + tx * 4 + e] = __float2bfloat16(acc[i][c * 4 + e] / l_safe);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + qp] =
          l[i] == 0.f ? INFINITY : m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KV, int D, int causal, int window, float scale,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
