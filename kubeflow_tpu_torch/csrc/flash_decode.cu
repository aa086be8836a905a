// Flash-decode for Hopper (sm_90a): one query token per row against the
// grouped KV cache. bf16 in and out, fp32 softmax.
//
// Replaces the Pallas kernel _decode_kernel (kubeflow_tpu/ops/flash_decode.py:53).
// Layout: q [B, G, R, D], k/v cache [B, G, L, D], pos [B] int32, o [B, G, R, D],
// all contiguous. R = H / G query heads share the group's cache.
//
// One thread block per (kv group, batch row), D threads. The block computes
// its live key range [lo, hi] from pos[b] and the window and walks only those
// keys, D at a time: thread t scores key k0 + t against the R queries (each
// thread reads its own key row as 16-byte vectors), one warp per head folds
// the tile into the streaming softmax (m, l in shared memory), and thread t
// then accumulates output column t over the tile's keys. Dead cache slots are
// never read: the counterpart of the TPU kernel's scalar-prefetch clamp.
//
// Bound: HBM bytes (the live K/V), and at serving sizes launch latency: B * G
// blocks occupy only that many of the card's 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(D)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                    int G, int R, int L, int window, float scale) {
  constexpr int TK = D;          // keys per tile: one per thread
  constexpr int NW = D / 32;     // warps
  __shared__ float qs[MAX_R][D];
  __shared__ float ps[MAX_R][TK];  // scores, then bf16-rounded probabilities
  __shared__ float m_s[MAX_R], l_s[MAX_R], corr_s[MAX_R];

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = blockIdx.x, b = blockIdx.y;
  const size_t bg = (size_t)b * G + g;
  const __nv_bfloat16* kb = kc + bg * (size_t)L * D;
  const __nv_bfloat16* vb = vc + bg * (size_t)L * D;

#pragma unroll
  for (int r = 0; r < MAX_R; ++r)
    if (r < R) qs[r][t] = __bfloat162float(q[(bg * R + r) * D + t]);
  if (t < R) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  const int p = pos[b];
  const int hi = min(p, L - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  float acc[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int k0 = lo; k0 <= hi; k0 += TK) {
    const int n = min(TK, hi - k0 + 1);  // live keys in this tile, >= 1
    float s[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) s[r] = 0.f;
    if (t < n) {
      const uint4* krow = reinterpret_cast<const uint4*>(kb + (size_t)(k0 + t) * D);
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const uint4 raw = krow[c];
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          if (r < R) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r] = fmaf(qs[r][c * 8 + e], kf[e], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (r < R) ps[r][t] = t < n ? s[r] * scale : -INFINITY;
    __syncthreads();

    for (int r = warp; r < R; r += NW) {
      float mx = -INFINITY;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, ps[r][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a live key
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float pj = j < n ? expf(ps[r][j] - m_new) : 0.f;
        sum += pj;
        ps[r][j] = bf16_round(pj);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (r < R) acc[r] *= corr_s[r];
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float vv = __bfloat162float(vb[(size_t)(k0 + j) * D + t]);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < R) acc[r] = fmaf(ps[r][j], vv, acc[r]);
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      // no live key (pos < 0) gives 0, the TPU kernel's l_safe
      const float l = l_s[r];
      o[(bg * R + r) * D + t] = __float2bfloat16(acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* pos, void* o, int B, int G,
                                   int R, int L, int D, int window, float scale,
                                   void* stream) {
  if (B < 1 || G < 1 || R < 1 || R > MAX_R || L < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (D == 128)
    flash_decode_kernel<128><<<grid, 128, 0, s>>>(qp, kp, vp, pp, op, G, R, L, window, scale);
  else if (D == 64)
    flash_decode_kernel<64><<<grid, 64, 0, s>>>(qp, kp, vp, pp, op, G, R, L, window, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
