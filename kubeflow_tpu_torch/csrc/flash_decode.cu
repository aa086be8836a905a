// Flash-decode for Hopper (sm_90a): one query token per row against the
// grouped KV cache. bf16 or fp32 in and out (one type), fp32 softmax.
//
// Replaces the Pallas kernel _decode_kernel (kubeflow_tpu/ops/flash_decode.py:53).
// Layout: q [B, G, R, D], k/v cache [B, G, L, D], pos [B] int32, o [B, G, R, D],
// all contiguous. R = H / G query heads share the group's cache.
//
// One thread block per (kv group, batch row, chunk of up to 8 query heads),
// D threads: any R in one launch, the cache read once a chunk (once a group
// for R <= 8). The block computes its live key range [lo, hi] from pos[b]
// and the window and walks only those keys, D at a time: thread t scores key
// k0 + t against the chunk's queries (each thread reads its own key row as
// 16-byte vectors), one warp per head folds the tile into the streaming
// softmax (m, l in shared memory), and thread t then accumulates output
// column t over the tile's keys. Dead cache slots are never read: the
// counterpart of the TPU kernel's scalar-prefetch clamp. Probabilities are
// rounded to the operands' type before the value product, as the TPU kernel's
// p.astype(v.dtype) (:88; the identity in fp32).
//
// Bound: HBM bytes (the live K/V), and at serving sizes launch latency: B * G
// blocks occupy only that many of the card's 132 SMs.

#include "flash_common.cuh"

namespace {

using flash::from_f;
using flash::round_to;
using flash::to_f;

constexpr int MAX_R = 8;       // query heads a block holds

// 8 consecutive values of a row as fp32, in 16-byte loads
__device__ __forceinline__ void load8(const flash::bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

template <int D, typename T>
__global__ void __launch_bounds__(D)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos,
                    T* __restrict__ o, int G, int R, int L, int window, float scale) {
  constexpr int TK = D;          // keys per tile: one per thread
  constexpr int NW = D / 32;     // warps
  __shared__ float qs[MAX_R][D];
  __shared__ float ps[MAX_R][TK];  // scores, then probabilities rounded to T
  __shared__ float m_s[MAX_R], l_s[MAX_R], corr_s[MAX_R];

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = blockIdx.x, b = blockIdx.y;
  const int r0 = blockIdx.z * MAX_R;       // this block's heads r0 .. r0 + nr - 1
  const int nr = min(MAX_R, R - r0);
  const size_t bg = (size_t)b * G + g;
  const T* kb = kc + bg * (size_t)L * D;
  const T* vb = vc + bg * (size_t)L * D;

#pragma unroll
  for (int r = 0; r < MAX_R; ++r)
    if (r < nr) qs[r][t] = to_f(q[(bg * R + r0 + r) * D + t]);
  if (t < nr) {
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
      const T* krow = kb + (size_t)(k0 + t) * D;
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        float kf[8];
        load8(krow + 8 * c, kf);
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          if (r < nr) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r] = fmaf(qs[r][c * 8 + e], kf[e], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (r < nr) ps[r][t] = t < n ? s[r] * scale : -INFINITY;
    __syncthreads();

    for (int r = warp; r < nr; r += NW) {
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
        ps[r][j] = round_to<T>(pj);
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
      if (r < nr) acc[r] *= corr_s[r];
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float vv = to_f(vb[(size_t)(k0 + j) * D + t]);
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < nr) acc[r] = fmaf(ps[r][j], vv, acc[r]);
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < nr) {
      // no live key (pos < 0) gives 0, the TPU kernel's l_safe
      const float l = l_s[r];
      o[(bg * R + r0 + r) * D + t] = from_f<T>(acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int D, typename T>
void launch(const void* q, const void* k, const void* v, const void* pos, void* o, dim3 grid,
            int G, int R, int L, int window, float scale, cudaStream_t s) {
  flash_decode_kernel<D, T><<<grid, D, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<T*>(o), G, R, L, window, scale);
}

}  // namespace

// f32: 0 for bf16 operands, 1 for fp32; any R >= 1 (a grid axis over chunks
// of MAX_R query heads).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* pos, void* o, int B, int G,
                                   int R, int L, int D, int window, float scale,
                                   int f32, void* stream) {
  if (B < 1 || G < 1 || R < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(G, B, (R + MAX_R - 1) / MAX_R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, pos, o, grid, G, R, L, window, scale, s
  if (D == 128)
    f32 ? launch<128, float>(ARGS) : launch<128, flash::bf16>(ARGS);
  else if (D == 64)
    f32 ? launch<64, float>(ARGS) : launch<64, flash::bf16>(ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef ARGS
  return (int)cudaGetLastError();
}
