// The fused tied head's fp32 forward: a scalar kernel on fp32 h and emb, any
// T, V and E. Tiles are staged as fp32 in shared memory and multiplied with
// fp32 FMAs: no TF32, since the plain version (and the JAX kernel on fp32
// operands) multiplies in full fp32.
//
// What bounds it: operations (2 T V E FLOP at the fp32 FMA peak, 67 TF/s:
// 8.0 ms at T 8192, V 32000, E 1024). This design is the first port's: 256
// threads as a 16 x 16 grid (ty, tx), thread (ty, tx) owning rows 4 ty ..
// 4 ty + 3 and columns 4 tx .. 4 tx + 3 of a [64, 64] logits tile, summed
// over E in chunks of SE columns staged transposed, then the bf16 route's
// fold, well below that peak. The backward's fp32 route
// is head_bwd_fma (fused_head_fma.cuh).

#pragma once

#include "fused_head_common.cuh"

namespace fused_head {
namespace scalar {

constexpr int TILE = 64;        // rows of either operand a tile
constexpr int SE = 32;          // E chunk of the logits
constexpr int LDT = TILE + 4;   // leading dim of the transposed chunks

// s[i][j] = sum_e a[a0 + 4 ty + i, e] * b[b0 + 4 tx + j, e], zero past the
// rows A and B of either operand. Starts with a barrier; ends without one.
__device__ __forceinline__ void logits_tile(float (&s)[4][4], float* aT, float* bT,
                                            const float* __restrict__ a, int a0, int A,
                                            const float* __restrict__ b, int b0, int B, int E) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int e0 = 0; e0 < E; e0 += SE) {
    __syncthreads();
    for (int x = threadIdx.x; x < TILE * SE; x += THREADS) {
      const int r = x / SE, e = x % SE;
      const bool in_e = e0 + e < E;
      aT[e * LDT + r] = (in_e && a0 + r < A) ? a[(size_t)(a0 + r) * E + e0 + e] : 0.f;
      bT[e * LDT + r] = (in_e && b0 + r < B) ? b[(size_t)(b0 + r) * E + e0 + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < SE; ++e) {
      const float4 av = *reinterpret_cast<const float4*>(aT + e * LDT + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(bT + e * LDT + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    }
  }
}

// Forward: one block per 64 tokens, the logits tile into ls, then the
// bf16 route's fold (fused_head_common.cuh).
__global__ void __launch_bounds__(THREADS)
head_fwd_scalar(const float* __restrict__ h, const float* __restrict__ emb,
                const int* __restrict__ tgt, float* __restrict__ lse,
                float* __restrict__ gold, int T, int V, int E) {
  __shared__ __align__(16) float aT[SE * LDT];
  __shared__ __align__(16) float bT[SE * LDT];
  __shared__ __align__(16) float ls[TILE * LDL];
  const int t0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  const int t = t0 + r;
  const int target = t < T ? tgt[t] : -1;
  float m = -INFINITY, s = 0.f, gsum = 0.f;
  for (int v0 = 0; v0 < V; v0 += TILE) {
    float lg[4][4];
    logits_tile(lg, aT, bT, h, t0, T, emb, v0, V, E);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ls + (4 * ty + i) * LDL + 4 * tx) =
          make_float4(lg[i][0], lg[i][1], lg[i][2], lg[i][3]);
    __syncthreads();
    fold_tile(ls, r, q, v0, V, target, m, s, gsum);
  }
  if (q == 0 && t < T) {
    lse[t] = m + logf(s);
    gold[t] = gsum;
  }
}

}  // namespace scalar
}  // namespace fused_head
