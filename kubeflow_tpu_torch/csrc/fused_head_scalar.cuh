// The fused tied head's fp32 route: scalar kernels for the forward, dh and
// dE on fp32 h and emb, any T, V and E. Tiles are staged as fp32 in shared
// memory and multiplied with fp32 FMAs: no TF32, since the plain versions
// (and the JAX kernels on fp32 operands) multiply in full fp32. dlogits are
// not rounded (round_to<float> is the identity), as the JAX kernels'
// astype(emb.dtype) on fp32 operands.
//
// 256 threads as a 16 x 16 grid (ty, tx). A [64, 64] logits tile: thread
// (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3, summed
// over E in chunks of SE columns staged transposed. The backward splits E
// across blocks of SC columns and recomputes the full-E logits for each
// (ceil(E / SC) times): this route is for parity runs, not for speed.

#pragma once

#include "fused_head_common.cuh"

namespace fused_head {
namespace scalar {

constexpr int TILE = 64;        // rows of either operand a tile
constexpr int SE = 32;          // E chunk of the logits
constexpr int SC = 128;         // E columns a backward block accumulates
constexpr int LDT = TILE + 4;   // leading dim of transposed chunks and the dlogits tile
constexpr int LDC = SC + 4;     // leading dim of the staged E slice

// Dynamic shared memory of head_bwd_scalar, in floats: the two transposed
// chunks, the dlogits tile, the staged slice, the row vectors.
// ops/fused_head_loss.py (_plan) computes the same bytes.
constexpr int BWD_FLOATS = 2 * SE * LDT + TILE * LDT + TILE * LDC + 4 * TILE;

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

// Backward: dh (DE false) or dE (DE true). One block per (64 resident rows:
// tokens for dh, vocabulary entries for dE; SC columns of E); the block
// walks every 64-row tile of the other operand, so no atomics. Per tile:
// the logits, the fp32 dlogits (0 past T and V) into dl[resident][streamed],
// the streamed operand's [64, SC] slice staged, and acc += dl @ slice.
template <bool DE>
__global__ void __launch_bounds__(THREADS)
head_bwd_scalar(const float* __restrict__ h, const float* __restrict__ emb,
                const int* __restrict__ tgt, const float* __restrict__ lse,
                const float* __restrict__ dlse, const float* __restrict__ dgold,
                float* __restrict__ out, int T, int V, int E) {
  extern __shared__ float4 smem4[];
  float* aT = reinterpret_cast<float*>(smem4);
  float* bT = aT + SE * LDT;
  float* dl = bT + SE * LDT;
  float* xs = dl + TILE * LDT;
  float* lse_s = xs + TILE * LDC;
  float* dlse_s = lse_s + TILE;
  float* dgold_s = dlse_s + TILE;
  int* tgt_s = reinterpret_cast<int*>(dgold_s + TILE);

  const float* res = DE ? emb : h;      // resident rows
  const float* str = DE ? h : emb;      // streamed rows
  const int R_rows = DE ? V : T, X_rows = DE ? T : V;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * TILE, e0 = blockIdx.y * SC;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int x0 = 0; x0 < X_rows; x0 += TILE) {
    // the tokens' row vectors: dh's resident rows, dE's streamed ones (the
    // previous tile's readers passed logits_tile's first barrier)
    if (threadIdx.x < TILE && (DE || x0 == 0)) {
      const int t = (DE ? x0 : r0) + threadIdx.x;
      const bool ok = t < T;
      lse_s[threadIdx.x] = ok ? lse[t] : 0.f;
      dlse_s[threadIdx.x] = ok ? dlse[t] : 0.f;
      dgold_s[threadIdx.x] = ok ? dgold[t] : 0.f;
      tgt_s[threadIdx.x] = ok ? tgt[t] : -1;
    }
    float lg[4][4];
    logits_tile(lg, aT, bT, res, r0, R_rows, str, x0, X_rows, E);
    for (int x = threadIdx.x; x < TILE * SC; x += THREADS) {
      const int r = x / SC, c = x % SC;
      xs[r * LDC + c] = (x0 + r < X_rows && e0 + c < E) ? str[(size_t)(x0 + r) * E + e0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, c = 4 * tx + j;
        const int tok = DE ? x0 + c : r0 + r, voc = DE ? r0 + r : x0 + c;
        const int sr = DE ? c : r;
        dl[r * LDT + c] = (tok < T && voc < V)
            ? round_to<float>(dlogit(lg[i][j], lse_s[sr], dlse_s[sr], dgold_s[sr], voc, tgt_s[sr]))
            : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int x = 0; x < TILE; ++x) {
      const float4 lo = *reinterpret_cast<const float4*>(xs + x * LDC + 4 * tx);
      const float4 hi = *reinterpret_cast<const float4*>(xs + x * LDC + 64 + 4 * tx);
      const float xv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dl[(4 * ty + i) * LDT + x];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(d, xv[c], acc[i][c]);
      }
    }
    // the next tile's logits_tile starts with a barrier before it restages
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= R_rows) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = e0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (col < E) out[(size_t)row * E + col] = acc[i][c];
    }
  }
}

template <bool DE>
int launch_bwd(const void* h, const void* emb, const void* tgt, const void* lse,
               const void* dlse, const void* dgold, void* out, int T, int V, int E, int smem,
               cudaStream_t stream) {
  if (smem != BWD_FLOATS * (int)sizeof(float)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(head_bwd_scalar<DE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((DE ? V : T) + TILE - 1) / TILE, (E + SC - 1) / SC);
  head_bwd_scalar<DE><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(emb), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dlse),
      static_cast<const float*>(dgold), static_cast<float*>(out), T, V, E);
  return (int)cudaGetLastError();
}

}  // namespace scalar
}  // namespace fused_head
