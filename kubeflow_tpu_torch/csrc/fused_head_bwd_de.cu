// Fused tied-head backward, dE, for Hopper (sm_90a):
//   dE[v, :] = sum_t bf16(dlse[t] * exp(logit[t, v] - lse[t]) + dgold[t] * [v == tgt[t]]) * h[t, :]
// in fp32, the logits recomputed tile by tile and never stored.
//
// Replaces the Pallas kernel _de_kernel (kubeflow_tpu/ops/fused_head_loss.py:183).
// Layout: h [T, E] and emb [V, E] bf16; tgt [T] int32; lse, dlse, dgold [T]
// fp32; dE [V, E] fp32; all contiguous.
//
// One block per (64-row vocabulary tile, 256-column slice of E), 256
// threads; the block walks every 64-token tile itself, so dE needs no
// atomics and no second pass and comes out the same on every run. The
// [64, 256] fp32 accumulator lives in registers (64 a thread). For each token
// tile: the [64 tokens, 64 vocab] logits tile (fused_head_common.cuh), the
// bf16 dlogits stored transposed ([v][t], zero past V and T), the h slice
// [64, 256] staged, and dE += dlogits^T @ h_slice on the tensor cores. Each
// E slice recomputes the full-E logits: ceil(E / 256) times in all.
//
// Bound: operations (4 T V E FLOP, 1,074 GFLOP at T 8192, V 32000, E 1024);
// this design does (2 ceil(E / 256) + 2) T V E, 2.5x that at E 1024.

#include "fused_head_common.cuh"

using namespace fused_head;

namespace {

constexpr size_t SMEM_BYTES =
    sizeof(float) * (BT * LDL + 3 * BT) + sizeof(int) * BT +
    sizeof(bf16) * (2 * 64 * LDK + BV * LDD + BT * LDE);

__global__ void __launch_bounds__(THREADS)
fused_head_bwd_de_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                         const int* __restrict__ tgt, const float* __restrict__ lse,
                         const float* __restrict__ dlse, const float* __restrict__ dgold,
                         float* __restrict__ de, int T, int V, int E) {
  extern __shared__ uint4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);
  float* lse_s = ls + BT * LDL;
  float* dlse_s = lse_s + BT;
  float* dgold_s = dlse_s + BT;
  int* tgt_s = reinterpret_cast<int*>(dgold_s + BT);
  bf16* hs = reinterpret_cast<bf16*>(tgt_s + BT);
  bf16* es = hs + 64 * LDK;
  bf16* dlt = es + 64 * LDK;      // dlogits transposed [v][t]
  bf16* bs = dlt + BV * LDD;      // h slice [t][e]

  const int v0 = blockIdx.x * BV, e0 = blockIdx.y * EC;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int t0 = 0; t0 < T; t0 += BT) {
    // the previous tile's readers of these passed the barriers of its
    // product phase; logits_tile's first barrier orders them for this one
    if (threadIdx.x < BT) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < T;
      lse_s[threadIdx.x] = ok ? lse[t] : 0.f;
      dlse_s[threadIdx.x] = ok ? dlse[t] : 0.f;
      dgold_s[threadIdx.x] = ok ? dgold[t] : 0.f;
      tgt_s[threadIdx.x] = ok ? tgt[t] : -1;
    }
    logits_tile(ls, hs, es, h, emb, t0, T, v0, V, E);
    Tile<EC> slice;
    slice.load(h, t0, T, e0, E);         // in flight during the dlogits
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BV; i += THREADS) {
      const int c = i / BT, r = i % BT, col = v0 + c;
      dlt[c * LDD + r] = (col < V && t0 + r < T)
          ? dlogit(ls[r * LDL + c], lse_s[r], dlse_s[r], dgold_s[r], col, tgt_s[r])
          : __float2bfloat16(0.f);
    }
    slice.store(bs, LDE);
    __syncthreads();
    product_tile(acc, dlt, bs);
  }
  store_acc(de, acc, v0, V, e0, E);
}

}  // namespace

extern "C" int fused_head_bwd_de_launch(const void* h, const void* emb, const void* tgt,
                                        const void* lse, const void* dlse, const void* dgold,
                                        void* de, int T, int V, int E, void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_bwd_de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + BV - 1) / BV, (E + EC - 1) / EC);
  fused_head_bwd_de_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dlse),
      static_cast<const float*>(dgold), static_cast<float*>(de), T, V, E);
  return (int)cudaGetLastError();
}
