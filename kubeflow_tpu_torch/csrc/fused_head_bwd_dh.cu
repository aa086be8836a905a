// Fused tied-head backward, dh, for Hopper (sm_90a):
//   dh[t, :] = sum_v bf16(dlse[t] * exp(logit[t, v] - lse[t]) + dgold[t] * [v == tgt[t]]) * emb[v, :]
// in fp32, the logits recomputed tile by tile and never stored.
//
// Replaces the Pallas kernel _dh_kernel (kubeflow_tpu/ops/fused_head_loss.py:157).
// Layout: h [T, E] and emb [V, E] bf16; tgt [T] int32; lse, dlse, dgold [T]
// fp32; dh [T, E] fp32; all contiguous.
//
// One block per (64-token tile, 256-column slice of E), 256 threads. The
// block's [64, 256] fp32 accumulator lives in registers (64 a thread, in
// mma fragments); a [64, E] accumulator would need 256 KB at E 1024, more
// than a block's shared memory or registers, so E is split across blocks and
// each slice recomputes the full-E logits (ceil(E / 256) times in all). For
// each 64-row vocabulary tile: the logits tile (fused_head_common.cuh), then
// the bf16 dlogits tile in shared memory (zero past V and T), then the emb
// slice [64, 256] staged and dh += dlogits @ emb_slice on the tensor cores.
//
// Bound: operations (4 T V E FLOP: the logits once and the product once;
// 1,074 GFLOP at T 8192, V 32000, E 1024). This design does
// (2 ceil(E / 256) + 2) T V E: 2.5x that at E 1024.

#include "fused_head_common.cuh"

using namespace fused_head;

namespace {

constexpr size_t SMEM_BYTES =
    sizeof(float) * (BT * LDL + 3 * BT) + sizeof(int) * BT +
    sizeof(bf16) * (2 * 64 * LDK + BT * LDD + BV * LDE);

__global__ void __launch_bounds__(THREADS)
fused_head_bwd_dh_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                         const int* __restrict__ tgt, const float* __restrict__ lse,
                         const float* __restrict__ dlse, const float* __restrict__ dgold,
                         float* __restrict__ dh, int T, int V, int E) {
  extern __shared__ uint4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);
  float* lse_s = ls + BT * LDL;
  float* dlse_s = lse_s + BT;
  float* dgold_s = dlse_s + BT;
  int* tgt_s = reinterpret_cast<int*>(dgold_s + BT);
  bf16* hs = reinterpret_cast<bf16*>(tgt_s + BT);
  bf16* es = hs + 64 * LDK;
  bf16* dls = es + 64 * LDK;      // dlogits [t][v]
  bf16* bs = dls + BT * LDD;      // emb slice [v][e]

  const int t0 = blockIdx.x * BT, e0 = blockIdx.y * EC;
  if (threadIdx.x < BT) {
    const int t = t0 + threadIdx.x;
    const bool ok = t < T;
    lse_s[threadIdx.x] = ok ? lse[t] : 0.f;
    dlse_s[threadIdx.x] = ok ? dlse[t] : 0.f;
    dgold_s[threadIdx.x] = ok ? dgold[t] : 0.f;
    tgt_s[threadIdx.x] = ok ? tgt[t] : -1;
  }

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int v0 = 0; v0 < V; v0 += BV) {
    logits_tile(ls, hs, es, h, emb, t0, T, v0, V, E);
    Tile<EC> slice;
    slice.load(emb, v0, V, e0, E);       // in flight during the dlogits
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BV; i += THREADS) {
      const int r = i / BV, c = i % BV, col = v0 + c;
      dls[r * LDD + c] = (col < V && t0 + r < T)
          ? dlogit(ls[r * LDL + c], lse_s[r], dlse_s[r], dgold_s[r], col, tgt_s[r])
          : __float2bfloat16(0.f);
    }
    slice.store(bs, LDE);
    __syncthreads();
    product_tile(acc, dls, bs);
  }
  store_acc(dh, acc, t0, T, e0, E);
}

}  // namespace

extern "C" int fused_head_bwd_dh_launch(const void* h, const void* emb, const void* tgt,
                                        const void* lse, const void* dlse, const void* dgold,
                                        void* dh, int T, int V, int E, void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BT - 1) / BT, (E + EC - 1) / EC);
  fused_head_bwd_dh_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dlse),
      static_cast<const float*>(dgold), static_cast<float*>(dh), T, V, E);
  return (int)cudaGetLastError();
}
