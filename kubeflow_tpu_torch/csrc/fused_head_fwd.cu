// Fused tied-head forward for Hopper (sm_90a): per-token logsumexp and gold
// logit of logits = h @ emb^T, without materialising the [T, V] logits.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/fused_head_loss.py:76).
// Layout: h [T, E] bf16, emb [V, E] bf16, tgt [T] int32, lse and gold [T]
// fp32, all contiguous. gold is the logit at column tgt, 0 for a target
// outside [0, V).
//
// One block per 64-token tile, 256 threads. The loop over 64-row vocabulary
// tiles takes the place of the TPU kernel's sequential vocabulary grid axis:
// each tile's [64, 64] fp32 logits come from bf16 tensor-core products
// (mma.sync m16n8k16, fp32 accumulate) over E in chunks of 64
// (fused_head_common.cuh), land in shared memory, and fold into each row's
// running (max m, sum s, gold), kept in registers by the four threads that
// share the row: m starts at -inf, s rescales by exp(m_old - m_new).
// lse = m + log(s). fp32 h and emb take the scalar kernel head_fwd_scalar
// (fused_head_scalar.cuh): the same fold over logits tiles of fp32 FMAs.
//
// Bound: operations (2 T V E FLOP; at T 8192, V 32000, E 1024 that is 537
// GFLOP against 82 MB of operands). Each tile re-reads its h rows from L2.

#include "fused_head_scalar.cuh"

using namespace fused_head;

namespace {

__global__ void __launch_bounds__(THREADS)
fused_head_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                      const int* __restrict__ tgt, float* __restrict__ lse,
                      float* __restrict__ gold, int T, int V, int E) {
  __shared__ __align__(16) bf16 hs[BT * LDK];
  __shared__ __align__(16) bf16 es[BV * LDK];
  __shared__ __align__(16) float ls[BT * LDL];

  const int t0 = blockIdx.x * BT;
  // four threads a row: thread q of row r reads columns q, q + 4, ...
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  const int t = t0 + r;
  const int target = t < T ? tgt[t] : -1;
  float m = -INFINITY, s = 0.f, gsum = 0.f;

  for (int v0 = 0; v0 < V; v0 += BV) {
    logits_tile(ls, hs, es, h, emb, t0, T, v0, V, E);
    __syncthreads();
    fold_tile(ls, r, q, v0, V, target, m, s, gsum);
  }
  if (q == 0 && t < T) {
    lse[t] = m + logf(s);
    gold[t] = gsum;
  }
}

}  // namespace

// f32: 0 for bf16 h and emb (the tensor-core kernel), 1 for fp32 (scalar).
extern "C" int fused_head_fwd_launch(const void* h, const void* emb, const void* tgt,
                                     void* lse, void* gold, int T, int V, int E, int f32,
                                     void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + BT - 1) / BT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    scalar::head_fwd_scalar<<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(emb),
        static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
        T, V, E);
  else
    fused_head_fwd_kernel<<<blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
        static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
        T, V, E);
  return (int)cudaGetLastError();
}
