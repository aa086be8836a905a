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
// lse = m + log(s).
//
// Bound: operations (2 T V E FLOP; at T 8192, V 32000, E 1024 that is 537
// GFLOP against 82 MB of operands). Each tile re-reads its h rows from L2.

#include "fused_head_common.cuh"

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
    const float* row = ls + r * LDL;
    float mx = -INFINITY, gl = 0.f;
#pragma unroll
    for (int i = 0; i < BV / 4; ++i) {
      const int c = i * 4 + q, col = v0 + c;
      if (col < V) {
        mx = fmaxf(mx, row[c]);
        if (col == target) gl += row[c];
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // column v0 < V is in every tile, so m_new is finite
    const float m_new = fmaxf(m, mx);
    float se = 0.f;
#pragma unroll
    for (int i = 0; i < BV / 4; ++i) {
      const int c = i * 4 + q;
      if (v0 + c < V) se += expf(row[c] - m_new);
    }
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    se += __shfl_xor_sync(0xffffffffu, se, 2);
    gl += __shfl_xor_sync(0xffffffffu, gl, 1);
    gl += __shfl_xor_sync(0xffffffffu, gl, 2);
    s = s * expf(m - m_new) + se;
    m = m_new;
    gsum += gl;
  }
  if (q == 0 && t < T) {
    lse[t] = m + logf(s);
    gold[t] = gsum;
  }
}

}  // namespace

extern "C" int fused_head_fwd_launch(const void* h, const void* emb, const void* tgt,
                                     void* lse, void* gold, int T, int V, int E,
                                     void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + BT - 1) / BT);
  fused_head_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
      static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
      T, V, E);
  return (int)cudaGetLastError();
}
