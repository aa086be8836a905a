// Fused tied-head backward, dE, for Hopper (sm_90a):
//   dE[v, :] = sum_t rnd(dlse[t] * exp(logit[t, v] - lse[t]) + dgold[t] * [v == tgt[t]]) * h[t, :]
// in fp32, rnd the rounding to the operands' dtype (bf16; the identity on fp32),
// the logits recomputed tile by tile and never stored.
//
// Replaces the Pallas kernel _de_kernel (kubeflow_tpu/ops/fused_head_loss.py:183).
// Layout: h [T, E] and emb [V, E], both bf16 or both fp32; tgt [T] int32;
// lse, dlse, dgold [T] fp32; dE [V, E] fp32; all contiguous.
//
// bf16 (E a multiple of 8; the wrapper zero-pads other E): head_bwd_wgmma
// (fused_head_common.cuh), dh's mirror: the emb rows of 128 vocabulary
// entries resident (64 above E 2048), 64-row h tiles streamed through a
// 3-stage TMA ring (2 where 3 do not fit) with their tokens' lse, dlse,
// dgold and tgt. The cluster splits E as for dh; per tile the partial logits
// S_c^T = emb_c h_c^T, the cluster's sum through distributed shared memory,
// the bf16 dlogits (the tokens are the columns, so the row vectors belong to
// the columns), then dE_c += dP^T h_c with the same h stage read MN-major.
// No atomics: every dE element is a fixed-order sum, the same on every run.
//
// Bound: operations (4 T V E FLOP, 1,074 GFLOP at T 8192, V 32000, E 1024);
// this design does 4 T V E up to E 2048 and (2 P + 2) T V E with P =
// ceil(E / 2048) passes above.
//
// fp32 (E a multiple of 4; the wrapper zero-pads other E): head_bwd_fma<true>
// (fused_head_fma.cuh), dh's mirror on register-tiled fp32 FMAs (no TF32) fed
// by TMA: the emb rows of 128 vocabulary entries resident, h tiles streamed,
// E split across a cluster of C = ceil(E / 128) <= 8 blocks, so the logits
// are computed once up to E 1024 (4 T V E FLOP against the fp32 FMA peak of
// 67 TF/s), passes that recompute them above.

#include "fused_head_fma.cuh"

using namespace fused_head;

// Arguments as fused_head_bwd_dh_launch's, with dE [V, E] for dh.
extern "C" int fused_head_bwd_de_launch(const void* h, const void* emb, const void* tgt,
                                        const void* lse, const void* dlse, const void* dgold,
                                        void* de, int T, int V, int E, int f32, int cluster,
                                        int slabs, int passes, int rows, int smem, int cap,
                                        void* ws, void* flags, void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return fp32::launch_bwd<true>(h, emb, tgt, lse, dlse, dgold, de, T, V, E, cluster, passes,
                                  rows, smem, cap, ws, flags, s);
  return launch_bwd_route<true>(h, emb, tgt, lse, dlse, dgold, de, T, V, E, cluster, slabs,
                                passes, rows, smem, cap, ws, flags, s);
}
