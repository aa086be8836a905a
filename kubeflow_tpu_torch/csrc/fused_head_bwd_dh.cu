// Fused tied-head backward, dh, for Hopper (sm_90a):
//   dh[t, :] = sum_v rnd(dlse[t] * exp(logit[t, v] - lse[t]) + dgold[t] * [v == tgt[t]]) * emb[v, :]
// in fp32, rnd the rounding to the operands' dtype (bf16; the identity on fp32),
// the logits recomputed tile by tile and never stored.
//
// Replaces the Pallas kernel _dh_kernel (kubeflow_tpu/ops/fused_head_loss.py:157).
// Layout: h [T, E] and emb [V, E], both bf16 or both fp32; tgt [T] int32;
// lse, dlse, dgold [T] fp32; dh [T, E] fp32; all contiguous.
//
// bf16 (E a multiple of 8; the wrapper zero-pads other E): head_bwd_wgmma
// (fused_head_common.cuh) with the h rows of 128 tokens resident (64 above
// E 2048) and 64-row emb tiles streamed through a 3-stage TMA ring (2 where
// 3 do not fit), in the vocabulary order every cluster shares, so the table
// streams from HBM about once a wave. Each block of a cluster of C = min(8,
// ceil(E / 256)) owns a slice of E: the partial logits h_c emb_c^T (wgmma
// m64n64k16, both operands K-major), the cluster's sum through distributed
// shared memory, the bf16 dlogits, then dh_c += dP emb_c with the same emb
// stage read MN-major (m64n256k16 at 256 columns). No atomics: every dh
// element is a fixed-order sum, the same on every run.
//
// Bound: operations (4 T V E FLOP: the logits once and the product once;
// 1,074 GFLOP at T 8192, V 32000, E 1024). This design does 4 T V E up to
// E 2048 and (2 P + 2) T V E with P = ceil(E / 2048) passes above.
//
// fp32 (E a multiple of 4; the wrapper zero-pads other E): head_bwd_fma<false>
// (fused_head_fma.cuh), the same skeleton with register-tiled fp32 FMAs (no
// TF32) fed by TMA: the h rows of 128 tokens resident, 128 columns a block,
// a cluster of C = ceil(E / 128) <= 8 blocks, so the logits are computed
// once up to E 1024 (4 T V E FLOP against the fp32 FMA peak of 67 TF/s,
// 16.0 ms at the shape above), passes that recompute them above.

#include "fused_head_fma.cuh"

using namespace fused_head;

// f32: 0 for bf16 h and emb (tensor-core route), 1 for fp32 (FMA route).
// Both take the plan's cluster size, passes and resident rows, the
// tensor-core route also its 64-column slabs a sub-slice; smem is the plan's
// shared-memory bytes, checked against the kernel's own layout; ws and flags
// the scratch of cap clusters (see launch_bwd_wgmma).
extern "C" int fused_head_bwd_dh_launch(const void* h, const void* emb, const void* tgt,
                                        const void* lse, const void* dlse, const void* dgold,
                                        void* dh, int T, int V, int E, int f32, int cluster,
                                        int slabs, int passes, int rows, int smem, int cap,
                                        void* ws, void* flags, void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return fp32::launch_bwd<false>(h, emb, tgt, lse, dlse, dgold, dh, T, V, E, cluster, passes,
                                   rows, smem, cap, ws, flags, s);
  return launch_bwd_route<false>(h, emb, tgt, lse, dlse, dgold, dh, T, V, E, cluster, slabs,
                                 passes, rows, smem, cap, ws, flags, s);
}
