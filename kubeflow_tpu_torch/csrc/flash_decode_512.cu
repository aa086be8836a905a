// Flash-decode for Hopper (sm_90a) at head width 512: the launcher over
// flash_decode.cuh's kernel (its header sets out the design). A source of
// its own, so that nvcc builds it in parallel with flash_decode.cu: its 16
// instantiations took longer than the other widths' 48 together.
//
// Replaces the Pallas kernel _decode_kernel (kubeflow_tpu/ops/flash_decode.py:53)
// at head sizes 257-512.

#include "flash_decode.cuh"

// The arguments of flash_decode_launch (flash_decode.cu) at D 512 only.
extern "C" int flash_decode_512_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* o, void* ws_o, void* ws_ml,
                                       void* tickets, int B, int G, int R, int L, int D,
                                       int dk, int window, float scale, int f32, int S,
                                       int chunk, int cluster, int smem, void* stream) {
  if (D != 512) return (int)cudaErrorInvalidValue;
  return launch_width<512>(q, k, v, pos, o, ws_o, ws_ml, tickets, B, G, R, L, dk, window, scale,
                           f32, S, chunk, cluster, smem, stream);
}
