// Flash-decode for Hopper (sm_90a) at head widths 64, 128 and 256: the
// launcher over flash_decode.cuh's kernel (its header sets out the design).
// Width 512 builds from flash_decode_512.cu, in parallel with this source.
//
// Replaces the Pallas kernel _decode_kernel (kubeflow_tpu/ops/flash_decode.py:53).

#include "flash_decode.cuh"

// D: the width the kernel runs at (64, 128 or 256; 512 is
// flash_decode_512_launch), dk: the cache's head size (1 .. D); q and o are
// [B, G, R, D], the caches [B, G, L, dk].
// f32: 0 for bf16 operands, 1 for fp32; any R >= 1 (a grid axis over chunks
// of MAX_R query heads). S blocks a (row, group, chunk of heads), each taking
// at most `chunk` keys (a multiple of 16, S * chunk >= L); cluster: 1 to
// combine through a cluster of the S blocks (S <= 16), 0 through the
// workspaces. ws_o [B, G, R, S, D] and ws_ml [B, G, R, S] (float2) fp32
// workspaces; tickets [B, G, chunks] then [B, G, chunks, ceil(S / 16)] int32
// (a row's, then its groups' of 16 runs), zero before the first launch and
// left zero by every launch; smem must equal the block's bytes. The wrapper's
// plan (ops/flash_decode.py _plan) picks S, chunk and cluster.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* pos, void* o, void* ws_o, void* ws_ml,
                                   void* tickets, int B, int G, int R, int L, int D,
                                   int dk, int window, float scale, int f32, int S, int chunk,
                                   int cluster, int smem, void* stream) {
#define ARGS q, k, v, pos, o, ws_o, ws_ml, tickets, B, G, R, L, dk, window, scale, f32, S, \
             chunk, cluster, smem, stream
  if (D == 256) return launch_width<256>(ARGS);
  if (D == 128) return launch_width<128>(ARGS);
  if (D == 64) return launch_width<64>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
