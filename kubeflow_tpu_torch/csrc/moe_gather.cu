// Row gather for Hopper (sm_90a): out[b, j] = x[b, idx[b, j]], and a zero row
// where idx[b, j] lies outside [0, R). Any element type: rows are moved as
// bytes.
//
// Replaces the Pallas kernel _gather_kernel (kubeflow_tpu/ops/moe_dispatch.py:57),
// the MoE dispatch (tokens -> expert slots) and combine (slots -> tokens).
// Layout: x [B, R, M], idx [B, J] int32, out [B, J, M], all contiguous.
//
// Bound: HBM bytes. Nothing is computed; the least time is the rows read
// once plus the output written once.
//
// One warp per output row (b, j): the warp reads the index once (one
// broadcast load), then its 32 lanes copy the row in the widest vectors the
// row's byte size allows (16 bytes whenever it is a multiple of 16, as for
// every row of 8k bf16 or 4k fp32 values), so consecutive lanes touch
// consecutive addresses and any M works. The TPU kernel stages a batch row's
// whole table in VMEM first; here the source rows come straight from HBM
// through L2, and the card's 132 SMs copy rows in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps (rows) per block

template <typename V>
__global__ void __launch_bounds__(WARPS * 32)
moe_gather_kernel(const V* __restrict__ x, const int* __restrict__ idx,
                  V* __restrict__ out, long long rows, int J, int R, int vecs) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = w / J;
  const int r = idx[w];
  V* dst = out + w * vecs;
  if ((unsigned)r >= (unsigned)R) {
    const V zero = V();
    for (int v = lane; v < vecs; v += 32) dst[v] = zero;
    return;
  }
  const V* src = x + (b * R + r) * vecs;
  for (int v = lane; v < vecs; v += 32) dst[v] = src[v];
}

template <typename V>
void launch(const void* x, const void* idx, void* out, long long rows, int J,
            int R, long long row_bytes, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  moe_gather_kernel<V><<<blocks, WARPS * 32, 0, s>>>(
      static_cast<const V*>(x), static_cast<const int*>(idx), static_cast<V*>(out),
      rows, J, R, (int)(row_bytes / sizeof(V)));
}

}  // namespace

extern "C" int moe_gather_launch(const void* x, const void* idx, void* out, int B,
                                 int R, int J, int M, int elem_bytes, void* stream) {
  if (B < 0 || R < 1 || J < 0 || M < 0 || elem_bytes < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * J;
  const long long row_bytes = (long long)M * elem_bytes;
  if (rows == 0 || row_bytes == 0) return (int)cudaSuccess;
  if ((rows + WARPS - 1) / WARPS > 0x7fffffffLL || row_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wrapper hands 16-byte aligned bases, so every row starts aligned to
  // the largest power of two (up to 16) that divides the row's byte size
  if (row_bytes % 16 == 0)
    launch<uint4>(x, idx, out, rows, J, R, row_bytes, s);
  else if (row_bytes % 8 == 0)
    launch<uint2>(x, idx, out, rows, J, R, row_bytes, s);
  else if (row_bytes % 4 == 0)
    launch<unsigned int>(x, idx, out, rows, J, R, row_bytes, s);
  else if (row_bytes % 2 == 0)
    launch<unsigned short>(x, idx, out, rows, J, R, row_bytes, s);
  else
    launch<unsigned char>(x, idx, out, rows, J, R, row_bytes, s);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
