// Row scatter for Hopper (sm_90a): the backward of the row gather.
// dx [B, R, M] is zero, and each row dy[b, j] whose index idx[b, j] lies in
// [0, R) goes to dx[b, idx[b, j]]:
//   accumulate = 1: added in fp32 (dx is fp32; dy fp32 or bf16);
//   accumulate = 0: stored as it is (dx has dy's dtype). Where several
//                   indices hit one row, which of them lands is unspecified.
//
// Replaces the Pallas kernel _scatter_kernel (kubeflow_tpu/ops/moe_dispatch.py:93):
// accumulate for the MoE dispatch's backward (a token sits in k slots, so its
// gradient rows collide), a direct store for the combine's (slots are
// injective; only the padding row, whose gradient is discarded, collides).
// Layout: dy [B, J, M], idx [B, J] int32, dx [B, R, M], all contiguous.
//
// Bound: HBM bytes, dy's valid rows read once and dx written once (the
// accumulate mode's one fp32 add per element is nothing beside them).
//
// dx is zeroed with cudaMemsetAsync, then one warp per source row (b, j)
// reads the index once and skips the row if it is out of range. Accumulate:
// lane l adds elements l, l + 32, ... with fp32 atomicAdd (coalesced: a
// warp's 32 adds hit one 128-byte line). A destination row with at most two
// sources is exact (0 + a + b); one with more sums in the atomics' order,
// which changes from run to run in the last fp32 bits. The MoE dispatch's
// empty slots all index the zero row S, so that row takes >= 1024 sources a
// batch row at the flagship: the contention to look at first if this kernel
// is slow. Direct store: the row is copied in the widest vectors its byte
// size allows, as in moe_gather.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps (source rows) per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
moe_scatter_add_kernel(const T* __restrict__ dy, const int* __restrict__ idx,
                       float* __restrict__ out, long long rows, int J, int R, int M) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= rows) return;
  const int r = idx[w];
  if ((unsigned)r >= (unsigned)R) return;
  const int lane = threadIdx.x % 32;
  const long long b = w / J;
  const T* src = dy + w * M;
  float* dst = out + (b * R + r) * M;
  for (int m = lane; m < M; m += 32) atomicAdd(dst + m, to_f32(src[m]));
}

template <typename V>
__global__ void __launch_bounds__(WARPS * 32)
moe_scatter_store_kernel(const V* __restrict__ dy, const int* __restrict__ idx,
                         V* __restrict__ out, long long rows, int J, int R, int vecs) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= rows) return;
  const int r = idx[w];
  if ((unsigned)r >= (unsigned)R) return;
  const int lane = threadIdx.x % 32;
  const long long b = w / J;
  const V* src = dy + w * vecs;
  V* dst = out + (b * R + r) * vecs;
  for (int v = lane; v < vecs; v += 32) dst[v] = src[v];
}

unsigned blocks_for(long long rows) { return (unsigned)((rows + WARPS - 1) / WARPS); }

template <typename T>
void launch_add(const void* dy, const void* idx, void* out, long long rows, int J,
                int R, int M, cudaStream_t s) {
  moe_scatter_add_kernel<T><<<blocks_for(rows), WARPS * 32, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const int*>(idx), static_cast<float*>(out),
      rows, J, R, M);
}

template <typename V>
void launch_store(const void* dy, const void* idx, void* out, long long rows, int J,
                  int R, long long row_bytes, cudaStream_t s) {
  moe_scatter_store_kernel<V><<<blocks_for(rows), WARPS * 32, 0, s>>>(
      static_cast<const V*>(dy), static_cast<const int*>(idx), static_cast<V*>(out),
      rows, J, R, (int)(row_bytes / sizeof(V)));
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (dy's element type)
extern "C" int moe_scatter_launch(const void* dy, const void* idx, void* out, int B,
                                  int J, int R, int M, int dtype, int accumulate,
                                  void* stream) {
  if (B < 0 || J < 0 || R < 1 || M < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int elem_bytes = dtype == 0 ? 4 : 2;
  const long long out_bytes = (long long)B * R * M * (accumulate ? 4 : elem_bytes);
  const long long rows = (long long)B * J;
  const long long row_bytes = (long long)M * elem_bytes;
  if ((rows + WARPS - 1) / WARPS > 0x7fffffffLL || row_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)out_bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || M == 0) return (int)cudaSuccess;
  if (accumulate) {
    if (dtype == 0)
      launch_add<float>(dy, idx, out, rows, J, R, M, s);
    else
      launch_add<__nv_bfloat16>(dy, idx, out, rows, J, R, M, s);
  } else if (row_bytes % 16 == 0) {
    launch_store<uint4>(dy, idx, out, rows, J, R, row_bytes, s);
  } else if (row_bytes % 8 == 0) {
    launch_store<uint2>(dy, idx, out, rows, J, R, row_bytes, s);
  } else if (row_bytes % 4 == 0) {
    launch_store<unsigned int>(dy, idx, out, rows, J, R, row_bytes, s);
  } else {
    launch_store<unsigned short>(dy, idx, out, rows, J, R, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
