// BatchNorm backward sums for Hopper (sm_90a): per channel, the sums of dy
// and of dy * xhat over the rows, xhat = (x - mean) * rinv recomputed from x
// in the same sweep, fp32.
//
// Replaces the Pallas kernel _bn_bwd_kernel (kubeflow_tpu/ops/bn_pallas.py:140):
// the two reductions that BatchNorm's gradient needs (dbeta and dgamma; dx is
// then elementwise).
// Layout: x and dy [m, C] row-major, both fp32 or both bf16; mean and rinv
// [C] fp32; part [2, gy, C] fp32 scratch; out [2, C] fp32 (row 0 the sums of
// dy, row 1 of dy * xhat).
//
// Bound: HBM bytes, dy and x read once each. The design, rows over parallel
// blocks and a fixed-order finishing pass, is in bn_common.cuh; the wrapper
// (ops/bn_pallas.py _plan) picks the split.

#include "bn_common.cuh"

namespace {

template <typename T, int V>
struct GradSumsOp {
  const T* x;
  const T* dy;
  const float* mean;
  const float* rinv;
  float mu[V], ri[V];

  GradSumsOp(const void* x_, const void* dy_, const void* mean_, const void* rinv_)
      : x(static_cast<const T*>(x_)), dy(static_cast<const T*>(dy_)),
        mean(static_cast<const float*>(mean_)), rinv(static_cast<const float*>(rinv_)) {}

  __device__ __forceinline__ void prepare(int c0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mu[i] = mean[c0 + i];
      ri[i] = rinv[c0 + i];
    }
  }

  __device__ __forceinline__ void add(long long offset, float* a, float* b) const {
    float fx[V], fd[V];
    bn::Vec<T, V>::load(x + offset, fx);
    bn::Vec<T, V>::load(dy + offset, fd);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] += fd[i];
      b[i] += fd[i] * ((fx[i] - mu[i]) * ri[i]);
    }
  }
};

}  // namespace

extern "C" int bn_grad_sums_launch(const void* x, const void* dy, const void* mean,
                                   const void* rinv, void* part, void* out, int m, int C,
                                   int dtype, int vec, int tx, int gy, void* stream) {
  return bn::launch_column_sums<GradSumsOp>(
      static_cast<float*>(part), static_cast<float*>(out), m, C, dtype, vec, tx, gy,
      static_cast<cudaStream_t>(stream), x, dy, mean, rinv);
}
