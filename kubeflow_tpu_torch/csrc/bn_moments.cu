// BatchNorm channel moments for Hopper (sm_90a): per channel, the sums of
// c * x and of (c * x)^2 over the rows of x [m, C], fp32, in one sweep.
//
// Replaces two Pallas kernels: _moments_kernel of
// kubeflow_tpu/ops/bn_pallas.py:96 (c = 1: the statistics pass of every
// train-mode BatchNorm) and _moments_kernel of benchmarks/bn_stats_probe.py:43
// (the same sums with a scalar multiplier applied to x first).
// Layout: x [m, C] row-major, fp32 or bf16; part (the blocks' partial rows)
// and tickets (zeroed int32, left zeroed) scratch; out [2, C] fp32 (row 0
// the sums, row 1 the sums of squares).
//
// Bound: HBM bytes, x read once (the 2 C floats written are nothing beside
// it). The design, rows over parallel blocks, eight row loads in flight a
// thread, and the last block of each column group adding the partial rows in
// a fixed order in the same launch, is column_sums_once in bn_common.cuh;
// the wrapper (ops/bn_pallas.py _moments_plan) picks the split.

#include "bn_common.cuh"

namespace {

template <typename T, int V>
struct MomentsOp {
  const T* x;
  float c;

  MomentsOp(const void* x_, float c_) : x(static_cast<const T*>(x_)), c(c_) {}

  __device__ __forceinline__ void prepare(int) {}

  __device__ __forceinline__ void load(long long offset, float* f) const {
    bn::Vec<T, V>::load(x + offset, f);
  }

  __device__ __forceinline__ void accumulate(const float* f, float* a, float* b) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = f[i] * c;
      a[i] += v;
      b[i] += v * v;
    }
  }
};

}  // namespace

extern "C" int bn_moments_launch(const void* x, void* part, void* tickets, void* out, int m,
                                 int C, int dtype, int vec, int tx, int gy, float c,
                                 void* stream) {
  return bn::launch_column_sums_once<MomentsOp>(
      static_cast<float*>(part), static_cast<int*>(tickets), static_cast<float*>(out), m, C,
      dtype, vec, tx, gy, static_cast<cudaStream_t>(stream), x, c);
}
