// Shared pieces of the two BatchNorm reduction kernels (bn_moments.cu,
// bn_grad_sums.cu): two per-channel fp32 sums over the rows of a row-major
// [m, C] activation (the free view of an NHWC tensor), in one sweep.
//
// The rows are split over gridDim.y blocks that run in parallel, the channel
// vectors over gridDim.x. In a block of 256 threads, thread t takes column
// vector blockIdx.x * tx + t % tx (V channels: one 16-byte load, or a single
// element where C does not allow the vector) and the rows blockIdx.y * ty +
// t / tx, + gridDim.y * ty, ... with ty = 256 / tx: neighbouring threads read
// neighbouring addresses, also across the short rows of a narrow C, and at
// every step the blocks together read one contiguous band of the tensor.
// Each thread keeps 2 V fp32 sums; the block adds them over its ty row lanes
// through shared memory in a fixed order and writes its row of partial sums.
// No atomics on the sums: the result is the same on every run.
//
// Two ways to add the gridDim.y partial rows:
//
// - launch_column_sums (bn_grad_sums): the rows go to part [2, gridDim.y, C]
//   and a second kernel, column_sums_finish, adds them in a fixed order.
// - launch_column_sums_once (bn_moments): one launch. Each thread issues
//   ONCE_UNROLL independent row loads before adding them, and the blocks are
//   fewer and fuller (the wrapper's plan); the last block of each column
//   group to finish, told so by an atomic ticket, adds the group's partial
//   rows in a fixed order and resets its ticket.
//
// Op supplies the two terms of an element: Op::prepare(c0) loads what it
// needs per channel, Op::add(offset, a, b) loads V elements at the offset
// and adds their terms to a[V] and b[V]; the one-launch kernel splits the
// last into Op::load(offset, f) and Op::accumulate(f, a, b).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn {

constexpr int THREADS = 256;
constexpr int FINISH_CH = 32;     // channels a finishing block
constexpr int FINISH_LANES = 32;  // row lanes a finishing block

typedef __nv_bfloat16 bf16;

// V consecutive elements at p as floats (p aligned to the vector's size).
template <typename T, int V>
struct Vec;

template <>
struct Vec<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(h[i]);
      f[2 * i] = a.x;
      f[2 * i + 1] = a.y;
    }
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* __restrict__ p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};

template <>
struct Vec<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float* f) {
    f[0] = __bfloat162float(*p);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* __restrict__ p, float* f) { f[0] = *p; }
};

template <int V, typename Op>
__global__ void __launch_bounds__(THREADS)
column_sums_kernel(Op op, long long m, int C, int tx, float* __restrict__ part) {
  __shared__ float sa[THREADS * V];
  __shared__ float sb[THREADS * V];
  const int ty = THREADS / tx;
  const int cx = threadIdx.x % tx, ry = threadIdx.x / tx;
  const int c0 = (blockIdx.x * tx + cx) * V;
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
  if (c0 < C) {
    op.prepare(c0);
    const long long step = (long long)gridDim.y * ty;
#pragma unroll 4
    for (long long r = (long long)blockIdx.y * ty + ry; r < m; r += step)
      op.add(r * C + c0, a, b);
  }
  // sa[ry][cx * V + i]: lane ry's partial sums of the block's tx * V channels
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa[(ry * tx + cx) * V + i] = a[i];
    sb[(ry * tx + cx) * V + i] = b[i];
  }
  __syncthreads();
  const int width = tx * V;                   // <= THREADS
  if (threadIdx.x < width) {
    const int c = blockIdx.x * width + threadIdx.x;
    if (c < C) {
      float ta = 0.f, tb = 0.f;
      for (int y = 0; y < ty; ++y) {
        ta += sa[y * width + threadIdx.x];
        tb += sb[y * width + threadIdx.x];
      }
      part[(size_t)blockIdx.y * C + c] = ta;
      part[((size_t)gridDim.y + blockIdx.y) * C + c] = tb;
    }
  }
}

// out[0, c] = sum_y part[0, y, c], out[1, c] = sum_y part[1, y, c]: lane l of
// a block adds rows l, l + 32, ...; the lanes' sums are added in lane order.
__global__ void __launch_bounds__(FINISH_CH * FINISH_LANES)
column_sums_finish(const float* __restrict__ part, int gy, int C, float* __restrict__ out) {
  __shared__ float sa[FINISH_LANES][FINISH_CH + 1];
  __shared__ float sb[FINISH_LANES][FINISH_CH + 1];
  const int cx = threadIdx.x % FINISH_CH, lane = threadIdx.x / FINISH_CH;
  const int c = blockIdx.x * FINISH_CH + cx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int y = lane; y < gy; y += FINISH_LANES) {
      a += part[(size_t)y * C + c];
      b += part[((size_t)gy + y) * C + c];
    }
  }
  sa[lane][cx] = a;
  sb[lane][cx] = b;
  __syncthreads();
  if (lane == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
    for (int l = 0; l < FINISH_LANES; ++l) {
      ta += sa[l][cx];
      tb += sb[l][cx];
    }
    out[c] = ta;
    out[C + c] = tb;
  }
}

// ---- one launch: the sweep with ONCE_UNROLL loads in flight a thread, then
// the last block of each column group adds the group's partial rows

constexpr int ONCE_UNROLL = 8;    // row loads a thread issues before adding them
constexpr int FINISH_UNROLL = 16; // partial-row loads a finishing thread issues at once

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// part holds, for column group x and row group y, the 2 W4 floats of row
// x * gridDim.y + y: the block's sums of a over its W = tx * V channels,
// padded with zeros to W4 = max(W, 4), then those of b. tickets [gridDim.x]
// int32 are 0 before the launch and after it.
template <int V, typename Op>
__global__ void __launch_bounds__(THREADS, 2)
column_sums_once(Op op, long long m, int C, int tx, float* __restrict__ part,
                 int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float sa[THREADS * V];
  __shared__ float sb[THREADS * V];
  __shared__ float4 fin[THREADS];
  __shared__ int last;
  const int ty = THREADS / tx;
  const int cx = threadIdx.x % tx, ry = threadIdx.x / tx;
  const int W = tx * V, W4 = W < 4 ? 4 : W;
  const int c0 = (blockIdx.x * tx + cx) * V;
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
  if (c0 < C) {
    op.prepare(c0);
    const long long step = (long long)gridDim.y * ty;
    long long r = (long long)blockIdx.y * ty + ry;
    for (; r + (ONCE_UNROLL - 1) * step < m; r += ONCE_UNROLL * step) {
      float f[ONCE_UNROLL][V];
#pragma unroll
      for (int u = 0; u < ONCE_UNROLL; ++u) op.load((r + u * step) * C + c0, f[u]);
#pragma unroll
      for (int u = 0; u < ONCE_UNROLL; ++u) op.accumulate(f[u], a, b);
    }
    for (; r < m; r += step) {
      float f[V];
      op.load(r * C + c0, f);
      op.accumulate(f, a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa[(ry * tx + cx) * V + i] = a[i];
    sb[(ry * tx + cx) * V + i] = b[i];
  }
  __syncthreads();
  float* row = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 2 * W4;
  if (threadIdx.x < W4) {
    float ta = 0.f, tb = 0.f;
    if (threadIdx.x < W) {
      for (int y = 0; y < ty; ++y) {
        ta += sa[y * W + threadIdx.x];
        tb += sb[y * W + threadIdx.x];
      }
    }
    row[threadIdx.x] = ta;
    row[W4 + threadIdx.x] = tb;
  }

  // the last block of the column group adds its gridDim.y rows
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Q float4 quads a row; lane l adds rows l, l + lanes, ... in order, then
  // the lanes' sums are added in lane order
  const int Q = W4 / 2, lanes = THREADS / Q;
  const int q = threadIdx.x % Q, lane = threadIdx.x / Q;
  const int gy = gridDim.y;
  const float4* src =
      reinterpret_cast<const float4*>(part + (size_t)blockIdx.x * gy * 2 * W4) + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int y = lane;
  for (; y + (FINISH_UNROLL - 1) * lanes < gy; y += FINISH_UNROLL * lanes) {
    float4 v[FINISH_UNROLL];
#pragma unroll
    for (int u = 0; u < FINISH_UNROLL; ++u) v[u] = __ldcg(src + (size_t)(y + u * lanes) * Q);
#pragma unroll
    for (int u = 0; u < FINISH_UNROLL; ++u) add4(acc, v[u]);
  }
  for (; y < gy; y += lanes) add4(acc, __ldcg(src + (size_t)y * Q));
  fin[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < Q) {
    float4 t = fin[q];
    for (int l = 1; l < lanes; ++l) add4(t, fin[l * Q + q]);
    const float tv[4] = {t.x, t.y, t.z, t.w};
    const int which = 4 * q / W4, col = 4 * q % W4;   // a quad lies in one half
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = blockIdx.x * W + col + e;
      if (col + e < W && ch < C) out[(size_t)which * C + ch] = tv[e];
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

// Checks the plan the wrapper made (ops/bn_pallas.py _moments_plan) and
// launches column_sums_once. OpT<T, V>(args...) is the Op for element type T
// and vector width V. dtype: 0 fp32, 1 bf16. part holds gridDim.x * gy * 2 *
// max(tx * vec, 4) floats, tickets gridDim.x zeroed int32.
template <template <typename, int> class OpT, typename... Args>
int launch_column_sums_once(float* part, int* tickets, float* out, int m, int C, int dtype,
                            int vec, int tx, int gy, cudaStream_t s, Args... args) {
  const int wide = dtype == 0 ? 4 : 8;
  if (m < 1 || C < 1 || dtype < 0 || dtype > 1 || (vec != 1 && vec != wide) || C % vec != 0 ||
      tx < 1 || (tx & (tx - 1)) != 0 || tx * vec > THREADS || gy < 1 || gy > 65535 || !part ||
      !tickets)
    return (int)cudaErrorInvalidValue;
  const int cols = C / vec;
  const dim3 grid((cols + tx - 1) / tx, gy);
  const long long rows = m;
  if (dtype == 0 && vec == 4)
    column_sums_once<4><<<grid, THREADS, 0, s>>>(OpT<float, 4>(args...), rows, C, tx, part,
                                                tickets, out);
  else if (dtype == 0)
    column_sums_once<1><<<grid, THREADS, 0, s>>>(OpT<float, 1>(args...), rows, C, tx, part,
                                                tickets, out);
  else if (vec == 8)
    column_sums_once<8><<<grid, THREADS, 0, s>>>(OpT<bf16, 8>(args...), rows, C, tx, part,
                                                tickets, out);
  else
    column_sums_once<1><<<grid, THREADS, 0, s>>>(OpT<bf16, 1>(args...), rows, C, tx, part,
                                                tickets, out);
  return (int)cudaGetLastError();
}

// Checks the plan the wrapper made (ops/bn_pallas.py _plan) and launches
// both kernels. OpT<T, V>(args...) is the Op for element type T and vector
// width V. dtype: 0 fp32, 1 bf16.
template <template <typename, int> class OpT, typename... Args>
int launch_column_sums(float* part, float* out, int m, int C, int dtype, int vec, int tx, int gy,
                       cudaStream_t s, Args... args) {
  const int wide = dtype == 0 ? 4 : 8;
  if (m < 1 || C < 1 || dtype < 0 || dtype > 1 || (vec != 1 && vec != wide) || C % vec != 0 ||
      tx < 1 || (tx & (tx - 1)) != 0 || tx * vec > THREADS || gy < 1 || gy > 65535)
    return (int)cudaErrorInvalidValue;
  const int cols = C / vec;
  const dim3 grid((cols + tx - 1) / tx, gy);
  const long long rows = m;
  if (dtype == 0 && vec == 4)
    column_sums_kernel<4><<<grid, THREADS, 0, s>>>(OpT<float, 4>(args...), rows, C, tx, part);
  else if (dtype == 0)
    column_sums_kernel<1><<<grid, THREADS, 0, s>>>(OpT<float, 1>(args...), rows, C, tx, part);
  else if (vec == 8)
    column_sums_kernel<8><<<grid, THREADS, 0, s>>>(OpT<bf16, 8>(args...), rows, C, tx, part);
  else
    column_sums_kernel<1><<<grid, THREADS, 0, s>>>(OpT<bf16, 1>(args...), rows, C, tx, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sums_finish<<<(C + FINISH_CH - 1) / FINISH_CH, FINISH_CH * FINISH_LANES, 0, s>>>(
      part, gy, C, out);
  return (int)cudaGetLastError();
}

}  // namespace bn

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
