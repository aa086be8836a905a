// Flash-attention backward, dq, for Hopper (sm_90a): bf16 operands, fp32 math.
//
// Replaces the Pallas kernel _dq_kernel (kubeflow_tpu/ops/pallas_attention.py:290).
// Layout: q, o, do [B, Sq, H, D], k/v [B, Sk, KV, D], all contiguous bf16;
// lse [B, H, Sq] fp32 (+inf on rows that see no key); dq [B, Sq, H, D] in
// bf16 or fp32 (out_f32). Query head h reads kv head h / (H / KV).
//
// One thread block per (64-row query tile, query head, batch row), 256
// threads as a 16 x 16 grid. Thread (ty, tx) owns query rows ty*4 .. ty*4+3:
// in each key tile it computes the 4 x 4 scores s = q k^T and dp = do v^T of
// those rows against keys tx*4 .. tx*4+3, and it accumulates dq of those rows
// in columns c*64 + tx*4 .. +3 (c < D/64) in registers across the loop over
// key tiles, which takes the place of the TPU kernel's sequential ik axis.
// delta = rowsum(do * o) is computed once per row at the start, in fp32 from
// the bf16 tiles (the TPU kernel's _init); no [B, H, S] delta array exists.
// p = exp(s * scale - lse); ds = p * (dp - delta) * scale is rounded to bf16
// before the ds k product, as the TPU kernel rounds it to k's dtype.
//
// Causal: key tiles above the diagonal and left of the sliding window are
// never loaded (the TPU kernel's _kv_valid, pallas_attention.py:104-116).
//
// Bound at the flagship training shape (B4 H8 S2048 D128, causal): FLOPs,
// three causal matmuls (q k^T, do v^T, ds k) = 5.2e10 FLOP, 0.052 ms at the
// card's 989 TFLOP/s bf16 peak, against ~84 MB of bf16 operands (0.025 ms at
// 3.35 TB/s). These scalar fp32 FMAs from shared memory cannot approach the
// tensor cores' rate; what the design does is keep every operand tile in
// shared memory and the accumulator in registers, so HBM traffic stays near
// one read of each operand per key-tile pass, and skip masked tiles, which
// halves the work under the causal mask. Tensor-core tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int LD = 64 + 4;      // leading dim of the transposed tiles; keeps float4 alignment

__host__ __device__ constexpr size_t smem_floats(int d) {
  // q^T, do^T, k^T, v^T [D][LD]; k [BK][D]; ds^T [BK][LD]
  return (size_t)4 * d * LD + (size_t)BK * d + (size_t)BK * LD;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ dout,
                    void* __restrict__ dq, int Sq, int Sk, int H, int KV,
                    int causal, int window, float scale, int out_f32) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + D * LD;
  float* kt = dot + D * LD;
  float* vt = kt + D * LD;
  float* ks = vt + D * LD;
  float* dst = ks + BK * D;

  constexpr int DC = D / 64;    // float4 column chunks per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * D;    // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const size_t q_base = ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    const bool in = qp < Sq;
    qt[d * LD + r] = in ? __bfloat162float(q[q_base + qp * q_stride + d]) : 0.f;
    dot[d * LD + r] = in ? __bfloat162float(dout[q_base + qp * q_stride + d]) : 0.f;
  }

  // delta and lse of this thread's rows; the 16 threads of a row share them
  float delta[4], row_lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    float acc = 0.f;
    if (qp < Sq) {
      for (int d = tx; d < D; d += 16)
        acc += __bfloat162float(dout[q_base + qp * q_stride + d]) *
               __bfloat162float(o[q_base + qp * q_stride + d]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
    row_lse[i] = qp < Sq ? lse[((size_t)b * H + h) * Sq + qp] : INFINITY;
  }

  // keys any row of this tile can see: causal skips tiles above the
  // diagonal, the window skips tiles left of the first row's window
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int k_hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  float acc[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // the q tile is in; the previous tile's reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int kp = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (kp < Sk) {
        kk = __bfloat162float(kb[kp * kv_stride + d]);
        vv = __bfloat162float(vb[kp * kv_stride + d]);
      }
      kt[d * LD + c] = kk;
      vt[d * LD + c] = vv;
      ks[c * D + d] = kk;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * LD + ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&dot[d * LD + ty * 4]);
      const float4 kc = *reinterpret_cast<const float4*>(&kt[d * LD + tx * 4]);
      const float4 vc = *reinterpret_cast<const float4*>(&vt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float kv[4] = {kc.x, kc.y, kc.z, kc.w};
      const float vv[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        bool keep = qp < Sq && kp < Sk;
        if (causal) keep = keep && kp <= qp && (window <= 0 || kp > qp - window);
        // masked scores and rows with lse = +inf give p = 0 explicitly
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta[i]) * scale;
        dst[(tx * 4 + j) * LD + ty * 4 + i] = bf16_round(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dst[kk * LD + ty * 4]);
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[kk * D + c * 64 + tx * 4]);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(dsv[i], kv[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const size_t row = q_base + qp * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (out_f32)
          static_cast<float*>(dq)[row + col] = acc[i][c * 4 + e];
        else
          static_cast<__nv_bfloat16*>(dq)[row + col] = __float2bfloat16(acc[i][c * 4 + e]);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, int B, int Sq, int Sk,
           int H, int KV, int causal, int window, float scale, int out_f32,
           cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(dout), dq,
      Sq, Sk, H, KV, causal, window, scale, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, int B, int Sq, int Sk, int H, int KV, int D,
    int causal, int window, float scale, int out_f32, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, dout, dq, B, Sq, Sk, H, KV, causal, window,
                       scale, out_f32, s);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, dout, dq, B, Sq, Sk, H, KV, causal, window,
                      scale, out_f32, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
