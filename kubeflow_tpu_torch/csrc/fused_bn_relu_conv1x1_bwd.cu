// Fused (BatchNorm + ReLU) backward and 1x1-convolution backward for Hopper
// (sm_90a), in one pass over the activations:
//   xhat = (y - mean) * inv
//   db   = dr where xhat * gamma + beta > 0, else 0      (ReLU mask recomputed)
//   dy   = gamma_inv * (db - mean_db - xhat * mean_db_xhat), rounded to bf16
//   dX   = dy @ W^T        [N, CI] bf16   (fp32 sums, rounded once)
//   dW   = X^T @ dy        [CI, CO] fp32
// Both matrix products are computed here, on the tensor cores.
//
// Replaces the Pallas kernel bwd_kernel (benchmarks/pallas_bwd_probe.py:25).
// Layout: dr and y [N, CO] bf16, x [N, CI] bf16, wt [CO, CI] bf16 (W^T), scal
// [7, CO] fp32 with rows gamma*inv, mean, inv, beta, mean_db, mean_db_xhat,
// gamma; dx [N, CI] bf16; part [gx, CI, CO] fp32 scratch; dw [CI, CO] fp32.
// All contiguous. Any N; CI a multiple of 16; CO a multiple of 16 up to 256.
//
// Bound: HBM bytes at the probe's shape (N 802,816, CI 256, CO 128): dr, y
// and x read once and dX written once, 1.23 GB, against 105 GFLOP.
//
// The TPU kernel walks the row tiles in order and carries dW [CI, CO] in VMEM.
// Here block (bx, s) owns a slice of SL input channels and the row tiles bx,
// bx + gx, ...: it keeps W^T's slice in shared memory and the slice's dW
// [SL, CO] in registers (64 fp32 a thread, so SL * CO <= 16,384: SL 128 up to
// CO 128, SL 64 up to CO 256) over all its tiles, and at the end writes it to
// part[bx]; fused_bwd_finish adds the gx partials in order, so dW is the same
// on every run (no atomics). Per tile of 64 rows: the elementwise chain in
// fp32 with no fused multiply-add (each product and sum rounds apart, as in
// the plain version, so the mask and the bf16 dy are the plain version's bit
// for bit), dy into shared memory, x's slice staged, then both products with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Every slice recomputes dy, so
// dr and y are read CI / SL times.

#include "fused_head_common.cuh"

using fused_head::bf16;
using fused_head::ld32;
using fused_head::mma_bf16;
using fused_head::pack2;

namespace {

constexpr int BN_ROWS = 64;     // rows a tile
constexpr int THREADS = 256;    // 8 warps: 4 along rows (dX) or input channels (dW), 2 along columns

template <int SL, int COT>
struct Shape {
  static constexpr int LDY = COT + 8;   // bf16 leading dim of dy [64][COT] and W^T's slice [SL][COT]
  static constexpr int LDX = SL + 8;    // bf16 leading dim of x's slice [64][SL]
  static constexpr int XF = SL / 16;    // dX fragments (16 x 8) a warp: 16 rows, SL / 2 columns
  static constexpr int WM = SL / 64;    // dW row fragments a warp: SL / 4 input channels
  static constexpr int WN = COT / 16;   // dW column fragments a warp: COT / 2 output channels
  static constexpr size_t SMEM =
      sizeof(float) * 7 * COT + sizeof(bf16) * (BN_ROWS * LDY + SL * LDY + BN_ROWS * LDX);
};

template <int SL, int COT>
__global__ void __launch_bounds__(THREADS)
fused_bwd_kernel(const bf16* __restrict__ dr, const bf16* __restrict__ y,
                 const bf16* __restrict__ x, const bf16* __restrict__ wt,
                 const float* __restrict__ scal, bf16* __restrict__ dx,
                 float* __restrict__ part, int N, int CI, int CO) {
  typedef Shape<SL, COT> S;
  extern __shared__ uint4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);            // [7][COT]
  bf16* dys = reinterpret_cast<bf16*>(sc + 7 * COT);      // [64][LDY]
  bf16* wts = dys + BN_ROWS * S::LDY;                     // [SL][LDY]: wts[ci][co] = wt[co][ci0 + ci]
  bf16* xs = wts + SL * S::LDY;                           // [64][LDX]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int ci0 = blockIdx.y * SL;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = threadIdx.x; i < 7 * COT; i += THREADS) {
    const int row = i / COT, co = i % COT;
    sc[i] = co < CO ? scal[row * CO + co] : 0.f;
  }
  for (int i = threadIdx.x; i < COT * SL; i += THREADS) {
    const int co = i / SL, ci = i % SL;
    wts[ci * S::LDY + co] = (co < CO && ci0 + ci < CI) ? wt[(size_t)co * CI + ci0 + ci] : zero;
  }

  float dw[S::WM][S::WN][4];
#pragma unroll
  for (int a = 0; a < S::WM; ++a)
#pragma unroll
    for (int b = 0; b < S::WN; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) dw[a][b][c] = 0.f;

  for (int n0 = blockIdx.x * BN_ROWS; n0 < N; n0 += gridDim.x * BN_ROWS) {
    __syncthreads();        // the tile before is read; sc and wts are staged
    // dy of the tile, 8 output channels a step (CO is a multiple of 8)
    for (int i = threadIdx.x; i < BN_ROWS * (COT / 8); i += THREADS) {
      const int r = i / (COT / 8), co = (i % (COT / 8)) * 8;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N && co < CO) {
        const size_t at = (size_t)(n0 + r) * CO + co;
        const uint4 yv = *reinterpret_cast<const uint4*>(y + at);
        const uint4 dv = *reinterpret_cast<const uint4*>(dr + at);
        const bf16* yb = reinterpret_cast<const bf16*>(&yv);
        const bf16* db16 = reinterpret_cast<const bf16*>(&dv);
        bf16* ob = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = co + j;
          const float xhat = __fmul_rn(__fsub_rn(__bfloat162float(yb[j]), sc[1 * COT + c]),
                                       sc[2 * COT + c]);
          const bool on = __fadd_rn(__fmul_rn(xhat, sc[6 * COT + c]), sc[3 * COT + c]) > 0.f;
          const float db = on ? __bfloat162float(db16[j]) : 0.f;
          const float d = __fmul_rn(
              sc[c], __fsub_rn(__fsub_rn(db, sc[4 * COT + c]), __fmul_rn(xhat, sc[5 * COT + c])));
          ob[j] = __float2bfloat16(d);
        }
      }
      *reinterpret_cast<uint4*>(dys + r * S::LDY + co) = out;
    }
    // x's slice of the tile (CI is a multiple of 8)
    for (int i = threadIdx.x; i < BN_ROWS * (SL / 8); i += THREADS) {
      const int r = i / (SL / 8), ci = (i % (SL / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N && ci0 + ci < CI)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(n0 + r) * CI + ci0 + ci);
      *reinterpret_cast<uint4*>(xs + r * S::LDX + ci) = v;
    }
    __syncthreads();

    // dX[64, SL] = dy[64, CO] @ wts^T: warp (wr, wc) rows wr * 16, columns wc * SL / 2
    {
      float acc[S::XF][4];
#pragma unroll
      for (int j = 0; j < S::XF; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int kk = 0; kk < CO; kk += 16) {
        const bf16* ap = dys + (wr * 16 + g) * S::LDY + kk + q * 2;
        const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * S::LDY), ld32(ap + 8),
                               ld32(ap + 8 * S::LDY + 8)};
#pragma unroll
        for (int j = 0; j < S::XF; ++j) {
          const bf16* bp = wts + (wc * (SL / 2) + j * 8 + g) * S::LDY + kk + q * 2;
          mma_bf16(acc[j], a, ld32(bp), ld32(bp + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < S::XF; ++j) {
        const int c = ci0 + wc * (SL / 2) + j * 8 + q * 2;
        if (c >= CI) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = n0 + wr * 16 + g + half * 8;
          if (r < N)
            *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * CI + c) =
                __floats2bfloat162_rn(acc[j][half * 2], acc[j][half * 2 + 1]);
        }
      }
    }

    // dW[SL, CO] += xs^T @ dy: the contraction runs over the tile's rows, the
    // strided dim of both operands, so each fragment register is packed from
    // two 16-bit loads. Warp (wr, wc): input channels wr * SL / 4, output
    // channels wc * COT / 2.
#pragma unroll
    for (int kk = 0; kk < BN_ROWS; kk += 16) {
      const bf16* k0 = xs + (kk + q * 2) * S::LDX + wr * (SL / 4) + g;
      uint32_t a[S::WM][4];
#pragma unroll
      for (int mf = 0; mf < S::WM; ++mf) {
        const bf16* p = k0 + mf * 16;
        a[mf][0] = pack2(p, p + S::LDX);
        a[mf][1] = pack2(p + 8, p + S::LDX + 8);
        a[mf][2] = pack2(p + 8 * S::LDX, p + 9 * S::LDX);
        a[mf][3] = pack2(p + 8 * S::LDX + 8, p + 9 * S::LDX + 8);
      }
      const bf16* b0 = dys + (kk + q * 2) * S::LDY + wc * (COT / 2) + g;
#pragma unroll
      for (int nf = 0; nf < S::WN; ++nf) {
        const bf16* p = b0 + nf * 8;
        const uint32_t r0 = pack2(p, p + S::LDY);
        const uint32_t r1 = pack2(p + 8 * S::LDY, p + 9 * S::LDY);
#pragma unroll
        for (int mf = 0; mf < S::WM; ++mf) mma_bf16(dw[mf][nf], a[mf], r0, r1);
      }
    }
  }

  // this block's dW slice into part[blockIdx.x] (zeros if it had no tile)
  float* dst = part + (size_t)blockIdx.x * CI * CO;
#pragma unroll
  for (int mf = 0; mf < S::WM; ++mf)
#pragma unroll
    for (int nf = 0; nf < S::WN; ++nf) {
      const int co = wc * (COT / 2) + nf * 8 + q * 2;
      if (co >= CO) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0 + wr * (SL / 4) + mf * 16 + g + half * 8;
        if (ci < CI) {
          dst[(size_t)ci * CO + co] = dw[mf][nf][half * 2];
          dst[(size_t)ci * CO + co + 1] = dw[mf][nf][half * 2 + 1];
        }
      }
    }
}

// dw[i] = sum_b part[b][i], in block order.
__global__ void fused_bwd_finish(const float* __restrict__ part, int gx, int n,
                                 float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < gx; ++b) s += part[(size_t)b * n + i];
  dw[i] = s;
}

template <int SL, int COT>
int launch(const void* dr, const void* y, const void* x, const void* wt, const void* scal,
           void* dx, void* part, void* dw, int N, int CI, int CO, int gx, cudaStream_t s) {
  typedef Shape<SL, COT> S;
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_kernel<SL, COT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gx, (CI + SL - 1) / SL);
  fused_bwd_kernel<SL, COT><<<grid, THREADS, S::SMEM, s>>>(
      static_cast<const bf16*>(dr), static_cast<const bf16*>(y), static_cast<const bf16*>(x),
      static_cast<const bf16*>(wt), static_cast<const float*>(scal), static_cast<bf16*>(dx),
      static_cast<float*>(part), N, CI, CO);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = CI * CO;
  fused_bwd_finish<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), gx, n,
                                                   static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

// gx: the row groups (blocks along N), each writing one [CI, CO] partial dW.
extern "C" int fused_bn_relu_conv1x1_bwd_launch(const void* dr, const void* y, const void* x,
                                                const void* wt, const void* scal, void* dx,
                                                void* part, void* dw, int N, int CI, int CO,
                                                int gx, void* stream) {
  if (N < 1 || CI < 16 || CO < 16 || CI % 16 || CO % 16 || CO > 256 || gx < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CO <= 128)
    return launch<128, 128>(dr, y, x, wt, scal, dx, part, dw, N, CI, CO, gx, s);
  return launch<64, 256>(dr, y, x, wt, scal, dx, part, dw, N, CI, CO, gx, s);
}
