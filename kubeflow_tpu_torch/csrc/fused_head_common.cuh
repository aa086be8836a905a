// Shared pieces of the three fused tied-head kernels (fused_head_fwd.cu,
// fused_head_bwd_dh.cu, fused_head_bwd_de.cu): staging bf16 tiles in shared
// memory, the bf16 tensor-core product (mma.sync m16n8k16, fp32 accumulate),
// and the [64 tokens, 64 vocab] logits tile that all three recompute.
//
// Operands: h [T, E] and emb [V, E] bf16, row-major and contiguous. Any T, V
// and E: rows past T or V and columns past E are staged as zeros. Rows of E
// a multiple of 8 move as 16-byte vectors (the wrapper checks the base
// pointers' alignment), other E element by element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fused_head {

constexpr int BT = 64;          // tokens per tile
constexpr int BV = 64;          // vocabulary rows per tile
constexpr int EK = 64;          // contraction (E) chunk of the logits tile
constexpr int LDK = EK + 8;     // bf16 leading dim of staged chunks: 144-byte rows
constexpr int LDL = BV + 4;     // fp32 leading dim of the logits tile
constexpr int THREADS = 256;    // 8 warps
constexpr int EC = 256;         // backward: E columns one block accumulates
constexpr int LDE = EC + 8;     // bf16 leading dim of a staged [64, EC] slice
constexpr int LDD = 64 + 8;     // bf16 leading dim of the dlogits tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// D += A (16 x 16, row-major fragment) * B (16 x 8, column fragment), fp32 D.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive elements src[row, col .. col+7] of a row-major [R, K]
// matrix, zero outside it.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ src, int row, int R,
                                       int col, int K) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= R || col >= K) return v;
  const bf16* p = src + (size_t)row * K + col;
  if ((K & 7) == 0) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < K ? __bfloat16_as_ushort(p[2 * i]) : 0u;
    const uint32_t hi = col + 2 * i + 1 < K ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A [64, W] tile of a row-major [R, K] matrix, rows r0.., columns k0..,
// through registers: W / 32 vectors of 8 elements a thread.
template <int W>
struct Tile {
  static constexpr int N = 64 * W / 8 / THREADS;
  uint4 r[N];

  __device__ __forceinline__ void load(const bf16* __restrict__ src, int r0, int R, int k0, int K) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int i = threadIdx.x + s * THREADS;
      r[s] = load8(src, r0 + i / (W / 8), R, k0 + (i % (W / 8)) * 8, K);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int ld) const {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int i = threadIdx.x + s * THREADS;
      *reinterpret_cast<uint4*>(dst + (i / (W / 8)) * ld + (i % (W / 8)) * 8) = r[s];
    }
  }
};

// logits[t, v] = sum_e h[t0 + t, e] * emb[v0 + v, e] for a [64, 64] tile, in
// fp32 from bf16 products, written to ls[64][LDL]. The E loop stages [64, EK]
// chunks of both operands in hs and es; the next chunk's global loads are in
// flight while the tensor cores work on the current one. Warp w computes rows
// (w % 4) * 16 .. +15 and columns (w / 4) * 32 .. +31. Starts with a barrier
// (the block's earlier readers of hs, es and ls are done) and ends without
// one: the caller synchronises before reading ls.
__device__ __forceinline__ void logits_tile(float* ls, bf16* hs, bf16* es,
                                            const bf16* __restrict__ h,
                                            const bf16* __restrict__ emb,
                                            int t0, int T, int v0, int V, int E) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  Tile<EK> ha, ea;
  ha.load(h, t0, T, 0, E);
  ea.load(emb, v0, V, 0, E);
  for (int k0 = 0; k0 < E; k0 += EK) {
    __syncthreads();
    ha.store(hs, LDK);
    ea.store(es, LDK);
    __syncthreads();
    if (k0 + EK < E) {
      ha.load(h, t0, T, k0 + EK, E);
      ea.load(emb, v0, V, k0 + EK, E);
    }
#pragma unroll
    for (int kk = 0; kk < EK; kk += 16) {
      const bf16* ap = hs + (wr * 16 + g) * LDK + kk + q * 2;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDK), ld32(ap + 8), ld32(ap + 8 * LDK + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* bp = es + (wc * 32 + j * 8 + g) * LDK + kk + q * 2;
        mma_bf16(acc[j], a, ld32(bp), ld32(bp + 8));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = wr * 16 + g, c = wc * 32 + j * 8 + q * 2;
    ls[r * LDL + c] = acc[j][0];
    ls[r * LDL + c + 1] = acc[j][1];
    ls[(r + 8) * LDL + c] = acc[j][2];
    ls[(r + 8) * LDL + c + 1] = acc[j][3];
  }
}

// acc[64, EC] += A[64, 64] * B[64, EC] for the backward kernels: A row-major
// bf16 in shared memory (a[m * LDD + k]), B row-major bf16 (b[k * LDE + n],
// the contraction dim strided, so each B fragment is packed from two 16-bit
// loads). Warp w owns rows (w % 4) * 16 .. +15 and columns (w / 4) * 128 ..
// +127: 16 fragments of 16 x 8, 64 fp32 registers a thread.
__device__ __forceinline__ void product_tile(float (*acc)[4], const bf16* a_s, const bf16* b_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    const bf16* ap = a_s + (wr * 16 + g) * LDD + kk + q * 2;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDD), ld32(ap + 8), ld32(ap + 8 * LDD + 8)};
    const bf16* bp = b_s + (kk + q * 2) * LDE + wc * 128 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bf16* b = bp + j * 8;
      mma_bf16(acc[j], a, pack2(b, b + LDE), pack2(b + 8 * LDE, b + 9 * LDE));
    }
  }
}

// Write acc (rows r0.., columns e0.., fragments as product_tile lays them
// out) into out [R, E] fp32.
__device__ __forceinline__ void store_acc(float* __restrict__ out, float (*acc)[4],
                                          int r0, int R, int e0, int E) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = e0 + wc * 128 + j * 8 + q * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wr * 16 + g + half * 8;
      if (r >= R) continue;
      float* o = out + (size_t)r * E;
      if (c < E) o[c] = acc[j][half * 2];
      if (c + 1 < E) o[c + 1] = acc[j][half * 2 + 1];
    }
  }
}

// dlogits of one logit: dlse * exp(logit - lse) + dgold * [col == tgt],
// rounded to bf16 as the TPU kernels round them before both products.
__device__ __forceinline__ bf16 dlogit(float logit, float lse, float dlse, float dgold,
                                       int col, int tgt) {
  // no fused multiply-add: the product and the sum round apart, as in the
  // plain version
  const float d = __fadd_rn(__fmul_rn(dlse, expf(logit - lse)), col == tgt ? dgold : 0.f);
  return __float2bfloat16(d);
}

}  // namespace fused_head

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
