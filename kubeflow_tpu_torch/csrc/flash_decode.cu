// Flash-decode for Hopper (sm_90a): one query token per row against the
// grouped KV cache. bf16 or fp32 in and out (one type), fp32 softmax.
//
// Replaces the Pallas kernel _decode_kernel (kubeflow_tpu/ops/flash_decode.py:53).
// Layout: q [B, G, R, D], k/v cache [B, G, L, dk], pos [B] int32, o [B, G, R, D],
// all contiguous. R = H / G query heads share the group's cache. D is the
// width the kernel is compiled for (64, 128 or 256); the cache's head size dk may
// be smaller (the wrapper pads q and cuts o): the kernel reads the cache's
// rows at dk and zero-fills their columns dk .. D - 1 in shared memory, so
// the scores and the value product are the unpadded ones and no step copies
// the cache. Rows of dk elements whose bytes are a multiple of 16 load in
// 16-byte pieces, other rows element by element.
//
// Bound: HBM bytes (the live K/V: 1.6 MB at the serving flagship's mean
// position, under a microsecond), and in practice latency: a decode step's
// 16 (batch row, kv group) pairs would occupy 16 of the card's 132 SMs, and a
// block that walks its keys tile after tile waits on one dependent load
// after another.
//
// The design splits each row's live range across blocks, so that many SMs
// load at once and each block waits for its loads only once:
//
// - grid (S, chunks of 8 query heads, B * G). The wrapper's plan picks S so
//   that the grid fills about two waves of SMs at the cache's full length L,
//   and sizes a block's shared memory for ceil(L / S) keys (rounded up to
//   16, at most 64 KB of K and V). The kernel reads pos[b] and cuts the
//   row's live range [lo, hi] (from pos and the window) into S runs of
//   `per` keys, the range's length over S rounded up to 16: block s takes
//   run s. So every position keeps every block busy (at the serving
//   flagship's mean position, 192 live keys, 12 blocks of 16 a row, where
//   fixed splits of 128 would leave 2 blocks with all the work), and dead
//   slots are never read: the counterpart of the TPU kernel's
//   scalar-prefetch clamp. A block past the range writes an empty partial.
// - a block first issues every load of its run at once (cp.async, 16 bytes a
//   thread; K and the queries in one group, V in a second, so the scores
//   start while V still arrives). A bf16 block of at least 32 keys then
//   multiplies on the tensor cores (mma.sync m16n8k16, the chunk's heads as
//   rows padded to 16: S = Q K^T a warp per 8 keys, O = P V a warp per D / 4
//   columns, K and V kept with 16-byte piece c of row j at c ^ (j % 8) so
//   that 8 rows read at one column hit 8 bank groups); fp32 and shorter
//   runs (the request's mean position gives 16 keys a block) take FMAs: 8
//   threads score a key over 8 consecutive 16-byte pieces a quarter warp and
//   sum by shuffles, and thread t accumulates output column t % D, 4 running
//   sums a head. Between the two products one warp a head folds the run into
//   (m, l) and rounds the probabilities to the operands' type (the TPU
//   kernel's p.astype(v.dtype), :88; the identity in fp32). The partial
//   (m, l, o[D]) of each head is fp32.
// - the combine is the same launch, by the route the wrapper's plan picks.
//   With S <= 16 the S blocks of a (b, g, chunk) form a thread-block
//   cluster (on an H100 at the serving flagship, chip_smoke.py's timing,
//   8% faster than the workspace combine at pos 191, 1.5% slower at pos
//   2047): each keeps its partial in shared memory, a cluster barrier, and
//   block 0 reads all S partials through
//   distributed shared memory (one round trip for up to 8 (head, column)
//   pairs a thread; at D 256 a thread's 16 pairs take two), rescales each by
//   exp(m_s - m), divides by the sum of the rescaled l (0 where no run has a
//   live key: the TPU kernel's l_safe) and casts once; a second barrier
//   keeps the others alive until it has read them. With more blocks the
//   partials go to a workspace (it stays in L2) and each block takes a
//   ticket (an atomic counter of its (b, g, chunk)); the block that takes
//   the last one combines them the same way and sets the counter back to 0.
//   The sums run in block order, so two launches on the same inputs give
//   the same bits.

#include "flash_common.cuh"

namespace {

using flash::from_f;
using flash::round_to;
using flash::to_f;

constexpr int MAX_R = 8;         // query heads a block holds
constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int TPK = 8;           // threads that score one key together
constexpr int UNIT = 16;         // a row's split is a multiple of this many keys
constexpr int CB = 16;           // partials the combine loads ahead
constexpr int MMA_KEYS = 32;     // the least keys of a block on the tensor cores
constexpr int MAX_CLUSTER = 16;  // blocks a cluster may hold (non-portable above 8)

using hopper::cluster_arrive;
using hopper::cluster_wait;
using hopper::mapa;
using hopper::smem_u32;

// D (16 x 8, fp32) += A (16 x 16, row-major bf16 pairs) * B (16 x 8, column
// bf16 pairs): a (g = lane / 4, t = lane % 4) holds A[g][2t..], A[g + 8][2t..],
// A[g][2t + 8..], A[g + 8][2t + 8..]; b B[2t..][g], B[2t + 8..][g]; d
// D[g][2t..], D[g + 8][2t..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8 (16 bytes), and gets in r[i] the pair of matrix i that an
// mma B operand holds.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes of another block's shared memory (a shared::cluster address)
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of T as fp32
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x), f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z), f[3] = __uint_as_float(raw.w);
}

// Shared memory of one block, in bytes: K and V rows of the most keys a
// block takes (chunk), the chunk's queries [MAX_R][D] in T, the scores
// [MAX_R][chunk] and the combine's weights [MAX_R][S] in fp32.
// ops/flash_decode.py (_plan) computes the same bytes.
__host__ __device__ inline int smem_bytes(int chunk, int S, int D, int elem) {
  return 2 * chunk * D * elem + MAX_R * D * elem + MAX_R * chunk * 4 + MAX_R * S * 4;
}

// NR: query heads a block computes (a power of 2 >= the chunk's heads; the
// rows past them are zero and never stored). CL: the S blocks of a (b, g,
// chunk) form a thread-block cluster and combine through distributed shared
// memory; else through the workspace and a ticket.
template <int D, typename T, int NR, bool CL>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ pos,
                   T* __restrict__ o, float* __restrict__ ws_o, float2* __restrict__ ws_ml,
                   int* __restrict__ tickets, int G, int R, int L, int dk, int window,
                   float scale, int chunk) {
  constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte piece
  constexpr int NCH = D / VEC;          // pieces a row (8 to 32)
  constexpr int PPT = NCH / TPK;        // pieces a thread scores of its key
  constexpr int KS = THREADS / D > 1 ? THREADS / D : 1;   // key groups of the value product: 2 (D 64) or 1
  constexpr int CPT = D / THREADS > 1 ? D / THREADS : 1;  // columns a thread of it: 2 (D 256) or 1
  constexpr int CW = D / CPT;                             // threads across a row of it
  // bf16 takes the tensor cores (mma.sync) for the scores and P V of a
  // block of at least MMA_KEYS keys; fewer keys, and fp32, take FMAs
  constexpr bool MMA = sizeof(T) == 2;
  extern __shared__ uint4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);                    // [chunk][D]
  T* vs = ks + (size_t)chunk * D;                         // [chunk][D]
  T* qs = vs + (size_t)chunk * D;                         // [MAX_R][D]
  float* ps = reinterpret_cast<float*>(qs + MAX_R * D);   // [MAX_R][chunk]
  float* wts = ps + MAX_R * chunk;                        // [MAX_R][S]
  float* po = reinterpret_cast<float*>(ks);               // CL: this block's o [NR][D], K read
  __shared__ float m_s[NR], l_s[NR], lc_s[NR];
  __shared__ int last_s;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int S = gridDim.x, s = blockIdx.x, ch = blockIdx.y, bg = blockIdx.z, b = bg / G;
  const int r0 = ch * MAX_R, nr = min(NR, R - r0);
  // the row's live range [lo, hi], cut into S runs of `per` keys (a multiple
  // of 16); this block takes run s
  const int p = pos[b];
  const int hi = min(p, L - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int len = hi - lo + 1;
  const int per = len > 0 ? ((len + S - 1) / S + UNIT - 1) / UNIT * UNIT : 0;
  const int k0 = lo + s * per;
  int n = min(hi, k0 + per - 1) - k0 + 1;   // live keys of this block (<= 0: none)
  // n is opaque to the optimiser: CUDA 12.8's nvcc ran the softmax's loops
  // over j < n by 4 past their bound when it could see n's derivation
  asm volatile("" : "+r"(n));
  // the partial of head r0 + r of this block: (bg * R + r0 + r) * S + s
  const size_t part0 = ((size_t)bg * R + r0) * S;

  if (n > 0) {
    const bool mma = MMA && n >= MMA_KEYS;
    const T* kb = kc + ((size_t)bg * L + k0) * dk;
    const T* vb = vc + ((size_t)bg * L + k0) * dk;
    // the tensor-core route keeps 16-byte piece c of row j at c ^ (j % 8), so
    // that 8 rows read at one column hit 8 bank groups
    auto at = [&](int i) { return mma ? (i & ~7) | ((i ^ (i / NCH)) & 7) : i; };
    // piece c of row j: the cache's 16 bytes where c < dk / VEC, else zeros
    const bool whole = (dk * (int)sizeof(T)) % 16 == 0;
    const int nck = dk / VEC;
    auto stage = [&](T* dst, const T* src) {
      if (whole) {
        for (int i = t; i < n * NCH; i += THREADS) {
          const int j = i / NCH, c = i % NCH;
          if (c < nck)
            cp_async16(dst + at(i) * VEC, src + (size_t)j * dk + c * VEC);
          else
            *reinterpret_cast<uint4*>(dst + at(i) * VEC) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
#pragma unroll 4
        for (int i = t; i < n * D; i += THREADS) {
          const int j = i / D, c = i % D;
          dst[at(j * NCH + c / VEC) * VEC + c % VEC] =
              c < dk ? src[(size_t)j * dk + c] : from_f<T>(0.f);
        }
      }
    };
    stage(ks, kb);
    for (int i = t; i < nr * NCH; i += THREADS)
      cp_async16(qs + i * VEC, q + ((size_t)bg * R + r0) * D + i * VEC);
    cp_async_commit();
    stage(vs, vb);
    cp_async_commit();
    for (int i = nr * NCH + t; i < MAX_R * NCH; i += THREADS)
      *reinterpret_cast<uint4*>(qs + i * VEC) = make_uint4(0u, 0u, 0u, 0u);
    if (mma)   // V rows up to the next 16 keys: their probabilities are 0
      for (int i = n * NCH + t; i < ((n + 15) & ~15) * NCH; i += THREADS)
        *reinterpret_cast<uint4*>(vs + i * VEC) = make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait<1>();                 // K and q (V may still be in flight)
    __syncthreads();

    if (mma) {
      // scores on the tensor cores: S[16 x 8 keys] = Q[16 x D] K^T, heads
      // as rows (past NR zero), warp w the key tiles w, w + 4, ...
      const int g = lane / 4, t4 = lane % 4;
      uint32_t qa[D / 16][2];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(qs + g * D + 16 * kk + 2 * t4);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(qs + g * D + 16 * kk + 2 * t4 + 8);
      }
      for (int kt = warp; kt < (n + 7) / 8; kt += NW) {
        const int key = 8 * kt + g;
        const T* krow = ks + (size_t)key * D;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int pc = 2 * kk;         // pieces 2 kk and 2 kk + 1 hold d 16 kk .. + 15
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              krow + ((pc ^ (key & 7)) * VEC) + 2 * t4);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              krow + (((pc + 1) ^ (key & 7)) * VEC) + 2 * t4);
          mma_bf16(c, qa[kk][0], 0u, qa[kk][1], 0u, b0, b1);
        }
        if (g < NR) {
          ps[g * chunk + 8 * kt + 2 * t4] = c[0] * scale;
          ps[g * chunk + 8 * kt + 2 * t4 + 1] = c[1] * scale;
        }
      }
    } else {
    // scores: TPK threads a key, thread h of a key the pieces h, h + 8, ...
    // (a quarter warp reads 8 consecutive pieces of one row: no bank
    // conflict), summed across the TPK threads by shuffles
    const int h = t % TPK;
    for (int j = t / TPK; j < ((n + 3) & ~3); j += THREADS / TPK) {
      const int jj = min(j, n - 1);     // 4 keys a warp: a short tail repeats the last key
      float acc[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = 0.f;
#pragma unroll
      for (int m = 0; m < PPT; ++m) {
        const int pc = h + TPK * m;
        float kf[VEC];
        unpack(*reinterpret_cast<const uint4*>(ks + (size_t)jj * D + pc * VEC), kf);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float qf[VEC];
          unpack(*reinterpret_cast<const uint4*>(qs + r * D + pc * VEC), qf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r] = fmaf(qf[e], kf[e], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (j < n) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
          if (h == r % TPK) ps[r * chunk + j] = acc[r] * scale;
      }
    }
    }
    __syncthreads();

    // one warp a head: (m, l) of the block's keys, probabilities rounded to
    // T, and zeros up to the next multiple of 16 keys
    for (int r = warp; r < NR; r += NW) {
      float* row = ps + r * chunk;
      float mx = -INFINITY;
#pragma unroll 1
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll 1
      for (int j = lane; j < n; j += 32) {
        const float pj = expf(row[j] - mx);
        sum += pj;
        row[j] = round_to<T>(pj);
      }
      if (lane < ((n + 15) & ~15) - n) row[n + lane] = 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[r] = mx;
        l_s[r] = sum;
      }
    }
    cp_async_wait<0>();                 // V
    __syncthreads();

    if (mma) {
      // P V on the tensor cores: O[16 x D] = P[16 x n] V, warp w the columns
      // w D / 4 .. + D / 4 - 1, P's rows from the scores (bf16 already)
      constexpr int NT = D / 32;        // 8-column tiles a warp
      const int g = lane / 4, t4 = lane % 4;
      float c[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
      const float* prow = ps + min(g, NR - 1) * chunk;
      for (int k0_ = 0; k0_ < n; k0_ += 16) {
        const float2 p0 = *reinterpret_cast<const float2*>(prow + k0_ + 2 * t4);
        const float2 p1 = *reinterpret_cast<const float2*>(prow + k0_ + 2 * t4 + 8);
        const uint32_t a0 = g < NR ? pack_bf16(p0.x, p0.y) : 0u;
        const uint32_t a2 = g < NR ? pack_bf16(p1.x, p1.y) : 0u;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          // matrix l / 8 of lane l: keys k0_ + 8 ((l / 8) & 1) .., columns
          // of tile j + (l / 16)
          const int key = k0_ + 8 * ((lane / 8) & 1) + lane % 8;
          const int pc = (warp * D / 4) / 8 + j + lane / 16;
          uint32_t b[4];
          ldsm_x4_trans(smem_u32(vs + (size_t)key * D + ((pc ^ (key & 7)) * VEC)), b);
          mma_bf16(c[j], a0, 0u, a2, 0u, b[0], b[1]);
          if (j + 1 < NT) mma_bf16(c[j + 1], a0, 0u, a2, 0u, b[2], b[3]);
        }
      }
      if (g < NR) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = warp * (D / 4) + 8 * j + 2 * t4 + e;
            if constexpr (CL)
              po[g * D + col] = c[j][e];
            else if (g < nr)
              ws_o[(part0 + (size_t)g * S + s) * D + col] = c[j][e];
          }
      }
      if (!CL && t < nr) ws_ml[part0 + (size_t)t * S + s] = make_float2(m_s[t], l_s[t]);
    } else {
    // P V: thread t takes CPT columns, t % CW + CW c (CW = D / CPT), and,
    // with KS key groups, every KS-th run of 4 keys; 4 running sums a
    // (head, column) (key j into sum j % 4)
    const int kg = t / CW, n4 = n & ~3;
    float acc[NR][CPT][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = acc[r][c][3] = 0.f;
#pragma unroll 2
    for (int j = 4 * kg; j < n4; j += 4 * KS) {
      float vv[CPT][4];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[c][i] = to_f(vs[(size_t)(j + i) * D + t % CW + CW * c]);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + r * chunk + j);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[r][c][0] = fmaf(pv.x, vv[c][0], acc[r][c][0]);
          acc[r][c][1] = fmaf(pv.y, vv[c][1], acc[r][c][1]);
          acc[r][c][2] = fmaf(pv.z, vv[c][2], acc[r][c][2]);
          acc[r][c][3] = fmaf(pv.w, vv[c][3], acc[r][c][3]);
        }
      }
    }
    if (kg == 0)
      for (int j = n4; j < n; ++j) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float vv = to_f(vs[(size_t)j * D + t % CW + CW * c]);
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[r][c][0] = fmaf(ps[r * chunk + j], vv, acc[r][c][0]);
        }
      }
    float ov[NR][CPT];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        ov[r][c] = (acc[r][c][0] + acc[r][c][1]) + (acc[r][c][2] + acc[r][c][3]);
    if constexpr (KS > 1) {
      float* red = reinterpret_cast<float*>(ks);   // K is read: [NR][D]
      const int col = t % CW;
      if (kg == 1)
#pragma unroll
        for (int r = 0; r < NR; ++r) red[r * D + col] = ov[r][0];
      __syncthreads();
      if (kg == 0)
#pragma unroll
        for (int r = 0; r < NR; ++r) ov[r][0] += red[r * D + col];
    }
    if (kg == 0)
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = t % CW + CW * c;
          if constexpr (CL)
            po[r * D + col] = ov[r][c];
          else if (r < nr)
            ws_o[(part0 + (size_t)r * S + s) * D + col] = ov[r][c];
        }
    if (!CL && t < nr) ws_ml[part0 + (size_t)t * S + s] = make_float2(m_s[t], l_s[t]);
    }
  } else if constexpr (CL) {
    for (int i = t; i < NR * D; i += THREADS) po[i] = 0.f;
    if (t < NR) {
      m_s[t] = -INFINITY;
      l_s[t] = 0.f;
    }
  } else {
    // an empty partial, written whole so that the combine reads only what
    // this launch wrote (it stays in L2)
    for (int i = t; i < nr * D; i += THREADS)
      ws_o[(part0 + (size_t)(i / D) * S + s) * D + i % D] = 0.f;
    if (t < nr) ws_ml[part0 + (size_t)t * S + s] = make_float2(-INFINITY, 0.f);
  }

  constexpr int NP = (NR * D + THREADS - 1) / THREADS;   // (head, column) pairs a thread
  constexpr int KB = NP < 8 ? NP : 8;                      // pairs a cluster-combine load batch
  if constexpr (CL) {
    // the combine inside the cluster: block 0 reads every block's (m, l) and
    // o from its shared memory (all loads of a thread at once), weights and
    // sums them in block order as below; a second cluster barrier keeps
    // every block alive until block 0 has read it
    cluster_arrive();
    cluster_wait();
    if (s == 0) {
      for (int r = warp; r < nr; r += NW) {
        float mj = -INFINITY, lj = 0.f;
        if (lane < S) {
          mj = ld_cluster(mapa(smem_u32(m_s + r), lane));
          lj = ld_cluster(mapa(smem_u32(l_s + r), lane));
        }
        float m = lj > 0.f ? mj : -INFINITY;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const float w = lj > 0.f ? expf(mj - m) : 0.f;
        if (lane < S) wts[r * S + lane] = w;
        float l = w * lj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) lc_s[r] = l;
      }
      // the pairs in batches of KB, all loads of a batch at once (the
      // first batch's before the barrier that publishes the weights)
      float x[KB][MAX_CLUSTER];
#pragma unroll 1
      for (int k0 = 0; k0 < NP; k0 += KB) {
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          const uint32_t a = smem_u32(po + min(t + (k0 + k) * THREADS, NR * D - 1));
#pragma unroll
          for (int j = 0; j < MAX_CLUSTER; ++j) x[k][j] = j < S ? ld_cluster(mapa(a, j)) : 0.f;
        }
        if (k0 == 0) __syncthreads();
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          const int u = t + (k0 + k) * THREADS, r = u / D;
          if (r >= nr) continue;
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < MAX_CLUSTER; ++j)
            if (j < S) acc = fmaf(wts[r * S + j], x[k][j], acc);
          const float l = lc_s[r];
          o[((size_t)bg * R + r0 + r) * D + u % D] = from_f<T>(l == 0.f ? 0.f : acc / l);
        }
      }
    }
    cluster_arrive();
    cluster_wait();
    return;
  }

  // the ticket (the pattern of cooperative groups' grid barrier: the
  // block's stores, a block barrier, one thread's fence and atomic; the
  // barrier orders the other threads' stores before the fence): the block
  // that completes the (b, g, chunk) combines
  __syncthreads();
  int* ticket = tickets + (size_t)bg * gridDim.y + ch;
  if (t == 0) {
    __threadfence();
    const int last = atomicAdd(ticket, 1) == S - 1;
    if (last) {
      __threadfence();
      *ticket = 0;                      // for the next launch
    }
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;

  // the combine. Thread t takes (head, column) pairs u = t + THREADS k and
  // loads the first CB blocks' o of its first pairs at once; meanwhile one
  // warp a head loads the S (m, l), takes m the largest m_s of a block with a
  // live key, the weights w_s = exp(m_s - m) (0 for a block with none) and
  // l the weighted sum of l_s; then each pair sums w_s o_s in block order,
  // CB partials a load batch.
  constexpr int NPF = NP < 2 ? NP : 2;                    // pairs loaded ahead
  float x0[NPF][CB];
#pragma unroll
  for (int k = 0; k < NPF; ++k) {
    const int u = t + k * THREADS, r = min(u / D, nr - 1);
#pragma unroll
    for (int i = 0; i < CB; ++i)
      x0[k][i] = i < S ? __ldcg(ws_o + (part0 + (size_t)r * S + i) * D + u % D) : 0.f;
  }
  for (int r = warp; r < nr; r += NW) {
    const float2* ml = ws_ml + part0 + (size_t)r * S;
    const float2 v0 = lane < S ? __ldcg(ml + lane) : make_float2(-INFINITY, 0.f);
    float m = v0.y > 0.f ? v0.x : -INFINITY;
    for (int j = lane + 32; j < S; j += 32) {
      const float2 v = __ldcg(ml + j);
      if (v.y > 0.f) m = fmaxf(m, v.x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    if (lane < S) {
      const float w = v0.y > 0.f ? expf(v0.x - m) : 0.f;
      wts[r * S + lane] = w;
      l = w * v0.y;
    }
    for (int j = lane + 32; j < S; j += 32) {
      const float2 v = __ldcg(ml + j);
      const float w = v.y > 0.f ? expf(v.x - m) : 0.f;
      wts[r * S + j] = w;
      l += w * v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) l_s[r] = l;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int u = t + k * THREADS, r = u / D, col = u % D;
    if (r >= nr) continue;
    const float* w = wts + r * S;
    const float* src = ws_o + (part0 + (size_t)r * S) * D + col;
    float acc = 0.f;
    for (int j0 = 0; j0 < S; j0 += CB) {
      float xb[CB];
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        if (k < NPF && j0 == 0)
          xb[i] = x0[k < NPF ? k : 0][i];
        else
          xb[i] = j0 + i < S ? __ldcg(src + (size_t)(j0 + i) * D) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < CB; ++i)
        if (j0 + i < S) acc = fmaf(w[j0 + i], xb[i], acc);
    }
    const float l = l_s[r];
    o[((size_t)bg * R + r0 + r) * D + col] = from_f<T>(l == 0.f ? 0.f : acc / l);
  }
}

template <int D, typename T, int NR, bool CL>
int launch(const void* q, const void* k, const void* v, const void* pos, void* o, void* ws_o,
           void* ws_ml, void* tickets, int B, int G, int R, int L, int dk, int window,
           float scale, int S, int chunk, int smem, cudaStream_t s) {
  auto kernel = flash_decode_split<D, T, NR, CL>;
  static int smem_set = 0;   // the attributes are set once per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && CL)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (R + MAX_R - 1) / MAX_R, B * G);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = CL ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos), static_cast<T*>(o),
      static_cast<float*>(ws_o), static_cast<float2*>(ws_ml), static_cast<int*>(tickets), G, R,
      L, dk, window, scale, chunk);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D, typename T>
int route(int R, const void* q, const void* k, const void* v, const void* pos, void* o,
          void* ws_o, void* ws_ml, void* tickets, int B, int G, int L, int dk, int window,
          float scale, int S, int chunk, int cluster, int smem, cudaStream_t s) {
#define ARGS q, k, v, pos, o, ws_o, ws_ml, tickets, B, G, R, L, dk, window, scale, S, chunk, \
             smem, s
#define BY_R(CL)                                  \
  if (R == 1) return launch<D, T, 1, CL>(ARGS);   \
  if (R == 2) return launch<D, T, 2, CL>(ARGS);   \
  if (R <= 4) return launch<D, T, 4, CL>(ARGS);   \
  return launch<D, T, 8, CL>(ARGS);
  if (cluster) {
    BY_R(true)
  }
  BY_R(false)
#undef BY_R
#undef ARGS
}

}  // namespace

// D: the width the kernel runs at (64, 128 or 256), dk: the cache's head size (1 ..
// D); q and o are [B, G, R, D], the caches [B, G, L, dk].
// f32: 0 for bf16 operands, 1 for fp32; any R >= 1 (a grid axis over chunks
// of MAX_R query heads). S blocks a (row, group, chunk of heads), each taking
// at most `chunk` keys (a multiple of 16, S * chunk >= L); cluster: 1 to
// combine through a cluster of the S blocks (S <= 16), 0 through the
// workspaces. ws_o [B, G, R, S, D] and ws_ml [B, G, R, S] (float2) fp32
// workspaces; tickets [B, G, chunks] int32, zero before the first launch and
// left zero by every launch; smem must equal the block's bytes. The wrapper's
// plan (ops/flash_decode.py _plan) picks S, chunk and cluster.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* pos, void* o, void* ws_o, void* ws_ml,
                                   void* tickets, int B, int G, int R, int L, int D,
                                   int dk, int window, float scale, int f32, int S, int chunk,
                                   int cluster, int smem, void* stream) {
  if (B < 1 || G < 1 || R < 1 || L < 1 || S < 1 || B * G > 65535 || chunk < UNIT ||
      dk < 1 || dk > D ||
      chunk % UNIT || (long long)S * chunk < L || (cluster && S > MAX_CLUSTER) ||
      smem != smem_bytes(chunk, S, D, f32 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS R, q, k, v, pos, o, ws_o, ws_ml, tickets, B, G, L, dk, window, scale, S, chunk, \
             cluster, smem, s
  if (D == 256) return f32 ? route<256, float>(ARGS) : route<256, flash::bf16>(ARGS);
  if (D == 128) return f32 ? route<128, float>(ARGS) : route<128, flash::bf16>(ARGS);
  if (D == 64) return f32 ? route<64, float>(ARGS) : route<64, flash::bf16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
