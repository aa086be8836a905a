// Fused tied-head forward for Hopper (sm_90a): per-token logsumexp and gold
// logit of logits = h @ emb^T, without materialising the [T, V] logits.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/fused_head_loss.py:76).
// Layout: h [T, E] and emb [V, E], both bf16 or both fp32 (E a multiple of 8
// for bf16, of 4 for fp32: the wrapper zero-pads other E, a zero column adds
// 0 to every logit), tgt [T] int32, lse and gold [T] fp32, all contiguous.
// gold is the logit at column tgt, 0 for a target outside [0, V).
//
// Bound: operations (2 T V E FLOP; at T 8192, V 32000, E 1024 that is 537
// GFLOP against 82 MB of bf16 operands). So each route is a GEMM S = H E^T
// (M = T, N = V, K = E) whose epilogue is the online softmax fold. The bf16
// route, head_fwd_wgmma:
//
// - A block owns 128 token rows and walks a range of 128-column vocabulary
//   tiles. For each tile, E streams in 128-column chunks (two 64-column
//   slabs; chunks of one slab ran slower) of h and emb through
//   a ring of three TMA stages (128-byte swizzle; rows past T or V and
//   columns past E arrive as zeros), fed by a ninth, producer warp (a warp,
//   not a warpgroup: 288 threads leave a thread 224 registers, and two
//   accumulators of 64 take 128). Its role comes from a shuffled warp index,
//   which ptxas knows to be warp-uniform: issued under a branch on
//   threadIdx.x, every wgmma of the kernel is serialised (C7518). Each of
//   the two consumer warpgroups multiplies its 64 rows by the tile with
//   wgmma m64n128k16 (both operands K-major) into fp32 registers.
// - The fold runs on the accumulators in registers: in wgmma's layout a
//   row's 128 columns sit in the four threads of a quad, so its tile max and
//   sum of exponentials take two shuffles each. The running (m, s, gold) of
//   a thread's two rows stay in registers across tiles; s rescales by
//   exp(m_old - m_new), exponentials as exp2 of log2(e)-scaled values.
//   Columns past V are -inf before the max. No accumulator is read or
//   written under a condition that differs between threads (ptxas would
//   serialise every wgmma), so gold is not picked out of the accumulators:
//   after the loop, the block whose range holds a row's target forms that
//   logit as an fp32 dot product of the two bf16 rows, one warp a row.
// - Tiles alternate between two accumulator sets: the next tile's first two
//   chunks are issued before the previous tile's fold, so the fold runs
//   while the tensor cores work.
// - At 64 token tiles (T 8192) the card has more SMs than tiles, so V is cut
//   into `ranges` ranges of whole tiles and each (token tile, range) block
//   leaves partial (m, s, gold) per row in a workspace. The last block of a
//   token tile to finish (an atomic ticket, reset by that block) combines
//   them in range order, a range with m = -inf adding nothing: the same bits
//   on every launch. Blocks are numbered range-major, so the blocks running
//   together read the same part of the table.
//
// The fp32 route, head_fwd_fma, multiplies in fp32 FMAs: no TF32 (3xTF32
// included), since the route exists to match the plain version's full-fp32
// products, whose peak is 67 TF/s (8.0 ms at the shape above). It is an
// SGEMM with the same epilogue, and needs no cluster: unlike dh and dE
// (fused_head_fma.cuh) it has no second product that wants a resident E
// slice, so E streams as the K loop.
//
// - The same blocks, ranges and combine: 128 token rows walking a range of
//   128-column vocabulary tiles, a (token tile, range) block a workspace
//   slot, the last block of a token tile combining them.
// - For each tile, E streams in 64-column chunks of h and emb (two fp32
//   boxes of 32 columns, 128-byte rows and swizzle, each; rows past T or V
//   and columns past E arrive as zeros) through a 3-stage TMA ring. Each
//   stage boundary costs the block time (a wait, a release, the loads that
//   no earlier products hide): one slab a stage over 4 stages measured
//   14.60 ms at the shape above, two over 3 stages 13.38 on an H100; a
//   deeper ring, or a refill probing with mbarrier.test_wait, which never
//   suspends the thread, changed nothing.
//   Thread 0 issues the copies between its own products, each stage once
//   every warp has released it: with no producer warp a thread may hold 255
//   registers.
// - 256 threads each hold an 8 x 8 logits tile: rows g + 16 i, columns
//   x + 16 j (g = thread / 16, x = thread % 16). A thread's rows share r % 8,
//   and so do its columns, so the swizzle is one XOR an operand; it reads
//   float4 along E, a warp's h loads broadcast (two rows) and its emb loads
//   hit 8 distinct 16-byte bank groups. 16 FMAs a 16-byte load.
// - The fold stays in the thread: each keeps its own running (m, s) for its
//   8 rows over its own columns across every tile of its range, and picks
//   gold out of its accumulators when it holds the target column. The 16
//   threads of a row combine once, at the end of the range, by shuffles in
//   a fixed order. A tile costs 72 exponentials a thread beside 64 E FMAs.
//
// ops/fused_head_loss.py (_fwd_plan) picks the ranges; each launcher checks
// the plan's stages and shared-memory bytes against its own.

#include <climits>

#include "fused_head_common.cuh"

using namespace fused_head;

namespace {

constexpr int FBM = 128;                 // token rows a block
constexpr int FBN = 128;                 // vocabulary columns a tile
constexpr int SLABS = 2;                 // 64-column slabs a ring stage
constexpr int FK = 64 * SLABS;           // E columns a ring stage
constexpr int H_SLAB = FBM * 128;        // bytes of a 64-column slab of h rows
constexpr int E_SLAB = FBN * 128;        // bytes of a 64-column slab of emb rows
constexpr int H_STAGE = SLABS * H_SLAB;  // bytes of a stage's h chunk
constexpr int E_STAGE = SLABS * E_SLAB;  // bytes of a stage's emb chunk
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of head_fwd_wgmma in bytes: 1024 of alignment slack, the
// ring (each stage an h chunk then an emb chunk, both 1024-aligned), then the
// full and empty mbarriers of every stage; ST stages, as many as fit (a
// depth read at run time measured slower).
constexpr int fwd_smem_bytes(int stages) { return 1024 + stages * (H_STAGE + E_STAGE) + 16 * stages; }
constexpr int ST = 3;
static_assert(fwd_smem_bytes(ST) <= 232448 && fwd_smem_bytes(ST + 1) > 232448, "ring depth");

// The last of token tile tt's S blocks to finish (an atomic ticket, reset by
// that block) combines the partial (m, s, gold) of its FBM rows that each
// block left in ws ([tt * S + r][3][FBM]), in range order, a range with m =
// -inf adding nothing: the same bits whichever block is last. Every thread
// of the block calls it once its own partials are stored.
__device__ __forceinline__ void combine_ranges(const float* ws, int* tickets, float* lse,
                                               float* gold, int tt, int S, int T) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + tt, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int row = threadIdx.x, t = tt * FBM + row;
  if (row < FBM && t < T) {
    const float* p = ws + (size_t)tt * S * 3 * FBM;
    float mm = -INFINITY;
    for (int q = 0; q < S; ++q) mm = fmaxf(mm, __ldcg(p + q * 3 * FBM + row));
    float ss = 0.f, gg = 0.f;
    for (int q = 0; q < S; ++q) {
      const float mq = __ldcg(p + q * 3 * FBM + row);
      if (mq != -INFINITY) ss += __ldcg(p + q * 3 * FBM + FBM + row) * exp2f((mq - mm) * LOG2E);
      gg += __ldcg(p + q * 3 * FBM + 2 * FBM + row);
    }
    lse[t] = mm + logf(ss);
    gold[t] = gg;
  }
  if (threadIdx.x == 0) tickets[tt] = 0;
}

// The ring of one block: the producer warp fills it, every consumer warp
// releases its stages.
// Member functions only (all inlined), so that no accumulator passed to them
// by reference leaves the registers.
struct FwdRing {
  const CUtensorMap* th;
  const CUtensorMap* te;
  uint32_t s_base, bar0;
  int n, nk, vt0, t0;
  int rel;

  __device__ __forceinline__ uint32_t full(int st) const { return bar0 + 8 * st; }
  __device__ __forceinline__ uint32_t empty(int st) const { return bar0 + 8 * (ST + st); }
  __device__ __forceinline__ uint32_t tile(int st) const {
    return s_base + st * (H_STAGE + E_STAGE);
  }

  // the producer warp's lane 0: every item of the block, each as soon as its
  // stage is free
  __device__ __forceinline__ void produce() {
    for (int j = 0; j < n; ++j) {
      const int sj = j % ST;
      mbar_wait(empty(sj), ((j / ST) & 1) ^ 1);
      const int v0 = (vt0 + j / nk) * FBN, k0 = (j % nk) * FK;
      mbar_expect_tx(full(sj), H_STAGE + E_STAGE);
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load(tile(sj) + sl * H_SLAB, th, k0 + 64 * sl, 0, t0, 0, full(sj));
        tma_load(tile(sj) + H_STAGE + sl * E_SLAB, te, k0 + 64 * sl, 0, v0, 0, full(sj));
      }
    }
  }

  // a stage is free once every consumer warp has read it: lane 0 of each
  // warp arrives for its warp
  __device__ __forceinline__ void release_upto(int upto, int lane) {
    for (; rel < upto; ++rel)
      if (lane == 0) mbar_arrive(empty(rel % ST));
    __syncwarp();
  }

  // S (+)= H_k E_k^T for item it (chunk k of its tile) into warpgroup wg's
  // accumulators, asynchronous
  __device__ __forceinline__ void issue(float (&d)[64], int it, int k, int wg) {
    const int st = it % ST;
    mbar_wait(full(st), (it / ST) & 1);
    const uint32_t a = tile(st) + wg * 64 * 128, b = tile(st) + H_STAGE;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * SLABS; ++kk)
      wgmma_ss_n128(d, desc_k(a, H_SLAB, kk), desc_k(b, E_SLAB, kk), k > 0 || kk > 0);
    wgmma_commit();
  }
};

// The running (max, sum) of a thread's rows row0 and row0 + 8.
struct FwdRows {
  float m[2], s[2];
};

// The fold of a finished tile d into the rows' running state. d[4 j + 2 i
// + e] is row row0 + 8 i, column 8 j + 2 t4 + e; with MASK, the columns
// 8 j + e >= lim lie past V and count as -inf. The accumulators are only
// read: an accumulator written by any other instruction, or under a
// condition that differs between the threads of a warpgroup, makes ptxas
// serialise every wgmma of the kernel (C7515, C7518). So the mask is a
// select at each read, and gold is not picked from the accumulators but
// formed after the loop.
template <bool MASK>
__device__ __forceinline__ void fold_tile_regs(const float (&d)[64], int lim, FwdRows& rs) {
  auto at = [&](int j, int i, int e) {
    const float x = d[4 * j + 2 * i + e];
    return MASK && 8 * j + e >= lim ? -INFINITY : x;
  };
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(at(j, ii, 0), at(j, ii, 1)));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(rs.m[ii], mx);       // column v0 < V is in every tile: finite
    const float ms = mn * LOG2E;
    float se = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      se += exp2f(fmaf(at(j, ii, 0), LOG2E, -ms));
      se += exp2f(fmaf(at(j, ii, 1), LOG2E, -ms));
    }
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    se += __shfl_xor_sync(0xffffffffu, se, 2);
    rs.s[ii] = rs.s[ii] * exp2f((rs.m[ii] - mn) * LOG2E) + se;
    rs.m[ii] = mn;
  }
}

// The fold of the finished tile d of columns v0 .. v0 + 127; only the tile
// that holds V's end masks (a branch the whole block takes alike).
__device__ __forceinline__ void fold(const float (&d)[64], int v0, int V, int t4, FwdRows& rs) {
  if (v0 + FBN > V)
    fold_tile_regs<true>(d, V - v0 - 2 * t4, rs);
  else
    fold_tile_regs<false>(d, 0, rs);
}

// The logit h[t] . emb[x] in fp32 from bf16 rows of E (a multiple of 8)
// columns: lane l takes the 8-column groups l, l + 32, ..., then the warp's
// sum by shuffles; the same order on every run.
__device__ __forceinline__ float row_dot(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                                         int t, int x, int E, int lane) {
  const uint4* hp = reinterpret_cast<const uint4*>(h + (size_t)t * E);
  const uint4* ep = reinterpret_cast<const uint4*>(emb + (size_t)x * E);
  float acc = 0.f;
  for (int c = lane; c < E / 8; c += 32) {
    const uint4 a = __ldg(hp + c), b = __ldg(ep + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]), fb = __bfloat1622float2(b2[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// Tile j of the block's range into cur. After its second chunk is issued
// (its first where the tile has one chunk) the previous tile's last group is
// waited for, its stages released, and prev folded while the tensor cores
// run the issued chunks; where that chunk is the tile's last, the groups
// before it are waited for and released too, so that no more than ST items
// are ever held (a tile of two chunks would otherwise hold its first into
// the next tile, whose second chunk then waits for a fourth stage).
// Otherwise the group before the newest is waited for and released. `it`
// counts the items consumed; tests/test_torch_head_plan.py replays this
// schedule for every chunk count.
__device__ __forceinline__ void run_tile(FwdRing& ring, FwdRows& rs, float (&cur)[64],
                                         float (&prev)[64], int j, int& it, int V, int wg,
                                         int t4, int lane) {
  for (int k = 0; k < ring.nk; ++k, ++it) {
    ring.issue(cur, it, k, wg);
    if (j > 0 && k == min(1, ring.nk - 1)) {
      const bool last = k == ring.nk - 1;
      if (last)
        wgmma_wait<1>();
      else
        wgmma_wait<2>();
      fence_regs(prev);
      ring.release_upto(last ? it : it - 1, lane);
      fold(prev, (ring.vt0 + j - 1) * FBN, V, t4, rs);
    } else if (k > 0 || j == 0) {
      wgmma_wait<1>();
      ring.release_upto(it, lane);
    }
  }
}

__global__ void __launch_bounds__(288, 1)
head_fwd_wgmma(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap te,
               const bf16* __restrict__ h, const bf16* __restrict__ emb,
               const int* __restrict__ tgt, float* __restrict__ lse, float* __restrict__ gold,
               float* __restrict__ ws, int* __restrict__ tickets, int T, int V, int E,
               int S) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float gold_s[FBM];
  const int ntt = (T + FBM - 1) / FBM;
  const int tt = blockIdx.x % ntt, r = blockIdx.x / ntt;
  const int nv = (V + FBN - 1) / FBN;
  const int t0 = tt * FBM;

  FwdRing ring;
  ring.th = &th;
  ring.te = &te;
  ring.s_base = smem_u32(align1024(smem_raw));
  ring.bar0 = ring.s_base + ST * (H_STAGE + E_STAGE);
  ring.nk = (E + FK - 1) / FK;
  ring.vt0 = (int)((long long)nv * r / S);
  const int vt1 = (int)((long long)nv * (r + 1) / S);
  const int ntiles = vt1 - ring.vt0;
  ring.n = ntiles * ring.nk;                           // ring items: (tile, chunk)
  ring.t0 = t0;
  ring.rel = 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(ring.full(st), 1);
      mbar_init(ring.empty(st), 8);                    // each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // ---- warp 8 produces; warpgroup wg < 2 owns rows 64 wg .. 64 wg + 63, a
  // thread rows row0 and row0 + 8, columns 8 j + 2 t4 + e of each tile
  // the role from a shuffled warp index, which ptxas knows is the same across
  // the warp: a branch on threadIdx.x would put every wgmma in a divergent
  // path, and ptxas then serialises them (C7518)
  const int warp_idx = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int wg = warp_idx / 4, warp = warp_idx % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = wg * 64 + 16 * warp + g;
  const bool consumer = warp_idx < 8;
  FwdRows rs;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    rs.m[ii] = -INFINITY;
    rs.s[ii] = 0.f;
  }

  if (!consumer) {
    if (lane == 0) ring.produce();
  } else {
    float acc0[64], acc1[64];
    int it = 0;
    for (int j = 0; j < ntiles; j += 2) {
      run_tile(ring, rs, acc0, acc1, j, it, V, wg, t4, lane);
      if (j + 1 < ntiles) run_tile(ring, rs, acc1, acc0, j + 1, it, V, wg, t4, lane);
    }
    wgmma_wait<0>();
    if (ntiles > 0) {
      ring.release_upto(ring.n, lane);
      if (ntiles & 1) {
        fence_regs(acc0);
        fold(acc0, (vt1 - 1) * FBN, V, t4, rs);
      } else {
        fence_regs(acc1);
        fold(acc1, (vt1 - 1) * FBN, V, t4, rs);
      }
    }
  }
  // gold of the rows whose target lies in this block's range (0 for the
  // others, and for a target outside [0, V)): warp w takes rows w, w + 8, ...
  const int c_lo = ring.vt0 * FBN, c_hi = min(vt1 * FBN, V);
  for (int row = warp_idx; consumer && row < FBM; row += 8) {
    const int t = t0 + row;
    const int x = t < T ? tgt[t] : -1;
    gold_s[row] = x >= c_lo && x < c_hi ? row_dot(h, emb, t, x, E, lane) : 0.f;
  }
  __syncthreads();
  {
    if (consumer && t4 == 0) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = row0 + 8 * ii, t = t0 + row;
        if (S == 1) {
          if (t < T) {
            lse[t] = rs.m[ii] + logf(rs.s[ii]);
            gold[t] = gold_s[row];
          }
        } else {
          float* p = ws + (size_t)(tt * S + r) * 3 * FBM;
          p[row] = rs.m[ii];
          p[FBM + row] = rs.s[ii];
          p[2 * FBM + row] = gold_s[row];
        }
      }
    }
    if (S > 1) combine_ranges(ws, tickets, lse, gold, tt, S, T);
  }
}

int launch_fwd_wgmma(const void* h, const void* emb, const void* tgt, void* lse, void* gold,
                     void* ws, void* tickets, int T, int V, int E, int ranges, int stages,
                     int smem, cudaStream_t stream) {
  const int nv = (V + FBN - 1) / FBN, ntt = (T + FBM - 1) / FBM;
  if (E % 8 != 0 || ranges < 1 || ranges > nv || (ranges > 1 && (!ws || !tickets)) ||
      stages != ST || smem != fwd_smem_bytes(ST))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(head_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap th, te;
  int err = make_map(&th, h, E, 1, T, 1, FBM);
  if (!err) err = make_map(&te, emb, E, 1, V, 1, FBN);
  if (err) return err;
  head_fwd_wgmma<<<ntt * ranges, 288, smem, stream>>>(
      th, te, static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
      static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
      static_cast<float*>(ws), static_cast<int*>(tickets), T, V, E, ranges);
  return (int)cudaGetLastError();
}

// ---- the fp32 route: register-tiled fp32 FMAs fed by TMA

namespace fwd32 {

constexpr int SLABS = 2;                 // 32-column fp32 slabs (128-byte rows) of a chunk
constexpr int CHUNK = 32 * SLABS;        // E columns a ring stage
constexpr int SLAB = FBM * 32 * 4;       // bytes of a slab of h (or emb) rows
constexpr int STAGE = 2 * SLABS * SLAB;  // bytes of a stage: the h chunk, then the emb chunk
constexpr int STAGES = 3;
constexpr int THR = 256;
constexpr int RI = FBM / 16;             // logits rows a thread
constexpr int CJ = FBN / 16;             // logits columns a thread

// Shared memory of head_fwd_fma in bytes: 1024 of alignment slack, the ring
// (each stage an h chunk then an emb chunk), then the full and empty
// mbarriers of every stage. ops/fused_head_loss.py (_fwd_smem) sums the
// same bytes.
constexpr int smem_bytes() { return 1024 + STAGES * STAGE + 16 * STAGES; }
static_assert(FBM == FBN && smem_bytes() <= 232448, "the ring must fit a block");

__global__ void __launch_bounds__(THR, 1)
head_fwd_fma(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap te,
             const int* __restrict__ tgt, float* __restrict__ lse, float* __restrict__ gold,
             float* __restrict__ ws, int* __restrict__ tickets, int T, int V, int E, int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const float* fs = reinterpret_cast<const float*>(smem);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar0 = s_base + STAGES * STAGE;
  auto full = [&](int st) { return bar0 + 8 * st; };
  auto empty = [&](int st) { return bar0 + 8 * (STAGES + st); };

  const int ntt = (T + FBM - 1) / FBM;
  const int tt = blockIdx.x % ntt, r = blockIdx.x / ntt;
  const int nv = (V + FBN - 1) / FBN;
  const int t0 = tt * FBM;
  const int vt0 = (int)((long long)nv * r / S), vt1 = (int)((long long)nv * (r + 1) / S);
  const int nk = (E + CHUNK - 1) / CHUNK;
  const int n = (vt1 - vt0) * nk;                   // ring items: (tile, chunk)

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), THR / 32);                 // each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues item `must` (waiting for its stage) and every later
  // item whose stage is already free, up to STAGES ahead
  int issued = 0;
  auto refill = [&](int must) {
    while (issued < n && issued < must + STAGES) {
      const int j = issued, sj = j % STAGES;
      const int parity = ((j / STAGES) & 1) ^ 1;
      if (j > must && !mbar_try_wait(empty(sj), parity)) break;
      mbar_wait(empty(sj), parity);
      const int v0 = (vt0 + j / nk) * FBN, k0 = (j % nk) * CHUNK;
      const uint32_t dst = s_base + sj * STAGE;
      mbar_expect_tx(full(sj), STAGE);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load(dst + sl * SLAB, &th, k0 + 32 * sl, 0, t0, 0, full(sj));
        tma_load(dst + (SLABS + sl) * SLAB, &te, k0 + 32 * sl, 0, v0, 0, full(sj));
      }
      ++issued;
    }
  };

  // rows g + 16 i, columns x + 16 j of each tile; the 16 threads of a row
  // are one half of a warp
  const int g = threadIdx.x >> 4, x = threadIdx.x & 15, lane = threadIdx.x & 31;
  float m[RI], s[RI], gl[RI];
  int yx[RI];                                       // target - x, or never a column
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = t0 + g + 16 * i;
    const int y = t < T ? __ldg(tgt + t) : -1;
    yx[i] = y >= 0 && y < V ? y - x : INT_MIN / 2;
    m[i] = -INFINITY;
    s[i] = gl[i] = 0.f;
  }
  float acc[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // row r of a slab holds its 16-byte chunk c at c ^ (r % 8): a thread's rows
  // share g % 8 and its columns x % 8
  const float* hb = fs + g * 32;
  const float* eb = fs + SLABS * SLAB / 4 + x * 32;
  const int kh = g & 7, ke = x & 7;
  int it = 0;
  for (int tile = vt0; tile < vt1; ++tile) {
    for (int k = 0; k < nk; ++k, ++it) {
      const int st = it % STAGES;
      if (threadIdx.x == 0) refill(it);
      __syncwarp();
      mbar_wait(full(st), (it / STAGES) & 1);
      for (int sl = 0; sl < SLABS; ++sl) {          // E in order: slab, 16-byte chunk, element
        const float* hs = hb + (st * STAGE + sl * SLAB) / 4;
        const float* es = eb + (st * STAGE + sl * SLAB) / 4;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float4 ev[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            ev[j] = *reinterpret_cast<const float4*>(es + j * 16 * 32 + 4 * (c ^ ke));
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float4 hv = *reinterpret_cast<const float4*>(hs + i * 16 * 32 + 4 * (c ^ kh));
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              acc[i][j] = fmaf(hv.x, ev[j].x, acc[i][j]);
              acc[i][j] = fmaf(hv.y, ev[j].y, acc[i][j]);
              acc[i][j] = fmaf(hv.z, ev[j].z, acc[i][j]);
              acc[i][j] = fmaf(hv.w, ev[j].w, acc[i][j]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    // the fold of the finished tile into this thread's (m, s, gold); columns
    // past V count as -inf (only the tile that holds V's end has them)
    const int v0 = tile * FBN;
    const bool edge = v0 + FBN > V;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (edge && v0 + x + 16 * j >= V) acc[i][j] = -INFINITY;
        mx = fmaxf(mx, acc[i][j]);
      }
      const float mn = fmaxf(m[i], mx);
      if (mn != -INFINITY) {                        // some column of this thread's is < V
        const float ms = mn * LOG2E;
        float se = 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) se += exp2f(fmaf(acc[i][j], LOG2E, -ms));
        s[i] = s[i] * exp2f((m[i] - mn) * LOG2E) + se;
        m[i] = mn;
      }
      const int rel = yx[i] - v0;                   // the target is column x + rel of the tile
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (rel == 16 * j) gl[i] = acc[i][j];
        acc[i][j] = 0.f;
      }
    }
  }
  // the row's 16 threads combine in a fixed order (a butterfly: every one
  // ends with the same sums, each a commutative pair)
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o *= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      gl[i] += __shfl_xor_sync(0xffffffffu, gl[i], o);
      const float mn = fmaxf(m[i], m2);
      s[i] = mn == -INFINITY ? 0.f
                             : s[i] * exp2f((m[i] - mn) * LOG2E) + s2 * exp2f((m2 - mn) * LOG2E);
      m[i] = mn;
    }
  }
  if (x == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = g + 16 * i, t = t0 + row;
      if (S == 1) {
        if (t < T) {
          lse[t] = m[i] + logf(s[i]);
          gold[t] = gl[i];
        }
      } else {
        float* p = ws + (size_t)(tt * S + r) * 3 * FBM;
        p[row] = m[i];
        p[FBM + row] = s[i];
        p[2 * FBM + row] = gl[i];
      }
    }
  }
  if (S > 1) combine_ranges(ws, tickets, lse, gold, tt, S, T);
}

}  // namespace fwd32

int launch_fwd_fma(const void* h, const void* emb, const void* tgt, void* lse, void* gold,
                   void* ws, void* tickets, int T, int V, int E, int ranges, int stages, int smem,
                   cudaStream_t stream) {
  const int nv = (V + FBN - 1) / FBN, ntt = (T + FBM - 1) / FBM;
  if (E % 4 != 0 || ranges < 1 || ranges > nv || (ranges > 1 && (!ws || !tickets)) ||
      stages != fwd32::STAGES || smem != fwd32::smem_bytes())
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fwd32::head_fwd_fma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap th, te;
  int err = make_map(&th, h, E, 1, T, 1, FBM, true);
  if (!err) err = make_map(&te, emb, E, 1, V, 1, FBN, true);
  if (err) return err;
  fwd32::head_fwd_fma<<<ntt * ranges, fwd32::THR, smem, stream>>>(
      th, te, static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
      static_cast<float*>(ws), static_cast<int*>(tickets), T, V, E, ranges);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 h and emb (head_fwd_wgmma), 1 for fp32 (head_fwd_fma).
// Each kernel takes the plan's ranges, ring stages and shared-memory bytes
// (checked against its own); ws holds ceil(T / 128) * ranges * 3 * 128
// floats and tickets ceil(T / 128) zeroed int32 where ranges > 1 (the kernel
// leaves every ticket at 0).
extern "C" int fused_head_fwd_launch(const void* h, const void* emb, const void* tgt,
                                     void* lse, void* gold, void* ws, void* tickets, int T,
                                     int V, int E, int f32, int ranges, int stages, int smem,
                                     void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return launch_fwd_fma(h, emb, tgt, lse, gold, ws, tickets, T, V, E, ranges, stages, smem, s);
  return launch_fwd_wgmma(h, emb, tgt, lse, gold, ws, tickets, T, V, E, ranges, stages, smem, s);
}
