// Fused tied-head forward for Hopper (sm_90a): per-token logsumexp and gold
// logit of logits = h @ emb^T, without materialising the [T, V] logits.
//
// Replaces the Pallas kernel _fwd_kernel (kubeflow_tpu/ops/fused_head_loss.py:76).
// Layout: h [T, E] bf16, emb [V, E] bf16 (E a multiple of 8: the wrapper
// zero-pads other E, a zero column adds 0 to every logit), tgt [T] int32,
// lse and gold [T] fp32, all contiguous. gold is the logit at column tgt, 0
// for a target outside [0, V).
//
// Bound: operations (2 T V E FLOP; at T 8192, V 32000, E 1024 that is 537
// GFLOP against 82 MB of operands). So the kernel is a bf16 GEMM S = H E^T
// (M = T, N = V, K = E) whose epilogue is the online softmax fold:
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
// ops/fused_head_loss.py (_fwd_plan) picks the ranges; the launcher checks
// the plan's stages and shared-memory bytes against its own.
//
// fp32 h and emb take the scalar kernel head_fwd_scalar (fused_head_scalar.cuh):
// the same fold over logits tiles of fp32 FMAs, one block per 64 tokens.

#include "fused_head_scalar.cuh"

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
  __shared__ int last;
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
    if (S > 1) {
      // the last of the token tile's S blocks combines the partials
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(tickets + tt, 1) == S - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        const int row = threadIdx.x, t = t0 + row;
        if (row < FBM && t < T) {
          const float* p = ws + (size_t)tt * S * 3 * FBM;
          float mm = -INFINITY;
          for (int q = 0; q < S; ++q) mm = fmaxf(mm, __ldcg(p + q * 3 * FBM + row));
          float ss = 0.f, gg = 0.f;
          for (int q = 0; q < S; ++q) {
            const float mq = __ldcg(p + q * 3 * FBM + row);
            if (mq != -INFINITY)
              ss += __ldcg(p + q * 3 * FBM + FBM + row) * exp2f((mq - mm) * LOG2E);
            gg += __ldcg(p + q * 3 * FBM + 2 * FBM + row);
          }
          lse[t] = mm + logf(ss);
          gold[t] = gg;
        }
        if (threadIdx.x == 0) tickets[tt] = 0;
      }
    }
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

}  // namespace

// f32: 0 for bf16 h and emb (the tensor-core kernel), 1 for fp32 (scalar).
// The tensor-core kernel takes the plan's ranges, ring stages and
// shared-memory bytes (checked against fwd_smem_bytes); ws holds
// ceil(T / 128) * ranges * 3 * 128 floats and tickets ceil(T / 128) zeroed
// int32 where ranges > 1 (the kernel leaves every ticket at 0).
extern "C" int fused_head_fwd_launch(const void* h, const void* emb, const void* tgt,
                                     void* lse, void* gold, void* ws, void* tickets, int T,
                                     int V, int E, int f32, int ranges, int stages, int smem,
                                     void* stream) {
  if (T < 1 || V < 1 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    scalar::head_fwd_scalar<<<(unsigned)((T + 63) / 64), THREADS, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(emb),
        static_cast<const int*>(tgt), static_cast<float*>(lse), static_cast<float*>(gold),
        T, V, E);
    return (int)cudaGetLastError();
  }
  return launch_fwd_wgmma(h, emb, tgt, lse, gold, ws, tickets, T, V, E, ranges, stages, smem, s);
}
