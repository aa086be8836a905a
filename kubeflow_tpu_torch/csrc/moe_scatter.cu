// Row scatter for Hopper (sm_90a): the backward of the row gather.
// dx [B, R, M] is zero, and each row dy[b, j] whose index idx[b, j] lies in
// [0, R) goes to dx[b, idx[b, j]]:
//   accumulate = 1: added in fp32 (dx is fp32; dy fp32 or bf16);
//   accumulate = 0: stored as it is (dx has dy's dtype). Where several
//                   indices hit one row, which of them lands is unspecified
//                   (this kernel stores the source of the largest j, as the
//                   TPU kernel's sequential stores leave it).
//
// Replaces the Pallas kernel _scatter_kernel (kubeflow_tpu/ops/moe_dispatch.py:93):
// accumulate for the MoE dispatch's backward (a token sits in k slots, so its
// gradient rows collide), a direct store for the combine's (slots are
// injective; only the padding row, whose gradient is discarded, collides).
// Layout: dy [B, J, M], idx [B, J] int32, dx [B, R, M], all contiguous.
//
// Bound: HBM bytes, dy's valid rows read once (a direct store: one source a
// destination row) and dx written once; the accumulate mode's one fp32 add
// per element is nothing beside them.
//
// The design is destination-first: every output row has one owner, which
// writes it once, so there is no memset and no atomic on data. A tile of RT
// destination rows of one batch row is a block's unit. Its block finds the
// tile's sources itself (the index pass, over idx only): it stages idx[b, :]
// in shared memory (16-byte loads, all at once) and, with ballots and
// __match_any_sync, counts and then places the j's that fall in the tile,
// each warp a contiguous part, so that each row's sources come out in j
// order (a stable counting sort by destination: no sort network).
//
// - Direct store: the tile keeps, per row, the largest j that hits it
//   (inv[r], -1 for none) and copies dy[b, inv[r]] or zeros in 16-byte
//   vectors (narrower where the row's bytes demand): one read of a source a
//   row and one write of every row. One launch of B * ceil(R / RT) blocks.
// - Accumulate: a row of at most SEG sources is summed by its tile's block
//   in j order in fp32 registers (8-byte bf16 or 16-byte fp32 loads, the
//   tile's light rows one stream of sources, 4 in flight a thread), starting
//   from 0: the sequential j-order sum the TPU kernel takes, bit for bit. A
//   row of more sources (the MoE dispatch's padding row S takes every empty
//   slot, ~1,600 a batch row at the training flagship) is heavy: its tile
//   registers it as work items, ceil(n / SEG) segments and one combine
//   slice a 256 columns, writes its sources in j order to a workspace and
//   publishes the items with flags. Blocks without a tile, and every block
//   after its tiles, take the items in order as they are published (so the
//   heavy rows' reads overlap the light rows'): a segment is summed in j
//   order into an fp32 partial in the workspace and flagged done; a combine
//   slice adds its row's partials in segment order as they are done and
//   writes its columns of the row. So two launches are bitwise equal. The
//   launch is cooperative (a persistent grid of four blocks an SM, all
//   resident), so a block may wait for work another block is still doing:
//   one device kernel a call.
//
// On an H100 at the MoE flagship (chip_smoke.py's moe kernels phase) more
// source rows in flight a thread, or more or fewer blocks an SM, measured
// slower: the light rows' stream is not latency-bound at 4, and a thread
// past 64 registers spills.
//
// The workspace (fp32 partials, each work item's row, segment lists) is
// written before it is read; the tickets (the registered-item, indexed-tile,
// next-item and finished-block counters, then a ticket, a ready flag and a
// done flag a work item) are zero before the first launch, and every launch
// leaves them zero: the last block to finish resets the counters, an item's
// taker its ready flag, a heavy row's last combine slice its done flags and
// its ticket.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int RT = 32;            // destination rows a tile (a warp's lanes in the index pass)
constexpr int SEG = 32;           // most sources a unit sums: a light row whole, a heavy row's segment
constexpr int HROW = 4 + SEG;     // ints a work item keeps: its heavy row's record, its sources
constexpr int CHUNK = 8192;       // idx values a block stages in shared memory at a time
constexpr int BLOCKS_PER_SM = 4;  // at most 64 registers a thread, so that four blocks fit an SM
constexpr unsigned FULL = 0xffffffffu;
// the counters at the head of the tickets
constexpr int CTR_ITEMS = 0;      // work items registered
constexpr int CTR_INDEXED = 1;    // tiles whose heavy rows are registered
constexpr int CTR_NEXT = 2;       // the next work item a block takes
constexpr int CTR_DONE = 3;       // blocks finished
constexpr int CTR_TICKETS = 4;    // then a ticket, a ready flag and a done flag a work item

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a flag between blocks: set (relaxed, after the setter's fence: one fence
// for many flags, where a release store fences each), waited for with
// acquire (the wait traps after 2 s: a launch error, not a hung card)
__device__ __forceinline__ void flag_set(int* f) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" :: "l"(f), "r"(1) : "memory");
}
__device__ __forceinline__ void flag_wait(const int* f) {
  if (ld_acquire(f)) return;
  const uint64_t t0 = global_ns();
  while (!ld_acquire(f)) {
    __nanosleep(128);
    if (global_ns() - t0 > 2000000000ull) __trap();
  }
}

// The lanes whose row is this lane's, among the lanes `hits` whose source
// falls in the tile (`in`, row `rl`): ballots where every such lane has one
// row (nearly always: a light tile's hits are sparse, a heavy row's share
// its row), __match_any_sync (slower) otherwise.
__device__ __forceinline__ unsigned same_row(unsigned hits, bool in, int rl, int lane) {
  const unsigned lo = __reduce_min_sync(FULL, in ? (unsigned)rl : 0xffffffffu);
  const unsigned hi = __reduce_max_sync(FULL, in ? (unsigned)rl : 0u);
  if (lo == hi) return hits;
  return __match_any_sync(FULL, in ? rl : RT + lane);
}

// VEC elements of T in one load: 4 bf16 in 8 bytes, 4 fp32 in 16, or one
template <typename T, int VEC>
struct Raw {
  using type = T;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
}

__device__ __forceinline__ void add_raw(float (&a)[1], float x) { a[0] += x; }
__device__ __forceinline__ void add_raw(float (&a)[1], __nv_bfloat16 x) {
  a[0] += __bfloat162float(x);
}
__device__ __forceinline__ void add_raw(float (&a)[4], float4 x) {
  a[0] += x.x, a[1] += x.y, a[2] += x.z, a[3] += x.w;
}
__device__ __forceinline__ void add_raw(float (&a)[4], uint2 x) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  a[0] += lo.x, a[1] += lo.y, a[2] += hi.x, a[3] += hi.y;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *p = a[0];
}

// acc = sum of dy[b, src[q]] over q < n, in q order from 0, columns c .. c + VEC - 1
template <typename T, int VEC, int U>
__device__ __forceinline__ void sum_rows(float (&acc)[VEC], const T* __restrict__ dyb,
                                         const int* src, int n, int M, int c) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int q0 = 0; q0 < n; q0 += U) {
    typename Raw<T, VEC>::type x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q0 + u < n) x[u] = load_raw<T, VEC>(dyb + (size_t)src[q0 + u] * M + c);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q0 + u < n) add_raw(acc, x[u]);
  }
}

// idx[b, c0 .. c0 + n) into shared memory, all threads at once: 16-byte
// loads where the run starts 16-byte aligned, else 4-byte ones
__device__ __forceinline__ void stage_idx(int* ids, const int* __restrict__ src, int n) {
  const int t = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
#pragma unroll 4
    for (int i = t; i < n4; i += THREADS)
      reinterpret_cast<int4*>(ids)[i] = __ldg(reinterpret_cast<const int4*>(src) + i);
    for (int i = 4 * n4 + t; i < n; i += THREADS) ids[i] = __ldg(src + i);
  } else {
#pragma unroll 8
    for (int i = t; i < n; i += THREADS) ids[i] = __ldg(src + i);
  }
}

// The accumulate mode. Each block first takes its tiles: the index pass,
// heavy rows registered and their work items published, light rows summed
// and written, empty rows written as zeros. Then it takes heavy rows' work
// items as they are published (a block without a tile starts on them at
// once): a segment is summed in j order into an fp32 partial; a combine
// slice adds its row's partials in segment order as they are done. Every
// block is resident (a cooperative launch), so a block may wait for work
// that another block is still doing.
//
// The index pass stages idx[b, :] in CHUNK runs in shared memory. Pass A:
// warp w counts the sources of each row in its contiguous part of the run
// (ballots and __match_any_sync). Warp 0 turns the counts into each warp's
// base within its row (after the row's sources of the earlier runs). Pass
// B: each warp places its sources at base + rank, so a row's sources lie in
// j order.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
scatter_add_kernel(const T* __restrict__ dy, const int* __restrict__ idx, float* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ wsi, int* __restrict__ ctr, int B,
                   int J, int R, int M, int item_max) {
  static_assert(RT == 32, "warp 0's lanes are the tile's rows");
  constexpr int U = 4;                // source rows in flight a thread (more measured slower)
  __shared__ int ids[CHUNK];          // a run of idx[b, :]
  __shared__ int cnt[NW][RT];         // a warp's sources a row in the run; then its base
  __shared__ int nrow[RT], loff[RT + 1], hs0[RT], cursor[RT];
  __shared__ int list[RT * SEG];      // the light rows' sources, row by row in j order
  __shared__ unsigned char tag[RT * SEG];
  __shared__ int item_s;
  __shared__ int hdr[HROW];           // a work item's heavy row, then its sources

  // [item_max][HROW]: a work item's heavy row (batch row, row, sources,
  // first item), then a segment's sources
  int* hlist = wsi;
  int* hticket = ctr + CTR_TICKETS;                // [item_max]: a heavy row's, at its first item
  int* ready = hticket + item_max;                 // [item_max]: a work item can start
  int* done = ready + item_max;                    // [item_max]: a segment's partial is written
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const int tiles_b = (R + RT - 1) / RT;
  const int tiles = B * tiles_b;
  const int runs = (J + CHUNK - 1) / CHUNK;

  // pass A or B over the staged run [0, n) (warp w its contiguous part):
  // count into cnt[w][row] (place = false), or place each source at
  // cnt[w][row] + its rank and count on (place = true)
  auto walk = [&](int r0, unsigned rows, int c0, int n, bool place) {
    const int cw = ((n + NW - 1) / NW + 31) / 32 * 32;
    const int lo = min(n, w * cw), hi = min(n, lo + cw);
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int rl = i < hi ? (int)((unsigned)ids[i] - (unsigned)r0) : -1;
      const bool in = (unsigned)rl < rows;
      const unsigned hits = __ballot_sync(FULL, in);
      if (!hits) continue;
      const unsigned peers = same_row(hits, in, rl, lane);
      if (place && in) {
        const int pos = cnt[w][rl] + __popc(peers & lanemask_lt());
        if (hs0[rl] >= 0) {
          hlist[(size_t)(hs0[rl] + pos / SEG) * HROW + 4 + pos % SEG] = c0 + i;
        } else {
          list[loff[rl] + pos] = c0 + i;
          tag[loff[rl] + pos] = (unsigned char)rl;
        }
      }
      __syncwarp();
      if (in && lane == __ffs(peers) - 1) cnt[w][rl] += __popc(peers);
      __syncwarp();
    }
  };
  // warp 0: each warp's count of the run -> its base in the row
  auto bases = [&]() {
    int run = cursor[lane];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int c = cnt[k][lane];
      cnt[k][lane] = run;
      run += c;
    }
    cursor[lane] = run;
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * RT;
    const unsigned rows = (unsigned)min(RT, R - r0);
    const int* ib = idx + (size_t)b * J;
    const T* dyb = dy + (size_t)b * J * M;
    // pass A: each row's sources (the run's per-warp counts kept when it is
    // the only run)
    if (t < RT) nrow[t] = 0;
    for (int c0 = 0; c0 < J; c0 += CHUNK) {
      const int n = min(CHUNK, J - c0);
      __syncthreads();
      stage_idx(ids, ib + c0, n);
      for (int i = t; i < NW * RT; i += THREADS) cnt[i / RT][i % RT] = 0;
      __syncthreads();
      walk(r0, rows, c0, n, false);
      __syncthreads();
      if (w == 0) {
        int c = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) c += cnt[k][lane];
        nrow[lane] += c;
      }
    }
    // heavy rows registered; the light rows' offsets in `list`
    if (w == 0) {
      const int rl = lane, n = nrow[rl];
      int s0 = -1;
      if (n > SEG) {
        const unsigned items = (n + SEG - 1) / SEG + (M + THREADS - 1) / THREADS;
        s0 = atomicAdd(ctr + CTR_ITEMS, (int)items);
        if (s0 + (int)items > item_max) __trap();   // the wrapper's item_max bounds them
        const int4 row = make_int4(b, r0 + rl, n, s0);
        for (int i = 0; i < (int)items; ++i)
          *reinterpret_cast<int4*>(hlist + (size_t)(s0 + i) * HROW) = row;
      }
      const int ln = s0 < 0 ? n : 0;
      int x = ln;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      loff[rl] = x - ln;
      if (lane == 31) loff[RT] = x;
      hs0[rl] = s0;
      cursor[rl] = 0;
      if (runs == 1) bases();
    }
    // pass B: each source to its place
    for (int c0 = 0; c0 < J; c0 += CHUNK) {
      const int n = min(CHUNK, J - c0);
      if (runs > 1) {
        __syncthreads();
        stage_idx(ids, ib + c0, n);
        for (int i = t; i < NW * RT; i += THREADS) cnt[i / RT][i % RT] = 0;
        __syncthreads();
        walk(r0, rows, c0, n, false);
        __syncthreads();
        if (w == 0) bases();
      }
      __syncthreads();
      walk(r0, rows, c0, n, true);
    }
    __syncthreads();
    // publish the tile: each heavy row's work items are ready (the block's
    // stores, a block barrier, a fence, then the flags), then the tile
    // counts as indexed (every heavy row of it registered)
    if (w == 0) {
      if (hs0[lane] >= 0) {
        __threadfence();
        const int items = (nrow[lane] + SEG - 1) / SEG + (M + THREADS - 1) / THREADS;
        for (int i = 0; i < items; ++i) flag_set(ready + hs0[lane] + i);
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence();
        atomicAdd(ctr + CTR_INDEXED, 1);
      }
    }
    // rows with no source: zeros
    for (int rl = 0; rl < (int)rows; ++rl) {
      if (nrow[rl]) continue;
      float* dst = out + ((size_t)b * R + r0 + rl) * M;
      const float z[VEC] = {};
      for (int c = t * VEC; c < M; c += THREADS * VEC) store_vec<VEC>(dst + c, z);
    }
    // the light rows, one stream of sources in row order: U rows in flight
    // whatever the rows' lengths, each row's sum from 0 in j order
    const int L = loff[RT];
    for (int c = t * VEC; c < M; c += THREADS * VEC) {
      const T* src = dyb + c;
      float* dst = out + ((size_t)b * R + r0) * M + c;
      float acc[VEC] = {};
      int cur = -1;
      for (int q0 = 0; q0 < L; q0 += U) {
        typename Raw<T, VEC>::type x[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (q0 + u < L) x[u] = load_raw<T, VEC>(src + (size_t)list[q0 + u] * M);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (q0 + u >= L) break;
          const int rl = tag[q0 + u];
          if (rl != cur) {
            if (cur >= 0) store_vec<VEC>(dst + (size_t)cur * M, acc);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
            cur = rl;
          }
          add_raw(acc, x[u]);
        }
      }
      if (cur >= 0) store_vec<VEC>(dst + (size_t)cur * M, acc);
    }
    __syncthreads();
  }

  // heavy rows' work items, as they are published. A heavy row of n
  // sources registers nseg = ceil(n / SEG) segment items, then `slices`
  // combine items (a column slice of THREADS columns each, one a thread, so
  // that a thread has a batch of partials in flight). A block takes the next
  // item number, waits until it is registered (or every tile is indexed and
  // it is past the last), then until its tile has published it; a combine
  // slice also waits for its row's segments, a batch at a time. An item
  // waits only for a tile or for items handed out before it, so the waits
  // cannot close a cycle.
  const int slices = (M + THREADS - 1) / THREADS;
  for (;;) {
    if (t == 0) {
      const int g = atomicAdd(ctr + CTR_NEXT, 1);
      int item = -1;
      const uint64_t t0 = global_ns();
      for (;;) {
        if (g < ld_acquire(ctr + CTR_ITEMS)) {
          item = g;
          break;
        }
        if (ld_acquire(ctr + CTR_INDEXED) == tiles) {   // every heavy row registered
          if (g < ld_acquire(ctr + CTR_ITEMS)) item = g;
          break;
        }
        __nanosleep(256);
        if (global_ns() - t0 > 2000000000ull) __trap();
      }
      if (item >= 0) {
        flag_wait(ready + item);
        ready[item] = 0;                // for the next launch
      }
      item_s = item;
    }
    __syncthreads();
    const int g = item_s;
    if (g < 0) break;
    if (t < HROW) hdr[t] = __ldcg(hlist + (size_t)g * HROW + t);
    __syncthreads();
    const int hb = hdr[0], hr = hdr[1], hn = hdr[2], i0 = hdr[3];
    const int nseg = (hn + SEG - 1) / SEG;
    if (g - i0 < nseg) {
      // a segment: its sources summed in j order from 0 into partial g,
      // then flagged done (the block's stores, a barrier, a fence, the flag)
      const int ns = min(SEG, hn - (g - i0) * SEG);
      const T* dyb = dy + (size_t)hb * J * M;
      for (int c = t * VEC; c < M; c += THREADS * VEC) {
        float acc[VEC];
        sum_rows<T, VEC, U>(acc, dyb, hdr + 4, ns, M, c);
        store_vec<VEC>(part + (size_t)g * M + c, acc);
      }
      __syncthreads();
      if (t == 0) {
        __threadfence();
        flag_set(done + g);
      }
    } else {
      // a combine slice: the row's partials added in segment order from 0,
      // UP at a time as their segments are done (so the slice's loads
      // overlap the row's later segments); the row's last slice sets its
      // flags and ticket back to 0
      constexpr int UP = 16;            // partials in flight a thread
      const int c = (g - i0 - nseg) * THREADS + t;
      float acc = 0.f;
      for (int s0 = 0; s0 < nseg; s0 += UP) {
        // the batch's flags, one a thread, polled together
        const bool mine = t < UP && s0 + t < nseg;
        const uint64_t t0 = global_ns();
        while (!__syncthreads_and(!mine || ld_acquire(done + i0 + s0 + t))) {
          __nanosleep(64);
          if (global_ns() - t0 > 2000000000ull) __trap();
        }
        if (c < M) {
          float x[UP];
#pragma unroll
          for (int u = 0; u < UP; ++u)
            if (s0 + u < nseg) x[u] = __ldcg(part + (size_t)(i0 + s0 + u) * M + c);
#pragma unroll
          for (int u = 0; u < UP; ++u)
            if (s0 + u < nseg) acc += x[u];
        }
      }
      if (c < M) out[((size_t)hb * R + hr) * M + c] = acc;
      if (t == 0 && atomicAdd(hticket + i0, 1) == slices - 1) {
        for (int s = 0; s < nseg; ++s) done[i0 + s] = 0;   // for the next launch
        hticket[i0] = 0;
      }
    }
    __syncthreads();
  }

  // the last block to finish sets the counters back to 0 for the next
  // launch (every block has read them by then)
  if (t == 0) {
    __threadfence();
    if (atomicAdd(ctr + CTR_DONE, 1) == (int)gridDim.x - 1) {
      ctr[CTR_ITEMS] = 0;
      ctr[CTR_INDEXED] = 0;
      ctr[CTR_NEXT] = 0;
      ctr[CTR_DONE] = 0;
      __threadfence();
    }
  }
}

// The direct store: a tile's rows take the largest j that hits them (the
// index pass keeps it with one shared-memory atomicMax a warp and row), then
// every (row, vector) pair is copied from that source or zeroed, U pairs in
// flight a thread.
template <typename V>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
scatter_store_kernel(const V* __restrict__ dy, const int* __restrict__ idx, V* __restrict__ out,
                     int J, int R, int vecs) {
  constexpr int U = 8;
  __shared__ int ids[CHUNK];          // a run of idx[b, :]
  __shared__ int inv[RT];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const int tiles_b = (R + RT - 1) / RT;
  const int b = blockIdx.x / tiles_b, r0 = (blockIdx.x % tiles_b) * RT;
  const int rows = min(RT, R - r0);
  const int* ib = idx + (size_t)b * J;
  if (t < RT) inv[t] = -1;
  for (int c0 = 0; c0 < J; c0 += CHUNK) {
    const int n = min(CHUNK, J - c0);
    __syncthreads();
    stage_idx(ids, ib + c0, n);
    __syncthreads();
    for (int i0 = w * 32; i0 < n; i0 += THREADS) {
      const int i = i0 + lane;
      const int rl = i < n ? (int)((unsigned)ids[i] - (unsigned)r0) : -1;
      const bool in = (unsigned)rl < (unsigned)rows;
      const unsigned hits = __ballot_sync(FULL, in);
      if (!hits) continue;
      const unsigned peers = same_row(hits, in, rl, lane);
      if (in && lane == 31 - __clz(peers)) atomicMax(&inv[rl], c0 + i);   // the group's largest j
    }
  }
  __syncthreads();
  const int pairs = rows * vecs;
  for (int i0 = t; i0 < pairs; i0 += THREADS * U) {
    V x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < pairs) {
        const int src = inv[i / vecs];
        x[u] = src >= 0 ? __ldg(dy + ((size_t)b * J + src) * vecs + i % vecs) : V{};
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < pairs) out[((size_t)b * R + r0 + i / vecs) * vecs + i % vecs] = x[u];
    }
  }
}

template <typename T, int VEC>
int launch_add(const void* dy, const void* idx, void* out, void* ws, void* tickets, int B, int J,
               int R, int M, int item_max, cudaStream_t s) {
  auto kernel = scatter_add_kernel<T, VEC>;
  static int grid_cap = 0;   // the blocks that fit at once, asked once per instantiation
  if (!grid_cap) {
    int dev, sms, per;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap = sms * per;
  }
  const long long tiles = (long long)B * ((R + RT - 1) / RT);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long want = tiles + item_max;
  const int grid = (int)(want < grid_cap ? (want > 0 ? want : 1) : grid_cap);
  float* part = static_cast<float*>(ws);
  int* wsi = reinterpret_cast<int*>(part + ((size_t)item_max * M + 3) / 4 * 4);   // 16-byte aligned
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(dy), static_cast<const int*>(idx),
      static_cast<float*>(out), part, wsi, static_cast<int*>(tickets), B, J, R, M, item_max);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename V>
int launch_store(const void* dy, const void* idx, void* out, int B, int J, int R,
                 long long row_bytes, cudaStream_t s) {
  const long long blocks = (long long)B * ((R + RT - 1) / RT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scatter_store_kernel<V><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const V*>(dy), static_cast<const int*>(idx), static_cast<V*>(out), J, R,
      (int)(row_bytes / sizeof(V)));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (dy's element type). Accumulate: ws holds item_max
// * M fp32 partials (rounded up to 4), then item_max * (4 + SEG) ints;
// tickets 4 + 3 * item_max ints, zero before the first launch and left zero
// by every launch. item_max bounds the work items of the rows of more than
// SEG sources (at most B * J / (SEG + 1) rows: ceil(B * J / SEG) segments
// plus one a row, and ceil(M / THREADS) combine slices a row):
// ops/moe_dispatch.py (_scatter_sizes) computes it and the sizes. The
// direct store uses neither.
extern "C" int moe_scatter_launch(const void* dy, const void* idx, void* out, void* ws,
                                  void* tickets, int B, int J, int R, int M, int dtype,
                                  int accumulate, int item_max, void* stream) {
  if (B < 0 || J < 0 || R < 1 || M < 0 || dtype < 0 || dtype > 1 || item_max < 0)
    return (int)cudaErrorInvalidValue;
  const int elem_bytes = dtype == 0 ? 4 : 2;
  const long long row_bytes = (long long)M * elem_bytes;
  if (row_bytes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (accumulate) {
    // 4-element vectors where every row (dy's, dx's, a partial's) starts 16-byte aligned
    if (M % 4 == 0)
      return dtype == 0 ? launch_add<float, 4>(dy, idx, out, ws, tickets, B, J, R, M, item_max, s)
                        : launch_add<__nv_bfloat16, 4>(dy, idx, out, ws, tickets, B, J, R, M,
                                                       item_max, s);
    return dtype == 0 ? launch_add<float, 1>(dy, idx, out, ws, tickets, B, J, R, M, item_max, s)
                      : launch_add<__nv_bfloat16, 1>(dy, idx, out, ws, tickets, B, J, R, M,
                                                     item_max, s);
  }
  if (row_bytes % 16 == 0) return launch_store<uint4>(dy, idx, out, B, J, R, row_bytes, s);
  if (row_bytes % 8 == 0) return launch_store<uint2>(dy, idx, out, B, J, R, row_bytes, s);
  if (row_bytes % 4 == 0) return launch_store<unsigned int>(dy, idx, out, B, J, R, row_bytes, s);
  return launch_store<unsigned short>(dy, idx, out, B, J, R, row_bytes, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
