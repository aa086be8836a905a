// Fused (BatchNorm + ReLU) backward and 1x1-convolution backward for Hopper
// (sm_90a), in one pass over the activations:
//   xhat = (y - mean) * inv
//   db   = dr where xhat * gamma + beta > 0, else 0      (ReLU mask recomputed)
//   dy   = gamma_inv * (db - mean_db - xhat * mean_db_xhat), rounded to bf16
//   dX   = dy @ W^T        [N, CI] bf16   (fp32 sums, rounded once)
//   dW   = X^T @ dy        [CI, CO] fp32
// Both matrix products are computed here, on the tensor cores (wgmma).
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
// The TPU kernel walks the row tiles in order and carries dW [CI, CO] in
// VMEM. Here a persistent grid of one block an SM: block (bx, s) owns a
// slice of CIS input channels (CIS 256 up to CO 128, else 128; so all of CI
// at the probe's shape, and dr and y are read once) and the 64-row tiles bx,
// bx + gx, ...; it keeps W^T's slice resident in shared memory and the
// slice's dW [CIS, CO] in the registers of its two consumer warpgroups (128
// fp32 a thread at CIS * CO = 32,768) over all its tiles, and at the end
// writes it to part[bx]; fused_bwd_finish adds the gx partials in block
// order, so dW is the same on every run (no atomics).
//
// Thread 0 feeds two rings of ST slots (2 where they fit, else 1) by TMA,
// one of the tiles' dr and y, one of their x slices, in 64-column slabs of
// 64 rows with the 128-byte swizzle (hopper_common.cuh). Per tile:
//   1. the elementwise chain in fp32 with no fused multiply-add (each product
//      and sum rounds apart, as in the plain version, so the mask and the
//      bf16 dy are the plain version's bit for bit), dy into shared memory in
//      the layout of the dr tile it comes from, which both products read;
//      the dr/y slot is then refilled at once with tile it + ST's;
//   2. dW += X^T dy: m64nCOk16 with both operands read MN-major (A the x
//      slab, B dy), warpgroup w taking the slice's 64-channel blocks w, w + 2;
//   3. dX = dy W^T, 64 columns at a time (warpgroup w the chunks w, w + 2):
//      m64n64k16 with dy K-major and W^T's slab MN-major, rounded to bf16,
//      staged in the warpgroup's x slab w (read by its dW products only) and
//      stored with coalesced 16-byte writes; the x slot is refilled once the
//      tile is done.
// Freeing the dr/y slot as soon as dy is formed keeps more of the next tiles'
// loads in flight while one is computed: the HBM stream, not the products,
// is the bound.
//
// CO is held to 256: dW's accumulators for a 128-channel slice (the least
// that the two warpgroups' 64-row wgmma blocks split evenly) take CO / 2
// fp32 registers a thread, 128 at CO 256; and at CO 256 one ring stage (dr,
// y: 64 KB, x: 16 KB) beside W^T's slice (64 KB) and dy (32 KB) already
// leaves no room for a second stage.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BN = 64;             // rows a tile
constexpr int THREADS = 256;       // two consumer warpgroups; thread 0 also produces
constexpr int SLAB = BN * 128;     // bytes of a [64 rows, 64 columns] bf16 slab

// Shared memory from a 1024-aligned base: W^T's slice (CIS / 64 slabs of COP
// rows), a ring of ST dr/y slots (COP / 64 slabs each of dr and y), a ring of
// ST x slots (CIS / 64 slabs), dy (COP / 64 slabs), scal [7][COP] fp32, the
// mbarriers (W, fullA[ST], fullX[ST]).
// benchmarks/pallas_bwd_probe.py (_plan) computes the same bytes.
template <int CIS, int COP, int ST>
struct Layout {
  static constexpr int CS = CIS / 64, OS = COP / 64;
  static constexpr int SLAB_W = COP * 128;
  static constexpr int A = 2 * OS * SLAB;       // a dr/y slot
  static constexpr int X = CS * SLAB;           // an x slot
  static constexpr int W = 0;
  static constexpr int RA = W + CS * SLAB_W;
  static constexpr int RX = RA + ST * A;
  static constexpr int DY = RX + ST * X;
  static constexpr int SC = DY + OS * SLAB;
  static constexpr int BAR = SC + 7 * COP * 4;
  static constexpr int bytes = 1024 + BAR + 8 * (1 + 2 * ST);
  static_assert(bytes <= 232448, "the layout must fit a block's shared memory");
  static_assert(CIS * COP <= 32768, "dW's slice must fit 128 fp32 registers a thread");
};

template <int N>
__device__ __forceinline__ void dw_product(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256)
    wgmma_ss_tt_n256(acc, da, db, 1);
  else if constexpr (N == 128)
    wgmma_ss_tt_n128(acc, da, db, 1);
  else
    wgmma_ss_tt_n64(acc, da, db, 1);
}

template <int CIS, int COP, int ST>
__global__ void __launch_bounds__(THREADS, 1)
fused_bwd_wgmma(const __grid_constant__ CUtensorMap tdr, const __grid_constant__ CUtensorMap ty,
                const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ scal, bf16* __restrict__ dx,
                float* __restrict__ part, int N, int CI, int CO) {
  using Lay = Layout<CIS, COP, ST>;
  constexpr int OS = Lay::OS, CS = Lay::CS, MB = CIS / 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_w = s_base + Lay::BAR;
  auto full_a = [&](int st) { return bar_w + 8 + 8 * st; };
  auto full_x = [&](int st) { return bar_w + 8 + 8 * ST + 8 * st; };
  float* sc = reinterpret_cast<float*>(smem + Lay::SC);
  uint8_t* dys = smem + Lay::DY;
  const uint32_t dy_s = s_base + Lay::DY, w_s = s_base + Lay::W;

  const int ci0 = blockIdx.y * CIS;
  const int ntiles = (N + BN - 1) / BN;
  const int n_mine =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto tile_row = [&](int it) { return ((int)blockIdx.x + it * (int)gridDim.x) * BN; };

  // thread 0: tile it's dr and y into dr/y slot it % ST, its x slice into x slot it % ST
  auto load_a = [&](int it) {
    const int st = it % ST, n0 = tile_row(it);
    const uint32_t base = s_base + Lay::RA + st * Lay::A;
    mbar_expect_tx(full_a(st), Lay::A);
    for (int c = 0; c < OS; ++c) {
      tma_load(base + c * SLAB, &tdr, 64 * c, 0, n0, 0, full_a(st));
      tma_load(base + (OS + c) * SLAB, &ty, 64 * c, 0, n0, 0, full_a(st));
    }
  };
  auto load_x = [&](int it) {
    const int st = it % ST, n0 = tile_row(it);
    const uint32_t base = s_base + Lay::RX + st * Lay::X;
    mbar_expect_tx(full_x(st), Lay::X);
    for (int c = 0; c < CS; ++c)
      tma_load(base + c * SLAB, &tx, ci0 + 64 * c, 0, n0, 0, full_x(st));
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_w, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(full_x(s), 1);
    }
    fence_barrier_init();
    // W^T's slice: slab c holds rows co < COP (zero past CO), columns ci0 + 64 c ..
    mbar_expect_tx(bar_w, CS * Lay::SLAB_W);
    for (int c = 0; c < CS; ++c) tma_load(w_s + c * Lay::SLAB_W, &tw, ci0 + 64 * c, 0, 0, 0, bar_w);
    for (int it = 0; it < ST && it < n_mine; ++it) load_a(it);
    for (int it = 0; it < ST - 1 && it < n_mine; ++it) load_x(it);
  }
  for (int i = threadIdx.x; i < 7 * COP; i += THREADS) {
    const int row = i / COP, co = i % COP;
    sc[i] = co < CO ? scal[row * CO + co] : 0.f;
  }
  __syncthreads();      // the barriers are initialised, scal is staged

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  float accw[MB][COP / 2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int x = 0; x < COP / 2; ++x) accw[mb][x] = 0.f;
  mbar_wait(bar_w, 0);

  for (int it = 0; it < n_mine; ++it) {
    const int st = it % ST, par = (it / ST) & 1, n0 = tile_row(it);
    __syncthreads();    // tile it - 1 is done: dy and its x slot are free
    if (threadIdx.x == 0 && it + ST - 1 < n_mine) load_x(it + ST - 1);
    mbar_wait(full_a(st), par);
    const uint8_t* slot_a = smem + Lay::RA + st * Lay::A;

    // 1. dy, 16 bytes at a time: slab i / 512, row (i / 8) % 64, stored
    // chunk i % 8, which holds logical columns 8 ((i % 8) ^ (row % 8)) ..
    for (int i = threadIdx.x; i < OS * 512; i += THREADS) {
      const int sl = i / 512, r = (i / 8) % 64, pk = i % 8;
      const int off = sl * SLAB + r * 128 + pk * 16;
      const int c0 = sl * 64 + ((pk ^ (r % 8)) * 8);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N) {
        const uint4 dv = *reinterpret_cast<const uint4*>(slot_a + off);
        const uint4 yv = *reinterpret_cast<const uint4*>(slot_a + OS * SLAB + off);
        const bf16* yb = reinterpret_cast<const bf16*>(&yv);
        const bf16* db16 = reinterpret_cast<const bf16*>(&dv);
        bf16* ob = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + j;
          const float xhat = __fmul_rn(__fsub_rn(__bfloat162float(yb[j]), sc[1 * COP + c]),
                                       sc[2 * COP + c]);
          const bool on = __fadd_rn(__fmul_rn(xhat, sc[6 * COP + c]), sc[3 * COP + c]) > 0.f;
          const float db = on ? __bfloat162float(db16[j]) : 0.f;
          const float d = __fmul_rn(
              sc[c], __fsub_rn(__fsub_rn(db, sc[4 * COP + c]), __fmul_rn(xhat, sc[5 * COP + c])));
          ob[j] = __float2bfloat16(d);
        }
      }
      *reinterpret_cast<uint4*>(dys + off) = out;
    }
    fence_proxy_async_cta();    // dy's stores before the wgmma reads them
    __syncthreads();
    // the dr/y slot is read: tile it + ST's dr and y into it, a tile ahead
    if (threadIdx.x == 0 && it + ST < n_mine) load_a(it + ST);

    // 2. dW += X^T dy over the tile's 64 rows (16 a k-step)
    mbar_wait(full_x(st), par);
    const uint32_t x_s = s_base + Lay::RX + st * Lay::X;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(accw[mb]);
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dw_product<COP>(accw[mb], desc(x_s + (wg + 2 * mb) * SLAB + kk * 2048, SLAB, 1024),
                        desc(dy_s + kk * 2048, SLAB, 1024));
    wgmma_commit();

    // 3. dX, chunk c of 64 columns of the slice: K = COP (16 a k-step),
    // rounded to bf16, staged in the warpgroup's first x slab (its own dW
    // products, the slab's only readers, are done by then) and stored with
    // coalesced 16-byte writes
    uint8_t* stg = smem + Lay::RX + st * Lay::X + wg * SLAB;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int c = wg + 2 * i;
      float accx[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) accx[x] = 0.f;
      fence_regs(accx);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < COP / 16; ++kk)
        wgmma_ss_t_n64(accx, desc_k(dy_s, SLAB, kk),
                       desc(w_s + c * Lay::SLAB_W + kk * 2048, Lay::SLAB_W, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();    // dW's products too
      fence_regs(accx);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(accw[mb]);
      // rows 16 warp + g (+ 8), columns 8 j + 2 t4 (+ 1), swizzled like a slab
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = 16 * warp + g + 8 * ii;
          *reinterpret_cast<uint32_t*>(stg + r * 128 + ((j ^ (r % 8)) << 4) + 4 * t4) =
              pack_bf16(accx[4 * j + 2 * ii], accx[4 * j + 2 * ii + 1]);
        }
      named_sync(1 + wg, 128);
      for (int q = threadIdx.x % 128; q < 512; q += 128) {
        const int r = q / 8, ch = q % 8;
        const int row = n0 + r, col = ci0 + c * 64 + ch * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + r * 128 + ((ch ^ (r % 8)) << 4));
        if (row < N && col < CI) *reinterpret_cast<uint4*>(dx + (size_t)row * CI + col) = v;
      }
      if (i + 1 < MB) named_sync(1 + wg, 128);   // the staging slab is read
    }
    fence_proxy_async_cta();    // the x slot's generic accesses before TMA refills it
  }

  // this block's dW slice into part[blockIdx.x] (zeros if it had no tile):
  // warpgroup wg, block mb: input channels ci0 + 64 (wg + 2 mb) + 16 warp + g (+ 8)
  float* dst = part + (size_t)blockIdx.x * CI * CO;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < COP / 8; ++j) {
      const int co = 8 * j + 2 * t4;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int ci = ci0 + 64 * (wg + 2 * mb) + 16 * warp + g + 8 * ii;
        if (ci < CI && co < CO)
          *reinterpret_cast<float2*>(dst + (size_t)ci * CO + co) =
              make_float2(accw[mb][4 * j + 2 * ii], accw[mb][4 * j + 2 * ii + 1]);
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

template <int CIS, int COP, int ST>
int launch(const void* dr, const void* y, const void* x, const void* wt, const void* scal,
           void* dx, void* part, void* dw, int N, int CI, int CO, int gx, int smem,
           cudaStream_t s) {
  using Lay = Layout<CIS, COP, ST>;
  if (smem != Lay::bytes) return (int)cudaErrorInvalidValue;
  auto kernel = fused_bwd_wgmma<CIS, COP, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mdr, my, mx, mw;
  int e = make_map(&mdr, dr, CO, 1, N, 1, BN);
  if (!e) e = make_map(&my, y, CO, 1, N, 1, BN);
  if (!e) e = make_map(&mx, x, CI, 1, N, 1, BN);
  if (!e) e = make_map(&mw, wt, CI, 1, CO, 1, COP);
  if (e) return e;
  const dim3 grid(gx, (CI + CIS - 1) / CIS);
  kernel<<<grid, THREADS, smem, s>>>(mdr, my, mx, mw, static_cast<const float*>(scal),
                                     static_cast<bf16*>(dx), static_cast<float*>(part), N, CI, CO);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = CI * CO;
  fused_bwd_finish<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part), gx, n,
                                                   static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's (ci_slice, co_pad, stages) -> the instantiation; gx blocks along
// N, each writing one [CI, CO] partial dW; smem must equal the layout's bytes.
extern "C" int fused_bn_relu_conv1x1_bwd_launch(const void* dr, const void* y, const void* x,
                                                const void* wt, const void* scal, void* dx,
                                                void* part, void* dw, int N, int CI, int CO,
                                                int gx, int ci_slice, int co_pad, int stages,
                                                int smem, void* stream) {
  if (N < 1 || CI < 16 || CO < 16 || CI % 16 || CO % 16 || CO > co_pad || gx < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROUTE(CIS, COP, ST)                                                                    \
  if (ci_slice == CIS && co_pad == COP && stages == ST)                                        \
    return launch<CIS, COP, ST>(dr, y, x, wt, scal, dx, part, dw, N, CI, CO, gx, smem, s);
  ROUTE(256, 128, 2)
  ROUTE(256, 64, 2)
  ROUTE(128, 128, 2)
  ROUTE(128, 64, 2)
  ROUTE(128, 256, 1)
#undef ROUTE
  return (int)cudaErrorInvalidValue;
}
