"""Fused tied LM head + softmax cross entropy; counterpart of ``kubeflow_tpu/ops/fused_head_loss.py``.

The chunked head (``models/transformer.py lm_loss_chunked``) materialises
fp32 logits per chunk ([1024, 32000] is 131 MB). Here the [T, V] logits
exist only as tiles on chip: the forward keeps per-token ``lse`` and gold
logit, and the backward recomputes each tile from them. Three CUDA kernels
replace the three Pallas kernels of the JAX module:

- ``csrc/fused_head_fwd.cu`` replaces ``_fwd_kernel`` (``:76``): per-token
  logsumexp and gold logit of h @ embᵀ, streamed over vocabulary tiles;
- ``csrc/fused_head_bwd_dh.cu`` replaces ``_dh_kernel`` (``:157``):
  dh = Σ_v bf16(dlogits) · emb_v;
- ``csrc/fused_head_bwd_de.cu`` replaces ``_de_kernel`` (``:183``):
  dE = Σ_t bf16(dlogits)ᵀ · h_t; no atomics in either, every element a
  fixed-order sum.

with dlogits = dlse · exp(logit − lse) + dgold · [v == tgt] in fp32, rounded
to the operand dtype before both products (``:174``, ``:202``), and the
products summed in fp32. What bounds them on an H100: operations (2 T V E
FLOP forward, 4 T V E each backward kernel). Routes, by h's dtype
(:func:`_plan`):

- bf16: the forward is a ``wgmma`` GEMM whose epilogue is the softmax
  fold (:func:`_fwd_plan`): a block keeps 128 tokens' accumulators of a
  128-column vocabulary tile in registers, streams E through a TMA ring,
  folds each finished tile into the rows' running (max, sum) while the next
  tile's products run, forms gold as a dot product of the two rows, and the
  vocabulary is cut into ranges whose partials the last block of each token
  tile combines in range order, in the same launch. dh and dE are one
  ``wgmma`` kernel
  mirrored (``csrc/fused_head_common.cuh``): a block keeps 128 rows of one
  operand resident and streams 64-row tiles of the other through a TMA
  ring; E is split across the C = min(8, ⌈E/256⌉) blocks of a thread-block
  cluster, each computing the partial logits over its own E slice, which
  the cluster sums through distributed shared memory, so the logits are
  computed once (4 T V E FLOP up to E 2048; above it, ⌈E/2048⌉ passes
  recompute them, up to E 8192). With one pass the launch takes no more
  clusters than fit on the card at once and splits the row tiles' work
  evenly between them, a row tile shared by two clusters summed in a fixed
  order through a small scratch buffer (:func:`_scratch`). E not a
  multiple of 8 (TMA needs 16-byte rows) is zero-padded: the wrapper copies
  h and emb to E rounded up to 8, which adds 0 to every logit, and drops
  the padded output columns.
- fp32: fp32 FMAs, no TF32, dlogits unrounded, as the JAX kernels'
  ``astype`` on fp32 operands. dh and dE are the bf16 route's skeleton with
  register-tiled FMA products (``csrc/fused_head_fma.cuh``,
  :func:`_fma_plan`): 128 resident rows, 64-row tiles streamed through a
  TMA ring, E (padded to a multiple of 4) split across a cluster of
  ⌈E/128⌉ ≤ 8 blocks whose partial logits are summed through distributed
  shared memory, so the logits are computed once up to E 1024; above it
  ⌈E/1024⌉ passes recompute them, with no limit on E. The forward is the
  bf16 forward's GEMM with register-tiled FMA products (``head_fwd_fma`` in
  ``csrc/fused_head_fwd.cu``): the same blocks, ranges and fold, E (padded
  to a multiple of 4) streamed through a TMA ring of 64-column chunks,
  256 threads each holding an 8 x 8 logits tile and folding it into its
  own running (max, sum) and gold, the 16 threads of a row combined once
  at the end of their range.

Contract, the same as the JAX module's where its kernels run:

- ``fused_lse_gold(h, emb, tgt)`` -> (lse [T], gold [T]) fp32, h [T, E],
  emb [V, E], tgt [T] int; gold is 0 for a target outside [0, V). The
  products run in h's dtype: emb is cast to it inside the autograd Function,
  so an fp32 table gets its gradient in fp32, unrounded, as the JAX backward
  hands its fp32 dE through ``astype`` (``:294``, ``:330``). dh comes back in
  h's dtype.
- ``fused_head_nll(hidden, embedding, tokens, compute_dtype=bf16)``: mean
  next-token NLL, targets ``roll(tokens, -1)`` with the last position masked
  out; a drop-in for ``lm_loss_chunked``.

One difference from the JAX function: it falls back to an einsum reference
when T % 256 ≠ 0 or V has no 128-multiple divisor under each kernel's block
limit (``:306-314``), and there autodiff of the einsum neither rounds the
dlogits to the operand dtype nor keeps dE in fp32 (it rounds dE and dh to the
operand dtype). The port has no shape fallback: the kernels take any T, V
and E (E up to 8192 on the bf16 backward, any E on fp32), with the kernels'
rounding at every shape, so the two agree exactly only at the shapes where
the JAX kernels run.

CPU tensors take the plain versions (fp32 sums of the operands' products, T
walked in chunks); CUDA tensors launch the kernels, which take bf16 or fp32
h and emb, or raise. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import dataclasses

import torch

from kubeflow_tpu_torch.models.transformer import matmul_f32
from kubeflow_tpu_torch.ops import _build, _workspace

PLAIN_CHUNK = 1024    # tokens a chunk in the plain versions: [1024, V] fp32 logits
SMEM_LIMIT = 232_448  # bytes of shared memory a block may take on Hopper
_SUB = 256            # E columns a backward block accumulates in one pass (bf16)
_MAX_CLUSTER = 8      # blocks a portable thread-block cluster may hold
_MAX_PASSES = 4       # passes over E the bf16 backward takes (E <= 8192)
_XROWS = 64           # rows of a streamed tile
_LDS = 72             # fp32 leading dim of the receive buffer
_FMA_COLS = 128       # E columns a block accumulates in one pass (fp32)


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How the backward kernels launch. ``route`` "wgmma" is the bf16
    tensor-core kernel, "fma" the fp32 kernel of register-tiled FMAs.
    ``cluster`` blocks share one tile's rows along E, each owning ``slice``
    columns (in ``passes`` passes of ``slice // passes``; ``slabs`` slabs of
    128-byte rows a pass: 64 bf16 or 32 fp32 columns); ``rows`` rows of a
    row tile (resident with one pass); ``stages`` ring stages (3 where they
    fit); ``e_pad`` the E the kernels see (E rounded up to 8 for bf16, to 4
    for fp32, the operands zero-padded to it); ``grid_dh``
    and ``grid_de`` the blocks of each launch (clusters of ``cluster``
    consecutive blocks; one pass launches at most as many as fit on the card
    at once, see ``_scratch``); ``smem_bytes`` each block's dynamic shared
    memory."""

    route: str
    cluster: int
    slice: int
    passes: int
    slabs: int
    rows: int
    stages: int
    e_pad: int
    grid_dh: tuple[int, ...]
    grid_de: tuple[int, ...]
    threads: int
    smem_bytes: int


def _plan(T: int, V: int, E: int, dtype) -> HeadPlan:
    """The launch of the dh and dE kernels for these shapes.

    bf16: E is padded to ``e_pad`` (a multiple of 8) and split across a
    cluster of C = ⌈e_pad / 256⌉ blocks, each owning 256 columns (at C = 1
    e_pad rounded up to 64, 128 or 256); 128 resident rows a block, two
    consumer warpgroups. Above e_pad 2048: P = ⌈e_pad / 2048⌉ passes, each
    block owning 256 P columns, C = ⌈e_pad / (256 P)⌉, 64 resident rows (the
    resident slice grows with P). Shared memory: 1024 bytes of alignment
    slack, the resident slice, 3 streamed sub-tiles (2 where 3 do not fit),
    the bf16 dP tile, the fp32 receive buffer of the cluster's partial
    logits (``rows + 8`` rows), four row vectors of 128, the mbarriers;
    ``csrc/fused_head_common.cuh`` (BwdLayout) sums the same bytes and the
    launcher checks them. fp32: :func:`_fma_plan`."""
    if dtype == torch.float32:
        return _fma_plan(T, V, E)
    if dtype != torch.bfloat16:
        raise TypeError(f"fused head kernels take bf16 or fp32 operands, got {dtype}")
    e_pad = -(-E // 8) * 8
    passes = -(-e_pad // (_MAX_CLUSTER * _SUB))
    if passes > _MAX_PASSES:
        raise ValueError(
            f"the bf16 fused head backward takes E up to {_MAX_CLUSTER * _SUB * _MAX_PASSES}, "
            f"got {E}: its resident E slice would not fit a block's shared memory")
    if passes == 1:
        cluster = -(-e_pad // _SUB)
        slabs = next(n for n in (1, 2, 4) if cluster > 1 and n == 4 or 64 * n >= e_pad)
        rows = 128
    else:
        cluster = -(-e_pad // (_SUB * passes))
        slabs, rows = 4, 64
    fixed = 1024 + passes * slabs * rows * 128 + rows * 128 + (rows + 8) * _LDS * 4 + 4 * 128 * 4
    stages = 3 if fixed + 3 * slabs * _XROWS * 128 + 8 * 9 <= SMEM_LIMIT else 2
    smem = fixed + stages * slabs * _XROWS * 128 + 8 * (3 + 2 * stages)
    assert smem <= SMEM_LIMIT, smem
    return HeadPlan("wgmma", cluster, passes * slabs * 64, passes, slabs, rows, stages, e_pad,
                    (cluster * -(-T // rows),), (cluster * -(-V // rows),), 2 * rows, smem)


def _fma_smem(rows: int, cluster: int, stages: int) -> int:
    """``Layout(rows, cluster).bytes`` of ``csrc/fused_head_fma.cuh`` at
    ``stages`` ring stages, part by part: 1024 bytes of alignment slack; with
    one pass (128 rows) the resident [rows][128] fp32 slice, else none; the
    stages (a streamed [64][128] tile, with passes also the row tile's
    [rows][128]); the fp32 dP tile [rows][64]; the receive buffer, C slots of
    ⌈rows / C⌉ rows of 64 partial logits; the mbarriers (resident,
    full and empty a stage, the exchange's two)."""
    one = rows == 128
    resident = rows * _FMA_COLS * 4 if one else 0
    stage = (0 if one else rows * _FMA_COLS * 4) + _XROWS * _FMA_COLS * 4
    receive = cluster * -(-rows // cluster) * _XROWS * 4
    return 1024 + resident + stages * stage + rows * _XROWS * 4 + receive + 8 * (3 + 2 * stages)


def _fma_plan(T: int, V: int, E: int) -> HeadPlan:
    """The fp32 backward's launch (``head_bwd_fma``): E padded to a
    multiple of 4 and split across a cluster of C = ⌈e_pad / 128⌉ ≤ 8
    blocks of 128 columns, so the logits are computed once up to e_pad 1024;
    128 rows a row tile, resident. Above it P = ⌈e_pad / 1024⌉ passes, each
    block owning 128 P columns, C = ⌈e_pad / (128 P)⌉, 64-row tiles of both
    operands streamed; no E is refused. 256 threads; 3 ring stages where
    they fit."""
    e_pad = -(-E // 4) * 4
    passes = -(-e_pad // (_MAX_CLUSTER * _FMA_COLS))
    cluster = -(-e_pad // (_FMA_COLS * passes))
    rows = 128 if passes == 1 else 64
    stages = 3 if _fma_smem(rows, cluster, 3) <= SMEM_LIMIT else 2
    smem = _fma_smem(rows, cluster, stages)
    assert smem <= SMEM_LIMIT, smem
    return HeadPlan("fma", cluster, passes * _FMA_COLS, passes, _FMA_COLS // 32, rows, stages,
                    e_pad, (cluster * -(-T // rows),), (cluster * -(-V // rows),), 256, smem)


_FWD_ROWS = 128         # token rows a forward block
_FWD_COLS = 128         # vocabulary columns a forward tile
# (route, E columns a ring stage, bytes an element, ring stages, threads) of
# each forward route (csrc/fused_head_fwd.cu): bf16, two 64-column slabs a
# stage, ST stages, two consumer warpgroups and a producer warp; fp32, two
# 32-column slabs a stage, fwd32::STAGES stages, 256 threads
_FWD_ROUTES = {torch.bfloat16: ("wgmma", 128, 2, 3, 288), torch.float32: ("fma", 64, 4, 3, 256)}
_FWD_MAX_RANGES = 32    # vocabulary ranges a token tile is cut into at most


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel launches. ``route`` "wgmma" is the bf16
    tensor-core kernel, "fma" the fp32 kernel of register-tiled FMAs. A
    block owns ``rows`` tokens and walks a range of ``cols``-column
    vocabulary tiles; E (padded to ``e_pad``, a multiple of 8 for bf16, of 4
    for fp32) streams through ``stages`` ring stages of ``chunk`` columns.
    The ``vocab_tiles`` tiles are cut into ``ranges`` ranges of whole tiles
    (range r: tiles ``nv r // S`` to ``nv (r + 1) // S``). ``grid`` is the
    launch's blocks, range-major, of ``threads`` (bf16: two consumer
    warpgroups and a producer warp; fp32: 256); ``smem_bytes`` each block's
    dynamic shared memory: ``align`` slack, the ring's h and emb chunks
    (``h_stage_bytes`` and ``emb_stage_bytes`` a stage), ``barrier_bytes``
    of mbarriers."""

    route: str
    rows: int
    cols: int
    chunk: int
    stages: int
    e_pad: int
    token_tiles: int
    vocab_tiles: int
    ranges: int
    grid: tuple[int, ...]
    threads: int
    align: int
    h_stage_bytes: int
    emb_stage_bytes: int
    barrier_bytes: int
    smem_bytes: int

    def range_tiles(self, r: int) -> tuple[int, int]:
        """The vocabulary tiles [lo, hi) of range r."""
        return self.vocab_tiles * r // self.ranges, self.vocab_tiles * (r + 1) // self.ranges


def _fwd_smem(stages: int, chunk: int, elem: int) -> int:
    """``fwd_smem_bytes`` (bf16) and ``fwd32::smem_bytes`` (fp32) of
    ``csrc/fused_head_fwd.cu``: alignment slack, a stage's h and emb chunks
    of ``chunk`` columns of ``elem``-byte elements, a full and an empty
    mbarrier a stage."""
    return 1024 + stages * chunk * elem * (_FWD_ROWS + _FWD_COLS) + 16 * stages


def _fwd_plan(T: int, V: int, E: int, dtype, sms: int = 132) -> FwdPlan:
    """The launch of the forward kernel for these shapes on a card of ``sms``
    SMs.

    Both routes: 128-token blocks, 128-column vocabulary tiles. bf16: three
    ring stages of 128 E columns (as many as fit), E padded to a multiple
    of 8; fp32: three stages of 64 columns, E padded to a multiple of 4. The
    vocabulary is cut into S ranges, S the one that minimises waves(S) *
    (tiles a range + 1) (a wave is ``sms`` blocks, one an SM; the + 1 a
    block's start and its partials), the fewest on a tie, at most 32 and at
    most the tiles: at the MoE flagship (64 token tiles, 250 vocabulary
    tiles) 2 ranges, 128 blocks in one wave."""
    if dtype not in _FWD_ROUTES:
        raise TypeError(f"fused head kernels take bf16 or fp32 operands, got {dtype}")
    route, chunk, elem, stages, threads = _FWD_ROUTES[dtype]
    e_pad = -(-E // (16 // elem)) * (16 // elem)
    ntt, nv = -(-T // _FWD_ROWS), -(-V // _FWD_COLS)
    smem = _fwd_smem(stages, chunk, elem)
    assert smem <= SMEM_LIMIT, smem

    def cost(S):
        return -(-ntt * S // sms) * (-(-nv // S) + 1), S

    ranges = min(range(1, min(nv, _FWD_MAX_RANGES) + 1), key=cost)
    return FwdPlan(route, _FWD_ROWS, _FWD_COLS, chunk, stages, e_pad, ntt, nv, ranges,
                   (ntt * ranges,), threads, 1024, chunk * elem * _FWD_ROWS,
                   chunk * elem * _FWD_COLS, 16 * stages, smem)


def _fwd_split_reference(h, emb, tgt, plan: FwdPlan):
    """The forward kernel's partition in plain PyTorch (a witness, never on
    the main path): each of the plan's vocabulary ranges gives per row its
    max m_r, its sum of exp(logit − m_r) and its gold logit (0 where the
    target lies outside the range), fp32 logits from the operands as they
    are; the ranges combine in range order, a range with no column (m_r =
    −inf: past V, or empty) adding nothing, and lse = m + log(s). Sums differ
    from the kernel's in order only (it folds tile by tile)."""
    T, V = h.shape[0], emb.shape[0]
    m = torch.full((T,), -torch.inf, dtype=torch.float32, device=h.device)
    parts = []
    for r in range(plan.ranges):
        lo, hi = (min(V, x * plan.cols) for x in plan.range_tiles(r))
        if hi <= lo:
            parts.append(None)
            continue
        logits = matmul_f32(h, emb[lo:hi])
        m_r = logits.amax(dim=1)
        s_r = torch.exp(logits - m_r[:, None]).sum(dim=1)
        inside = (tgt >= lo) & (tgt < hi)
        g_r = torch.where(inside, logits.gather(1, torch.where(inside, tgt - lo, 0)
                                                 .long()[:, None])[:, 0], 0.0)
        parts.append((m_r, s_r, g_r))
        m = torch.maximum(m, m_r)
    s = torch.zeros_like(m)
    gold = torch.zeros_like(m)
    for part in parts:
        if part is not None:
            m_r, s_r, g_r = part
            s = s + s_r * torch.exp(m_r - m)
            gold = gold + g_r
    return m + torch.log(s), gold


def _bwd_split_reference(h, emb, tgt, lse, dlse, dgold, plan: HeadPlan):
    """The backward kernels' partition of E in plain PyTorch (a witness,
    never on the main path): (dh [T, E], dE [V, E]) fp32. The operands are
    zero-padded to the plan's ``e_pad`` and cut into its ``cluster`` slices
    of ``slice`` columns; each slice gives the partial logits over its own
    columns only, the partials are summed in block order, the dlogits formed
    once from the sum (rounded to h's dtype: unrounded on fp32), and each
    slice's columns of dh and dE are the products with that slice alone.
    Sums differ from the kernels' in order only."""
    E, V = h.shape[1], emb.shape[0]
    hp, ep = _pad_e(h, plan.e_pad), _pad_e(emb, plan.e_pad)
    cuts = [slice(c * plan.slice, min((c + 1) * plan.slice, plan.e_pad))
            for c in range(plan.cluster)]
    logits = matmul_f32(hp[:, cuts[0]], ep[:, cuts[0]])
    for cut in cuts[1:]:
        logits = logits + matmul_f32(hp[:, cut], ep[:, cut])
    y = (torch.arange(V, device=h.device)[None, :] == tgt[:, None]).float()
    dl = (dlse[:, None] * torch.exp(logits - lse[:, None]) + dgold[:, None] * y).to(h.dtype)
    dh = torch.cat([matmul_f32(dl, ep[:, cut].t()) for cut in cuts], dim=1)
    de = torch.cat([matmul_f32(dl.t(), hp[:, cut].t()) for cut in cuts], dim=1)
    return dh[:, :E], de[:, :E]


def _pad_e(x, e_pad: int):
    """x [R, E] zero-padded to [R, e_pad] columns (x itself when E = e_pad):
    a zero column adds 0 to every logit and its output column is dropped."""
    if x.shape[1] == e_pad:
        return x
    return torch.nn.functional.pad(x, (0, e_pad - x.shape[1]))


def lse_gold_plain(h, emb, tgt):
    """Plain version of the forward kernel (``_reference_lse_gold``,
    ``:258-264``): fp32 logits from the operands as they are, then
    logsumexp and the gold logit (0 for a target outside [0, V))."""
    T, V = h.shape[0], emb.shape[0]
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    gold = torch.empty(T, dtype=torch.float32, device=h.device)
    valid = (tgt >= 0) & (tgt < V)
    safe = torch.where(valid, tgt, 0).long()
    for s in range(0, T, PLAIN_CHUNK):
        logits = matmul_f32(h[s:s + PLAIN_CHUNK], emb)
        lse[s:s + PLAIN_CHUNK] = torch.logsumexp(logits, dim=-1)
        g = logits.gather(1, safe[s:s + PLAIN_CHUNK, None])[:, 0]
        gold[s:s + PLAIN_CHUNK] = torch.where(valid[s:s + PLAIN_CHUNK], g, 0.0)
    return lse, gold


def head_grads_plain(h, emb, tgt, lse, dlse, dgold, *, dh: bool = True, de: bool = True):
    """Plain version of the two backward kernels (``_dh_kernel`` /
    ``_de_kernel``, ``:157-209``): (dh [T, E], dE [V, E]) in fp32, either
    None when not asked for. The logits are recomputed, dlogits = dlse · p +
    dgold · y in fp32 is rounded to h's dtype, and both products sum in fp32."""
    T, E = h.shape
    V = emb.shape[0]
    cols = torch.arange(V, device=h.device)
    out_dh = torch.empty((T, E), dtype=torch.float32, device=h.device) if dh else None
    out_de = torch.zeros((V, E), dtype=torch.float32, device=h.device) if de else None
    for s in range(0, T, PLAIN_CHUNK):
        h_c = h[s:s + PLAIN_CHUNK]
        logits = matmul_f32(h_c, emb)
        p = torch.exp(logits - lse[s:s + PLAIN_CHUNK, None])
        y = (cols[None, :] == tgt[s:s + PLAIN_CHUNK, None]).float()
        dl = (dlse[s:s + PLAIN_CHUNK, None] * p + dgold[s:s + PLAIN_CHUNK, None] * y).to(h.dtype)
        if dh:
            out_dh[s:s + PLAIN_CHUNK] = matmul_f32(dl, emb.t())
        if de:
            out_de += matmul_f32(dl.t(), h_c.t())
    return out_dh, out_de


def _check_shapes(h, emb, tgt, *rows):
    T = h.shape[0] if h.dim() == 2 else -1
    if (h.dim() != 2 or emb.dim() != 2 or h.shape[1] != emb.shape[1]
            or tgt.shape != (T,) or any(r.shape != (T,) for r in rows)):
        raise ValueError(
            f"expected h [T, E], emb [V, E], tgt and row vectors [T]; got "
            f"{[tuple(x.shape) for x in (h, emb, tgt, *rows)]}")
    if min(h.shape) < 1 or emb.shape[0] < 1:
        raise ValueError(f"empty operands: h {tuple(h.shape)}, emb {tuple(emb.shape)}")


def _kernel_args(what, h, emb, tgt, *rows):
    """The kernel's operands: bf16 or fp32 h and emb of one dtype, int32
    targets, fp32 rows, all on h's CUDA device, contiguous, 16-byte aligned;
    raise otherwise."""
    if h.dtype not in (torch.bfloat16, torch.float32) or emb.dtype != h.dtype:
        raise TypeError(f"{what} kernel takes bf16 or fp32 h and emb of one dtype, got "
                        f"{h.dtype} and {emb.dtype}")
    if tgt.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: tgt must be an integer tensor, got {tgt.dtype}")
    if any(r.dtype != torch.float32 for r in rows):
        raise TypeError(f"{what}: lse, dlse and dgold must be float32")
    if h.device.type != "cuda":
        raise TypeError(f"{what} kernel takes CUDA tensors; h is on {h.device}")
    for name, t in (("emb", emb), ("tgt", tgt)) + tuple(
            (f"row {i}", r) for i, r in enumerate(rows)):
        if t.device != h.device:
            raise ValueError(f"{what}: {name} is on {t.device}, h on {h.device}")
    for name, t in (("h", h), ("emb", emb)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs {name} contiguous and 16-byte aligned")
    return (tgt.to(torch.int32).contiguous(), *(r.contiguous() for r in rows))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_head_fwd(h, emb, tgt):
    """(lse [T], gold [T]) fp32 without autograd: the forward kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    _check_shapes(h, emb, tgt)
    if h.device.type == "cpu":
        return lse_gold_plain(h, emb, tgt)
    (tgt,) = _kernel_args("fused_head_fwd", h, emb, tgt)
    T, E = h.shape
    V = emb.shape[0]
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    plan = _fwd_plan(T, V, E, h.dtype, sms)
    h_k, emb_k = _pad_e(h, plan.e_pad), _pad_e(emb, plan.e_pad)
    stream = _stream(h)
    # with ranges: 3 fp32 rows of 128 a (token tile, range), a ticket a token tile
    ws, tickets = (None, None) if plan.ranges == 1 else _workspace.workspace(
        h.device, stream, plan.token_tiles * plan.ranges * 3 * plan.rows, plan.token_tiles)
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    gold = torch.empty(T, dtype=torch.float32, device=h.device)
    _build.launch("fused_head_fwd", h_k.data_ptr(), emb_k.data_ptr(), tgt.data_ptr(),
                  lse.data_ptr(), gold.data_ptr(), ws.data_ptr() if ws is not None else None,
                  tickets.data_ptr() if tickets is not None else None, T, V, plan.e_pad,
                  int(plan.route == "fma"), plan.ranges, plan.stages, plan.smem_bytes, stream)
    fused_head_fwd.launches += 1
    return lse, gold


def _scratch(plan, rows_out, device):
    """(cap, ws, flags) of a launch with one pass, either route: room for
    the sums of row tiles split between clusters, a block's [rows, slice]
    accumulators a (cluster, block). The launcher takes as many clusters as
    fit on the card at once, at most the row tiles' count and ``cap``, here
    the row tiles' count or one cluster an SM, whichever is fewer
    (``launch_bwd_wgmma`` in ``csrc/fused_head_common.cuh``, ``launch_fma``
    in ``csrc/fused_head_fma.cuh``)."""
    nrt = -(-rows_out // plan.rows)
    if plan.passes > 1 or nrt == 1:
        return 0, None, None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cap = min(nrt, max(1, sms // plan.cluster))
    ws = torch.empty(cap * plan.cluster * plan.rows * plan.slice, dtype=torch.float32,
                     device=device)
    return cap, ws, torch.zeros(cap * plan.cluster, dtype=torch.int32, device=device)


def _backward(name, h, emb, tgt, lse, dlse, dgold, rows_out):
    tgt, lse, dlse, dgold = _kernel_args(name, h, emb, tgt, lse, dlse, dgold)
    T, E = h.shape
    V = emb.shape[0]
    plan = _plan(T, V, E, h.dtype)
    h_k, emb_k = _pad_e(h, plan.e_pad), _pad_e(emb, plan.e_pad)
    out = torch.empty((rows_out, plan.e_pad), dtype=torch.float32, device=h.device)
    cap, ws, flags = _scratch(plan, rows_out, h.device)
    _build.launch(name, h_k.data_ptr(), emb_k.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
                  dlse.data_ptr(), dgold.data_ptr(), out.data_ptr(), T, V, plan.e_pad,
                  int(plan.route == "fma"), plan.cluster, plan.slabs, plan.passes,
                  plan.rows, plan.smem_bytes, cap, ws.data_ptr() if ws is not None else None,
                  flags.data_ptr() if flags is not None else None, _stream(h))
    return out if plan.e_pad == E else out[:, :E].contiguous()


def fused_head_bwd_dh(h, emb, tgt, lse, dlse, dgold):
    """dh [T, E] fp32 without autograd: the dh kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_shapes(h, emb, tgt, lse, dlse, dgold)
    if h.device.type == "cpu":
        return head_grads_plain(h, emb, tgt, lse, dlse, dgold, de=False)[0]
    out = _backward("fused_head_bwd_dh", h, emb, tgt, lse, dlse, dgold, h.shape[0])
    fused_head_bwd_dh.launches += 1
    return out


def fused_head_bwd_de(h, emb, tgt, lse, dlse, dgold):
    """dE [V, E] fp32 without autograd: the dE kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_shapes(h, emb, tgt, lse, dlse, dgold)
    if h.device.type == "cpu":
        return head_grads_plain(h, emb, tgt, lse, dlse, dgold, dh=False)[1]
    out = _backward("fused_head_bwd_de", h, emb, tgt, lse, dlse, dgold, emb.shape[0])
    fused_head_bwd_de.launches += 1
    return out


class _FusedLseGold(torch.autograd.Function):
    """``head_lse_gold``'s ``jax.custom_vjp``: the forward kernel, then the
    dh and dE kernels from the residuals h, the table (cast to h's dtype),
    the targets and lse (``_vjp_fwd``, ``:281-283``)."""

    @staticmethod
    def forward(ctx, h, table, tgt):
        emb = table.to(h.dtype).contiguous()
        h = h.contiguous()
        tgt = tgt.to(torch.int32)             # int64 from torch: converted once
        lse, gold = fused_head_fwd(h, emb, tgt)
        ctx.save_for_backward(h, emb, tgt, lse)
        return lse, gold

    @staticmethod
    def backward(ctx, dlse, dgold):
        h, emb, tgt, lse = ctx.saved_tensors
        args = (h, emb, tgt, lse, dlse.float().contiguous(), dgold.float().contiguous())
        dh = fused_head_bwd_dh(*args).to(h.dtype) if ctx.needs_input_grad[0] else None
        # fp32 for the table as it came in: autograd rounds it only if the
        # table itself is held in a lower precision
        de = fused_head_bwd_de(*args) if ctx.needs_input_grad[1] else None
        return dh, de, None


def fused_lse_gold(h, emb, tgt):
    """(lse [T], gold [T]) fp32 of logits = h @ embᵀ without materialising
    them, differentiable in h and emb. h [T, E] in the compute dtype (bf16 or
    fp32 on the card), emb [V, E] in any float dtype (cast to h's inside; its
    gradient keeps emb's dtype), tgt [T] int. Every shape takes the kernels
    on the card; CPU tensors take the plain versions."""
    return _FusedLseGold.apply(h, emb, tgt)


def fused_head_nll(hidden, embedding, tokens, *, compute_dtype=torch.bfloat16, start: int = 0):
    """Mean next-token NLL over [B, S] tokens with the tied head fused.

    Drop-in for ``lm_loss_chunked``: hidden [B, S, E] from
    ``return_hidden=True``, the tied ``embedding [V, E]`` (fp32 parameters:
    pass the table itself, not a cast of it, so its gradient stays fp32).
    ``start`` as there: ``hidden`` holds positions ``start .. start+S-1`` of
    the rows ``tokens`` [B, T] (a seq rank's span), whose targets are
    ``tokens[:, start+1 : start+S+1]``; only the row's last position has
    none, and the sum is divided by the whole rows' B·(T-1) targets."""
    B, S, E = hidden.shape
    T = tokens.shape[1]
    if start < 0 or start + S > T:
        raise ValueError(f"positions {start} .. {start + S - 1} are outside rows of {T} tokens")
    h = hidden.reshape(B * S, E).to(compute_dtype)
    tgt = torch.roll(tokens, -1, dims=1)[:, start:start + S].reshape(B * S)
    mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if start + S == T:
        mask[:, -1] = 0.0
    mask = mask.reshape(B * S)
    count = torch.full((), float(B * (T - 1)), dtype=torch.float32, device=hidden.device)
    lse, gold = fused_lse_gold(h, embedding, tgt)
    return torch.sum((lse - gold) * mask) / count


fused_head_fwd.launches = 0
fused_head_bwd_dh.launches = 0
fused_head_bwd_de.launches = 0
