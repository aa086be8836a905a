"""Flash attention for the PyTorch port: forward and backward.

Counterpart of ``kubeflow_tpu/ops/pallas_attention.py``. Three CUDA kernels
replace the three Pallas kernels of that module:

- ``csrc/flash_attention_fwd.cu`` replaces ``_fwd_kernel`` (``:160``);
- ``csrc/flash_attention_bwd_dq.cu`` replaces ``_dq_kernel`` (``:290``);
- ``csrc/flash_attention_bwd_dkv.cu`` replaces ``_dkv_kernel`` (``:336``).

What bounds them on an H100: at the serving path's prefill shape (B4 H8 KV4
S128 D128, causal) the forward moves ~3 MB and does ~0.14 GFLOP, so HBM bytes
and launch latency bound it; at the training shape (B4 H8 S2048 D128, causal)
all three are bound by FLOPs (forward 2, dq 3, dk/dv 4 causal matmuls of
1.7e10 FLOP each, against ~84 MB of bf16 operands).

Two routes, chosen by :func:`_plan` from the operands' dtype and width:

- **bf16: tensor cores.** A producer (a warpgroup for the forward and dq,
  thread 0 for dk/dv) keeps tiles in flight by TMA into a 2-stage
  shared-memory ring; one or two consumer warpgroups (64 rows each)
  multiply with ``wgmma`` (bf16 operands, fp32 accumulators) and
  keep P (forward), dS (dq) or P^T and dS^T (dk/dv) in registers as the next
  product's operand. The forward and dq hold a query tile and stream K/V
  tiles of 64 keys; ``_plan`` takes 128-row query tiles where they still
  give every SM a block, else 64 (at width 256 always 64). dk/dv holds 64
  or 128 keys (by the same rule; at width 256 always 64) and streams the Q,
  dO and O tiles of 64 query rows (48 at width 256) that can see them, over
  every query head of the GQA group.
- **fp32: fp32 FMAs, no TF32.** All three kernels are the tensor-core
  route's walks with register-tiled FMA products, 256 threads, the resident
  side's tiles loaded once and the streamed side's through a 2-stage TMA
  ring; P (forward), dS (dq), P^T and dS^T (dk/dv) pass to the next
  product through fp32 shared tiles. The forward holds 128 query rows and
  streams 64-key tiles (64 rows and 32 keys at width 256), a thread 8 x 4
  scores and 8 x 8 of O at width 128 (:func:`_fma_fwd_bytes`). dq holds 64
  query rows (Q and dO) and streams 64-key tiles, a thread 4 x 4 of S and
  of dP (one loop) and 4 x 8 of dQ at width 128. dk/dv holds 64 keys (K and
  V) and streams the Q and dO tiles of 64 rows, its two warpgroups split as
  the bf16 width-256 kernel's (one S^T, P^T and dV, the other dP^T, dS^T
  and dK, P^T handed over through shared memory), a thread 8 x 4 scores and
  8 x 8 of its accumulator at width 128; both take 32 and 32 at width 256
  (:func:`_fma_bwd_tiles`, :func:`_fma_bwd_bytes`). At 512 all three run
  their width-256 kernels on the two column halves as a cluster of two
  blocks, as the bf16 dq and dk/dv pairs below do. dk/dv reads O from
  device memory for delta, which its warpgroups share through shared
  memory. The TPU kernels' rounding points are the identity in fp32.

The kernels are compiled for head widths 64, 128, 256 and 512. bf16 takes
the tensor cores in all three kernels at every width. At 256
(``_WGMMA_64_ROWS_D``) the forward and dq take them in 64-row tiles only
(one consumer warpgroup beside the producer, where a thread may hold 255
registers), and dk/dv in blocks of 64 keys whose two consumer warpgroups
each own one of dK and dV (one warpgroup holding both, with S^T and dP^T,
would need 320 registers a thread, and 64-row ring tiles would pass the
block's shared memory: :func:`_wgmma_sums`); warpgroup 0 hands its fp32
P^T to warpgroup 1 through shared memory. At 512 an accumulator of 64 rows
would take a thread's every register. In the forward (``_HALVES_D``) two
warpgroups on the same 64 rows each own 256 of O's columns and both compute
the scores over all 512, K/V streamed in 32-key tiles, thread 0 issuing the
copies between its own products. dq and dk/dv (``_PAIR_D``) run their
width-256 kernels on the two column halves as a cluster of
``_PAIR_CLUSTER`` blocks (a grid axis of twice the tiles): each block holds
256 columns of every operand, computes its partial score products over
them and swaps them with the other block through distributed shared
memory, so every score product is computed once; dk/dv keeps one O tile,
loaded one ring item ahead, and swaps its partial delta too
(:func:`_pair_reference` is their order of operations in plain PyTorch,
:func:`_pair_forward_reference` the fp32 forward pair's).
fp32 takes the FMA kernels at every width (at 512 the forward, dq and
dk/dv the same pairs of width-256 blocks: the forward 64 rows and 32-key
tiles a block, dq and dk/dv 32 and 32, each block's 256 threads swapping 8
partials, dk/dv's partial delta too, dq's delta read over every column by
both). Any head size D up to 512 runs on
them: :func:`_pad_heads` zero-pads the head axis to the next width and
launches with the true ``D ** -0.5`` as the
softmax scale, so the scores, the softmax and delta = rowsum(dO·O) are the
unpadded ones, and cuts the padded columns off o, dq, dk and dv (products
with zero columns). At D 64, 128, 256 and 512 nothing is copied. D above
512 is a stated refusal: the message gives the shared memory the width-512
designs would need at D padded to 64 columns against the card's limit, and
the columns each of their two warpgroups or blocks would own against wgmma's
widest product.

What every kernel does:

- one thread block per query tile (key tile for dk/dv), head and batch row;
  a loop inside the block over the other side's tiles takes the place of the
  TPU kernels' sequential grid axis, and the accumulators stay in fp32
  registers across it;
- causal and sliding-window tile skipping: a tile that no row of the block
  can see is never loaded;
- GQA: query head ``h`` reads kv head ``h // group``; grouped K/V are never
  expanded. The dk/dv kernel owns one kv head and loops over its group's
  query heads, so it sums the group in fp32 inside the block: no per-head
  partials, no atomics, a deterministic result;
- the TPU kernels' rounding points: probabilities rounded to the operands'
  dtype before the value products, ``ds`` before the key and query products.

Autograd: :func:`flash_attention` always calls the custom op
``kubeflow_tpu_torch::flash_attention_fwd`` (the forward kernel with lse), so
that selective checkpointing can see it and keep its outputs (the ``flash``
remat policy). The op's registered backward launches the dq and dk/dv
kernels.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF

_KERNEL_D = (64, 128, 256, 512)   # head widths the kernels are compiled for
# widths where the bf16 forward and dq take the tensor cores in 64-row tiles
# only: two consumer warpgroups beside the producer leave a thread
# ``_REGS_BESIDE_PRODUCER`` registers, fewer than their accumulators (forward
# 160, dq 192) and the addresses, counters and softmax state beside them
# (ptxas gives the one-consumer kernels 196 and 228); dk/dv takes blocks of
# 64 keys with two warpgroups, one owning dV and one dK (152 accumulators
# each), Q, dO and O in ``_PAIR_QROWS``-row tiles
_WGMMA_64_ROWS_D = (256,)
# widths where one warpgroup's accumulator of 64 rows would take every
# register a thread has (256 fp32 at 512): the forward's two warpgroups each
# own half of O's columns
_HALVES_D = (512,)
# ... and where dq and dk/dv run their width-256 kernels (``_PAIR_COLS``
# columns a block) on the column halves, as a cluster of ``_PAIR_CLUSTER``
# blocks that swap their partial score products
_PAIR_D = (512,)
_PAIR_CLUSTER = 2
_PAIR_COLS = 256


def _group_of(q, k, v):
    """GQA group size from [B, S, H, D] operands; validates head divisibility."""
    H, KV = q.shape[2], k.shape[2]
    if v.shape[2] != KV:
        raise ValueError(
            f"k and v must carry the same head count, got {KV} vs {v.shape[2]}"
        )
    if H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {KV}")
    return H // KV


def _block_plan(Sq, Sk, block_q, block_k):
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq lengths ({Sq},{Sk}) must divide blocks ({bq},{bk})")
    return bq, bk


def _keep_mask(Sq, Sk, causal, window, device):
    """[Sq, Sk] bool: key k is visible to query q (positions from 0 on both)."""
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


_SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448        # bytes of shared memory a block may take on Hopper
_REGS_BESIDE_PRODUCER = 168  # registers a thread keeps beside a producer warpgroup (CUDA 12.8 ptxas)
_REGS_MAX = 255             # registers a thread may hold
_TILE_K = 64                # keys a tile on both routes
_STAGES = 2                 # ring tiles in flight on the tensor-core route
_QROWS = 64                 # query rows of a dk/dv ring tile
_PAIR_QROWS = 48            # ... at the widths of ``_WGMMA_64_ROWS_D``
_HALF_KEYS = {"fwd": 32}    # keys a K/V ring tile of the forward at the widths of ``_HALVES_D``
_WGMMA_N_MAX = 256          # the widest wgmma product, in columns
_FMA_THREADS = 256          # threads of the fp32 FMA kernels


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one flash kernel launches. ``route`` "wgmma" is the bf16
    tensor-core kernel, "fma" the fp32 kernel of register-tiled FMAs;
    ``block`` is the query
    rows a block (forward, dq) or the keys a block (dk/dv); ``width`` the
    head width the kernel runs at (the head size zero-padded to 64, 128,
    256 or 512); ``cluster`` the blocks of a thread-block cluster along the
    grid's last axis (2 at the widths of ``_PAIR_D`` for dq and dk/dv, and
    for the fp32 forward)."""

    route: str
    block: int
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    width: int
    cluster: int = 1


def _wgmma_sums(kernel: str, block: int, width: int) -> tuple[int, int]:
    """(shared-memory bytes, fp32 accumulator registers of a consumer
    thread) of the bf16 tensor-core ``kernel`` with ``block`` query rows
    (forward, dq) or keys (dk/dv) at head width ``width``.

    Shared memory: 1024 bytes of alignment slack and the mbarriers; the
    forward and dq hold the Q (and dO) tile, ``_STAGES`` K and V tiles of 64
    keys and dq's delta row; dk/dv holds its K and V, ``_STAGES`` Q, dO and O
    tiles of 64 rows and each consumer warpgroup's two delta/lse rows, and at
    the widths of ``_WGMMA_64_ROWS_D`` tiles of ``_PAIR_QROWS`` rows, the
    fp32 P^T exchange slot, two delta rows and the slot's two mbarriers.
    From width 512 on (the refusal sums wider ones) the 64-row forward
    (``_HALVES_D``) holds Q and K/V tiles of ``_HALF_KEYS["fwd"]`` keys; a
    block of dq's or dk/dv's pair (``_PAIR_D``) the width-256 layout over its
    half of the columns (slabs of 64 columns, rounded up), one O tile at
    dk/dv, and the receive slots of the other block's partials: dq's S and
    dP [64, 64] fp32 and their two mbarriers, dk/dv's S^T and dP^T [block,
    ``_PAIR_QROWS``] fp32, its partial delta row and five mbarriers. The
    launchers check the same sums. Registers: a consumer warpgroup's 64 rows
    of fp32 accumulators over its 128 threads: O and S (forward), dQ, S and
    dP (dq), dK, dV, S^T and dP^T (dk/dv), or at the wide widths the busier
    of the pair's two: dV and S^T, or dK and dP^T; from 512 on half of O
    beside S, a block's dQ beside S and dP, or its dV or dK beside S^T or
    dP^T."""
    bars = 8 * (1 + 2 * _STAGES)
    slabs = width // 64                     # 64-column bf16 slabs of a row
    if width >= _HALVES_D[0] and kernel == "fwd":
        keys = _HALF_KEYS["fwd"]
        return (1024 + slabs * 64 * 128 + 2 * _STAGES * slabs * keys * 128 + bars,
                width // 4 + keys // 2)
    if width >= _PAIR_D[0]:
        half = -(-width // _PAIR_CLUSTER // 64)     # slabs of a block's columns
        if kernel == "dq":
            tiles = 2 * half * 64 * 128            # Q, dO
            kv = 2 * _STAGES * half * _TILE_K * 128
            rx = 2 * 64 * _TILE_K * 4              # the other block's S and dP
            return 1024 + tiles + kv + 4 * 64 + rx + bars + 8 * 2, half * 32 + _TILE_K
        rows = _PAIR_QROWS
        kv = 2 * half * block * 128
        ring = (2 * _STAGES + 1) * half * rows * 128   # Q, dO tiles and one O tile
        slot = block * rows * 4
        rx = 2 * block * rows * 4 + rows * 4       # the other block's S^T, dP^T and delta
        return (1024 + kv + ring + slot + 2 * rows * 4 + rx + bars + 8 * 2 + 8 * 5,
                half * 32 + rows // 2)
    if kernel in ("fwd", "dq"):
        tiles = (1 if kernel == "fwd" else 2) * slabs * 64 * 2 * block
        kv = 2 * _STAGES * slabs * _TILE_K * 128
        delta = 4 * block if kernel == "dq" else 0
        return 1024 + tiles + kv + delta + bars, width // 2 + (32 if kernel == "fwd" else 64)
    kv = 2 * slabs * block * 128                   # resident K and V
    if width in _WGMMA_64_ROWS_D:
        ring = 3 * _STAGES * slabs * _PAIR_QROWS * 128
        slot = block * _PAIR_QROWS * 4             # fp32 P^T [block, rows]
        rows = 2 * _PAIR_QROWS * 4                 # [2] delta
        return 1024 + kv + ring + slot + rows + bars + 8 * 2, width // 2 + _PAIR_QROWS // 2
    ring = 3 * _STAGES * slabs * _QROWS * 128      # Q, dO, O tiles
    rows = (block // 64) * 2 * 2 * _QROWS * 4      # [2][delta | lse] a consumer
    return 1024 + kv + ring + rows + bars, width + 64


def _fma_fwd_tiles(width: int) -> tuple[int, int]:
    """(query rows, keys) of the fp32 forward's tiles at head width
    ``width``: 128 rows and 64 keys up to 128, 64 rows and 32 keys from 256
    on (at the widths of ``_PAIR_D`` a block of the pair's, over its half of
    the columns)."""
    return (128, 64) if width <= 128 else (64, 32)


def _fma_fwd_bytes(width: int) -> int:
    """Shared memory of the fp32 forward (``flash_fwd_fma``) at head width
    ``width``, part by part as ``fwd32::Layout`` in
    ``csrc/flash_attention_fwd.cu`` sums it (the launcher checks it): 1024
    bytes of alignment slack, the fp32 Q tile, ``_STAGES`` fp32 K and V
    tiles, the fp32 P tile [rows, keys], the mbarriers (Q, full and empty a
    stage). From ``_PAIR_D`` on (the refusal sums wider ones) a block of the
    pair holds its half of the columns (in 32-column slabs, rounded up) and
    the receive slot of the other block's partial S [rows, keys] with its
    two mbarriers."""
    rows, keys = _fma_fwd_tiles(width)
    pair = width >= _PAIR_D[0]
    cols = -(-width // _PAIR_CLUSTER // 32) * 32 if pair else width
    rx = 4 * rows * keys + 8 * 2 if pair else 0
    return (1024 + 4 * rows * cols + _STAGES * 2 * 4 * keys * cols + 4 * rows * keys
            + 8 * (1 + 2 * _STAGES) + rx)


def _fma_bwd_tiles(kernel: str, width: int) -> tuple[int, int]:
    """The fp32 backward ``kernel``'s tiles at head width ``width``: dq's
    (query rows a block, keys a streamed tile), dk/dv's (keys a block, query
    rows a streamed tile); 64 and 64 up to 128, 32 and 32 from 256 on (at
    the widths of ``_PAIR_D`` a block of the pair's, over its half of the
    columns)."""
    return (64, 64) if width <= 128 else (32, 32)


def _fma_bwd_bytes(kernel: str, width: int) -> int:
    """Shared memory of the fp32 ``kernel`` ("dq": ``flash_dq_fma``, "dkv":
    ``flash_dkv_fma``) at head width ``width``, part by part as its
    ``Layout`` in ``csrc/flash_attention_bwd_{dq,dkv}.cu`` sums it (the
    launcher checks it): 1024 bytes of alignment slack, the resident fp32
    tiles (Q and dO, or K and V), ``_STAGES`` streamed tiles (K and V, or Q
    and dO), the fp32 tiles rows pass through [block, tile] (dq's dS, dk/dv's
    P^T and dS^T) and dk/dv's delta row of each stage, and the mbarriers
    (the resident tiles', full and empty a stage, dk/dv's P^T full and
    empty). From ``_PAIR_D`` on (the refusal sums wider ones) a block of the
    pair holds its half of the columns (in 32-column slabs, rounded up) and
    the receive slots of the other block's partials: dq's S and dP [block,
    tile] and their two mbarriers; dk/dv's S^T and dP^T [block, tile], its
    partial delta row and each warpgroup's two mbarriers."""
    block, tile = _fma_bwd_tiles(kernel, width)
    pair = width >= _PAIR_D[0]
    cols = -(-width // _PAIR_CLUSTER // 32) * 32 if pair else width
    resident = 2 * 4 * block * cols
    ring = _STAGES * 2 * 4 * tile * cols
    if kernel == "dq":
        rx = 2 * 4 * block * tile + 8 * 2 if pair else 0
        return 1024 + resident + ring + 4 * block * tile + 8 * (1 + 2 * _STAGES) + rx
    exchange = 2 * 4 * block * tile
    rows = _STAGES * 4 * tile
    rx = 2 * 4 * block * tile + 4 * tile + 8 * 4 if pair else 0
    return 1024 + resident + ring + exchange + rows + 8 * (1 + 2 * _STAGES + 2) + rx


def _wide_head_refusal(D: int) -> str:
    """Why D above 512 is refused: the width-512 designs at D padded to 64
    columns, in shared-memory bytes (:func:`_wgmma_sums`, and the fp32
    kernels' :func:`_fma_fwd_bytes` and :func:`_fma_bwd_bytes` at their
    width-512 tiles) and in the columns and registers a warpgroup would own."""
    width = -(-D // 64) * 64
    bf16 = "; ".join(f"{name} {_wgmma_sums(k, 64, width)[0]:,}"
                     for name, k in (("forward", "fwd"), ("dq", "dq"), ("dk/dv", "dkv")))
    fp32 = (f"forward {_fma_fwd_bytes(width):,}; dq {_fma_bwd_bytes('dq', width):,}; "
            f"dk/dv {_fma_bwd_bytes('dkv', width):,}")
    return (f"flash kernels take head_dim up to {_KERNEL_D[-1]} (zero-padded to 64, 128, 256 "
            f"or 512), got {D}. At width {width} the width-512 designs would need shared "
            f"memory bytes a block of: bf16 {bf16}; fp32 (its width-512 tiles) {fp32}; the card "
            f"gives a block {SMEM_LIMIT:,} bytes. Each of the forward's two warpgroups that "
            f"split O, and each of the two blocks of a cluster that split dQ, dK and dV, would "
            f"own {width // 2} columns ({width // 4} fp32 accumulator registers a thread), more "
            f"than wgmma's widest product of {_WGMMA_N_MAX}; a train step needs all three "
            f"kernels")


def _kernel_width(D: int) -> int:
    """The head width the kernels run at: D zero-padded to 64, 128, 256 or 512."""
    if not 1 <= D <= _KERNEL_D[-1]:
        raise ValueError(_wide_head_refusal(D))
    return next(w for w in _KERNEL_D if D <= w)


def _plan(kernel: str, B: int, Sq: int, Sk: int, H: int, KV: int, D: int, dtype,
          sms: int = _SMS) -> Plan:
    """The launch of ``kernel`` ("fwd", "dq" or "dkv") for these shapes, at
    head size ``D`` (planned at its padded ``width``, :func:`_kernel_width`).

    bf16 takes the tensor-core route: ``block // 64`` consumer warpgroups,
    with a producer warpgroup beside them for the forward and dq (for dk/dv
    thread 0 produces). The forward and dq: a grid
    of (H, B, query tiles), 128-row tiles where ``B * H * ceil(Sq / 128)``
    blocks still fill ``sms`` SMs (the training shape: 512 blocks), else
    64-row tiles (the serving prefill B4 H8 S128: 64 blocks where 128 rows
    would give 32); at widths ``_WGMMA_64_ROWS_D`` 64-row tiles at every
    shape. dk/dv: a grid of (KV, B, key blocks), 128 keys a block where
    ``B * KV * ceil(Sk / 128)`` blocks fill the SMs, else 64; at widths
    ``_WGMMA_64_ROWS_D`` 64 keys in 256 threads, two warpgroups owning dV and
    dK. At widths ``_HALVES_D`` the forward takes 64-row tiles in 256
    threads, two warpgroups each owning half of O's columns; at ``_PAIR_D``
    dq and dk/dv take the width-256 launch on each column half, as clusters
    of ``_PAIR_CLUSTER`` blocks along the grid's last axis (twice the query
    tiles or key blocks). Shared memory as :func:`_wgmma_sums` counts it. fp32: every kernel
    takes the FMA route, 256 threads; the forward a grid of (H, B, query
    tiles), the tiles of :func:`_fma_fwd_tiles` and the bytes of
    :func:`_fma_fwd_bytes`; dq and dk/dv the bf16 route's grids, the tiles
    of :func:`_fma_bwd_tiles` and the bytes of :func:`_fma_bwd_bytes`; at
    ``_PAIR_D`` all three the same clusters of ``_PAIR_CLUSTER`` blocks.
    """
    width = _kernel_width(D)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take bf16 or fp32 operands, got {dtype}")
    wide = width in _WGMMA_64_ROWS_D or width in _HALVES_D or width in _PAIR_D
    # the pairs: dq and dk/dv on both routes, the forward on the fp32 one
    pair = width in _PAIR_D and (kernel != "fwd" or dtype == torch.float32)
    cluster = _PAIR_CLUSTER if pair else 1
    if dtype == torch.bfloat16 and kernel in ("fwd", "dq"):
        rows = 128 if not wide and B * H * -(-Sq // 128) >= sms else 64
        smem, _ = _wgmma_sums(kernel, rows, width)
        return Plan("wgmma", rows, (H, B, cluster * -(-Sq // rows)), 128 * (rows // 64 + 1),
                    smem, width, cluster)
    if dtype == torch.bfloat16:
        keys = 128 if not wide and B * KV * -(-Sk // 128) >= sms else 64
        smem, _ = _wgmma_sums(kernel, keys, width)
        threads = 256 if wide else 128 * (keys // 64)
        return Plan("wgmma", keys, (KV, B, cluster * -(-Sk // keys)), threads, smem, width,
                    cluster)
    if kernel == "fwd":
        rows, _ = _fma_fwd_tiles(width)
        return Plan("fma", rows, (H, B, cluster * -(-Sq // rows)), _FMA_THREADS,
                    _fma_fwd_bytes(width), width, cluster)
    block, _ = _fma_bwd_tiles(kernel, width)
    grid = ((KV, B, cluster * -(-Sk // block)) if kernel == "dkv" else
            (H, B, cluster * -(-Sq // block)))
    return Plan("fma", block, grid, _FMA_THREADS, _fma_bwd_bytes(kernel, width), width, cluster)


def _pad_heads(inner, heads, width: int):
    """``inner(*heads, scale=D ** -0.5)`` with every tensor of ``heads``
    zero-padded on its last axis from the head size D to ``width``; of the
    tuple ``inner`` returns, the 4-D tensors (o, dq, dk, dv: head axis last)
    come back cut to D and the rest (lse) as they are.

    A zero column adds nothing to a score q·k or to delta = rowsum(dO·O),
    and the padded columns of o, dq, dk and dv are products with zero
    columns, so with the true D's scale the cut outputs are the unpadded
    ones. At D == width nothing is copied. ``inner`` is the kernel launch on
    the card and the plain version in the CPU tests."""
    D = heads[0].shape[-1]
    if D == width:
        return inner(*heads, scale=D ** -0.5)
    out = inner(*(F.pad(t, (0, width - D)) for t in heads), scale=D ** -0.5)
    return tuple(t[..., :D].contiguous() if t.dim() == 4 else t for t in out)


def _query_tiles(k0: int, keys: int, Sq: int, Sk: int, causal: bool,
                 window: int | None, rows: int = _QROWS) -> tuple[int, int]:
    """(first, count) of the ``rows``-row query tiles (``_QROWS``,
    ``_PAIR_QROWS`` at widths 256 and 512, or the fp32 kernel's rows of
    :func:`_fma_bwd_tiles`) that can see keys ``k0 .. k0 + keys - 1``: the
    dk/dv kernels' walk (``query_tiles`` in ``csrc/flash_common.cuh``,
    mirrored here for the CPU tests). Causal starts at the diagonal; the
    window ends ``window - 1`` rows after the last key."""
    k_last = min(k0 + keys - 1, Sk - 1)
    q_lo = k0 if causal else 0
    q_hi = min(Sq - 1, k_last + window - 1) if causal and window else Sq - 1
    first = q_lo // rows
    return first, (q_hi // rows - first + 1 if q_hi >= q_lo else 0)


def _key_tiles(q0: int, rows: int, Sq: int, Sk: int, causal: bool,
               window: int | None, keys: int = _TILE_K) -> tuple[int, int]:
    """(first, count) of the ``keys``-key tiles that query rows ``q0 .. q0
    + rows - 1`` can see: the forward's and dq's walk (``key_tiles`` in
    ``csrc/flash_common.cuh``, mirrored here for the CPU tests; the width-512
    dq pair skips none of its tiles). Causal ends at the last row's
    diagonal; the window starts ``window - 1`` keys before the first row."""
    k_hi = min(Sk - 1, q0 + rows - 1, Sq - 1) if causal else Sk - 1
    k_lo = max(0, q0 - window + 1) if causal and window else 0
    first = k_lo // keys
    return first, (k_hi // keys - first + 1 if k_hi >= k_lo else 0)


@functools.cache
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_kernel_inputs(what, **tensors):
    """The CUDA kernels take contiguous CUDA operands of one dtype, bf16 or
    fp32, 16-byte aligned (the tensor maps' rule); :func:`_plan` checks D."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{what} kernel takes bf16 or fp32 CUDA tensors; {name} is {t.dtype} on {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what} kernel takes operands of one dtype; {name} is {t.dtype}, not {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs {name} contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs {name} 16-byte aligned")


def _acc(t):
    """The plain versions' working type: fp32, or fp64 for fp64 inputs
    (``torch.autograd.gradcheck``)."""
    return t if t.dtype == torch.float64 else t.float()


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """Plain PyTorch version of the kernel: (o [B,Sq,H,D], lse [B,H,Sq] f32).

    ``scale`` defaults to ``D ** -0.5`` (a padded head passes its true D's).
    Scores and softmax in fp32; unnormalized probabilities are cast to v's
    dtype before the value product and divided by the fp32 row sum after it,
    as the TPU kernel does. A row that sees no key gives output 0 and lse
    +inf (the TPU kernel's ``l_safe`` rule, ``pallas_attention.py:200-204``).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    # fold query heads into [KV, group] so grouped K/V are read as they are
    qg = _acc(q).reshape(B, Sq, KV, group, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, _acc(k)) * (D ** -0.5 if scale is None else scale)
    keep = _keep_mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", _acc(p.to(v.dtype)), _acc(v))
    l_q = l.squeeze(-1).permute(0, 3, 1, 2)[..., None]     # [B, Sq, KV, group, 1]
    o = (o / torch.where(l_q == 0, 1.0, l_q)).reshape(B, Sq, H, D)
    lse = torch.where(l == 0, torch.inf, m + torch.log(torch.where(l == 0, 1.0, l)))
    return o.to(q.dtype), lse.reshape(B, H, Sq)


def _forward(q, k, v, causal, window):
    """(o, lse) from the plain version on the CPU or the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_kernel_inputs("flash_attention", q=q, k=k, v=v)
    return _pad_heads(functools.partial(_launch_forward, causal=causal, window=window),
                      (q, k, v), _kernel_width(q.shape[-1]))


def _launch_forward(q, k, v, *, scale, causal, window):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    plan = _plan("fwd", B, Sq, Sk, H, KV, D, q.dtype, _sms_of(q.device.index))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _build.launch(
        "flash_attention_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, KV, D, int(causal), window or 0, scale,
        int(q.dtype == torch.float32), plan.block, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention.launches += 1
    return o, lse


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal=True, window=None,
                                   grad_dtype=None, scale=None):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv).
    ``scale`` defaults to ``D ** -0.5``, as in the forward.

    An explicit formula with the TPU kernels' rounding points, not autograd
    through the forward:

    - ``delta = rowsum(do * o)`` in fp32 from the stored dtypes (``:300-304``);
    - ``p = exp(s - lse)`` in fp32; a masked score or an lse of +inf gives 0;
    - ``p`` rounded to do's dtype before ``p^T do`` (``:363-365``);
    - ``ds = p * (dp - delta) * scale`` rounded to the operand dtype before
      ``ds k`` (``:325-327``) and ``ds^T q`` (``:370-372``);
    - fp32 accumulation; under GQA dk and dv sum the group in fp32
      (``:454-456``);
    - outputs in ``grad_dtype`` or else each input's dtype.

    Layouts as the forward: q, o, do [B, Sq, H, D]; k, v [B, Sk, KV, D];
    lse [B, H, Sq] fp32.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = D ** -0.5 if scale is None else scale
    qg = _acc(q).reshape(B, Sq, KV, group, D)
    dog = _acc(do).reshape(B, Sq, KV, group, D)
    delta = (_acc(do) * _acc(o)).sum(-1)                   # [B, Sq, H]
    delta = delta.permute(0, 2, 1).reshape(B, KV, group, Sq, 1)
    lse = lse.reshape(B, KV, group, Sq, 1)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, _acc(k)) * scale
    keep = _keep_mask(Sq, Sk, causal, window, q.device)
    p = torch.where(keep, torch.exp(s - lse), 0.0)             # [B, KV, group, Sq, Sk]
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, _acc(v))
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", _acc(ds.to(k.dtype)), _acc(k))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", _acc(p.to(do.dtype)), dog)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", _acc(ds.to(q.dtype)), qg)
    return (dq.reshape(B, Sq, H, D).to(grad_dtype or q.dtype),
            dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype))


def _pair_reference(q, k, v, o, lse, do, *, causal=True, window=None, grad_dtype=None,
                    scale=None):
    """The order of operations of the dq and dk/dv kernels of both routes
    (bf16 and fp32) at the widths of ``_PAIR_D``, in plain PyTorch: (dq,
    dk, dv), a witness for their checks on the card.

    The two blocks of a cluster hold the head's first ``_PAIR_COLS``
    columns and the rest (zero-padded columns add nothing), so S and dP
    (S^T and dP^T) are the fp32 sum of the two halves' partial products,
    and dk/dv's delta = rowsum(do * o) the sum of the halves' partial row
    sums (dq's block takes it over every column). Then the kernels'
    roundings, as :func:`flash_attention_backward_plain`: p rounded to do's
    dtype before p^T do, ds to the operand dtype before ds k and ds^T q,
    fp32 accumulation, the GQA group summed in fp32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = D ** -0.5 if scale is None else scale
    c = _PAIR_COLS
    qg = _acc(q).reshape(B, Sq, KV, group, D)
    dog = _acc(do).reshape(B, Sq, KV, group, D)

    def scores(a, b):
        """[B, KV, group, Sq, Sk]: the two column halves' partial products, summed."""
        part = [torch.einsum("bqgrd,bkgd->bgrqk", a[..., i:i + c], _acc(b)[..., i:i + c])
                for i in (0, c)]
        return part[0] + part[1]

    prod = _acc(do) * _acc(o)                              # [B, Sq, H, D]
    deltas = (prod.sum(-1), prod[..., :c].sum(-1) + prod[..., c:].sum(-1))   # dq's, dk/dv's
    lse = lse.reshape(B, KV, group, Sq, 1)
    keep = _keep_mask(Sq, Sk, causal, window, q.device)
    p = torch.where(keep, torch.exp(scores(qg, k) * scale - lse), 0.0)
    dp = scores(dog, v)
    ds = [p * (dp - d.permute(0, 2, 1).reshape(B, KV, group, Sq, 1)) * scale for d in deltas]
    dq = torch.einsum("bgrqk,bkgd->bqgrd", _acc(ds[0].to(k.dtype)), _acc(k))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", _acc(p.to(do.dtype)), dog)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", _acc(ds[1].to(q.dtype)), qg)
    return (dq.reshape(B, Sq, H, D).to(grad_dtype or q.dtype),
            dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype))



def _pair_forward_reference(q, k, v, *, causal=True, window=None, scale=None):
    """The order of operations of the fp32 forward at the widths of
    ``_PAIR_D`` (``flash_fwd_fma<512, 64, 32, 2>``), in plain PyTorch: (o,
    lse), a witness for its checks on the card.

    S is the fp32 sum of the two column halves' partial products (the two
    blocks of a cluster hold the head's first ``_PAIR_COLS`` columns and the
    rest), masked; then the kernel's online softmax over key tiles of
    ``_fma_fwd_tiles`` keys in order: the running max m (a row that has seen
    no key keeps -inf and rescales by 0), p = 2^(s * scale * log2 e - m *
    scale * log2 e) unrounded, l and O rescaled by the change of m and
    added to; O / l at the end (0 where l is 0) and lse = m * scale + log l
    (+inf there). A tile no row of the block sees changes nothing, so every
    tile is walked. Sums differ from the kernel's in order only."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = D ** -0.5 if scale is None else scale
    c = _PAIR_COLS
    keys = _fma_fwd_tiles(_PAIR_D[0])[1]
    sl2 = scale * 1.4426950408889634
    qg, kf, vf = _acc(q).reshape(B, Sq, KV, group, D), _acc(k), _acc(v)
    part = [torch.einsum("bqgrd,bkgd->bgrqk", qg[..., i:i + c], kf[..., i:i + c])
            for i in (0, c)]
    s = (part[0] + part[1]).masked_fill(~_keep_mask(Sq, Sk, causal, window, q.device),
                                        -torch.inf)
    del part
    m = s.new_full((B, KV, group, Sq), -torch.inf)
    l = s.new_zeros((B, KV, group, Sq))
    acc = s.new_zeros((B, KV, group, Sq, D))
    for k0 in range(0, Sk, keys):
        st = s[..., k0:k0 + keys]
        mx = torch.maximum(m, st.amax(-1))
        m_use = torch.where(mx == -torch.inf, 0.0, mx)
        corr = torch.exp2((m - m_use) * sl2)
        p = torch.exp2(st * sl2 - (m_use * sl2)[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                                   vf[:, k0:k0 + keys])
        m = mx
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    lse = torch.where(l == 0, torch.inf, m * scale + torch.log(torch.where(l == 0, 1.0, l)))
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype),
            lse.reshape(B, H, Sq))

def _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _group_of(q, k, v)
    if tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != (B, Sk, KV, D):
        raise ValueError(f"k and v must be [B={B}, Sk, KV, D={D}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must be [B={B}, H={H}, Sq={Sq}], got {tuple(lse.shape)}")
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    if grad_dtype not in (None, torch.float32, q.dtype):
        raise ValueError(f"grad_dtype must be None, fp32 or {q.dtype}, got {grad_dtype}")


def _check_backward_inputs(name, q, k, v, o, lse, do):
    _check_kernel_inputs(name, q=q, k=k, v=v, o=o, do=do)
    if lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name} kernel needs lse fp32 and contiguous on {q.device}")
    return _kernel_width(q.shape[-1])


def _launch_backward(name, q, k, v, o, do, *, lse, scale, causal, window, grad_dtype):
    """One backward kernel on (padded) operands: (dq,) or (dk, dv)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kernel = "dq" if name == "flash_attention_bwd_dq" else "dkv"
    plan = _plan(kernel, B, Sq, Sk, H, KV, D, q.dtype, _sms_of(q.device.index))
    outs = ((torch.empty(q.shape, dtype=grad_dtype or q.dtype, device=q.device),)
            if kernel == "dq" else
            tuple(torch.empty(t.shape, dtype=grad_dtype or t.dtype, device=t.device)
                  for t in (k, v)))
    _build.launch(
        name,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), *(t.data_ptr() for t in outs),
        B, Sq, Sk, H, KV, D, int(causal), window or 0, scale,
        int(outs[0].dtype == torch.float32), int(q.dtype == torch.float32),
        plan.block, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if kernel == "dq":
        flash_attention_bwd_dq.launches += 1
    else:
        flash_attention_bwd_dkv.launches += 1
    return outs


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal=True, window=None,
                           grad_dtype=None):
    """dq [B, Sq, H, D] in ``grad_dtype`` (default q's dtype).

    CPU tensors take the plain version; CUDA tensors launch the dq kernel
    or raise."""
    _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, grad_dtype=grad_dtype)[0]
    name = "flash_attention_bwd_dq"
    width = _check_backward_inputs(name, q, k, v, o, lse, do)
    (dq,) = _pad_heads(functools.partial(_launch_backward, name, lse=lse, causal=causal,
                                         window=window, grad_dtype=grad_dtype),
                       (q, k, v, o, do), width)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *, causal=True, window=None,
                            grad_dtype=None):
    """(dk, dv), each [B, Sk, KV, D] in ``grad_dtype`` (default k's dtype).

    CPU tensors take the plain version; CUDA tensors launch the dk/dv kernel
    or raise."""
    _check_backward(q, k, v, o, lse, do, causal, window, grad_dtype)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, grad_dtype=grad_dtype)[1:]
    name = "flash_attention_bwd_dkv"
    width = _check_backward_inputs(name, q, k, v, o, lse, do)
    return _pad_heads(functools.partial(_launch_backward, name, lse=lse, causal=causal,
                                        window=window, grad_dtype=grad_dtype),
                      (q, k, v, o, do), width)


@torch.library.custom_op(
    "kubeflow_tpu_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window) -> (Tensor, Tensor)",
)
def flash_attention_fwd_op(q, k, v, causal, window):
    """The forward with lse as one dispatcher op (``window`` 0 = none), so a
    selective-checkpoint policy can name it (``models/transformer.py``)."""
    return _forward(q, k, v, causal, window or None)


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal, window):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=_acc(q).dtype)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window = causal, window or None


def _backward(ctx, do, _):
    """The op's backward (``jax.custom_vjp`` there): the residuals are the
    ones the TPU op saves, (q, k, v, o, lse), and the dq and dk/dv kernels
    recompute block scores from them, so no [S, S] tensor is ever kept."""
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    kw = dict(causal=ctx.causal, window=ctx.window)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    return dq, dk, dv, None, None


flash_attention_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, window: int | None = None, *,
                    return_lse: bool = False):
    """Fused attention. Layout [B, S, H, D] (matching ops/attention.py).

    GQA/MQA: pass k/v with fewer heads than q (H % KV == 0); query head h
    reads kv head h // (H // KV).

    ``window``: sliding-window (local) attention — position q attends
    [q - window + 1, q]. ``block_q``/``block_k`` keep the TPU op's tiling
    contract (the sequence lengths must divide them); the CUDA kernels' tiles
    are :func:`_plan`'s, whatever they are.

    ``return_lse`` also returns the row logsumexp [B, H, Sq] in fp32 (+inf on
    rows that see no key; it carries no gradient). When an input requires
    grad, the call saves the backward's residuals; under ``inference_mode``,
    as in serving, it is the forward kernel alone.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _group_of(q, k, v)
    _block_plan(Sq, Sk, block_q, block_k)
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    if q.device.type != "cpu" and (
            tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != (B, Sk, KV, D)):
        raise ValueError(f"k and v must be [B={B}, Sk, KV, D={D}], got {tuple(k.shape)}, {tuple(v.shape)}")
    o, lse = flash_attention_fwd_op(q, k, v, causal, window or 0)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
