"""MoE dispatch/combine row movement: row gather and its scatter backward.

Counterpart of ``kubeflow_tpu/ops/moe_dispatch.py``. Two CUDA kernels replace
the two Pallas kernels of that module:

- ``csrc/moe_gather.cu`` replaces ``_gather_kernel`` (``:57``):
  ``out[b, j] = x[b, idx[b, j]]``, and an index >= R reads a zero row;
- ``csrc/moe_scatter.cu`` replaces ``_scatter_kernel`` (``:93``), the
  gather's backward ``dx[b, idx[b, j]] (+)= dy[b, j]`` in its two modes.

What bounds them on an H100: bytes. Both only move rows (the accumulating
scatter adds one fp32 value per element moved), so the least time is the rows
read once plus the output written once over 3.35 TB/s: at the MoE training
flagship (B4, S2048, E·C = 5120 slots, M 1024, bf16) ~10-22 µs a launch.

The gather: one warp per output row; the warp reads its index once and
copies the row in the widest vectors that the row's byte size allows (16
bytes for every row of 8 bf16 or 4 fp32 values), so every shape works: any
M, any J, any R.

The scatter is destination-first: every output row has one owner, which
writes it once; no memset, no atomic on data. A block owns a tile of 32
destination rows of one batch row and finds their sources itself from
``idx`` (the index pass: a stable counting sort of the sources by
destination, so a row's sources come out in j order; :func:`scatter_plan`
is its CPU mirror). A direct store copies one source a row (the largest j,
as the TPU kernel's sequential stores leave it) or zeros. The accumulating
scatter sums a row of at most ``SEG`` sources in j order from 0 in fp32,
the TPU kernel's order, bit for bit; a row of more (the dispatch's padding
row takes every empty slot) is cut into segments of ``SEG`` sources that
the blocks of the grid take as they are published (overlapping the light
rows), each summed in j order into an fp32 partial, and the row's partials
are added in segment order, a slice of 256 columns a block
(:func:`scatter_replay` is that order in plain PyTorch). So two launches
give the same bits, and a call is one device kernel.

Contract, the same as the JAX module's:

- ``gather_rows(x, idx, unique_indices=False)``; x ``[B, R, M]``, idx
  ``[B, J]`` int; an index >= R (or < 0) reads zero and carries no gradient;
- the backward accumulates in fp32 and casts to x's dtype (default: the
  dispatch, where a token sits in k slots and its rows collide), or, with
  ``unique_indices=True`` (the combine), stores the cotangent's rows directly
  in the cotangent's dtype. In unique mode the value of a row that several
  indices hit is unspecified: the combine's dropped tokens all index the
  padding row, whose gradient is discarded.

One difference from the JAX function: it falls back to ``take_along_axis``
for shapes that do not fit the TPU's VMEM or (8, 128) tiling
(``moe_dispatch.py:290-301``), and that fallback accumulates colliding
gradient rows in x's dtype. The port has no shape fallback and always
accumulates in fp32, so the two agree exactly only at the shapes where the
JAX kernel runs.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import dataclasses

import torch

from kubeflow_tpu_torch.ops import _build, _workspace

# scatter kernel's dtype codes (csrc/moe_scatter.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SEG = 32           # most sources a unit of the accumulating scatter sums (csrc/moe_scatter.cu)
_SCATTER_THREADS = 256   # a scatter block's threads: the columns of a combine slice


def _flat_rows(idx, R: int, spill: int):
    """Flat row ``b * R + idx`` of each index, or ``spill`` where the index
    lies outside [0, R): [B * J] int64. No host sync (no boolean indexing),
    so the plain versions queue on the card like the kernels."""
    B = idx.shape[0]
    valid = (idx >= 0) & (idx < R)
    base = torch.arange(B, device=idx.device)[:, None] * R
    return torch.where(valid, base + idx.long(), spill).reshape(-1), valid


def gather_rows_plain(x, idx):
    """Plain version of the gather kernel: out[b, j] = x[b, idx[b, j]], an
    index outside [0, R) reads zero (``_gather_ref``, ``moe_dispatch.py:234``)."""
    B, R, M = x.shape
    rows, valid = _flat_rows(idx, R, 0)
    out = x.reshape(B * R, M)[rows].reshape(B, idx.shape[1], M)
    return torch.where(valid[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def scatter_rows_plain(idx, dy, R: int, *, accumulate: bool):
    """Plain version of the scatter kernel: dx [B, R, M], zero but where an
    index in [0, R) puts a row of dy [B, J, M] there.

    ``accumulate``: colliding rows add up in fp32, and dx is fp32.
    Otherwise dx has dy's dtype and each row is stored; where several
    indices hit one row, which of them lands is unspecified. Out-of-range
    indices go to a spill row past the table, which is cut off (the JAX
    kernel's clamp, ``moe_dispatch.py:193-194``)."""
    B, J, M = dy.shape
    rows, _ = _flat_rows(idx, R, B * R)
    src = dy.reshape(B * J, M)
    if accumulate:
        out = torch.zeros((B * R + 1, M), dtype=torch.float32, device=dy.device)
        out.index_add_(0, rows, src.float())
    else:
        out = torch.zeros((B * R + 1, M), dtype=dy.dtype, device=dy.device)
        out[rows] = src
    return out[:B * R].reshape(B, R, M)


def _check_kernel_operand(what, name, t):
    if t.device.type != "cuda":
        raise TypeError(f"{what} kernel takes CUDA tensors; {name} is on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs {name} contiguous and 16-byte aligned")


def _kernel_index(idx, device):
    if idx.device != device:
        raise ValueError(f"idx must be on {device}, got {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    return idx.to(torch.int32).contiguous()


def _check_shapes(x_or_dy, idx):
    if x_or_dy.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x_or_dy.shape[0]:
        raise ValueError(
            f"expected rows [B, *, M] and idx [B, J] with one B, got "
            f"{tuple(x_or_dy.shape)} and {tuple(idx.shape)}"
        )


def gather(x, idx):
    """out[b, j] = x[b, idx[b, j]] without autograd: the gather kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    _check_shapes(x, idx)
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    _check_kernel_operand("moe_gather", "x", x)
    idx = _kernel_index(idx, x.device)
    B, R, M = x.shape
    J = idx.shape[1]
    out = torch.empty((B, J, M), dtype=x.dtype, device=x.device)
    _build.launch(
        "moe_gather",
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, R, J, M, x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    gather.launches += 1
    return out


def _scatter_sizes(B: int, J: int, M: int):
    """(item_max, workspace fp32 values, tickets) of the accumulating
    scatter. At most ``B * J // (SEG + 1)`` rows have more than ``SEG``
    sources; each registers ceil(n / SEG) segment items (at most
    ``ceil(B * J / SEG)`` plus one a row in all) and ``ceil(M / 256)``
    combine items (a column slice of 256 columns each). The workspace holds
    a partial of M fp32 values an item (rounded up to 4 values), then (as
    int32) each item's heavy row (four values) and SEG sources; the tickets
    four counters, then a ticket, a ready flag and a done flag an item."""
    heavy_max = B * J // (SEG + 1)
    item_max = -(-B * J // SEG) + heavy_max * (1 + -(-M // _SCATTER_THREADS))
    return item_max, -(-item_max * M // 4) * 4 + item_max * (4 + SEG), 4 + 3 * item_max


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """What the scatter's index pass derives from ``idx`` [B, J] and R (the
    kernel's, made on the CPU by :func:`scatter_plan`):

    - ``counts`` [B, R]: the sources of each destination row;
    - ``order`` [B] of int64 arrays: each batch row's in-range j's sorted by
      (destination, j), ``starts`` [B, R + 1] each row's run in it;
    - ``segments``: (b, r, s, j's) of every row of more than ``SEG``
      sources, s-th run of ``SEG`` of its sources in j order, rows in (b, r)
      order (the kernel registers them in any order; each row's segments
      and their sums do not depend on it);
    - ``inv`` [B, R]: the direct store's source, the largest j that hits the
      row, or -1;
    - ``heavy``, ``items``: the rows of more than ``SEG`` sources and their
      work items (``len(segments)`` and ceil(M / 256) combine slices a row);
    - ``item_max``, ``ws_floats``, ``tickets``: the launch's bound on the
      items and its sizes (:func:`_scatter_sizes`)."""

    counts: torch.Tensor
    order: list
    starts: torch.Tensor
    segments: list
    inv: torch.Tensor
    heavy: int
    items: int
    item_max: int
    ws_floats: int
    tickets: int


def scatter_plan(idx, R: int, M: int = 1) -> ScatterPlan:
    """The scatter kernel's index pass on the CPU. Sorting the unique key
    ``r * 2^ceil(log2 J) + j`` gives each row's sources in j order without
    a stable sort."""
    idx = torch.as_tensor(idx).to("cpu", torch.int64)
    B, J = idx.shape
    valid = (idx >= 0) & (idx < R)
    shift = max(1, (J - 1).bit_length())
    j = torch.arange(J).expand(B, J)
    counts = torch.zeros((B, R), dtype=torch.int64)
    inv = torch.full((B, R), -1, dtype=torch.int64)
    order, starts, segments = [], [], []
    for b in range(B):
        r_b, j_b = idx[b][valid[b]], j[b][valid[b]]
        keys = torch.sort((r_b << shift) | j_b).values
        order.append(keys & ((1 << shift) - 1))
        counts[b] = torch.bincount(r_b, minlength=R)
        starts.append(torch.cat([torch.zeros(1, dtype=torch.int64), counts[b].cumsum(0)]))
        inv[b].scatter_reduce_(0, r_b, j_b, "amax")
        for r in torch.nonzero(counts[b] > SEG).flatten().tolist():
            run = order[b][starts[b][r]:starts[b][r + 1]]
            segments += [(b, r, s // SEG, run[s:s + SEG]) for s in range(0, len(run), SEG)]
    item_max, ws_floats, tickets = _scatter_sizes(B, J, M)
    heavy = int((counts > SEG).sum())
    return ScatterPlan(counts, order, torch.stack(starts) if starts else
                       torch.zeros((0, R + 1), dtype=torch.int64), segments, inv, heavy,
                       len(segments) + heavy * -(-M // _SCATTER_THREADS), item_max,
                       ws_floats, tickets)


def _sequential_sums(rows, src):
    """fp32 sums of ``rows[src[u, k]]`` over k in order from 0, one a unit u
    (``src`` [U, K], -1 past a unit's end: adding 0 changes no sum)."""
    acc = torch.zeros((src.shape[0], rows.shape[1]), dtype=torch.float32, device=rows.device)
    for k in range(src.shape[1] if rows.shape[0] else 0):
        col = src[:, k]
        acc += torch.where((col >= 0)[:, None], rows[col.clamp(min=0)].float(), 0.0)
    return acc


def scatter_replay(idx, dy, R: int, plan: ScatterPlan | None = None):
    """The accumulating scatter kernel's order of operations in plain
    PyTorch (a witness for the tests and the chip smoke, never on the main
    path): a row of at most ``SEG`` sources summed in j order from 0 in fp32;
    a row of more, each segment so summed into a partial and the partials
    added in segment order from 0. [B, R, M] fp32."""
    plan = plan or scatter_plan(idx, R)
    B, J, M = dy.shape
    rows = dy.reshape(B * J, M)
    units, dest = [], []
    for b in range(B):
        light = torch.nonzero(plan.counts[b] <= SEG).flatten()
        for r in light.tolist():
            run = plan.order[b][plan.starts[b, r]:plan.starts[b, r + 1]]
            units.append(b * J + run)
            dest.append(b * R + r)
    seg_units = [b * J + run for b, _, _, run in plan.segments]

    def padded(lists, width):
        out = torch.full((len(lists), width), -1, dtype=torch.int64)
        for u, l in enumerate(lists):
            out[u, :len(l)] = l
        return out.to(dy.device)

    out = torch.empty((B * R, M), dtype=torch.float32, device=dy.device)
    out[torch.tensor(dest, dtype=torch.int64, device=dy.device)] = _sequential_sums(
        rows, padded(units, SEG))
    if seg_units:
        partials = _sequential_sums(rows, padded(seg_units, SEG))
        heavy, first = [], []
        for i, (b, r, s, _) in enumerate(plan.segments):
            if s == 0:
                heavy.append(b * R + r)
                first.append([])
            first[-1].append(i)
        width = max(len(f) for f in first)
        out[torch.tensor(heavy, dtype=torch.int64, device=dy.device)] = _sequential_sums(
            partials, padded([torch.tensor(f) for f in first], width))
    return out.reshape(B, R, M)


def scatter(idx, dy, R: int, *, accumulate: bool):
    """The gather's backward without autograd: dx [B, R, M] in fp32
    (``accumulate``) or in dy's dtype (direct store). The scatter kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    _check_shapes(dy, idx)
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    if dy.device.type == "cpu":
        return scatter_rows_plain(idx, dy, R, accumulate=accumulate)
    _check_kernel_operand("moe_scatter", "dy", dy)
    if dy.dtype not in _DTYPE_CODES:
        raise TypeError(f"moe_scatter kernel takes {list(_DTYPE_CODES)}, got {dy.dtype}")
    idx = _kernel_index(idx, dy.device)
    B, J, M = dy.shape
    out = torch.empty((B, R, M), dtype=torch.float32 if accumulate else dy.dtype,
                      device=dy.device)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    item_max = ws_ptr = tickets_ptr = 0        # the direct store needs no workspace
    if accumulate:
        item_max, n_ws, n_tickets = _scatter_sizes(B, J, M)
        ws, tickets = _workspace.workspace(dy.device, stream, n_ws, n_tickets)
        ws_ptr, tickets_ptr = ws.data_ptr(), tickets.data_ptr()
    _build.launch(
        "moe_scatter",
        dy.data_ptr(), idx.data_ptr(), out.data_ptr(), ws_ptr, tickets_ptr,
        B, J, R, M, _DTYPE_CODES[dy.dtype], int(accumulate), item_max, stream,
    )
    scatter.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX module: the forward is the gather
    kernel, the backward the scatter kernel (``_gather_bwd``, ``:258-271``)."""

    @staticmethod
    def forward(ctx, x, idx, unique_indices):
        ctx.save_for_backward(idx)
        ctx.x_rows, ctx.x_dtype, ctx.unique = x.shape[1], x.dtype, unique_indices
        return gather(x, idx)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        dx = scatter(idx, dy.contiguous(), ctx.x_rows, accumulate=not ctx.unique)
        return dx.to(ctx.x_dtype), None, None


def gather_rows(x, idx, *, unique_indices: bool = False):
    """out[b, j, :] = x[b, idx[b, j], :], differentiable in x.

    x ``[B, R, M]``, idx ``[B, J]`` int32 in [0, R); an index >= R reads a
    zero row and carries no gradient. The backward is the scatter kernel:
    fp32 accumulation by default, a direct store in the cotangent's dtype
    with ``unique_indices=True`` (the caller promises no index repeats per
    batch row; where one does, that row's gradient is unspecified). Every
    shape takes the kernel on the card; CPU tensors take the plain versions.
    """
    return _GatherRows.apply(x, idx, unique_indices)


gather.launches = 0
scatter.launches = 0
