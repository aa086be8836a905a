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

What the design does: one warp per output row (gather) or per source row
(scatter); the warp reads its index once and copies the row in the widest
vectors that the row's byte size allows (16 bytes for every row of 8 bf16 or
4 fp32 values), so every shape works: any M, any J, any R. The scatter first
zeroes its output (``cudaMemsetAsync``); then each warp with an index below R
adds its row into the fp32 table with ``atomicAdd`` (accumulate mode) or
stores it (unique mode). The TPU kernels keep a batch row's whole table in
VMEM; on the card the table stays in HBM (through L2) and the 132 SMs work on
rows in parallel.

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
JAX kernel runs. The accumulating scatter's sums follow the atomics' order:
a row with at most two sources is exact (0 + a + b), a row with more may
differ from a sequential sum in the last fp32 bits.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build

# scatter kernel's dtype codes (csrc/moe_scatter.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    _build.launch(
        "moe_scatter",
        dy.data_ptr(), idx.data_ptr(), out.data_ptr(), B, J, R, M,
        _DTYPE_CODES[dy.dtype], int(accumulate),
        torch.cuda.current_stream(dy.device).cuda_stream,
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
