"""Fused tied LM head + softmax cross entropy; counterpart of ``kubeflow_tpu/ops/fused_head_loss.py``.

The chunked head (``models/transformer.py lm_loss_chunked``) materialises
fp32 logits per chunk ([1024, 32000] is 131 MB). Here the [T, V] logits
exist only as [64, 64] tiles on chip: the forward keeps per-token ``lse``
and gold logit, and the backward recomputes each tile from them. Three CUDA
kernels replace the three Pallas kernels of the JAX module:

- ``csrc/fused_head_fwd.cu`` replaces ``_fwd_kernel`` (``:76``): per-token
  logsumexp and gold logit of h @ embᵀ, streamed over vocabulary tiles;
- ``csrc/fused_head_bwd_dh.cu`` replaces ``_dh_kernel`` (``:157``):
  dh = Σ_v bf16(dlogits) · emb_v;
- ``csrc/fused_head_bwd_de.cu`` replaces ``_de_kernel`` (``:183``):
  dE = Σ_t bf16(dlogits)ᵀ · h_t, one block walking every token for its
  vocabulary tile, so no atomics.

with dlogits = dlse · exp(logit − lse) + dgold · [v == tgt] in fp32, rounded
to the operand dtype before both products (``:174``, ``:202``), and the
products summed in fp32. What bounds them on an H100: operations (2 T V E
FLOP forward, 4 T V E each backward kernel). The kernels multiply on the
tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 accumulate); each
backward block accumulates a [64, 256] slice of its output in registers and
recomputes the full-E logits per slice (``csrc/fused_head_common.cuh``).

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
and E, with the kernels' rounding at every shape, so the two agree exactly
only at the shapes where the JAX kernels run.

CPU tensors take the plain versions (fp32 sums of the operands' products, T
walked in chunks); CUDA tensors launch the kernels, which take bf16 operands
only, or raise. Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.models.transformer import matmul_f32
from kubeflow_tpu_torch.ops import _build

PLAIN_CHUNK = 1024    # tokens a chunk in the plain versions: [1024, V] fp32 logits


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
    """The kernel's operands: bf16 h and emb, int32 targets, fp32 rows, all
    on h's CUDA device, contiguous, 16-byte aligned; raise otherwise."""
    if h.dtype != torch.bfloat16 or emb.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 h and emb, got {h.dtype} and {emb.dtype}")
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
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    gold = torch.empty(T, dtype=torch.float32, device=h.device)
    _build.launch("fused_head_fwd", h.data_ptr(), emb.data_ptr(), tgt.data_ptr(),
                  lse.data_ptr(), gold.data_ptr(), T, emb.shape[0], E, _stream(h))
    fused_head_fwd.launches += 1
    return lse, gold


def _backward(name, h, emb, tgt, lse, dlse, dgold, shape):
    tgt, lse, dlse, dgold = _kernel_args(name, h, emb, tgt, lse, dlse, dgold)
    out = torch.empty(shape, dtype=torch.float32, device=h.device)
    T, E = h.shape
    _build.launch(name, h.data_ptr(), emb.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
                  dlse.data_ptr(), dgold.data_ptr(), out.data_ptr(), T, emb.shape[0], E,
                  _stream(h))
    return out


def fused_head_bwd_dh(h, emb, tgt, lse, dlse, dgold):
    """dh [T, E] fp32 without autograd: the dh kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_shapes(h, emb, tgt, lse, dlse, dgold)
    if h.device.type == "cpu":
        return head_grads_plain(h, emb, tgt, lse, dlse, dgold, de=False)[0]
    out = _backward("fused_head_bwd_dh", h, emb, tgt, lse, dlse, dgold, h.shape)
    fused_head_bwd_dh.launches += 1
    return out


def fused_head_bwd_de(h, emb, tgt, lse, dlse, dgold):
    """dE [V, E] fp32 without autograd: the dE kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_shapes(h, emb, tgt, lse, dlse, dgold)
    if h.device.type == "cpu":
        return head_grads_plain(h, emb, tgt, lse, dlse, dgold, dh=False)[1]
    out = _backward("fused_head_bwd_de", h, emb, tgt, lse, dlse, dgold, emb.shape)
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
    them, differentiable in h and emb. h [T, E] in the compute dtype (bf16 on
    the card), emb [V, E] in any float dtype (cast to h's inside; its
    gradient keeps emb's dtype), tgt [T] int. Every shape takes the kernels
    on the card; CPU tensors take the plain versions."""
    return _FusedLseGold.apply(h, emb, tgt)


def fused_head_nll(hidden, embedding, tokens, *, compute_dtype=torch.bfloat16):
    """Mean next-token NLL over [B, S] tokens with the tied head fused.

    Drop-in for ``lm_loss_chunked``: hidden [B, S, E] from
    ``return_hidden=True``, the tied ``embedding [V, E]`` (fp32 parameters:
    pass the table itself, not a cast of it, so its gradient stays fp32)."""
    B, S, E = hidden.shape
    h = hidden.reshape(B * S, E).to(compute_dtype)
    tgt = torch.roll(tokens, -1, dims=1).reshape(B * S)
    mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask[:, -1] = 0.0
    mask = mask.reshape(B * S)
    lse, gold = fused_lse_gold(h, embedding, tgt)
    return torch.sum((lse - gold) * mask) / torch.sum(mask)


fused_head_fwd.launches = 0
fused_head_bwd_dh.launches = 0
fused_head_bwd_de.launches = 0
