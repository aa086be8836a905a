"""Attention ops for the PyTorch port; counterpart of ``kubeflow_tpu/ops/attention.py``.

The masking constant, the materialized-scores oracle, and the blockwise
streaming-softmax path (``attention_impl="block"``) with the pieces ring
attention reuses (``blockwise_scores``, ``_block_update``, ``finalize``).
Plain PyTorch: these ops have no kernel in the JAX package either.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# Finite, not -inf: a masked score stays a number, exactly as in the JAX
# package, so the oracle's fully-masked rows match it (uniform softmax).
NEG_INF = -1e30


def naive_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    window: int | None = None):
    """Materialized-scores attention; the correctness oracle for everything else.

    Shapes: q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D].
    ``window``: sliding-window mask (causal only) — q attends [q-window+1, q].
    Scores and softmax run in float32; probabilities are cast to v's dtype
    before the value product, as in the JAX oracle.
    """
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _block_update(carry, s, v_blk):
    """One streaming-softmax step: fold scores s [B,H,q,k] and values v_blk
    [B,k,H,D] into (o, m, l). Numerics in fp32."""
    o, m, l = carry
    m_new = torch.maximum(m, s.amax(dim=-1))                 # [B,H,q]
    # NEG_INF is finite, so a fully-masked row keeps exp() at 0, not NaN
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])                      # [B,H,q,k]
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return o * correction[..., None] + pv, m_new, l_new


def blockwise_scores(q, k, scale, q_offset, k_offset, causal):
    """Scaled (+ causally masked) fp32 scores [B,H,q,k] for one (q-block,
    k-block) pair with *global* position offsets — the piece ring attention
    reuses across devices."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    return s


def finalize(o, m, l):
    """Normalize the accumulator; fully-masked rows (l==0) produce zeros."""
    return o / torch.where(l == 0.0, 1.0, l)[..., None]


def blockwise_attention(q, k, v, *, causal: bool = True, block_size: int = 512):
    """Memory-efficient attention: O(S·block) memory, the math of
    ``naive_attention`` — through the backward too: each key block's step
    runs under ``torch.utils.checkpoint``, as the JAX scan body is
    ``jax.checkpoint``-ed, so autograd recomputes each block's
    probabilities instead of keeping the [S, S] matrix.

    Shapes: q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D] in q's dtype.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bs = min(block_size, Sk)
    if Sk % bs:
        raise ValueError(f"block_size {bs} must divide the sequence length {Sk}")
    scale = D ** -0.5

    def step(o, m, l, k_blk, v_blk, k_offset):
        s = blockwise_scores(q, k_blk, scale, 0, k_offset, causal)
        return _block_update((o, m, l), s, v_blk)

    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, bs):
        k_blk, v_blk = k[:, start:start + bs], v[:, start:start + bs]
        if torch.is_grad_enabled():
            o, m, l = checkpoint(step, o, m, l, k_blk, v_blk, start, use_reentrant=False)
        else:
            o, m, l = step(o, m, l, k_blk, v_blk, start)
    return finalize(o, m, l).transpose(1, 2).to(q.dtype)
