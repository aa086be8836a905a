"""Attention oracle for the PyTorch port; counterpart of ``kubeflow_tpu/ops/attention.py``.

Only what the serving slice needs: the masking constant and the
materialized-scores oracle. The blockwise streaming path and ring attention
belong to the training slice.
"""
from __future__ import annotations

import torch

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
