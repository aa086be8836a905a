"""Flash-attention forward for the PyTorch port.

Counterpart of ``kubeflow_tpu/ops/pallas_attention.py`` (forward only; the
backward kernels come with the training slice). The CUDA kernel
(``csrc/flash_attention_fwd.cu``) replaces the Pallas ``_fwd_kernel``
(``kubeflow_tpu/ops/pallas_attention.py:160``).

What bounds it on an H100: at the serving path's prefill shape (B4 H8 KV4
S128 D128, causal) the kernel moves ~3 MB and does ~0.14 GFLOP, so HBM bytes
bound it (under a microsecond); at long prompts the FLOPs grow as S^2 and the
tensor cores become the bound. This first kernel multiplies with scalar fp32
FMAs from shared memory, so past a few thousand tokens it is compute-bound
far below the card's bf16 peak; ``mma``/``wgmma`` tiles are later work.

What the design does:

- one thread block per (64-row query tile, head, batch row); a loop inside
  the block over 64-key tiles staged in shared memory takes the place of the
  TPU kernel's sequential ``ik`` grid axis;
- the online-softmax state (m, l, and the context accumulator) stays in
  registers in fp32 across the loop; only probabilities go through shared
  memory, rounded to bf16 before the value product as the TPU kernel does;
- causal block skipping: k tiles above the diagonal and left of the sliding
  window are never loaded;
- GQA: query head ``h`` reads kv head ``h // group``; grouped K/V are never
  expanded.
"""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF

_KERNEL_D = (64, 128)


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


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """Plain PyTorch version of the kernel: (o [B,Sq,H,D], lse [B,H,Sq] f32).

    Scores and softmax in fp32; unnormalized probabilities are cast to v's
    dtype before the value product and divided by the fp32 row sum after it,
    as the TPU kernel does. A row that sees no key gives output 0 and lse
    +inf (the TPU kernel's ``l_safe`` rule, ``pallas_attention.py:200-204``).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    # fold query heads into [KV, group] so grouped K/V are read as they are
    qg = q.float().reshape(B, Sq, KV, group, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (D ** -0.5)
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    l_q = l.squeeze(-1).permute(0, 3, 1, 2)[..., None]     # [B, Sq, KV, group, 1]
    o = (o / torch.where(l_q == 0, 1.0, l_q)).reshape(B, Sq, H, D)
    lse = torch.where(l == 0, torch.inf, m + torch.log(torch.where(l == 0, 1.0, l)))
    return o.to(q.dtype), lse.reshape(B, H, Sq)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, window: int | None = None, *,
                    return_lse: bool = False):
    """Fused attention forward. Layout [B, S, H, D] (matching ops/attention.py).

    GQA/MQA: pass k/v with fewer heads than q (H % KV == 0); query head h
    reads kv head h // (H // KV).

    ``window``: sliding-window (local) attention — position q attends
    [q - window + 1, q]. ``block_q``/``block_k`` keep the TPU op's tiling
    contract (the sequence lengths must divide them); the CUDA kernel tiles
    at 64 rows by 64 keys whatever they are.

    ``return_lse`` also returns the row logsumexp [B, H, Sq] in fp32 (+inf on
    rows that see no key), the residual the training slice's backward needs.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _group_of(q, k, v)
    _block_plan(Sq, Sk, block_q, block_k)
    if window is not None and (window < 1 or not causal):
        raise ValueError("window requires causal=True and window >= 1")
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal=causal, window=window)
        return (o, lse) if return_lse else o
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16 CUDA tensors; {name} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs {name} contiguous")
    if tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != (B, Sk, KV, D):
        raise ValueError(f"k and v must be [B={B}, Sk, KV, D={D}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if D not in _KERNEL_D:
        raise ValueError(f"flash_attention kernel supports head_dim {_KERNEL_D}, got {D}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    _build.launch(
        "flash_attention_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, Sq, Sk, H, KV, D, int(causal), window or 0, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
