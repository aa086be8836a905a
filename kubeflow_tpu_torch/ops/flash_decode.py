"""Single-query (flash-decode) attention over the grouped KV cache.

Counterpart of ``kubeflow_tpu/ops/flash_decode.py``. The CUDA kernel
(``csrc/flash_decode.cu``) replaces the Pallas ``_decode_kernel``
(``kubeflow_tpu/ops/flash_decode.py:53``).

What bounds it on an H100: bytes. One decode step per layer reads the live
K/V slots of every (row, group) — ``2 * B * G * (pos + 1) * D`` bf16 values —
and does 4 FLOPs per value read, far below the ~295 FLOP/byte the card needs
before compute matters. At the flagship shape (B4 G4 R2 D128, pos ~190) that
is ~1.6 MB, under a microsecond of HBM time, so in practice the step is
bounded by launch latency and by how few SMs 16 blocks occupy.

What the design does about it:

- one thread block per (row, kv group, chunk of up to 8 query heads): the
  heads of a chunk share each K/V tile, so the cache is read once per group
  for R <= 8 (the flagship's R 2), never per head (the TPU kernel's
  batched-``dot_general`` over groups, the GPU way); a group of more heads
  (MQA with 16) takes more chunks in the same launch;
- the block computes the live key range ``[lo, hi]`` from ``pos[b]`` and the
  window itself and loops over only those keys: dead slots are never read.
  This is the counterpart of the TPU kernel's scalar-prefetch clamp of the
  k/v block index (``flash_decode.py:131-142``);
- streaming softmax in fp32 (m, l per head in shared memory, the context
  accumulator in registers), probabilities rounded to the operands' dtype
  before the value product as the TPU kernel does (bf16 rounds, fp32 keeps).

bf16 and fp32 operands (one dtype), D in {64, 128}; another head size is a
stated refusal. B * G = 16 blocks fill 16 of the card's 132 SMs at the
flagship shape; splitting the key range across blocks (with a combine pass)
is later work.
"""
from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import NEG_INF

_KERNEL_D = (64, 128)


def _check(q, k_cache, v_cache, block_k):
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    if tuple(k_cache.shape) != (B, G, L, D) or tuple(v_cache.shape) != (B, G, L, D):
        raise ValueError(
            f"cache must be [B={B}, G={G}, L, D={D}], got {tuple(k_cache.shape)}"
        )
    bk = min(block_k, L)
    if L % bk:
        raise ValueError(
            f"cache length {L} must be a multiple of block_k {bk}"
        )


def flash_decode_plain(q, k_cache, v_cache, pos, *, window=None):
    """Plain PyTorch version of the kernel: same contract as ``flash_decode``.

    Follows ``decode_attention_reference`` (``flash_decode.py:176-189``) with
    the kernel's own two guarantees made explicit: dead slots contribute
    nothing (not even a NaN that lies there), and a row with no live key
    (``pos < 0``) gives 0, as the TPU kernel's ``l_safe`` does.
    """
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    kpos = torch.arange(L, device=q.device)[None, :]
    pos = pos.to(device=q.device, dtype=torch.int64)
    live = kpos <= pos[:, None]                              # [B, L]
    if window is not None:
        live = live & (kpos > pos[:, None] - window)
    live4 = live[:, None, :, None]                           # [B, 1, L, 1]
    k = torch.where(live4, k_cache, 0).float()
    v = torch.where(live4, v_cache, 0)
    s = torch.einsum("bgrd,bgkd->bgrk", q.float(), k) * (D ** -0.5)
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * live[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrk,bgkd->bgrd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, 1.0, l)
    return o.to(q.dtype)


def flash_decode(q, k_cache, v_cache, pos, *, window=None, block_k: int = 256):
    """Attend one query token per row against the grouped KV cache.

    Args:
      q: ``[B, G, R, D]`` — this step's queries, grouped (R = H // G).
      k_cache, v_cache: ``[B, G, L, D]`` — the rolling cache, all slots.
      pos: ``[B]`` int — the current token's position; cache slots
        ``0..pos`` are live (slot ``pos`` holds this step's own k/v).
      window: optional sliding-window size (keys ``(pos-window, pos]``).
      block_k: the cache must tile into blocks of this many slots, as for
        the TPU kernel; the CUDA kernel walks the live range key by key.
    Returns:
      ``[B, G, R, D]`` context in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    _check(q, k_cache, v_cache, block_k)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, window=window)
    B, G, R, D = q.shape
    L = k_cache.shape[2]
    operands = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache))
    for name, t in operands:
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"flash_decode kernel takes bf16 or fp32 operands of one dtype; "
                            f"{name} is {t.dtype}, q {q.dtype}")
    if D not in _KERNEL_D:
        raise ValueError(f"flash_decode kernel supports head_dim {_KERNEL_D}, got {D}")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    for name, t in operands:
        if t.device.type != "cuda":
            raise TypeError(f"flash_decode kernel takes CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel needs {name} contiguous and 16-byte aligned")
    if pos.device != q.device or pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be an int32 [B={B}] tensor on {q.device}")
    out = torch.empty_like(q)
    _build.launch(
        "flash_decode",
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, G, R, L, D, window or 0, D ** -0.5,
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
