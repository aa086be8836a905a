"""Decoder-only transformer LM in PyTorch; counterpart of ``kubeflow_tpu/models/transformer.py``.

The serving half of the model: the same parameters, the same numerics and
the same three attention branches in KV-cache mode (flash prefill, flash
decode, and the cache-masked einsum path) as the JAX module, so weights
carried over by ``interop.params_from_flax`` give the same logits.

Numerics follow what the flax module computes, not its comments:

- Dense layers (``DenseGeneral``/``Dense`` with ``dtype=cfg.dtype``) cast
  their fp32 kernels to ``cfg.dtype`` on every call, so this module holds
  its projection and embedding weights in ``cfg.dtype`` once, at load;
- the tied head (``embed.attend``) promotes both operands to ``cfg.dtype``:
  the logits come out in ``cfg.dtype`` (bf16 when serving), and become fp32
  only in the decoding loop;
- RMSNorm and rope compute in fp32 and cast back; the norm scales stay fp32.

``remat``, the ``block`` and ``ring`` attention impls and the losses belong
to the training slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.ops import attention as att
from kubeflow_tpu_torch.ops.flash_decode import flash_decode
from kubeflow_tpu_torch.ops.pallas_attention import flash_attention

TRAINING_SLICE = "the training slice of the PyTorch port (flash backward, remat, losses)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int | None = None      # grouped-query attention; None = MHA
    embed_dim: int = 768
    mlp_dim: int = 3072
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    attention_impl: str = "block"        # xla | flash (block | ring: training slice)
    attention_block_size: int = 512
    attention_window: int | None = None  # sliding-window (local) attention
    decode_block_k: int = 256            # flash-decode cache tiling contract
    remat: bool = False                  # training slice
    decode: bool = False                 # KV-cache mode (prefill / decode)
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without a card and without an explicit device this raises: the port
    never carries on on the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def rope_tables(positions, dim: int, theta: float):
    """(cos, sin) [S, dim/2] in fp32 for ``positions`` [S]."""
    freqs = 1.0 / (theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    ))
    angles = positions[:, None].float() * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate-halves rotary embedding of x [B, S, H, D] by precomputed tables."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings; x [B, S, H, D], positions [S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.epsilon)
        return (normed * self.weight).to(x.dtype)


def _linear(n_in: int, n_out: int, cfg: TransformerConfig, device):
    return nn.Linear(n_in, n_out, bias=False, dtype=cfg.dtype, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.embed_dim
        self.q_proj = _linear(E, H * D, cfg, device)
        self.k_proj = _linear(E, KV * D, cfg, device)
        self.v_proj = _linear(E, KV * D, cfg, device)
        self.o_proj = _linear(H * D, E, cfg, device)

    def forward(self, x, rope_cs, start: int = 0, cache=None, pos=None):
        cfg = self.cfg
        B, S, E = x.shape
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = apply_rope(self.q_proj(x).view(B, S, H, D), *rope_cs)
        k = apply_rope(self.k_proj(x).view(B, S, KV, D), *rope_cs)
        v = self.v_proj(x).view(B, S, KV, D)

        if cfg.attention_window is not None and cfg.attention_impl not in ("xla", "flash"):
            raise ValueError(
                "attention_window is supported by the 'xla' and 'flash' "
                f"impls, not {cfg.attention_impl!r}"
            )
        if cfg.decode:
            o = self._cached_attention(q, k, v, start, cache, pos)
        elif cfg.attention_impl == "xla":
            if KV != H:
                # GQA: expand kv heads to query heads for the oracle path
                k = k.repeat_interleave(H // KV, dim=2)
                v = v.repeat_interleave(H // KV, dim=2)
            o = att.naive_attention(q, k, v, causal=True, window=cfg.attention_window)
        elif cfg.attention_impl == "flash":
            o = flash_attention(
                q, k, v, True, cfg.attention_block_size,
                cfg.attention_block_size, cfg.attention_window,
            )
        elif cfg.attention_impl in ("block", "ring"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} comes with {TRAINING_SLICE}"
            )
        else:
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        return self.o_proj(o.reshape(B, S, H * D))

    def _cached_attention(self, q, k, v, start: int, cache, pos):
        """Attend q [B,S,H,D] against the layer's cache; new k/v are written
        at slots ``start .. start+S-1``. Returns the pre-projection context
        [B,S,H,D].

        ``cache`` is this layer's (k, v) pair, each **[B, G, L, D]** and
        updated IN PLACE: the counterpart of ``decode_steps``' donated cache
        (``donate_argnums`` in the JAX package), so no step ever holds two
        copies. ``pos`` is ``start`` as an int32 [B] tensor on the device,
        made once per forward for the flash-decode kernel."""
        cfg = self.cfg
        B, S, H, D = q.shape
        G = cfg.kv_heads
        R = H // G
        k_cache, v_cache = cache
        L = k_cache.shape[2]
        k_cache[:, :, start:start + S] = k.to(cfg.dtype).transpose(1, 2)
        v_cache[:, :, start:start + S] = v.to(cfg.dtype).transpose(1, 2)

        bs_pf = min(cfg.attention_block_size, S)
        if S > 1 and cfg.attention_impl == "flash" and S % bs_pf == 0:
            # flash prefill: the training kernel fills attention for the
            # whole prompt in linear memory. Valid because prefill writes
            # from slot 0 (causal-within-prompt == causal-vs-cache); the
            # grouped K/V feed the kernel directly.
            return flash_attention(q, k, v, True, bs_pf, bs_pf, cfg.attention_window)
        bk = min(cfg.decode_block_k, L)
        if S == 1 and cfg.attention_impl == "flash" and L % bk == 0:
            # flash-decode kernel: reads only the live cache slots
            o = flash_decode(
                q.view(B, G, R, D), k_cache, v_cache, pos,
                window=cfg.attention_window, block_k=bk,
            )
            return o.view(B, 1, H, D)

        # einsum path (the JAX package's own shape branch): prefill scores
        # only the first S slots, a single-token step the full cache
        k_att = k_cache[:, :, :S] if S > 1 else k_cache
        v_att = v_cache[:, :, :S] if S > 1 else v_cache
        L_att = k_att.shape[2]
        q_g = q.reshape(B, S, G, R, D)
        s = torch.einsum("bqgrd,bgkd->bgrqk", q_g.float(), k_att.float()) * (D ** -0.5)
        positions = torch.arange(start, start + S, device=q.device)
        kpos = torch.arange(L_att, device=q.device)[None, :]
        mask = kpos <= positions[:, None]              # [S, L] causal vs cache
        if cfg.attention_window is not None:
            mask = mask & (kpos > positions[:, None] - cfg.attention_window)
        s = s.masked_fill(~mask, att.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bgkd->bqgrd", p.to(v_att.dtype).float(), v_att.float())
        return o.to(q.dtype).reshape(B, S, H, D)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.gate_proj = _linear(cfg.embed_dim, cfg.mlp_dim, cfg, device)
        self.up_proj = _linear(cfg.embed_dim, cfg.mlp_dim, cfg, device)
        self.down_proj = _linear(cfg.mlp_dim, cfg.embed_dim, cfg, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.embed_dim, device=device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.embed_dim, device=device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, rope_cs, start=0, cache=None, pos=None):
        x = x + self.attn(self.attn_norm(x), rope_cs, start, cache, pos)
        return x + self.mlp(self.mlp_norm(x))


class TransformerLM(nn.Module):
    """The LM. ``device`` defaults to CUDA and raises without a card."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.remat:
            raise NotImplementedError(f"remat comes with {TRAINING_SLICE}")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def init_cache(self, batch: int):
        """Zeroed KV cache: one (k, v) pair of [B, G, L, D] per layer."""
        cfg = self.cfg
        shape = (batch, cfg.kv_heads, cfg.max_seq_len, cfg.head_dim)
        return [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.num_layers)
        ]

    def head(self, x):
        """Tied output head: operands in ``cfg.dtype``, as flax's
        ``Embed.attend`` promotes them; logits in ``cfg.dtype``."""
        return F.linear(x.to(self.cfg.dtype), self.embed.weight)

    def forward(self, tokens, start: int = 0, cache=None, return_hidden: bool = False):
        """tokens [B, S] at positions ``start .. start+S-1`` -> logits [B, S, V].

        In decode mode ``cache`` (from ``init_cache``) is required and is
        written in place."""
        cfg = self.cfg
        B, S = tokens.shape
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache (TransformerLM.init_cache)")
        x = self.embed(tokens)
        positions = torch.arange(start, start + S, device=tokens.device)
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        pos = torch.full((B,), start, dtype=torch.int32, device=tokens.device) if cfg.decode else None
        for i, layer in enumerate(self.layers):
            x = layer(x, rope_cs, start, cache[i] if cfg.decode else None, pos)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.head(x)
