"""Decoder-only transformer LM in PyTorch; counterpart of ``kubeflow_tpu/models/transformer.py``.

The same parameters, the same numerics and the same attention branches as
the JAX module, so weights carried over by ``interop.params_from_flax`` give
the same logits, losses and gradients: ``xla``, ``block`` and ``flash`` for
training, and in KV-cache mode (``decode=True``) flash prefill, flash decode
and the cache-masked einsum path.

Numerics follow what the flax module computes, not its comments:

- Dense layers and the embedding (``dtype=cfg.dtype``,
  ``param_dtype=float32``) keep fp32 weights and cast them to ``cfg.dtype`` on
  every call; so does this module when it trains. A ``decode=True`` model
  holds those weights in ``cfg.dtype`` once, at load: for serving the numbers
  are the same, and it saves the cast on every decode step;
- the tied head (``embed.attend``) promotes both operands to ``cfg.dtype``:
  the logits come out in ``cfg.dtype`` (bf16 when serving), and become fp32
  only in the decoding loop; ``lm_loss_chunked`` instead multiplies its
  ``compute_dtype`` operands into fp32 logits;
- RMSNorm and rope compute in fp32 and cast back; the norm scales stay fp32.

``remat`` checkpoints each block (``torch.utils.checkpoint``) under the
policy ``remat_policy`` names. The ``ring`` impl (``parallel/ring_attention.py``)
runs over ``cfg.mesh``'s ``seq`` axis: the model then takes its rank's chunk
of each row, and its rope positions start at the chunk's offset.

Under a tensor split (the train steps' ``tensor`` axis, Megatron-style) an
``Attention`` or ``MLP`` holds its rank's columns of q/k/v/gate/up and rows
of o/down, and the step hands it the tensor group (``tensor_group``) while
it runs: the block's input goes through ``copy_to_group`` (identity forward,
gradient all-reduced backward) and its output through
``reduce_from_group`` (the row-parallel partials all-reduced forward). The
head counts come from the weights it holds, so the flash kernels run at
H/tp heads.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from kubeflow_tpu_torch.ops import attention as att
from kubeflow_tpu_torch.ops.flash_decode import flash_decode
from kubeflow_tpu_torch.ops.pallas_attention import flash_attention
from kubeflow_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group
from kubeflow_tpu_torch.parallel.ring_attention import ring_attention


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
    attention_impl: str = "block"        # xla | block | flash | ring
    attention_block_size: int = 512
    attention_window: int | None = None  # sliding-window (local) attention
    decode_block_k: int = 256            # flash-decode cache tiling contract
    remat: bool = False                  # torch.utils.checkpoint each block
    remat_policy: str = "full"           # full | dots | flash (resolve_remat_policy)
    decode: bool = False                 # KV-cache mode (prefill / decode)
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None                  # parallel/mesh.create_mesh's mesh; "ring" needs it

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def resolve_remat_policy(name: str):
    """Map a config remat_policy name to a selective-checkpoint policy: a
    list of ops whose outputs a rematerialized block keeps (None = keep
    nothing but the block's input). Raises on unknown names.

    The ladder (memory high to low), as in the JAX package:
    - 'dots': keep every matmul output (jax ``dots_saveable``) — the
      cheapest recompute;
    - 'flash': keep ONLY the flash kernel's out and lse — the backward
      replay redoes the projections and the MLP but never the S^2 attention
      kernel. With a non-flash attention impl the op never runs and this is
      exactly 'full';
    - 'full': keep the block's input only — the most recompute, including a
      second flash forward per block.
    """
    if name == "dots":
        aten = torch.ops.aten
        return [aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default]
    if name == "flash":
        return [torch.ops.kubeflow_tpu_torch.flash_attention_fwd.default]
    if name == "full":
        return None
    raise ValueError(
        f"unknown remat_policy {name!r}; expected 'full', 'dots' or 'flash'"
    )


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


def seq_offset(cfg, S: int) -> int:
    """The position of a row's first token on this rank: under the ring,
    rank i of the ``seq`` axis holds positions i·S .. (i+1)·S - 1."""
    if cfg.attention_impl != "ring" or cfg.mesh is None:
        return 0
    return cfg.mesh.get_local_rank("seq") * S


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


def _param_dtype(cfg: TransformerConfig) -> torch.dtype:
    """fp32 weights for training (flax's ``param_dtype``); ``cfg.dtype``
    weights for a decode model, which only ever uses them cast."""
    return cfg.dtype if cfg.decode else torch.float32


def _cast_dtype(cfg: TransformerConfig):
    """The dtype a layer casts its operands to on every call, or None for a
    decode model: its weights and activations are already ``cfg.dtype``, and
    a decode step, bound by the host, makes no cast calls."""
    return None if cfg.decode else cfg.dtype


class Dense(nn.Linear):
    """flax ``Dense``/``DenseGeneral`` without bias: in training, input and
    fp32 weight are cast to ``cfg.dtype`` on every call."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig, device=None):
        super().__init__(n_in, n_out, bias=False, dtype=_param_dtype(cfg), device=device)
        self.compute_dtype = _cast_dtype(cfg)

    def forward(self, x):
        if self.compute_dtype is None:
            return F.linear(x, self.weight)
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class Embed(nn.Embedding):
    """flax ``Embed``: in training, the fp32 table is cast to ``cfg.dtype``
    before the lookup and before the tied head."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__(cfg.vocab_size, cfg.embed_dim, dtype=_param_dtype(cfg), device=device)
        self.compute_dtype = _cast_dtype(cfg)

    def table(self):
        """The table in the dtype the model computes in."""
        return self.weight if self.compute_dtype is None else self.weight.to(self.compute_dtype)

    def forward(self, tokens):
        return F.embedding(tokens, self.table())


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D, E = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.embed_dim
        self.q_proj = Dense(E, H * D, cfg, device)
        self.k_proj = Dense(E, KV * D, cfg, device)
        self.v_proj = Dense(E, KV * D, cfg, device)
        self.o_proj = Dense(H * D, E, cfg, device)
        self.tensor_group = None     # set by the train step under a tensor split

    def forward(self, x, rope_cs, start: int = 0, cache=None, pos=None):
        cfg = self.cfg
        B, S, E = x.shape
        D = cfg.head_dim
        # this rank's heads: all of them, or H/tp and KV/tp under a tensor split
        H, KV = self.q_proj.weight.shape[0] // D, self.k_proj.weight.shape[0] // D
        x = copy_to_group(x, self.tensor_group)
        q = apply_rope(self.q_proj(x).view(B, S, H, D), *rope_cs)
        k = apply_rope(self.k_proj(x).view(B, S, KV, D), *rope_cs)
        v = self.v_proj(x).view(B, S, KV, D)

        if not cfg.decode and KV != H and cfg.attention_impl in ("xla", "block"):
            # GQA: expand kv heads to query heads for the paths that need
            # per-head alignment; the flash kernels take grouped K/V
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        if cfg.attention_window is not None and cfg.attention_impl not in ("xla", "flash"):
            raise ValueError(
                "attention_window is supported by the 'xla' and 'flash' "
                f"impls, not {cfg.attention_impl!r}"
            )
        if cfg.decode:
            o = self._cached_attention(q, k, v, start, cache, pos)
        elif cfg.attention_impl == "xla":
            o = att.naive_attention(q, k, v, causal=True, window=cfg.attention_window)
        elif cfg.attention_impl == "block":
            o = att.blockwise_attention(q, k, v, causal=True, block_size=cfg.attention_block_size)
        elif cfg.attention_impl == "flash":
            o = flash_attention(
                q, k, v, True, cfg.attention_block_size,
                cfg.attention_block_size, cfg.attention_window,
            )
        elif cfg.attention_impl == "ring":
            if cfg.mesh is None:
                raise ValueError("attention_impl='ring' requires cfg.mesh")
            o = ring_attention(q, k, v, cfg.mesh, axis_name="seq", causal=True,
                               block=cfg.attention_block_size)
        else:
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
        return reduce_from_group(self.o_proj(o.reshape(B, S, H * D)), self.tensor_group)

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
        self.gate_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg, device)
        self.up_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg, device)
        self.down_proj = Dense(cfg.mlp_dim, cfg.embed_dim, cfg, device)
        self.tensor_group = None     # set by the train step under a tensor split

    def forward(self, x):
        x = copy_to_group(x, self.tensor_group)
        out = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return reduce_from_group(out, self.tensor_group)


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
        device = resolve_device(device)
        self.cfg = cfg
        policy = resolve_remat_policy(cfg.remat_policy)
        self._remat_context = (
            functools.partial(create_selective_checkpoint_contexts, policy)
            if policy is not None else None
        )
        self.embed = Embed(cfg, device)
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
        """Tied output head: both operands in ``cfg.dtype``, as flax's
        ``Embed.attend`` promotes them; logits in ``cfg.dtype``."""
        return F.linear(x.to(self.cfg.dtype), self.embed.table())

    def forward(self, tokens, start: int = 0, cache=None, return_hidden: bool = False):
        """tokens [B, S] at positions ``start .. start+S-1`` -> logits [B, S, V].

        In decode mode ``cache`` (from ``init_cache``) is required and is
        written in place."""
        cfg = self.cfg
        B, S = tokens.shape
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache (TransformerLM.init_cache)")
        x = self.embed(tokens)
        start = start + seq_offset(cfg, S)
        positions = torch.arange(start, start + S, device=tokens.device)
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        pos = torch.full((B,), start, dtype=torch.int32, device=tokens.device) if cfg.decode else None
        remat = cfg.remat and not cfg.decode and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                kw = {} if self._remat_context is None else {"context_fn": self._remat_context}
                x = checkpoint(layer, x, rope_cs, use_reentrant=False, **kw)
            else:
                x = layer(x, rope_cs, start, cache[i] if cfg.decode else None, pos)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.head(x)


def lm_loss(logits, tokens):
    """Next-token cross entropy (shift inside; tokens [B, S])."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def matmul_f32(a, b):
    """a [N, K] @ b [M, K]^T -> [N, M] in fp32 from operands of one dtype.

    bf16 and fp16 operands on the card go through ``torch.mm(...,
    out_dtype=torch.float32)``: products of the operands as they are, summed
    in fp32, and the logits never rounded to the operand dtype (XLA's
    ``preferred_element_type=f32``). Elsewhere the operands, already rounded
    to their dtype, are multiplied in fp32, which gives the same numbers."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    return a.float() @ b.float().t()


class _LogitsF32(torch.autograd.Function):
    """fp32 logits from ``compute_dtype`` operands, with XLA's transpose
    rule for ``preferred_element_type``: each operand's gradient is the fp32
    cotangent times the other operand in fp32, rounded to the operand's
    dtype."""

    @staticmethod
    def forward(ctx, h, e):
        ctx.save_for_backward(h, e)
        return matmul_f32(h, e)

    @staticmethod
    def backward(ctx, g):
        h, e = ctx.saved_tensors
        dh = (g @ e.float()).to(h.dtype) if ctx.needs_input_grad[0] else None
        de = (g.t() @ h.float()).to(e.dtype) if ctx.needs_input_grad[1] else None
        return dh, de


def lm_loss_chunked(hidden, embedding, tokens, *, chunk: int = 512, compute_dtype=None,
                    start: int = 0):
    """Next-token cross entropy with the tied head folded in, chunked over
    the sequence so the [B, S, vocab] fp32 logits never exist at once.

    ``hidden`` is the model's ``return_hidden=True`` output [B, S, E];
    ``embedding`` the tied [vocab, E] table. Each chunk's logits come from
    ``compute_dtype`` operands (default bf16) in fp32 and reduce to a scalar
    under ``torch.utils.checkpoint``, so the backward recomputes them instead
    of keeping them (the JAX scan body is ``jax.checkpoint``-ed). Everything
    past the logits (logsumexp, gather, sums) is fp32. Same math as
    ``lm_loss(embed.attend(hidden), tokens)``.

    ``start``: ``hidden`` holds positions ``start .. start+S-1`` of the rows
    ``tokens`` [B, T] (a ``seq`` rank's span; 0 and T = S for whole rows).
    The span's last position predicts the next span's first token, only the
    row's last position has no target, and the sum is divided by the whole
    rows' B·(T-1) targets: the spans' losses add up to the rows' loss.
    """
    B, S, E = hidden.shape
    T = tokens.shape[1]
    compute_dtype = compute_dtype or torch.bfloat16
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"chunk {c} must divide seq len {S}")
    if start < 0 or start + S > T:
        raise ValueError(f"positions {start} .. {start + S - 1} are outside rows of {T} tokens")
    # predict token t+1 from position t; the row's final position has no target
    tgt = torch.roll(tokens, -1, dims=1)[:, start:start + S].long()
    mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if start + S == T:
        mask[:, -1] = 0.0
    count = torch.full((), float(B * (T - 1)), dtype=torch.float32, device=hidden.device)

    def body(h_c, emb, t_c, m_c):
        logits = _LogitsF32.apply(
            h_c.reshape(-1, E).to(compute_dtype), emb.to(compute_dtype)
        ).view(B, c, -1)
        logz = torch.logsumexp(logits, dim=-1)                     # [B, c]
        gold = logits.gather(-1, t_c[..., None])[..., 0]
        return ((logz - gold) * m_c).sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, c):
        part = (hidden[:, c0:c0 + c], embedding, tgt[:, c0:c0 + c], mask[:, c0:c0 + c])
        if torch.is_grad_enabled():
            nll_sum = nll_sum + checkpoint(body, *part, use_reentrant=False)
        else:
            nll_sum = nll_sum + body(*part)
    return nll_sum / count
