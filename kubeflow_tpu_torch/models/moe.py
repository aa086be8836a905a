"""Mixture-of-Experts transformer LM in PyTorch; counterpart of ``kubeflow_tpu/models/moe.py``.

The same parameters (flax's layouts: router ``[M, E]``, expert tables
``[E, M, H]`` and ``[E, H, M]``), routing and numerics as the JAX module, so
weights carried over by ``interop.moe_params_from_flax`` give the same routing
plan, logits, losses and gradients:

- capacity-based top-k routing in fp32 (the router matmul runs on fp32
  operands: keep TF32 off on the card), tokens over capacity dropped, their
  residual stream passing through;
- two dispatch modes: ``gather`` (the row-gather kernel moves tokens into
  expert slots and back, ``ops/moe_dispatch.py``) and ``einsum`` (one-hot
  matmuls). ``a2a``, the expert-parallel path, comes with the multi-GPU
  slice;
- expert matmuls in ``cfg.dtype`` from fp32 weights cast on every call, GELU
  in its tanh form (``nn.gelu``'s default), the combine summed in fp32.

Each block returns its load-balance aux loss with its output (flax ``sow``s
it), so the losses survive ``torch.utils.checkpoint`` recompute. The
attention stack, norms, embedding and tied head are the dense model's
(``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from kubeflow_tpu_torch.models.transformer import (
    Attention,
    Embed,
    RMSNorm,
    TransformerConfig,
    lm_loss,
    lm_loss_chunked,
    resolve_device,
    resolve_remat_policy,
    rope_tables,
)
from kubeflow_tpu_torch.ops.moe_dispatch import gather_rows

EXPERT_SLICE = "slice 5 of the PyTorch port (multi-GPU parallelism: the expert mesh)"
FUSED_HEAD_SLICE = "slice 3b of the PyTorch port (ops/fused_head_loss.py, kernels 5-7)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    num_layers: int = 4
    num_heads: int = 8
    embed_dim: int = 512
    expert_hidden_dim: int = 1024
    num_experts: int = 8
    experts_per_token: int = 2          # top-k routing
    capacity_factor: float = 1.25
    max_seq_len: int = 2048
    aux_loss_weight: float = 1e-2
    dispatch: str = "einsum"            # einsum | gather (a2a: slice 5)
    attention_impl: str = "block"
    attention_block_size: int = 512
    remat: bool = False                 # torch.utils.checkpoint each block
    remat_policy: str = "full"          # full | dots | flash (as TransformerConfig)
    dtype: torch.dtype = torch.bfloat16

    def attention_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            embed_dim=self.embed_dim,
            mlp_dim=self.expert_hidden_dim,
            max_seq_len=self.max_seq_len,
            attention_impl=self.attention_impl,
            attention_block_size=self.attention_block_size,
            dtype=self.dtype,
        )

    def capacity(self, seq_len: int) -> int:
        """Per-expert token budget, a multiple of 8 (the JAX package's rule)."""
        raw = seq_len * self.experts_per_token / self.num_experts
        cap = int(math.ceil(raw * self.capacity_factor))
        return max(8, -(-cap // 8) * 8)


@dataclasses.dataclass
class RoutingPlan:
    """Per-choice routing decisions (k = experts_per_token entries each):
    ``experts``/``pos`` [k, B, S] int64 (chosen expert; slot within it),
    ``gates``/``keep`` [k, B, S] fp32 (combine weight; 1.0 if within
    capacity), plus the scalar load-balance ``aux_loss``."""

    experts: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux_loss: torch.Tensor


def _one_hot(idx, n: int):
    """fp32 one-hot with ``jax.nn.one_hot``'s rule: an index outside [0, n)
    gives a zero row (``F.one_hot`` raises instead)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route_top_k(router_logits, k: int, capacity: int) -> RoutingPlan:
    """Capacity-constrained top-k gating -> a RoutingPlan.

    router_logits: [B, S, E]. The choices come from an argmax-then-zero loop,
    not ``torch.topk``: ``argmax`` returns the first maximum, as
    ``jnp.argmax`` does, so ties break the same way on both sides.
    """
    B, S, E = router_logits.shape
    if k > E:
        raise ValueError(
            f"experts_per_token={k} exceeds num_experts={E}: after E rounds "
            "the argmax would re-select experts with duplicate gates"
        )
    probs = torch.softmax(router_logits.float(), dim=-1)

    idxs, masks, gates = [], [], []
    remaining = probs
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                      # [B, S]
        mask = _one_hot(idx, E)                                    # [B, S, E]
        gates.append(torch.sum(probs * mask, dim=-1))              # [B, S]
        idxs.append(idx)
        masks.append(mask)
        remaining = remaining * (1.0 - mask)

    # k > 1: renormalize over the selected experts (GShard); k == 1 keeps the
    # raw softmax probability (Switch), which still carries router gradient
    if k > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]

    # slots: every choice-0 pick before any choice-1 pick (GShard priority),
    # in sequence order within a choice; an fp32 cumsum, as in the JAX module
    poss, keeps = [], []
    offset = torch.zeros((B, E), dtype=torch.float32, device=probs.device)
    for mask in masks:
        pos_in_expert = torch.cumsum(mask, dim=1) - mask + offset[:, None, :]
        offset = offset + torch.sum(mask, dim=1)
        pos = torch.sum(pos_in_expert * mask, dim=-1)              # [B, S]
        keeps.append((pos < capacity).float() * torch.sum(mask, dim=-1))
        poss.append(pos.long())

    # load-balance aux: E * sum_e fraction_dispatched(e) * mean_prob(e)
    frac = torch.mean(masks[0], dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux_loss = E * torch.sum(frac * mean_prob)
    return RoutingPlan(
        experts=torch.stack(idxs), gates=torch.stack(gates), pos=torch.stack(poss),
        keep=torch.stack(keeps), aux_loss=aux_loss,
    )


def top_k_routing(router_logits, k: int, capacity: int):
    """Capacity-constrained top-k gating as a dense combine tensor:
    (combine [B, S, E, C] fp32, the gate weight of token (b, s) in slot c of
    expert e, 0 if dropped; aux_loss)."""
    plan = route_top_k(router_logits, k, capacity)
    return _dense_combine(plan, router_logits.shape[2], capacity), plan.aux_loss


def _dense_combine(plan: RoutingPlan, E: int, C: int):
    """The plan as a dense combine tensor [B, S, E, C] fp32."""
    k, B, S = plan.experts.shape
    combine = torch.zeros((B, S, E, C), dtype=torch.float32, device=plan.experts.device)
    for j in range(k):
        mask = _one_hot(plan.experts[j], E)
        slot = _one_hot(plan.pos[j], C)
        combine = combine + (
            (plan.gates[j] * plan.keep[j])[..., None, None]
            * mask[..., None] * slot[:, :, None, :]
        )
    return combine


def slot_indices(plan: RoutingPlan, E: int, C: int, S: int):
    """The gather indices of both trips: (slot_token [B, E*C] int32, the
    token each slot reads, S for an empty slot; combine_idx [k, B, S] int32,
    the slot each choice reads back, E*C for a dropped one).

    The slot table is built with an index write, as the JAX package builds
    it with XLA's scatter outside any kernel. Kept slots are distinct
    (expert, pos) pairs, so only the dropped choices collide, on column E*C,
    which is cut off."""
    k, B, _ = plan.experts.shape
    flat_idx = plan.experts * C + plan.pos                       # [k, B, S]
    combine_idx = torch.where(plan.keep > 0, flat_idx, E * C)
    slot_token = torch.full((B, E * C + 1), S, dtype=torch.int64, device=flat_idx.device)
    tokens = torch.arange(S, device=flat_idx.device).expand(B, S)
    for j in range(k):
        slot_token.scatter_(1, combine_idx[j], tokens)
    return slot_token[:, :E * C].to(torch.int32), combine_idx.to(torch.int32)


def _gather_dispatch(x, slot_token, E: int, C: int, dtype):
    """Index dispatch: x [B, S, M] -> expert slots [B, E, C, M] through the
    gather kernel, from x plus one zero row (row S, read by empty slots)."""
    B, S, M = x.shape
    x_pad = torch.cat([x.to(dtype), x.new_zeros((B, 1, M), dtype=dtype)], dim=1)
    return gather_rows(x_pad, slot_token).reshape(B, E, C, M)


def _gather_combine(out, plan: RoutingPlan, combine_idx):
    """Weighted return trip: [B, E, C, M] -> [B, S, M] fp32, one gather per
    choice from the slots plus one zero row (row E*C, read by dropped
    choices). Kept slots are injective, so the backward is the direct-store
    scatter; the dropped choices' collisions land on the padding row, whose
    gradient is discarded."""
    B, E, C, M = out.shape
    out_pad = torch.cat([out.reshape(B, E * C, M), out.new_zeros((B, 1, M))], dim=1)
    y = torch.zeros((B, combine_idx.shape[2], M), dtype=torch.float32, device=out.device)
    for j in range(combine_idx.shape[0]):
        tok = gather_rows(out_pad, combine_idx[j], unique_indices=True)   # [B, S, M]
        w = (plan.gates[j] * plan.keep[j])[..., None]
        y = y + w * tok.float()
    return y


class MoEMLP(nn.Module):
    """Expert FFN: route -> dispatch -> expert matmuls -> combine. Returns
    (y in ``cfg.dtype``, aux_loss)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        if cfg.dispatch == "a2a":
            raise NotImplementedError(f"dispatch='a2a' comes with {EXPERT_SLICE}")
        if cfg.dispatch not in ("einsum", "gather"):
            raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
        self.cfg = cfg
        M, E, H = cfg.embed_dim, cfg.num_experts, cfg.expert_hidden_dim
        f32 = dict(dtype=torch.float32, device=device)
        # zeros until weights are loaded (interop.moe_init_state_dict or
        # moe_params_from_flax)
        self.router = nn.Parameter(torch.zeros((M, E), **f32))
        self.experts_wi = nn.Parameter(torch.zeros((E, M, H), **f32))
        self.experts_wo = nn.Parameter(torch.zeros((E, H, M), **f32))

    def route(self, x) -> RoutingPlan:
        """The routing plan of x [B, S, M]: fp32 router logits on fp32
        operands, then capacity-constrained top-k."""
        logits = torch.einsum("bsm,me->bse", x.float(), self.router)
        return route_top_k(logits, self.cfg.experts_per_token, self.cfg.capacity(x.shape[1]))

    def forward(self, x):
        cfg = self.cfg
        B, S, M = x.shape
        E = cfg.num_experts
        C = cfg.capacity(S)
        plan = self.route(x)
        aux_loss = plan.aux_loss
        wi = self.experts_wi.to(cfg.dtype)
        wo = self.experts_wo.to(cfg.dtype)

        if cfg.dispatch == "einsum":
            combine = _dense_combine(plan, E, C)
            dispatch = (combine > 0).to(cfg.dtype)
            combine = combine.to(cfg.dtype)
            expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, x.to(cfg.dtype))
            h = F.gelu(torch.einsum("ebcm,emh->ebch", expert_in, wi), approximate="tanh")
            out = torch.einsum("ebch,ehm->ebcm", h, wo)
            y = torch.einsum("bsec,ebcm->bsm", combine, out)
        else:
            slot_token, combine_idx = slot_indices(plan, E, C, S)
            # [B, E, C, M] end to end: the kernel gathers straight into it
            # and the combine gathers straight out of it
            expert_in = _gather_dispatch(x, slot_token, E, C, cfg.dtype)
            h = F.gelu(torch.einsum("becm,emh->bech", expert_in, wi), approximate="tanh")
            out = torch.einsum("bech,ehm->becm", h, wo)
            y = _gather_combine(out, plan, combine_idx)
        return y.to(cfg.dtype), aux_loss


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        dim = cfg.embed_dim
        self.attn_norm = RMSNorm(dim, device=device)
        self.attn = Attention(cfg.attention_cfg(), device)
        self.moe_norm = RMSNorm(dim, device=device)
        self.moe = MoEMLP(cfg, device)

    def forward(self, x, rope_cs):
        """(x after the block, this block's aux loss)."""
        x = x + self.attn(self.attn_norm(x), rope_cs)
        y, aux_loss = self.moe(self.moe_norm(x))
        return x + y, aux_loss


class MoETransformerLM(nn.Module):
    """Decoder-only LM with an MoE FFN in every block. ``device`` defaults to
    CUDA and raises without a card."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        att_cfg = cfg.attention_cfg()
        self.rope_theta, self.head_dim = att_cfg.rope_theta, att_cfg.head_dim
        policy = resolve_remat_policy(cfg.remat_policy)
        self._remat_context = (
            functools.partial(create_selective_checkpoint_contexts, policy)
            if policy is not None else None
        )
        self.embed = Embed(att_cfg, device)
        self.layers = nn.ModuleList(MoEBlock(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def head(self, x):
        """Tied output head: both operands in ``cfg.dtype``, as flax's
        ``Embed.attend`` promotes them."""
        return F.linear(x.to(self.cfg.dtype), self.embed.table())

    def forward(self, tokens, return_hidden: bool = False, return_aux: bool = False):
        """tokens [B, S] -> logits [B, S, V] (or the final-norm hidden
        states). ``return_aux`` also returns the per-layer aux losses [L]
        (flax's ``mutable=["intermediates"]``)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed(tokens)
        rope_cs = rope_tables(torch.arange(S, device=tokens.device), self.head_dim,
                              self.rope_theta)
        remat = cfg.remat and torch.is_grad_enabled()
        kw = {} if self._remat_context is None else {"context_fn": self._remat_context}
        aux = []
        for layer in self.layers:
            if remat:
                x, a = checkpoint(layer, x, rope_cs, use_reentrant=False, **kw)
            else:
                x, a = layer(x, rope_cs)
            aux.append(a)
        x = self.final_norm(x)
        out = x if return_hidden else self.head(x)
        return (out, torch.stack(aux)) if return_aux else out


def moe_lm_loss(model: MoETransformerLM, tokens):
    """Next-token cross entropy + weighted load-balance aux losses."""
    logits, aux = model(tokens, return_aux=True)
    return lm_loss(logits, tokens) + model.cfg.aux_loss_weight * aux.mean()


def moe_lm_loss_chunked(model: MoETransformerLM, tokens, *, chunk: int = 512,
                        compute_dtype=None):
    """``moe_lm_loss`` through the chunked tied head (``lm_loss_chunked``):
    the [B, S, vocab] fp32 logits never exist at once. ``compute_dtype``
    passes through (default bf16 operands, fp32 logits)."""
    hidden, aux = model(tokens, return_hidden=True, return_aux=True)
    nll = lm_loss_chunked(hidden, model.embed.weight, tokens, chunk=chunk,
                          compute_dtype=compute_dtype)
    return nll + model.cfg.aux_loss_weight * aux.mean()


def moe_lm_loss_fused(model: MoETransformerLM, tokens, *, compute_dtype=None):
    """The fused-head loss: its three kernels are not ported yet."""
    raise NotImplementedError(f"moe_lm_loss_fused comes with {FUSED_HEAD_SLICE}")
