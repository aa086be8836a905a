"""Mixture-of-Experts transformer LM in PyTorch; counterpart of ``kubeflow_tpu/models/moe.py``.

The same parameters (flax's layouts: router ``[M, E]``, expert tables
``[E, M, H]`` and ``[E, H, M]``), routing and numerics as the JAX module, so
weights carried over by ``interop.moe_params_from_flax`` give the same routing
plan, logits, losses and gradients:

- capacity-based top-k routing in fp32 (the router matmul runs on fp32
  operands: keep TF32 off on the card), tokens over capacity dropped, their
  residual stream passing through;
- three dispatch modes: ``gather`` (the row-gather kernel moves tokens into
  expert slots and back, ``ops/moe_dispatch.py``), ``einsum`` (one-hot
  matmuls) and ``a2a``, the expert-parallel path: the gather dispatch on
  the rank's rows, an all-to-all over ``cfg.mesh``'s ``expert`` group to the
  ranks that hold each expert ([B, E, C, M] slots become [B·ep, E/ep, C, M]),
  the local experts' FFN, and the all-to-all back before the gather
  combine (``_expert_compute_a2a``);
- under a tensor split the expert tables hold their rank's columns of the
  hidden dim (``wi``) and rows of it (``wo``): the FFN's partials are
  all-reduced over the tensor group the train step hands the module
  (``tensor_group``), its input's gradient too;
- ``einsum`` with the tables split over the expert axis (the JAX default
  dispatch on an expert mesh): the train step hands the module its expert
  group (``expert_group``); every rank of it routes the same rows and runs
  the slots of the E/ep experts it holds, x enters that segment through
  ``copy_to_group`` and y leaves through ``reduce_from_group``, and the
  gates' gradient is summed over the group (each choice's expert lives on
  one rank), so the router and x get the whole gradient on every rank;
- expert matmuls in ``cfg.dtype`` from fp32 weights cast on every call, GELU
  in its tanh form (``nn.gelu``'s default), the combine summed in fp32.

- under the train steps' span route (``parallel/train.py``: a ring model,
  each ``seq`` rank holding one span of every row) the module gets the seq
  group (``seq_group``) and routes its span as the whole row would: the
  capacity is the whole row's, and the slots of each choice continue from
  the lower seq ranks' counts of that choice and the whole row's counts of
  every earlier choice (``route_top_k``), so the plan is the whole row's,
  bit for bit, and no token crosses the seq ranks after it (the expert FFN
  is per slot).

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
import torch.distributed as dist
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
    seq_offset,
)
from kubeflow_tpu_torch.ops.fused_head_loss import fused_head_nll
from kubeflow_tpu_torch.ops.moe_dispatch import gather_rows
from kubeflow_tpu_torch.parallel import mesh as meshlib
from kubeflow_tpu_torch.parallel.collectives import all_to_all, copy_to_group, reduce_from_group


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
    dispatch: str = "einsum"            # einsum | gather | a2a
    attention_impl: str = "block"
    attention_block_size: int = 512
    remat: bool = False                 # torch.utils.checkpoint each block
    remat_policy: str = "full"          # full | dots | flash (as TransformerConfig)
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None                 # parallel/mesh.create_mesh's mesh; "a2a" needs it

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
            mesh=self.mesh,
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


def route_top_k(router_logits, k: int, capacity: int, group=None, seq_group=None) -> RoutingPlan:
    """Capacity-constrained top-k gating -> a RoutingPlan.

    router_logits: [B, S, E]. The choices come from an argmax-then-zero loop,
    not ``torch.topk``: ``argmax`` returns the first maximum, as
    ``jnp.argmax`` does, so ties break the same way on both sides.

    ``group``: the process group over which the tokens are sharded (equal
    shards). The load-balance loss is then the global tokens': ``frac`` and
    ``mean_prob`` are averaged over the group before their product. The
    gradient reaches this rank's router through its own ``mean_prob``, as
    the product's derivative is ``E * frac``: the train step's sum of the
    ranks' shares of their gradients is then the global loss's. Capacity
    and dispatch stay per batch row.

    ``seq_group``: the ranks that each hold one span of the rows, in order
    (``group`` then spans them too). ``capacity`` is then the whole row's,
    and the slots are the whole row's: choice j of the span starts at the
    lower ranks' counts of choice j plus the whole row's counts of choices
    0 .. j-1 (one all-gather of the [k, B, E] counts), so ``pos`` and
    ``keep`` equal the whole-row plan's at these positions, bit for bit
    (fp32 sums of integers). The aux loss is this rank's share, the whole
    rows' divided by the seq ranks, so that the spans' losses add up.
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
    counts = [torch.sum(mask, dim=1) for mask in masks]              # [B, E] each
    before = [None] * k
    if seq_group is not None:
        before, counts = (list(c) for c in _seq_counts(torch.stack(counts), seq_group))
    poss, keeps = [], []
    offset = torch.zeros((B, E), dtype=torch.float32, device=probs.device)
    for mask, count, lower in zip(masks, counts, before):
        start = offset if lower is None else offset + lower
        pos_in_expert = torch.cumsum(mask, dim=1) - mask + start[:, None, :]
        offset = offset + count
        pos = torch.sum(pos_in_expert * mask, dim=-1)              # [B, S]
        keeps.append((pos < capacity).float() * torch.sum(mask, dim=-1))
        poss.append(pos.long())

    # load-balance aux: E * sum_e fraction_dispatched(e) * mean_prob(e)
    frac = torch.mean(masks[0], dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    if group is not None:
        both = torch.stack([frac, mean_prob.detach()])
        dist.all_reduce(both, group=group)
        both = both / dist.get_world_size(group)
        frac, mean_prob = both[0], mean_prob + (both[1] - mean_prob).detach()
    aux_loss = E * torch.sum(frac * mean_prob)
    if seq_group is not None:
        aux_loss = aux_loss / _seq_size(seq_group)
    return RoutingPlan(
        experts=torch.stack(idxs), gates=torch.stack(gates), pos=torch.stack(poss),
        keep=torch.stack(keeps), aux_loss=aux_loss,
    )


def _seq_size(seq_group) -> int:
    """The number of spans a row is cut into: the seq group's ranks."""
    return dist.get_world_size(seq_group)


def _seq_counts(counts, seq_group):
    """(the lower seq ranks' sums of ``counts`` [k, B, E], all ranks' sums):
    one all-gather over ``seq_group``, summed in rank order."""
    n, my = _seq_size(seq_group), dist.get_rank(seq_group)
    every = counts.new_empty((n * counts.shape[0], *counts.shape[1:]))
    dist.all_gather_into_tensor(every, counts.contiguous(), group=seq_group)
    every = every.view(n, *counts.shape)
    return every[:my].sum(dim=0), every.sum(dim=0)


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


def _expert_ffn(x, wi, wo, layout: str, group=None):
    """The experts' FFN on slots ``x`` in ``layout`` ("becm" or "ebcm"):
    GELU (tanh form) of x·wi, then ·wo. Under a tensor split (``group``)
    wi holds this rank's hidden columns and wo its rows: the partials are
    summed over the group, and x's gradient is too."""
    x = copy_to_group(x, group)
    hidden = layout[:-1] + "h"
    h = F.gelu(torch.einsum(f"{layout},emh->{hidden}", x, wi), approximate="tanh")
    return reduce_from_group(torch.einsum(f"{hidden},ehm->{layout}", h, wo), group)


def _to_experts(slots, ep: int):
    """[B, E, C, M] slots -> [ep, B, E/ep, C, M]: chunk u holds the slots of
    the experts rank u of the expert group holds (the all-to-all's input)."""
    B, E, C, M = slots.shape
    return slots.view(B, ep, E // ep, C, M).transpose(0, 1).contiguous()


def _from_sources(received):
    """The all-to-all's output [ep, B, E/ep, C, M] (chunk t from rank t) ->
    the local experts' slots of the whole group's rows [ep·B, E/ep, C, M]."""
    return received.flatten(0, 1)


def _to_sources(out, ep: int):
    """The local experts' output [ep·B, E/ep, C, M] -> [ep, B, E/ep, C, M]:
    chunk t goes back to rank t."""
    return out.unflatten(0, (ep, -1))


def _from_experts(returned):
    """The return all-to-all's output [ep, B, E/ep, C, M] (chunk u from
    the rank holding expert group u) -> [B, E, C, M]."""
    return returned.transpose(0, 1).flatten(1, 2)


def _expert_compute_a2a(slots, wi, wo, expert_group, tensor_group=None):
    """The expert-parallel segment: [B, E, C, M] slots of this rank's rows
    to the ranks of the expert group that hold their experts, this rank's
    E/ep experts on the group's rows, and back: [B, E, C, M]. ``wi`` and
    ``wo`` are the rank's experts (E/ep of them; under a tensor split also
    its part of the hidden dim)."""
    ep = dist.get_world_size(expert_group)
    E = slots.shape[1]
    if wi.shape[0] * ep != E or wo.shape[0] * ep != E:
        raise ValueError(f"dispatch='a2a' on {ep} expert ranks holds {E} // {ep} experts a "
                         f"rank, got tables of {wi.shape[0]} and {wo.shape[0]}: split them over "
                         "the expert axis (parallel/mesh.moe_param_spec)")
    received = all_to_all(_to_experts(slots, ep), expert_group)
    out = _expert_ffn(_from_sources(received), wi, wo, "becm", tensor_group)
    return _from_experts(all_to_all(_to_sources(out, ep), expert_group))


class MoEMLP(nn.Module):
    """Expert FFN: route -> dispatch -> expert matmuls -> combine. Returns
    (y in ``cfg.dtype``, aux_loss)."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        if cfg.dispatch not in ("einsum", "gather", "a2a"):
            raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
        expert_mesh = cfg.mesh is not None and meshlib.axis_sizes(cfg.mesh)["expert"] > 1
        if cfg.dispatch == "a2a" and not expert_mesh:
            raise ValueError("dispatch='a2a' requires cfg.mesh with an expert axis > 1; use "
                             "'gather' on single-device/data-parallel setups")
        if cfg.dispatch == "gather" and expert_mesh:
            raise ValueError("dispatch='gather' is the single-device/data-parallel path; use "
                             "dispatch='a2a' on expert-parallel meshes")
        self.cfg = cfg
        M, E, H = cfg.embed_dim, cfg.num_experts, cfg.expert_hidden_dim
        f32 = dict(dtype=torch.float32, device=device)
        # zeros until weights are loaded (interop.moe_init_state_dict or
        # moe_params_from_flax)
        self.router = nn.Parameter(torch.zeros((M, E), **f32))
        self.experts_wi = nn.Parameter(torch.zeros((E, M, H), **f32))
        self.experts_wo = nn.Parameter(torch.zeros((E, H, M), **f32))
        # the process group of the ranks that shard the batch (set by the
        # train step under a mesh): the load-balance loss is the global batch's
        self.group = None
        self.seq_group = None        # set by the train step's span route: x is a span of each row
        self.tensor_group = None     # set by the train step under a tensor split
        self.expert_group = None     # set by the train step: einsum, tables split over expert

    def capacity(self, S: int) -> int:
        """The per-expert budget of rows of which x holds ``S`` positions:
        the whole row's under the span route."""
        n = 1 if self.seq_group is None else _seq_size(self.seq_group)
        return self.cfg.capacity(S * n)

    def route(self, x) -> RoutingPlan:
        """The routing plan of x [B, S, M]: fp32 router logits on fp32
        operands, then capacity-constrained top-k."""
        logits = torch.einsum("bsm,me->bse", x.float(), self.router)
        return route_top_k(logits, self.cfg.experts_per_token, self.capacity(x.shape[1]),
                           self.group, self.seq_group)

    def forward(self, x):
        cfg = self.cfg
        B, S, M = x.shape
        E = cfg.num_experts
        C = self.capacity(S)
        plan = self.route(x)
        aux_loss = plan.aux_loss
        wi = self.experts_wi.to(cfg.dtype)
        wo = self.experts_wo.to(cfg.dtype)

        if cfg.dispatch == "einsum":
            group, x_in = self.expert_group, x
            if group is not None:
                plan.gates = copy_to_group(plan.gates, group)
            combine = _dense_combine(plan, E, C)
            if group is not None:
                first = dist.get_rank(group) * wi.shape[0]
                combine = combine[:, :, first:first + wi.shape[0]]
                x_in = copy_to_group(x, group)
            dispatch = (combine > 0).to(cfg.dtype)
            combine = combine.to(cfg.dtype)
            expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, x_in.to(cfg.dtype))
            out = _expert_ffn(expert_in, wi, wo, "ebcm", self.tensor_group)
            y = reduce_from_group(torch.einsum("bsec,ebcm->bsm", combine, out), group)
        else:
            slot_token, combine_idx = slot_indices(plan, E, C, S)
            # [B, E, C, M] end to end: the kernel gathers straight into it
            # and the combine gathers straight out of it
            expert_in = _gather_dispatch(x, slot_token, E, C, cfg.dtype)
            if cfg.dispatch == "gather":
                out = _expert_ffn(expert_in, wi, wo, "becm", self.tensor_group)
            else:
                out = _expert_compute_a2a(expert_in, wi, wo, cfg.mesh.get_group("expert"),
                                          self.tensor_group)
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
    CUDA and raises without a card. A ``ring`` model takes its rank's span
    of each row, its rope positions from the span's offset, as the dense
    model does (``whole_rows`` as there)."""

    whole_rows = False       # set by the train step's whole-row route

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
        start = seq_offset(cfg, S, self.whole_rows)
        rope_cs = rope_tables(torch.arange(start, start + S, device=tokens.device),
                              self.head_dim, self.rope_theta)
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
                        compute_dtype=None, start: int = 0, S: int | None = None):
    """``moe_lm_loss`` through the chunked tied head (``lm_loss_chunked``):
    the [B, S, vocab] fp32 logits never exist at once. ``compute_dtype``
    passes through (default bf16 operands, fp32 logits). ``start`` and
    ``S``: the loss of positions ``start .. start+S-1`` of the rows (a seq
    rank's span; the whole rows by default)."""
    S = tokens.shape[1] if S is None else S
    hidden, aux = model(tokens[:, start:start + S], return_hidden=True, return_aux=True)
    nll = lm_loss_chunked(hidden, model.embed.weight, tokens, chunk=chunk,
                          compute_dtype=compute_dtype, start=start)
    return nll + model.cfg.aux_loss_weight * aux.mean()


def moe_lm_loss_fused(model: MoETransformerLM, tokens, *, compute_dtype=None, start: int = 0,
                      S: int | None = None):
    """``moe_lm_loss`` through the fused tied head (``ops/fused_head_loss.py``):
    the [B, S, vocab] logits exist only as tiles inside its kernels, and the
    fp32 table's gradient comes back from the dE kernel in fp32.
    ``compute_dtype`` as in ``moe_lm_loss_chunked`` (default bf16 operands;
    fp32 for parity runs, on the CPU or through the head's fp32 kernels on
    the card); ``start`` and ``S`` as there."""
    S = tokens.shape[1] if S is None else S
    hidden, aux = model(tokens[:, start:start + S], return_hidden=True, return_aux=True)
    nll = fused_head_nll(hidden, model.embed.weight, tokens,
                         compute_dtype=compute_dtype or torch.bfloat16, start=start)
    return nll + model.cfg.aux_loss_weight * aux.mean()
