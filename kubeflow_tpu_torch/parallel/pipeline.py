"""Pipeline parallelism over the ``stage`` mesh axis (GPipe); counterpart of
``kubeflow_tpu/parallel/pipeline.py``.

The same schedule as the reference's ``_pipelined``: the transformer blocks
are cut into ``n_stages`` stages of consecutive blocks, the batch into
``n_micro`` microbatches, and ``n_micro + n_stages - 1`` ticks run every
stage on its in-flight microbatch, then hand the activations to the next
stage. Stage 0 feeds microbatch t at tick t; each stage step runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a stage
keeps one input a microbatch, not its activations.

Where the reference differentiates through the scan, the port runs the
backward explicitly, in reverse tick order: the last stage gets each
microbatch's output gradient from the head and loss, every stage
back-propagates one microbatch a tick and hands its input gradient to the
stage before. Each transfer is paired by the schedule itself, never by
autograd's order across ranks.

Parameters (``PipelineLM``): the embedding and the final norm are whole on
every stage rank, as the reference replicates them; a stage's blocks are
whole on the ranks of that stage (the reference's ``P("stage")``). The tied
embedding's gradient has two parts, the lookup's at stage 0 and the head's
at the last stage, summed over the stage group with the final norm's; then
every gradient is averaged over the batch ranks. The batch axes are the
reference's ``("data", "fsdp")``: each microbatch's rows are split over
them, and the ranks of every other axis (dcn among them) see the same rows.

``mesh`` is a ``DeviceMesh`` from ``parallel/mesh.create_mesh``, one stage a
process, the activations moved by ``all_to_all_single`` over the stage
group with one non-empty split (it takes CUDA tensors under nccl and gloo
alike); or a ``MeshPlan`` of stages alone, whose stages all run in this
process, handed over in memory by the same tick loop: how one card walks a
pipeline.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.interop import init_state_dict
from kubeflow_tpu_torch.models.transformer import (
    Block,
    Embed,
    RMSNorm,
    TransformerConfig,
    TransformerLM,
    lm_loss,
    resolve_device,
    rope_tables,
)
from kubeflow_tpu_torch.ops.optimizers import GradientTransformation, apply_updates
from kubeflow_tpu_torch.parallel import mesh as meshlib

# the reference's batch axes (`_pipelined`, `:136`): dcn is not among them
_BATCH_AXES = ("data", "fsdp")


class PipelineStage(nn.Module):
    """``num_blocks`` consecutive transformer blocks: one pipeline stage."""

    def __init__(self, cfg: TransformerConfig, num_blocks: int, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(num_blocks))

    def forward(self, x, rope_cs):
        for block in self.blocks:
            x = block(x, rope_cs)
        return x


class _Layout:
    """Where this process sits in the pipeline: the stages it runs, its
    stage and batch groups, and its share of each microbatch's rows."""

    def __init__(self, mesh):
        sizes = meshlib.axis_sizes(mesh)
        self.n_stages = sizes["stage"]
        self.n_batch = sizes["data"] * sizes["fsdp"]
        if isinstance(mesh, meshlib.MeshPlan):
            others = {a: n for a, n in sizes.items() if a != "stage" and n > 1}
            if others:
                raise ValueError(f"a MeshPlan runs every stage in this process; {others} need "
                                 "ranks: pass create_mesh's mesh")
            self.local, self.stage_group, self.batch_group, self.batch_index = (
                tuple(range(self.n_stages)), None, None, 0)
            return
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.local = (coord["stage"],)
        self.stage_group = mesh.get_group("stage") if self.n_stages > 1 else None
        self.batch_group = meshlib.group_over(mesh, _BATCH_AXES) if self.n_batch > 1 else None
        self.batch_index = coord["data"] * sizes["fsdp"] + coord["fsdp"]

    @property
    def last(self) -> int:
        return self.n_stages - 1

    def exchange(self, sends: dict, receive: bool, source: int, like):
        """One tick's hand-over: ``sends`` maps a stage to the tensor for it
        (from its neighbour on this process); ``receive``: whether this
        process's stage gets one from ``source``, shaped as ``like``. Returns
        {stage: tensor received}. In a walk every stage is here: the tensors
        change hands in memory."""
        if self.stage_group is None:
            return sends
        n, numel = self.n_stages, like.numel()
        in_splits, out_splits = [0] * n, [0] * n
        inp = like.new_empty(0)
        for dst, t in sends.items():
            in_splits[dst], inp = numel, t.reshape(-1).contiguous()
        out = like.new_empty(numel if receive else 0)
        if receive:
            out_splits[source] = numel
        dist.all_to_all_single(out, inp, out_splits, in_splits, group=self.stage_group)
        return {self.local[0]: out.view_as(like)} if receive else {}

    def stage_sum(self, t):
        """t summed over the stage group, in place (the parts a replicated
        parameter's gradient has on the stages that use it)."""
        if self.stage_group is not None:
            dist.all_reduce(t, group=self.stage_group)
        return t

    def batch_mean(self, t):
        """t averaged over the batch ranks, in place."""
        if self.batch_group is not None:
            dist.all_reduce(t, group=self.batch_group)
            t.div_(self.n_batch)
        return t


class PipelineLM(nn.Module):
    """This process's part of a pipelined LM: the embedding and final norm
    (whole on every stage rank) and the stages it runs (``stages[str(s)]``:
    its own under a process-group mesh, every stage under a ``MeshPlan``).
    Parameter names: ``embed.weight``, ``stages.{s}.blocks.{i}.<Block's>``,
    ``final_norm.weight`` (``interop.pipeline_params_from_flax``'s)."""

    def __init__(self, cfg: TransformerConfig, mesh, device=None):
        super().__init__()
        n_stages = meshlib.axis_sizes(mesh)["stage"]
        if cfg.num_layers % n_stages:
            raise ValueError(
                f"num_layers={cfg.num_layers} not divisible by {n_stages} pipeline stages")
        device = resolve_device(device)
        self.cfg, self.mesh, self.layout = cfg, mesh, _Layout(mesh)
        self.blocks_per_stage = cfg.num_layers // n_stages
        self.embed = Embed(cfg, device)
        self.stages = nn.ModuleDict({str(s): PipelineStage(cfg, self.blocks_per_stage, device)
                                     for s in self.layout.local})
        self.final_norm = RMSNorm(cfg.embed_dim, device=device)

    # the tied head's dtype rule: both operands in cfg.dtype, as flax's attend
    head = TransformerLM.head

    def load_pipeline_state_dict(self, sd: dict) -> None:
        """This process's part of a whole pipeline's state dict (every
        stage's blocks, the embedding and the final norm)."""
        self.load_state_dict({k: sd[k] for k in self.state_dict()})


def _lm_to_pipeline(sd: dict, blocks_per_stage: int) -> dict:
    """A ``TransformerLM`` state dict under the pipeline's names: layer l is
    block l % nb of stage l // nb."""
    out = {}
    for k, v in sd.items():
        if k.startswith("layers."):
            _, layer, rest = k.split(".", 2)
            s, i = divmod(int(layer), blocks_per_stage)
            k = f"stages.{s}.blocks.{i}.{rest}"
        out[k] = v
    return out


def init_pipeline_lm(cfg: TransformerConfig, mesh, seed: int = 0, *, device=None) -> PipelineLM:
    """This process's part of a pipelined LM with fresh fp32 weights from
    ``seed`` at flax's init scale: those of ``interop.init_state_dict(cfg,
    seed)``, so that ``TransformerLM`` with that state dict is the same model
    unpipelined. The card unless ``device`` says otherwise."""
    model = PipelineLM(cfg, mesh, device)
    sd = init_state_dict(cfg, seed, device=model.embed.weight.device)
    model.load_pipeline_state_dict(_lm_to_pipeline(sd, model.blocks_per_stage))
    return model


def _microbatches(model: PipelineLM, tokens, num_microbatches: int):
    """This process's rows of each microbatch: [n_micro, rows, S], the
    reference's ``P(None, ("data", "fsdp"))`` over the microbatched batch."""
    B, S = tokens.shape
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by {num_microbatches} microbatches")
    mb, nb = B // num_microbatches, model.layout.n_batch
    if mb % nb:
        raise ValueError(
            f"a microbatch of tokens [{mb}, {S}] (batch [{B}, {S}] in {num_microbatches}) "
            f"cannot be split over the {nb} batch ranks (data x fsdp)")
    tokens = tokens.to(model.embed.weight.device)
    return tokens.view(num_microbatches, nb, mb // nb, S)[:, model.layout.batch_index]


def _valid(t: int, s: int, n_micro: int) -> bool:
    """Whether stage s runs a microbatch at tick t (microbatch t - s). The
    reference's bubble ticks recompute the last microbatch and write
    nothing: they are not run here, which changes no output or gradient."""
    return 0 <= t - s < n_micro


def _forward(model: PipelineLM, xs, rope_cs, grad: bool):
    """The GPipe forward over this process's stages. ``xs``: stage 0's
    inputs a microbatch (on the process that runs stage 0). Returns the last
    stage's outputs a microbatch (where it runs) and, with ``grad``, each
    (stage, microbatch)'s (input, output) for the backward."""
    L, n_micro = model.layout, len(xs)
    ys, saved, inbox = [None] * n_micro, {}, {}
    like = torch.empty_like(xs[0])
    for t in range(n_micro + L.n_stages - 1):
        sends = {}
        for s in L.local:
            if not _valid(t, s, n_micro):
                continue
            x = xs[t - s] if s == 0 else inbox.pop(s)
            if grad:
                x = x.detach().requires_grad_()
                y = checkpoint(model.stages[str(s)], x, rope_cs, use_reentrant=False)
                saved[s, t - s] = (x, y)
            else:
                y = model.stages[str(s)](x, rope_cs)
            if s == L.last:
                ys[t - s] = y
            else:
                sends[s + 1] = y.detach()
        me = L.local[0]
        if any(_valid(t, s, n_micro) for s in range(L.last)):
            inbox = L.exchange(sends, me > 0 and _valid(t, me - 1, n_micro), me - 1, like)
    return ys, saved


def _backward(model: PipelineLM, saved, dys, like):
    """The explicit backward, in reverse tick order: each stage
    back-propagates one microbatch a tick from its output gradient (``dys``
    at the last stage, else the next stage's hand-over) and hands its input
    gradient back. Returns stage 0's input gradients a microbatch and
    {parameter: gradient summed over the microbatches} of this process's
    stages."""
    L, n_micro = model.layout, len(dys)
    dxs, grads, inbox = [None] * n_micro, {}, {}
    for t in reversed(range(n_micro + L.n_stages - 1)):
        sends = {}
        for s in L.local:
            if not _valid(t, s, n_micro):
                continue
            dy = dys[t - s] if s == L.last else inbox.pop(s)
            x, y = saved.pop((s, t - s))
            params = list(model.stages[str(s)].parameters())
            dx, *dps = torch.autograd.grad(y, [x, *params], dy)
            for p, g in zip(params, dps):
                grads[p] = g if p not in grads else grads[p] + g
            if s == 0:
                dxs[t - s] = dx
            else:
                sends[s - 1] = dx
        me = L.local[0]
        if any(_valid(t, s, n_micro) for s in range(1, L.n_stages)):
            inbox = L.exchange(sends, me < L.last and _valid(t, me + 1, n_micro), me + 1, like)
    return dxs, grads


def _check(model, mesh):
    if not isinstance(model, PipelineLM) or model.mesh != mesh:
        raise ValueError("params must be init_pipeline_lm's PipelineLM for this mesh")


def pipeline_forward(cfg: TransformerConfig, mesh, params: PipelineLM, tokens, *,
                     num_microbatches: int):
    """Full forward of the global batch ``tokens`` [B, S]: embed, the
    pipelined stages, final norm, tied logits [B, S, V] in ``cfg.dtype``,
    the same on every rank (the reference's logits, replicated over stage).
    No gradient: a step differentiates with ``pipeline_value_and_grad``."""
    _check(params, mesh)
    L = params.layout
    with torch.no_grad():
        local = _microbatches(params, tokens, num_microbatches)
        n_micro, rows, S = local.shape
        rope_cs = rope_tables(torch.arange(S, device=local.device), cfg.head_dim, cfg.rope_theta)
        xs = list(params.embed(local.flatten(0, 1)).view(n_micro, rows, S, -1))
        ys, _ = _forward(params, xs, rope_cs, grad=False)
        # the last stage's outputs to every stage rank (the reference's psum)
        y = torch.stack(ys) if L.last in L.local else torch.zeros_like(torch.stack(xs))
        L.stage_sum(y)
        if L.batch_group is not None:
            out = y.new_empty((L.n_batch * n_micro, *y.shape[1:]))
            dist.all_gather_into_tensor(out, y.contiguous(), group=L.batch_group)
            y = out.view(L.n_batch, *y.shape).transpose(0, 1)
        return params.head(params.final_norm(y.reshape(-1, S, y.shape[-1])))


def pipeline_value_and_grad(cfg: TransformerConfig, mesh, params: PipelineLM, tokens, *,
                            num_microbatches: int):
    """``jax.value_and_grad`` of ``lm_loss(pipeline_forward(...), tokens)``:
    (the global batch's loss, {parameter name: its gradient}), the same on
    every rank of the mesh: embedding and final norm summed over the stage
    group, every gradient averaged over the batch ranks."""
    _check(params, mesh)
    L = params.layout
    local = _microbatches(params, tokens, num_microbatches)
    n_micro, rows, S = local.shape
    rope_cs = rope_tables(torch.arange(S, device=local.device), cfg.head_dim, cfg.rope_theta)
    embed_w, norm_w = params.embed.weight, params.final_norm.weight
    like = torch.empty((rows, S, cfg.embed_dim), dtype=cfg.dtype, device=local.device)
    with torch.enable_grad():
        emb = params.embed(local.flatten(0, 1)) if 0 in L.local else None
        xs = list(emb.view(n_micro, rows, S, -1)) if emb is not None else [like] * n_micro
        ys, saved = _forward(params, xs, rope_cs, grad=True)
        # the parts the stages outside the blocks owe: head and final norm
        # at the last stage, the lookup at stage 0
        g_embed, g_norm = torch.zeros_like(embed_w), torch.zeros_like(norm_w)
        loss = torch.zeros((), dtype=torch.float32, device=embed_w.device)
        dys = [None] * n_micro
        if L.last in L.local:
            y = torch.stack(ys).detach().requires_grad_()
            logits = params.head(params.final_norm(y.view(n_micro * rows, S, -1)))
            loss_l = lm_loss(logits, local.flatten(0, 1))
            dy, g_norm, g_head = torch.autograd.grad(loss_l, [y, norm_w, embed_w])
            dys, loss = list(dy), loss_l.detach()
            g_embed = g_embed + g_head
        dxs, grads = _backward(params, saved, dys, like)
        if emb is not None:
            g_embed = g_embed + torch.autograd.grad(emb, embed_w, torch.stack(dxs).flatten(0, 1))[0]
    # the parameters outside the stages: their parts summed over the stage group
    grads[embed_w], grads[norm_w] = L.stage_sum(g_embed), L.stage_sum(g_norm)
    L.stage_sum(loss)
    out = {}
    for name, p in params.named_parameters():
        out[name] = L.batch_mean(grads[p])
    return L.batch_mean(loss), out


def make_pipeline_train_step(cfg: TransformerConfig, mesh, tx: GradientTransformation, *,
                             num_microbatches: int):
    """(init, step): an LM training step over the pipelined forward.

    ``init(seed=0, *, device=None) -> (params, opt_state)``: this process's
    ``PipelineLM`` (``init_pipeline_lm``) and ``tx.init`` of its parameters
    in ``named_parameters()`` order (weights loaded otherwise take
    ``tx.init(list(params.parameters()))``). ``step(params, opt_state,
    tokens) -> (params, opt_state, loss)``: every rank passes the global
    batch; the parameters and the optimizer state are updated in place (the
    JAX step's donated state) and the loss is the global batch's, the same
    on every rank."""

    def init(seed: int = 0, *, device=None):
        params = init_pipeline_lm(cfg, mesh, seed, device=device)
        return params, tx.init(list(params.parameters()))

    def step(params, opt_state, tokens):
        loss, grads = pipeline_value_and_grad(cfg, mesh, params, tokens,
                                              num_microbatches=num_microbatches)
        ps = list(params.parameters())
        apply_updates(ps, tx.update(list(grads.values()), opt_state, ps))
        return params, opt_state, loss

    return init, step
