"""Train steps for LM and classifier models; counterpart of ``kubeflow_tpu/parallel/train.py``.

The step factories take the reference's arguments in the reference's order
(``model, tx, mesh, *, param_rule, ..., donate``). The model's parameters and
the optimizer state are updated in place, the counterpart of the JAX step's
donated state, so ``donate`` must stay True.

``mesh=None`` is one device: the state is ``{"params", "opt_state", "step"}``,
``"params"`` the model's own parameters by name (the same tensors; the step
updates them through the model), and ``TrainStepBundle.state_shardings`` is
None. Every state is a :class:`TrainState`, a dict that also says where its
tensors live, for the checkpoint manager (``utils/checkpoint.py``).

Under a mesh (``parallel/mesh.py``'s ``create_mesh``) every rank calls
``step`` with the same global batch, as the JAX step is called with the
global array, and takes its part of it:

- rows: equal shards over the batch axes (dcn, data, fsdp, and expert for a
  model with the ``a2a`` dispatch, whose batch rides the expert axis outside
  the MoE experts as the JAX ``a2a`` path's does);
- ``seq``, two routes. The span route, for an LM step whose loss takes a
  span (the step's own chunked loss, or a ``loss_fn`` with the keywords
  ``start`` and ``S``, as ``moe_lm_loss_chunked`` and ``moe_lm_loss_fused``
  have) on a model with ``attention_impl="ring"`` over the step's mesh: each
  row is cut into equal spans over the seq axis, the model runs ring
  attention over it (an MoE model routes its span with the slots and the
  capacity of the whole row, ``models/moe.py``) and the loss divides each
  span's sum by its whole rows' target count, a span's last position
  predicting the next span's first token; the spans' losses add up to the
  rows'. The whole-row route, for everything else (a ``loss_fn`` without
  those keywords, the classifier, a model not on the ring), is the JAX
  layout: every seq rank holds whole rows and computes the same loss, a ring
  model's attention cutting its span and gathering the output
  (``ring_attention_rows``); the seq ranks' identical gradients and metrics
  are averaged;
- ``tensor``: the same rows on every rank; the tensor-parallel layers
  (``Attention``, ``MLP``, the MoE experts) hold their rank's columns and
  rows and get the tensor group while the step runs. Where the legalised
  rule splits an ``Attention``'s q and o but leaves k and v whole (KV heads
  not a multiple of tensor), the layer computes k and v for the KV heads
  its query heads read, and the whole k and v weights' gradients, partial
  on each rank, are summed over tensor;
- ``expert`` under the ``einsum`` dispatch: the same rows on every rank;
  each MoE layer holds E/ep experts and gets the expert group while the
  step runs (``models/moe.py``);
- ``stage``: the same rows and the same shards on every rank, nothing
  summed over it, as the JAX steps replicate over it (no rule names it;
  the pipeline is ``parallel/pipeline.py``'s own step).

Parameters and optimizer slots are stored as the rule's legalised shards
(ZeRO-3 over fsdp, Megatron over tensor, experts over expert):
``state["params"]`` maps each parameter's name to this rank's shard, a
parameter the rule replicates stays whole, and between steps the model
holds only its replicated parameters (a split one is an empty tensor). Each
step all-gathers the fsdp shards into the model for compute (a tensor or
expert split stays the rank's own part). Each rank differentiates its share
of the global loss, its loss divided by the number of ranks whose losses
average to the global one (the row shards, times the seq ranks on the
whole-row route), as GSPMD differentiates the global mean: the backward
then carries the one-device step's scale, whose bf16 roundings a later
division would not reproduce. Each gradient is then summed over the ranks
whose data differ but whose part of the parameter is the same: the batch
axes and seq, less expert for the expert tables (whose gradients already
hold their expert group's rows) and never tensor or stage (their ranks see
the same rows, and ``copy_to_group`` has summed what the split layers'
inputs owe), save the whole k/v of a half-split layer; fsdp by
reduce-scatter. The optimizer, which is elementwise, runs on the shards.
The loss (and accuracy) come back as the global batch's on every rank, as
the JAX step returns them replicated. The batch statistics of train-mode
BatchNorm and the MoE load-balance loss are the global batch's: while a
step runs, the model's ``BatchNorm``, ``PallasBatchNorm`` and ``MoEMLP``
modules hold the batch group (an MoE layer on the span route the batch and
seq group, and the seq group for its slots) and all-reduce their sums; the
step clears it again, so the model is left as it was given.
``bundle.gather`` returns whole tensors from a {name: shard} dict, e.g. the
parameters for serving after training.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.models.moe import MoEMLP, MoETransformerLM
from kubeflow_tpu_torch.models.resnet import BatchNorm, PallasBatchNorm
from kubeflow_tpu_torch.models.transformer import (
    MLP,
    Attention,
    TransformerLM,
    lm_loss_chunked,
)
from kubeflow_tpu_torch.ops.optimizers import GradientTransformation, apply_updates
from kubeflow_tpu_torch.parallel import mesh as meshlib


class TrainState(dict):
    """A train bundle's state, ``{"params": {name: tensor}, "opt_state", "step"}``.

    ``mesh`` and ``shardings`` say where its tensors live: under a mesh the
    bundle's mesh and ``state_shardings`` (each tensor this rank's shard of
    the whole), on one device None (each tensor whole)."""

    mesh = None
    shardings = None


@dataclasses.dataclass
class TrainStepBundle:
    """Everything a notebook (or bench harness) needs to run training."""

    init: Callable  # () -> TrainState {"params", "opt_state", "step"} (params: shards under a mesh)
    step: Callable  # (state, batch) -> (state, metrics); updates in place
    state_shardings: object = None  # the state's specs over a mesh; None on one device
    gather: Callable | None = None  # ({name: shard}) -> {name: whole tensor}; None on one device


# the modules that reduce over the batch under a mesh (their ``group``)
_BATCH_REDUCERS = (BatchNorm, PallasBatchNorm, MoEMLP)
# the modules that read whether they get whole rows under seq > 1 (``whole_rows``)
_ROW_READERS = (TransformerLM, MoETransformerLM, Attention)
# the axes whose ranks hold different rows (with expert for the a2a
# dispatch, whose batch rides it), in the mesh's order
_ROW_AXES = ("dcn", "data", "fsdp")
# the layers a tensor split runs on, and the parameters it splits in each
_TENSOR_LAYERS = {Attention: ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                              "o_proj.weight"),
                  MLP: ("gate_proj.weight", "up_proj.weight", "down_proj.weight"),
                  MoEMLP: ("experts_wi", "experts_wo")}
# an Attention whose KV heads do not split over tensor: q and o split, k and v whole
_KV_WHOLE = ("k_proj.weight", "v_proj.weight")


def _check_donate(donate):
    if not donate:
        raise ValueError(
            "donate=False is not supported: the port's step updates the parameters and "
            "the optimizer state in place")


def _gather_dim(t, d, group, n):
    """``t`` all-gathered over the ``n`` ranks of ``group`` along dim ``d``."""
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out if d == 0 else torch.cat(out.view(n, *t.shape).unbind(0), dim=d)


def takes_span(loss_fn) -> bool:
    """Whether ``loss_fn(model, tokens, ...)`` takes the keywords ``start``
    and ``S`` (the loss of positions ``start .. start+S-1`` of the rows),
    which the span route needs."""
    try:
        params = inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return False
    kinds = (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
    return all(n in params and params[n].kind in kinds for n in ("start", "S"))


class _Sharded:
    """The rule's shards of a model's parameters over a mesh, and the
    collectives of a step: gather for compute, reduce the gradients back to
    shards, average the metrics, cut the batch.

    ``spans``: whether the step's loss takes a span of each row; under
    ``seq > 1`` a ring model over the step's mesh then takes the span route
    (module docstring), anything else the whole-row route."""

    def __init__(self, mesh, model, rule, spans=False):
        sizes = meshlib.axis_sizes(mesh)
        self.mesh, self.sizes = mesh, sizes
        modules = dict(model.named_modules())
        cfg = getattr(model, "cfg", None)
        ring = getattr(cfg, "attention_impl", None) == "ring"
        if sizes["seq"] > 1 and ring and cfg.mesh is not mesh:
            raise ValueError(
                f"seq={sizes['seq']}: a model on attention_impl='ring' runs its ring over "
                "cfg.mesh's seq axis, which must be the step's mesh")
        self.spans = sizes["seq"] > 1 and spans and ring
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.params = dict(model.named_parameters())
        self.specs = {n: s for n, s in meshlib.param_shardings(mesh, model, rule).items()
                      if n in self.names}
        # the axis that splits each dim: an entry's axes of size 1 split
        # nothing (a rule's tensor or expert entry on a mesh without those
        # axes), and what is left names fsdp (kept at size 1, where the step
        # gathers and reduce-scatters over one rank), tensor or expert
        self.split = {}
        for n, spec in self.specs.items():
            split = {}
            for i, entry in enumerate(spec):
                axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                             if a == "fsdp" or (a is not None and sizes[a] > 1))
                if len(axes) > 1 or (axes and axes[0] not in ("fsdp", "tensor", "expert")):
                    raise ValueError(f"{n}: spec {spec} splits dim {i} over {axes} on this mesh; "
                                     "the steps split a dim over one of fsdp, tensor and expert")
                if axes:
                    split[i] = axes[0]
            if len(set(split.values())) < len(split):
                raise ValueError(f"{n}: spec {spec} splits two dims over one axis")
            self.split[n] = split
        self.fsdp_dim = {n: next((d for d, a in split.items() if a == "fsdp"), None)
                         for n, split in self.split.items()}
        self.tensor_partial = set()       # whole parameters whose gradients are partial over tensor
        self.tensor_layers = self._tensor_layers(modules)
        self.expert_layers = self._check_experts(modules, mesh)
        a2a = any(isinstance(m, MoEMLP) and m.cfg.dispatch == "a2a" for m in modules.values())
        self.row_axes = _ROW_AXES + (("expert",) if a2a else ())
        # the axes whose ranks hold different tokens, in the mesh's order
        self.token_axes = tuple(a for a in meshlib.AXES if a in self.row_axes or a == "seq")
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.coord = coord
        self.n_batch = 1
        self.batch_index = 0
        for a in self.row_axes:
            self.n_batch *= sizes[a]
            self.batch_index = self.batch_index * sizes[a] + coord[a]
        self.n_seq, self.seq_index = sizes["seq"], coord["seq"]
        # the ranks whose losses average to the global batch's: the row
        # shards, times the seq ranks where each holds whole rows (their
        # losses are the same; a span route's spans add up instead)
        self.n_mean = self.n_batch * (1 if self.spans else self.n_seq)
        self.fsdp_rank, self.n_fsdp = coord["fsdp"], sizes["fsdp"]
        self.fsdp = mesh.get_group("fsdp")
        # every group a step reduces over, made on every rank in one order
        self.groups = {}
        for axes in sorted({self._reduce_axes(n) for n in self.names}
                           | {self.row_axes, self.token_axes}):
            self.groups[axes] = meshlib.group_over(mesh, axes)
        self.batch = self.groups[self.row_axes]
        self.reducers = [m for m in modules.values() if isinstance(m, _BATCH_REDUCERS)]
        self.row_readers = ([m for m in modules.values() if isinstance(m, _ROW_READERS)]
                            if self.n_seq > 1 and not self.spans else [])

    def _tensor_layers(self, modules):
        """[(module, tensor group)] of the layers the rule splits over tensor.
        An ``Attention`` whose q and o are split and whose k and v are whole
        (its KV heads not a multiple of tensor) computes its k/v heads
        itself, and its k/v weights join ``tensor_partial``; any other half
        split is refused with the shapes."""
        out = []
        for name, m in modules.items():
            held = _TENSOR_LAYERS.get(type(m))
            if held is None:
                continue
            split = {p: "tensor" in self.split[f"{name}.{p}"].values() for p in held}
            if all(split.values()):
                out.append(m)
            elif isinstance(m, Attention) and [p for p in held if not split[p]] == list(_KV_WHOLE):
                out.append(m)
                self.tensor_partial |= {f"{name}.{p}" for p in _KV_WHOLE}
            elif any(split.values()):
                shapes = {f"{name}.{p}": (tuple(self.params[f"{name}.{p}"].shape),
                                          self.specs[f"{name}.{p}"]) for p in held}
                raise ValueError(
                    f"{name}: the rule splits {[f'{name}.{p}' for p in held if split[p]]} over "
                    f"tensor={self.sizes['tensor']} and leaves "
                    f"{[f'{name}.{p}' for p in held if not split[p]]} whole (shape, spec: "
                    f"{shapes}); this half split is not computed")
        return [(m, self.mesh.get_group("tensor")) for m in out]

    def _check_experts(self, modules, mesh):
        """Only MoE expert tables split over expert, both of a layer's: the
        ``a2a`` dispatch (with cfg.mesh the step's mesh) always holds its
        experts so, the ``einsum`` dispatch may (the layers returned, which
        get the expert group), ``gather`` never, as in the reference."""
        for n, split in self.split.items():
            if "expert" in split.values() and n.rsplit(".", 1)[-1] not in ("experts_wi",
                                                                            "experts_wo"):
                raise ValueError(f"{n}: spec {self.specs[n]} splits it over expert; the steps "
                                 "split only MoE expert tables over expert")
        out = []
        for name, m in modules.items():
            if not isinstance(m, MoEMLP):
                continue
            tables = [f"{name}.experts_wi", f"{name}.experts_wo"]
            split = ["expert" in self.split[t].values() for t in tables]
            a2a = m.cfg.dispatch == "a2a"
            if any(split) and (not all(split) or m.cfg.dispatch == "gather"
                               or (a2a and m.cfg.mesh is not mesh)):
                raise ValueError(
                    f"{name}: the rule splits {[t for t, x in zip(tables, split) if x]} over "
                    f"expert={self.sizes['expert']} (specs {[self.specs[t] for t in tables]}); "
                    "expert-split tables run dispatch='einsum', or 'a2a' with cfg.mesh the "
                    "step's mesh, both tables split")
            if a2a and not all(split):
                raise ValueError(
                    f"{name}: dispatch='a2a' holds E/ep experts a rank, but the rule leaves "
                    f"the tables whole over expert (specs {[self.specs[t] for t in tables]}); "
                    "use parallel/mesh.moe_param_spec with num_experts a multiple of expert")
            if all(split) and not a2a:
                out.append(m)
        return out

    def _reduce_axes(self, name) -> tuple:
        """The axes a gradient is summed over after its reduce-scatter over
        fsdp (fsdp itself where the parameter has no fsdp dim): the rows'
        axes and seq, less expert for an expert-split table; tensor only
        for the whole k/v of a half-split layer; never stage."""
        axes = set(self.token_axes) - set(self.split[name].values())
        if name in self.tensor_partial:
            axes.add("tensor")
        return tuple(a for a in meshlib.AXES if a in axes)

    def shard(self, name, full):
        """This rank's part of the whole tensor ``full``, an allocation of its
        own (a view would keep the whole tensor alive); ``full`` itself
        where the rule replicates it."""
        t = full
        for d, axis in self.split[name].items():
            t = t.chunk(self.sizes[axis], dim=d)[self.coord[axis]]
        return full if t is full else t.clone(memory_format=torch.contiguous_format)

    def full(self, name, shard):
        """The compute tensor of a stored ``shard``: gathered over fsdp (its
        tensor or expert split stays the rank's own part)."""
        d = self.fsdp_dim[name]
        return shard if d is None else _gather_dim(shard, d, self.fsdp, self.n_fsdp)

    def gather(self, shards: dict) -> dict:
        """Whole tensors from {name: shard} (a copy of a replicated one)."""
        out = {}
        for n, t in shards.items():
            t = self.full(n, t) if self.fsdp_dim[n] is not None else t.detach().clone()
            for d, axis in self.split[n].items():
                if axis != "fsdp":
                    t = _gather_dim(t, d, self.mesh.get_group(axis), self.sizes[axis])
            out[n] = t
        return out

    def load(self, shards: dict) -> None:
        """The model's split parameters as this rank computes with them
        (fsdp shards gathered), and the groups handed to the modules that
        use them (train-mode ``PallasBatchNorm`` statistics, the MoE
        load-balance loss and, on the span route, its slots; the
        tensor-parallel layers); on the whole-row route the models and
        their attention layers are told they get whole rows."""
        for n, t in shards.items():
            if self.split[n]:
                self.params[n].data = self.full(n, t)
        for m in self.reducers:
            if isinstance(m, MoEMLP) and self.spans:
                m.group, m.seq_group = self.groups[self.token_axes], self.mesh.get_group("seq")
            else:
                m.group = self.batch
        for m, group in self.tensor_layers:
            m.tensor_group = group
        for m in self.expert_layers:
            m.expert_group = self.mesh.get_group("expert")
        for m in self.row_readers:
            m.whole_rows = True

    def release(self) -> None:
        """Drop the model's copies of the split parameters and its modules'
        groups."""
        for n in self.names:
            if self.split[n]:
                self.params[n].data = self.params[n].data.new_empty(0)
        for m in self.reducers:
            m.group = None
            if isinstance(m, MoEMLP):
                m.seq_group = None
        for m, _ in self.tensor_layers:
            m.tensor_group = None
        for m in self.expert_layers:
            m.expert_group = None
        for m in self.row_readers:
            m.whole_rows = False

    def share(self, loss):
        """This rank's share of the global loss, the one it differentiates."""
        return loss / self.n_mean

    def reduce(self, name, g):
        """The gradient of the global loss, summed from the ranks' shares, as
        this rank's shard."""
        d = self.fsdp_dim[name]
        g = g.contiguous()
        if d is not None:
            out = g.new_empty(g.chunk(self.n_fsdp, dim=d)[0].shape)
            dist.reduce_scatter_tensor(out, torch.cat(g.chunk(self.n_fsdp, dim=d)) if d else g,
                                        group=self.fsdp)
            g = out
        dist.all_reduce(g, group=self.groups[self._reduce_axes(name)])
        return g

    def mean(self, x):
        """A rank's metric as the global batch's (every rank gets it): the
        span route's spans summed, the row shards and whole-row copies
        averaged."""
        x = x.detach().float().clone()
        dist.all_reduce(x, group=self.groups[self.token_axes])
        return x.div_(self.n_mean)

    def local(self, x):
        """This rank's rows of the global batch ``x``: equal shards over
        the row axes, in row-major order of the mesh."""
        B = x.shape[0]
        if B % self.n_batch:
            raise ValueError(f"batch {B} must be divisible by the {self.n_batch} batch ranks "
                             f"({' x '.join(self.row_axes)})")
        n = B // self.n_batch
        return x[self.batch_index * n:(self.batch_index + 1) * n]

    def span(self, S: int) -> dict:
        """This rank's span of rows of ``S`` tokens, as the loss's keywords
        ``start`` and ``S``."""
        if S % self.n_seq:
            raise ValueError(f"seq len {S} must be divisible by the {self.n_seq} seq ranks")
        return dict(start=self.seq_index * (S // self.n_seq), S=S // self.n_seq)

    def state(self, tx, model):
        """The initial sharded state from the model's whole parameters; the
        model keeps only its replicated ones."""
        shards = {}
        for n in self.names:
            p = self.params[n]
            if p.numel() == 0:
                raise ValueError(f"{n} is already held as shards: init() runs once a bundle")
            shards[n] = self.shard(n, p.detach())
        self.release()
        return TrainState(params=shards, opt_state=tx.init(list(shards.values())), step=0)


def optimizer_state_shardings(opt_state, params, param_specs, repl=()):
    """Optimizer slots shaped like the parameters (a list of one tensor a
    parameter: momentum, mu, nu, ...) follow the parameters' specs;
    everything else (counts, scalars) is replicated (``repl``)."""
    shapes = [tuple(p.shape) for p in params]

    def walk(x):
        if (isinstance(x, list) and len(x) == len(shapes)
                and all(isinstance(t, torch.Tensor) and tuple(t.shape) == s
                        for t, s in zip(x, shapes))):
            return list(param_specs)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return repl

    return walk(opt_state)


def _bundle(model, tx, mesh, param_rule, step_fn, spans=False) -> TrainStepBundle:
    """The bundle of ``step_fn(state, batch, params, sharded)``: one device
    for ``mesh=None``, else the rule's shards of the parameters (``spans``:
    whether the step's loss takes a span of each row, ``_Sharded``)."""
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    params = list(named.values())
    if mesh is None:
        return TrainStepBundle(
            init=lambda: TrainState(params=dict(named), opt_state=tx.init(params), step=0),
            step=lambda state, batch: step_fn(state, batch, params, None))
    sharded = _Sharded(mesh, model, param_rule, spans)
    bundle = TrainStepBundle(init=None, step=None, gather=sharded.gather)

    def init():
        state = sharded.state(tx, model)
        shards = list(state["params"].values())
        specs = [sharded.specs[n] for n in sharded.names]
        bundle.state_shardings = {
            "params": dict(sharded.specs),
            "opt_state": optimizer_state_shardings(state["opt_state"], shards, specs),
            "step": (),
        }
        state.mesh, state.shardings = mesh, bundle.state_shardings
        return state

    def step(state, batch):
        sharded.load(state["params"])
        try:
            return step_fn(state, batch, list(state["params"].values()), sharded)
        finally:
            sharded.release()

    bundle.init, bundle.step = init, step
    return bundle


def _update(tx, state, grads, params, sharded):
    """The optimizer on this rank's parameters (or shards), in place."""
    if sharded is not None:
        grads = [sharded.reduce(n, g) for n, g in zip(sharded.names, grads)]
    apply_updates(params, tx.update(grads, state["opt_state"], params))
    state["step"] += 1


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy of fp32 ``logits`` [B, classes] against
    integer ``labels`` [B]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def make_classifier_train_step(
    model,
    tx: GradientTransformation,
    mesh=None,
    *,
    param_rule=meshlib.fsdp_param_spec,
    loss_fn: Callable = cross_entropy_loss,
    donate: bool = True,
) -> TrainStepBundle:
    """Build a train step for a classifier with BatchNorm state (``ResNet``).

    ``mesh`` None is one device; a mesh shards the batch and the parameters
    by ``param_rule`` (module docstring; under ``seq > 1`` every seq rank
    holds whole images). ``donate`` must be True.

    The returned ``step`` consumes batches of ``{"image": [B, H, W, C],
    "label": [B]}`` and returns ``(state, {"loss", "accuracy"})``. The
    model's parameters, the optimizer state and the BatchNorm running
    statistics (the model's buffers, updated by its train-mode forward from
    the global batch's statistics) all change in place.
    """
    _check_donate(donate)
    module_params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state, batch, params, sharded):
        image, label = batch["image"], batch["label"]
        if sharded is not None:
            image, label = sharded.local(image), sharded.local(label)
        with torch.enable_grad():
            logits = model(image, train=True)
            loss = loss_fn(logits, label)
            grads = torch.autograd.grad(loss if sharded is None else sharded.share(loss),
                                        module_params)
        _update(tx, state, grads, params, sharded)
        accuracy = (logits.argmax(dim=-1) == label).float().mean()
        if sharded is not None:
            loss, accuracy = sharded.mean(loss), sharded.mean(accuracy)
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return _bundle(model, tx, mesh, param_rule, train_step)


def make_lm_train_step(
    model,
    tx: GradientTransformation,
    mesh=None,
    *,
    param_rule=meshlib.fsdp_param_spec,
    loss_fn: Callable | None = None,
    accum_steps: int = 1,
    chunk: int = 512,
    loss_dtype=None,
    donate: bool = True,
) -> TrainStepBundle:
    """Build an LM train step (tokens [B, S] -> next-token loss).

    ``mesh`` None is one device; a mesh shards the batch and the parameters
    by ``param_rule`` (module docstring). ``donate`` must be True.

    ``loss_fn(model, tokens) -> scalar`` defaults to the chunked tied-head
    loss for ``TransformerLM``-shaped models: ``lm_loss_chunked(hidden,
    model.embed.weight, tokens, chunk=chunk, compute_dtype=loss_dtype)``;
    ``loss_dtype`` None is bf16 operands with fp32 accumulation, fp32 gives
    parity with the unchunked loss. Under ``seq > 1`` a loss that takes the
    keywords ``start`` and ``S`` (the default one, ``moe_lm_loss_chunked``,
    ``moe_lm_loss_fused``) on a ring model runs on the rank's span of each
    row (the span route); any other loss gets whole rows on every seq rank
    (the whole-row route, module docstring).

    ``accum_steps > 1`` runs gradient accumulation: the batch (each rank's
    rows under a mesh) is split into A microbatches along dim 0, the MEAN
    gradient accumulates in fp32 as g / A (each microbatch carries equal
    token count, so the mean of per-microbatch means equals the full-batch
    gradient), and ONE optimizer update applies.
    """
    _check_donate(donate)
    module_params = [p for p in model.parameters() if p.requires_grad]

    if loss_fn is None:
        def loss_fn(model, tokens, start=0, S=None):
            """The loss of positions ``start .. start+S-1`` of the rows."""
            S = tokens.shape[1] if S is None else S
            hidden = model(tokens[:, start:start + S], return_hidden=True)
            return lm_loss_chunked(
                hidden, model.embed.weight, tokens, chunk=chunk,
                compute_dtype=loss_dtype, start=start,
            )

    def train_step(state, tokens, params, sharded):
        if accum_steps > 1 and tokens.shape[0] % accum_steps:
            raise ValueError(f"accum_steps {accum_steps} must divide batch {tokens.shape[0]}")
        span = {}
        if sharded is not None:
            tokens = sharded.local(tokens)
            if sharded.spans:
                span = sharded.span(tokens.shape[1])

        def grads_of(tokens):
            loss = loss_fn(model, tokens, **span)
            return loss.detach(), torch.autograd.grad(
                loss if sharded is None else sharded.share(loss), module_params)

        with torch.enable_grad():
            if accum_steps == 1:
                loss, grads = grads_of(tokens)
            else:
                B = tokens.shape[0]
                if B % accum_steps:
                    raise ValueError(f"accum_steps {accum_steps} must divide the local batch "
                                     f"{B} of each of the {sharded.n_batch} batch ranks")
                micro = tokens.reshape(accum_steps, B // accum_steps, *tokens.shape[1:])
                loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in module_params]
                for mb in micro:
                    mb_loss, mb_grads = grads_of(mb)
                    loss = loss + mb_loss / accum_steps
                    for acc, g in zip(grads, mb_grads):
                        acc.add_(g.float() / accum_steps)
                grads = [g.to(p.dtype) for g, p in zip(grads, module_params)]
        _update(tx, state, grads, params, sharded)
        if sharded is not None:
            loss = sharded.mean(loss)
        return state, {"loss": loss}

    return _bundle(model, tx, mesh, param_rule, train_step, spans=takes_span(loss_fn))
