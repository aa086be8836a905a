"""Train steps for LM and classifier models; counterpart of ``kubeflow_tpu/parallel/train.py``.

The step factories take the reference's arguments in the reference's order
(``model, tx, mesh, *, param_rule, ..., donate``). The model's parameters and
the optimizer state are updated in place, the counterpart of the JAX step's
donated state, so ``donate`` must stay True.

``mesh=None`` is one device: the state is ``{"opt_state", "step"}`` over the
model's own parameters and ``TrainStepBundle.state_shardings`` is None.

Under a mesh (``parallel/mesh.py``'s ``create_mesh``; its dcn, data and fsdp
axes) every rank calls ``step`` with the same global batch, as the JAX step
is called with the global array, and takes its shard of the rows over (dcn,
data, fsdp), equal shards, so that the mean of the ranks' mean losses is the
global mean. Parameters and optimizer slots are stored as the rule's
legalised shards (ZeRO-3): ``state["params"]`` maps each parameter's name to
this rank's shard, a parameter the rule replicates stays whole, and between
steps the model holds only its replicated parameters (a sharded one is an
empty tensor). Each step all-gathers the shards into the model for compute
and reduce-scatters the gradients over fsdp (then sums them over the dcn and
data replicas), divides by the batch ranks, and runs the optimizer, which is
elementwise, on the shards. The loss (and accuracy) come back as the global
batch's on every rank, as the JAX step returns them replicated. The batch
statistics of train-mode BatchNorm and the MoE load-balance loss are the
global batch's: while a step runs, the model's ``PallasBatchNorm`` and
``MoEMLP`` modules hold the batch group and all-reduce their sums; the
step clears it again, so the model is left as it was given.
``bundle.gather`` returns whole tensors from a {name: shard} dict, e.g. the
parameters for serving after training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.models.moe import MoEMLP
from kubeflow_tpu_torch.models.resnet import BatchNorm, PallasBatchNorm
from kubeflow_tpu_torch.models.transformer import lm_loss_chunked
from kubeflow_tpu_torch.ops.optimizers import GradientTransformation, apply_updates
from kubeflow_tpu_torch.parallel import mesh as meshlib


@dataclasses.dataclass
class TrainStepBundle:
    """Everything a notebook (or bench harness) needs to run training."""

    init: Callable  # () -> state {"opt_state", "step"} (+ "params": this rank's shards under a mesh)
    step: Callable  # (state, batch) -> (state, metrics); updates in place
    state_shardings: object = None  # the state's specs over a mesh; None on one device
    gather: Callable | None = None  # ({name: shard}) -> {name: whole tensor}; None on one device


# the mesh axes the steps do not split yet, and the slice that brings each
_LATER_AXES = {"stage": "slice 5d (pipeline)", "seq": "slice 5b (ring attention)",
               "expert": "slice 5c (expert and tensor axes)",
               "tensor": "slice 5c (expert and tensor axes)"}
# the modules that reduce over the batch under a mesh (their ``group``)
_BATCH_REDUCERS = (PallasBatchNorm, MoEMLP)


def _check_donate(donate):
    if not donate:
        raise ValueError(
            "donate=False is not supported: the port's step updates the parameters and "
            "the optimizer state in place")


class _Sharded:
    """The rule's shards of a model's parameters over a mesh's batch axes,
    and the collectives of a step: gather for compute, reduce the gradients
    back to shards, average the metrics, cut the batch."""

    def __init__(self, mesh, model, rule):
        sizes = meshlib.axis_sizes(mesh)
        for axis, later in _LATER_AXES.items():
            if sizes[axis] > 1:
                raise NotImplementedError(
                    f"the port's train steps split the dcn, data and fsdp axes; {axis}="
                    f"{sizes[axis]} comes with {later} (ROADMAP.md Queue 1)")
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.params = dict(model.named_parameters())
        self.specs = {n: s for n, s in meshlib.param_shardings(mesh, model, rule).items()
                      if n in self.names}
        self.n_fsdp = sizes["fsdp"]
        self.n_batch = sizes["dcn"] * sizes["data"] * sizes["fsdp"]
        # the dim a spec splits: an entry's other axes of size 1 split
        # nothing (a rule's tensor or expert entry on a mesh without those
        # axes), and what is left names fsdp alone (the only batch axis that
        # shards parameters; kept at size 1, where the step gathers and
        # reduce-scatters over one rank) or nothing
        self.dim = {}
        for n, spec in self.specs.items():
            split = {}
            for i, entry in enumerate(spec):
                axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                             if a == "fsdp" or (a is not None and sizes[a] > 1))
                if axes:
                    split[i] = axes
            if any(axes != ("fsdp",) for axes in split.values()) or len(split) > 1:
                raise ValueError(f"{n}: spec {spec} splits over {tuple(split.values())} on this "
                                 "mesh; the steps shard parameters over fsdp alone")
            self.dim[n] = next(iter(split), None)
        coord = mesh.get_coordinate()
        c = dict(zip(mesh.mesh_dim_names, coord))
        self.batch_index = (c["dcn"] * sizes["data"] + c["data"]) * sizes["fsdp"] + c["fsdp"]
        self.fsdp_rank = c["fsdp"]
        self.fsdp = mesh.get_group("fsdp")
        ranks = mesh.mesh.reshape(-1, sizes["fsdp"])        # rows: (dcn, data); columns: fsdp
        self.batch = dist.new_group(ranks.flatten().tolist())
        # the replicas of one fsdp shard: one group a column, made on every rank
        replicas = [dist.new_group(ranks[:, f].tolist()) for f in range(sizes["fsdp"])]
        self.replica = replicas[self.fsdp_rank]
        self.reducers = [m for m in model.modules() if isinstance(m, _BATCH_REDUCERS)]
        if self.n_batch > 1 and any(isinstance(m, BatchNorm) for m in model.modules()):
            raise NotImplementedError(
                "bn_impl='xla' normalises with its rank's statistics, where the reference "
                "normalises with the global batch's; use bn_impl='pallas' or 'mxu' under a "
                "mesh of more than one batch rank")

    def shard(self, name, full):
        d = self.dim[name]
        if d is None:
            return full
        # an allocation of its own: a view would keep the whole tensor alive
        return full.chunk(self.n_fsdp, dim=d)[self.fsdp_rank].clone(
            memory_format=torch.contiguous_format)

    def full(self, name, shard):
        """The whole tensor of a sharded parameter's ``shard``, gathered."""
        d = self.dim[name]
        out = shard.new_empty((self.n_fsdp * shard.shape[0], *shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.fsdp)
        return out if d == 0 else torch.cat(out.view(self.n_fsdp, *shard.shape).unbind(0), dim=d)

    def gather(self, shards: dict) -> dict:
        """Whole tensors from {name: shard} (a copy of a replicated one)."""
        return {n: self.full(n, t) if self.dim[n] is not None else t.detach().clone()
                for n, t in shards.items()}

    def load(self, shards: dict) -> None:
        """The model's sharded parameters gathered whole for compute, and the
        batch group handed to the modules that reduce over the batch
        (train-mode ``PallasBatchNorm`` statistics, the MoE load-balance
        loss)."""
        for n, t in shards.items():
            if self.dim[n] is not None:
                self.params[n].data = self.full(n, t)
        for m in self.reducers:
            m.group = self.batch

    def release(self) -> None:
        """Drop the model's whole copies of the sharded parameters and its
        modules' batch group."""
        for n in self.names:
            if self.dim[n] is not None:
                self.params[n].data = self.params[n].data.new_empty(0)
        for m in self.reducers:
            m.group = None

    def reduce(self, name, g):
        """The gradient's mean over the batch ranks, as this rank's shard."""
        d = self.dim[name]
        g = g.contiguous()
        if d is None:
            dist.all_reduce(g, group=self.batch)
            return g.div_(self.n_batch)
        out = g.new_empty(g.chunk(self.n_fsdp, dim=d)[0].shape)
        dist.reduce_scatter_tensor(out, torch.cat(g.chunk(self.n_fsdp, dim=d)) if d else g,
                                    group=self.fsdp)
        dist.all_reduce(out, group=self.replica)
        return out.div_(self.n_batch)

    def mean(self, x):
        """A metric's mean over the batch ranks (every rank gets it)."""
        x = x.detach().float().clone()
        dist.all_reduce(x, group=self.batch)
        return x.div_(self.n_batch)

    def local(self, x):
        """This rank's rows of the global batch ``x``: equal shards over
        (dcn, data, fsdp), in row-major order of the mesh."""
        B = x.shape[0]
        if B % self.n_batch:
            raise ValueError(f"batch {B} must be divisible by the {self.n_batch} batch ranks "
                             "(dcn x data x fsdp)")
        n = B // self.n_batch
        return x[self.batch_index * n:(self.batch_index + 1) * n]

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
        return {"params": shards, "opt_state": tx.init(list(shards.values())), "step": 0}


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


def _bundle(model, tx, mesh, param_rule, step_fn) -> TrainStepBundle:
    """The bundle of ``step_fn(state, batch, params, sharded)``: one device
    for ``mesh=None``, else the rule's shards of the parameters."""
    params = [p for p in model.parameters() if p.requires_grad]
    if mesh is None:
        return TrainStepBundle(init=lambda: {"opt_state": tx.init(params), "step": 0},
                               step=lambda state, batch: step_fn(state, batch, params, None))
    sharded = _Sharded(mesh, model, param_rule)
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
    by ``param_rule`` (module docstring). ``donate`` must be True.

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
            grads = torch.autograd.grad(loss, module_params)
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
    parity with the unchunked loss.

    ``accum_steps > 1`` runs gradient accumulation: the batch (each rank's
    rows under a mesh) is split into A microbatches along dim 0, the MEAN
    gradient accumulates in fp32 as g / A (each microbatch carries equal
    token count, so the mean of per-microbatch means equals the full-batch
    gradient), and ONE optimizer update applies.
    """
    _check_donate(donate)
    module_params = [p for p in model.parameters() if p.requires_grad]

    if loss_fn is None:
        def loss_fn(model, tokens):
            hidden = model(tokens, return_hidden=True)
            return lm_loss_chunked(
                hidden, model.embed.weight, tokens, chunk=chunk,
                compute_dtype=loss_dtype,
            )

    def grads_of(tokens):
        loss = loss_fn(model, tokens)
        return loss.detach(), torch.autograd.grad(loss, module_params)

    def train_step(state, tokens, params, sharded):
        if accum_steps > 1 and tokens.shape[0] % accum_steps:
            raise ValueError(f"accum_steps {accum_steps} must divide batch {tokens.shape[0]}")
        if sharded is not None:
            tokens = sharded.local(tokens)
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

    return _bundle(model, tx, mesh, param_rule, train_step)
