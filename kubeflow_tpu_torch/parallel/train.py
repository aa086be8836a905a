"""Train steps for LM and classifier models; counterpart of ``kubeflow_tpu/parallel/train.py``.

The step factories take the reference's arguments in the reference's order
(``model, tx, mesh, *, param_rule, ..., donate``). One device for now:
``mesh=None`` is the only mesh, the parameter rule has nothing to place, and
``TrainStepBundle.state_shardings`` is None. The model's parameters and the
optimizer state are updated in place, the counterpart of the JAX step's
donated state, so ``donate`` must stay True. Meshes and the sharding rules
come with the port's multi-GPU slice (slice 5a).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.transformer import lm_loss_chunked
from kubeflow_tpu_torch.ops.optimizers import GradientTransformation, apply_updates


@dataclasses.dataclass
class TrainStepBundle:
    """Everything a notebook (or bench harness) needs to run training."""

    init: Callable  # () -> state {"opt_state", "step"} over the model's parameters
    step: Callable  # (state, batch) -> (state, metrics); updates in place
    state_shardings: object = None  # the state's placement over a mesh; None on one device


def _one_device(mesh, donate):
    """The port's steps run on one device and update in place."""
    if mesh is not None:
        raise NotImplementedError(
            "the port's train steps run on one device (mesh=None); meshes and sharding "
            "rules come with slice 5a (ROADMAP.md Queue 1)")
    if not donate:
        raise ValueError(
            "donate=False is not supported: the port's step updates the parameters and "
            "the optimizer state in place")


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
    param_rule=None,
    loss_fn: Callable = cross_entropy_loss,
    donate: bool = True,
) -> TrainStepBundle:
    """Build a train step for a classifier with BatchNorm state (``ResNet``).

    ``mesh`` must be None (one device) and ``donate`` True; ``param_rule``
    places parameters over a mesh and has nothing to do on one device.

    The returned ``step`` consumes batches of ``{"image": [B, H, W, C],
    "label": [B]}`` and returns ``(state, {"loss", "accuracy"})``. The
    model's parameters, the optimizer state and the BatchNorm running
    statistics (the model's buffers, updated by its train-mode forward) all
    change in place.
    """
    _one_device(mesh, donate)
    params = [p for p in model.parameters() if p.requires_grad]

    def init():
        return {"opt_state": tx.init(params), "step": 0}

    def train_step(state, batch):
        with torch.enable_grad():
            logits = model(batch["image"], train=True)
            loss = loss_fn(logits, batch["label"])
            grads = torch.autograd.grad(loss, params)
        apply_updates(params, tx.update(grads, state["opt_state"], params))
        state["step"] += 1
        accuracy = (logits.argmax(dim=-1) == batch["label"]).float().mean()
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return TrainStepBundle(init=init, step=train_step)


def make_lm_train_step(
    model,
    tx: GradientTransformation,
    mesh=None,
    *,
    param_rule=None,
    loss_fn: Callable | None = None,
    accum_steps: int = 1,
    chunk: int = 512,
    loss_dtype=None,
    donate: bool = True,
) -> TrainStepBundle:
    """Build an LM train step (tokens [B, S] -> next-token loss).

    ``mesh`` must be None (one device) and ``donate`` True; ``param_rule``
    places parameters over a mesh and has nothing to do on one device.

    ``loss_fn(model, tokens) -> scalar`` defaults to the chunked tied-head
    loss for ``TransformerLM``-shaped models: ``lm_loss_chunked(hidden,
    model.embed.weight, tokens, chunk=chunk, compute_dtype=loss_dtype)``;
    ``loss_dtype`` None is bf16 operands with fp32 accumulation, fp32 gives
    parity with the unchunked loss.

    ``accum_steps > 1`` runs gradient accumulation: the batch is split into
    A microbatches along dim 0, the MEAN gradient accumulates in fp32 as
    g / A (each microbatch carries equal token count, so the mean of
    per-microbatch means equals the full-batch gradient), and ONE optimizer
    update applies.
    """
    _one_device(mesh, donate)
    params = [p for p in model.parameters() if p.requires_grad]

    if loss_fn is None:
        def loss_fn(model, tokens):
            hidden = model(tokens, return_hidden=True)
            return lm_loss_chunked(
                hidden, model.embed.weight, tokens, chunk=chunk,
                compute_dtype=loss_dtype,
            )

    def grads_of(tokens):
        loss = loss_fn(model, tokens)
        return loss.detach(), torch.autograd.grad(loss, params)

    def init():
        return {"opt_state": tx.init(params), "step": 0}

    def train_step(state, tokens):
        with torch.enable_grad():
            if accum_steps == 1:
                loss, grads = grads_of(tokens)
            else:
                B = tokens.shape[0]
                if B % accum_steps:
                    raise ValueError(f"accum_steps {accum_steps} must divide batch {B}")
                micro = tokens.reshape(accum_steps, B // accum_steps, *tokens.shape[1:])
                loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in params]
                for mb in micro:
                    mb_loss, mb_grads = grads_of(mb)
                    loss = loss + mb_loss / accum_steps
                    for acc, g in zip(grads, mb_grads):
                        acc.add_(g.float() / accum_steps)
                grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        apply_updates(params, tx.update(grads, state["opt_state"], params))
        state["step"] += 1
        return state, {"loss": loss}

    return TrainStepBundle(init=init, step=train_step)
