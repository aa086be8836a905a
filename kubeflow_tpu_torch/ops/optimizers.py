"""Low-HBM-traffic optimizers; counterpart of ``kubeflow_tpu/ops/optimizers.py``.

The JAX package builds them from optax gradient transformations. The port
keeps that shape, on lists of tensors: a :class:`GradientTransformation` is
an ``init(params) -> state`` and an ``update(grads, state, params) ->
updates`` that advances ``state`` in place, and :func:`apply_updates` adds
the updates to the parameters in place (the counterpart of ``donate``).
The same numbers as optax come out: ``torch.optim.AdamW`` is not the same
formula once the moments are stored in bf16, so it is not used.

Numerics note (why naive bf16 nu is dangerous): with decay ``b2`` the
per-step increment to nu is ``(1-b2)*g^2``. bf16 carries 8 mantissa bits, so
increments below ``nu * 2^-9`` round to nothing and nu silently stops
tracking the gradient scale. At the default ``b2=0.999`` the steady-state
increment is ~``nu/1000`` — BELOW the rounding floor. Storing nu in bf16 is
therefore only sound with ``b2 <= ~0.99`` (increment ~nu/100, comfortably
representable). ``scale_by_adam_lowmem`` enforces this pairing.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    """optax's pair on lists of tensors: ``update`` advances the state in
    place and returns the updates."""

    init: Callable[[list], Any]
    update: Callable[..., list]


def _f32_pow(base: float, count: int) -> float:
    """``base ** count`` computed in fp32, as optax's bias corrections are."""
    return torch.tensor(base, dtype=torch.float32).pow(count).item()


def scale_by_adam_lowmem(b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                         mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16):
    """``optax.scale_by_adam`` with BOTH moments storable in low precision.

    Moment math runs in fp32 (the stored moments are upcast, updated, and
    cast back), so precision is lost only at the storage boundary — see the
    module docstring for the b2/nu_dtype pairing rule. ``None`` stores a
    moment in its parameter's dtype.
    """
    if nu_dtype == torch.bfloat16 and b2 > 0.99:
        raise ValueError(
            f"bf16 nu with b2={b2}: increments (1-b2)*g^2 fall below bf16's "
            "rounding floor at steady state and are silently dropped; use "
            "b2 <= 0.99 or nu_dtype=None (f32)"
        )

    def init(params):
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params],
            "nu": [torch.zeros_like(p, dtype=nu_dtype or p.dtype) for p in params],
        }

    def update(grads, state, params=None):
        del params
        state["count"] += 1
        c1 = 1.0 - _f32_pow(b1, state["count"])
        c2 = 1.0 - _f32_pow(b2, state["count"])
        updates = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            g32 = g.float()
            mu32 = mu.float() * b1 + g32 * (1 - b1)
            nu32 = nu.float() * b2 + g32.square() * (1 - b2)
            updates.append((mu32 / c1) / ((nu32 / c2).sqrt() + eps))
            mu.copy_(mu32)
            nu.copy_(nu32)
        return updates

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float):
    """``optax.add_decayed_weights``: updates + weight_decay * params, on
    every parameter."""

    def update(grads, state, params):
        return [u + weight_decay * p for u, p in zip(grads, params)]

    return GradientTransformation(lambda params: None, update)


def scale(step_size: float):
    """``optax.scale``."""

    def update(grads, state, params=None):
        return [u * step_size for u in grads]

    return GradientTransformation(lambda params: None, update)


def chain(*txs: GradientTransformation):
    """``optax.chain``: each transformation's updates feed the next."""

    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params=None):
        for tx, s in zip(txs, state):
            grads = tx.update(grads, s, params)
        return grads

    return GradientTransformation(init, update)


@functools.cache
def _rounded(value: float, dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def trace(decay: float, nesterov: bool = False, accumulator_dtype=None):
    """``optax.trace``: ``t <- g + decay * t``; the update is ``t``, or with
    ``nesterov`` ``g + decay * t``. The trace is stored in
    ``accumulator_dtype`` (None: the parameter's dtype); ``decay * t`` is
    computed in the stored trace's dtype with ``decay`` itself rounded to
    it, as optax's weakly typed scalar is (0.9 is 0.8984375 against a bf16
    trace), and the update comes from the trace before it is rounded for
    storage."""

    def init(params):
        return {"trace": [torch.zeros_like(p, dtype=accumulator_dtype or p.dtype) for p in params]}

    def update(grads, state, params=None):
        del params
        updates = []
        for g, t in zip(grads, state["trace"]):
            new_t = g + _rounded(decay, t.dtype) * t
            updates.append(g + decay * new_t if nesterov else new_t)
            t.copy_(new_t)
        return updates

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float | None = None, nesterov: bool = False,
        accumulator_dtype=None):
    """``optax.sgd``: updates = -learning_rate * grads, through
    :func:`trace` when ``momentum`` is given."""
    txs = [] if momentum is None else [trace(momentum, nesterov, accumulator_dtype)]
    return chain(*txs, scale(-learning_rate))


def adamw_lowmem(learning_rate: float, *, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16):
    """AdamW with low-precision moment storage (see scale_by_adam_lowmem):
    the Adam update, then the decayed weights of every parameter (norm
    scales and the embedding included), then ``scale(-learning_rate)``."""
    txs = [scale_by_adam_lowmem(b1, b2, eps, mu_dtype, nu_dtype)]
    if weight_decay:
        txs.append(add_decayed_weights(weight_decay))
    txs.append(scale(-learning_rate))
    return chain(*txs)


def with_f32_master(inner: GradientTransformation):
    """bf16-params / f32-master layout as a gradient transformation.

    The MODEL params stay bf16; the f32 master lives in the optimizer state
    and is the only f32 copy touched per step. The emitted update is
    ``new_master.to(param.dtype) - param``, so :func:`apply_updates` lands
    the rounded master in the bf16 params.
    """

    def init(params):
        master = [p.detach().float().clone() for p in params]
        return {"master": master, "inner": inner.init(master)}

    def update(grads, state, params):
        if params is None:
            raise ValueError("with_f32_master requires params")
        master = state["master"]
        inner_updates = inner.update([g.float() for g in grads], state["inner"], master)
        apply_updates(master, inner_updates)
        return [m.to(p.dtype) - p for m, p in zip(master, params)]

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``optax.apply_updates`` in place: p <- (p + u) in p's dtype."""
    for p, u in zip(params, updates):
        p.copy_(p + u)
