"""Device meshes and sharding rules; counterpart of ``kubeflow_tpu/parallel/mesh.py``.

The same seven named axes, in the same order, and the same three parameter
rules as the JAX module:

    dcn      data parallelism across hosts (the gradient reduction crosses them)
    stage    pipeline parallelism (parallel/pipeline.py)
    data     pure data parallelism (batch split, gradients averaged)
    fsdp     data parallelism with ZeRO-3 parameter and optimizer sharding
    seq      sequence parallelism (ring attention, parallel/ring_attention.py)
    expert   expert parallelism (the MoE a2a or einsum dispatch, models/moe.py)
    tensor   tensor parallelism (Megatron column/row splits)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, row-major over the plan (``tensor`` innermost),
with one named dim for each axis. The train steps (``parallel/train.py``)
run over every axis, their stage ranks replicas; the pipeline
(``parallel/pipeline.py``) runs over stage, data and fsdp.

The rules see each parameter as the JAX module does: by its flax path and
its flax shape, and they return the JAX ``PartitionSpec``'s entries as a
tuple of axis names (``()`` where it is ``P()``). The port stores some
parameters in another layout than flax (``interop.py``: a q/k/v projection
``[E, H, D]`` is ``[H·D, E]`` here, a conv ``[kh, kw, ci, co]`` is ``[co,
ci, kh, kw]``), so :func:`param_shardings` evaluates each rule on the flax
path and shape and carries the split dim through the layout's permutation:
a port parameter is split along the same logical axis as its JAX twin (a
split of H in flax is a contiguous block of H·D rows here).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

import numpy as np
import torch

AXES = ("dcn", "stage", "data", "fsdp", "seq", "expert", "tensor")
BATCH_AXES = ("dcn", "data", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A named parallelism layout, e.g. MeshPlan(data=2, fsdp=2, tensor=2)."""

    dcn: int = 1
    stage: int = 1
    data: int = 1
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes().values())

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}


def create_mesh(plan: MeshPlan, devices: Sequence[int] | None = None, *,
                physical_topology: Sequence[int] | None = None,
                device_type: str | None = None):
    """The named ``DeviceMesh`` of ``plan`` over ``devices`` (ranks of the
    default process group; all of them by default), row-major over the
    plan's axes. ``physical_topology`` is accepted for the reference's
    signature and checked for size only: the TPU torus placement solver has
    no counterpart on NVLink, where every card of a host reaches every other
    directly. ``device_type`` defaults to the process group's
    (:func:`default_device_type`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if plan.size != len(ranks):
        raise ValueError(
            f"mesh plan needs {plan.size} devices ({plan.axis_sizes()}), have {len(ranks)}")
    if physical_topology is not None and math.prod(physical_topology) != plan.size:
        raise ValueError(f"physical topology {tuple(physical_topology)} holds "
                         f"{math.prod(physical_topology)} devices, the plan {plan.size}")
    if device_type is None:
        device_type = default_device_type()
    shape = tuple(plan.axis_sizes()[a] for a in AXES)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=AXES)


def default_device_type() -> str:
    """The device of the default process group's tensors: "cuda" where it
    has nccl (``"nccl"`` or ``"cpu:gloo,cuda:nccl"``), else "cpu" (gloo)."""
    import torch.distributed as dist

    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def group_over(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ from this one only along
    ``axes`` and share its coordinates on the others. Every rank makes every
    such group, in one order, as ``torch.distributed.new_group`` requires, so
    every rank must call this with the same ``axes``."""
    import torch.distributed as dist

    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    rows = mesh.mesh.permute(*outer, *inner).reshape(-1, math.prod(sizes[a] for a in axes))
    me, mine = dist.get_rank(), None
    for row in rows.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` from :func:`create_mesh` or of a
    :class:`MeshPlan` (the rules and :func:`_legalize` need only the sizes)."""
    if isinstance(mesh, MeshPlan):
        return mesh.axis_sizes()
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def auto_plan(n_devices: int, *, tensor: int = 1, seq: int = 1) -> MeshPlan:
    """Default layout: requested tensor/seq degree, rest goes to fsdp."""
    rest, rem = divmod(n_devices, tensor * seq)
    if rem:
        raise ValueError(
            f"{n_devices} devices not divisible by tensor={tensor} * seq={seq}"
        )
    return MeshPlan(fsdp=rest, tensor=tensor, seq=seq)


def batch_spec() -> tuple:
    """Batch dims shard over every data-ish axis (dcn × data × fsdp)."""
    return (BATCH_AXES,)


def placements(mesh, spec: tuple) -> list:
    """``spec`` as DTensor placements over ``mesh``'s dims: ``Shard(i)`` on
    each axis that entry ``i`` names, ``Replicate()`` on the others (the
    counterpart of ``NamedSharding(mesh, P(*spec))``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(i)
    return out


def batch_sharding(mesh) -> list:
    return placements(mesh, batch_spec())


def replicated(mesh) -> list:
    return placements(mesh, ())


# ---------------------------------------------------------------- param rules


def fsdp_param_spec(path: tuple[str, ...], value) -> tuple:
    """ZeRO-3-style parameter sharding rule.

    Shard the largest dim of every >=2-d parameter over ``fsdp`` (each rank
    stores its shard; the step gathers it for compute and reduce-scatters
    the gradient). 1-d params (biases, norm scales) stay replicated.
    """
    shape = getattr(value, "shape", ())
    if len(shape) < 2:
        return ()
    largest = int(np.argmax(shape))
    if shape[largest] < 128:  # don't shard tiny dims below tile size
        return ()
    spec: list = [None] * len(shape)
    spec[largest] = "fsdp"
    return tuple(spec)


def tensor_param_spec(path: tuple[str, ...], value) -> tuple:
    """Megatron-style TP rule for transformer blocks, composed with fsdp.

    Column-parallel for QKV/up projections (last dim over ``tensor``),
    row-parallel for output/down projections (first dim over ``tensor``),
    identified by the flax path's module names.
    """
    shape = getattr(value, "shape", ())
    joined = "/".join(path)
    if len(shape) < 2:
        return ()
    if any(m in joined for m in ("q_proj", "k_proj", "v_proj", "up_proj", "gate_proj")):
        return ("fsdp", "tensor")
    if any(m in joined for m in ("o_proj", "down_proj")):
        return ("tensor", "fsdp")
    if "embed" in joined:
        return (None, "fsdp")
    return fsdp_param_spec(path, value)


def moe_param_spec(path: tuple[str, ...], value) -> tuple:
    """Expert-parallel rule for MoE models, composed with the TP rule.

    Expert tables (3-d leaves ``experts_wi`` / ``experts_wo``): dim 0 over
    ``expert``, the hidden dim over ``tensor``; ``router`` leaves stay
    replicated; everything else follows the transformer TP rule.
    """
    shape = getattr(value, "shape", ())
    leaf = path[-1] if path else ""
    if len(shape) == 3 and leaf == "experts_wi":
        return ("expert", "fsdp", "tensor")
    if len(shape) == 3 and leaf == "experts_wo":
        return ("expert", "tensor", "fsdp")
    if leaf == "router":
        return ()
    return tensor_param_spec(path, value)


def _legalize(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop axis assignments a dim can't honor (size not divisible by the mesh
    axis product) — odd mesh degrees degrade to replication, never error."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        degree = math.prod(sizes[a] for a in axes)
        out.append(entry if shape[i] % degree == 0 else None)
    return tuple(out)


# ------------------------------------------------- the port's layouts vs flax's


@dataclasses.dataclass(frozen=True)
class FlaxLayout:
    """Where a port parameter sits in the JAX model: its flax ``path`` and
    ``shape``, and for each port dim the flax dims it holds, major first
    (``dims``; a q/k/v projection's port dim 0 holds flax dims 1 and 2)."""

    path: tuple[str, ...]
    shape: tuple[int, ...]
    dims: tuple[tuple[int, ...], ...]


def flax_layout(name: str, shape: Sequence[int], head_dim: int | None = None) -> FlaxLayout:
    """The flax path, shape and dim map of the port parameter ``name`` of
    ``shape``: the inverse of ``interop.py``'s ``*_from_flax``. ``head_dim``
    splits a q/k/v projection's H·D rows (transformer and MoE models)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    shape = tuple(shape)
    leaf = parts[-1]
    if parts[-2:-1] and parts[-2].endswith("norm") and leaf == "weight":
        return FlaxLayout(tuple(parts[:-1]) + ("scale",), shape, ((0,),))
    if parts[0] == "embed":
        return FlaxLayout(("embed", "embedding"), shape, ((0,), (1,)))
    if leaf != "weight":                      # MoE tables, BatchNorm scale/bias, head bias
        return FlaxLayout(tuple(parts), shape, tuple((i,) for i in range(len(shape))))
    path = tuple(parts[:-1]) + ("kernel",)
    if re.fullmatch(r"[qkv]_proj", parts[-2]):   # [heads*D, E] <- [E, heads, D]
        if head_dim is None or shape[0] % head_dim:
            raise ValueError(f"{name}: rows {shape[0]} are not heads of head_dim {head_dim}")
        return FlaxLayout(path, (shape[1], shape[0] // head_dim, head_dim), ((1, 2), (0,)))
    if len(shape) == 4:                       # conv [co, ci, kh, kw] <- [kh, kw, ci, co]
        co, ci, kh, kw = shape
        return FlaxLayout(path, (kh, kw, ci, co), ((3,), (2,), (0,), (1,)))
    return FlaxLayout(path, shape[::-1], ((1,), (0,)))   # dense [out, in] <- [in, out]


def port_spec(flax_spec: tuple, layout: FlaxLayout, name: str = "") -> tuple:
    """A spec over flax dims carried to the port's dims through ``layout``.
    A port dim that holds several flax dims takes the entry of its major
    one (a split of H is a contiguous block of H·D rows); a split of a minor
    one would not be a contiguous block and raises."""
    entries = list(flax_spec) + [None] * (len(layout.shape) - len(flax_spec))
    out = []
    for held in layout.dims:
        if any(entries[d] is not None for d in held[1:]):
            raise ValueError(f"{name}: the rule splits flax dim(s) {held[1:]}, which the "
                             f"port's layout interleaves into one dim")
        out.append(entries[held[0]])
    return tuple(out)


def param_shardings(mesh, model, rule=fsdp_param_spec) -> dict[str, tuple]:
    """Port parameter name -> its spec over the port's dims: ``rule`` on the
    flax path and shape, legalised against ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshPlan`), then carried through the layout."""
    head_dim = _head_dim(model)
    out = {}
    for name, p in model.named_parameters():
        layout = flax_layout(name, p.shape, head_dim)
        flax_spec = _legalize(rule(layout.path, torch.empty(layout.shape, device="meta")),
                              layout.shape, mesh)
        out[name] = port_spec(flax_spec, layout, name)
    return out


def _head_dim(model) -> int | None:
    cfg = getattr(model, "cfg", None)
    if cfg is None:
        return None
    return cfg.attention_cfg().head_dim if hasattr(cfg, "attention_cfg") else cfg.head_dim
