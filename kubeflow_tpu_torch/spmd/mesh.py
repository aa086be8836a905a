"""A placement's derived mesh as the port's mesh; counterpart of the mesh
build in ``kubeflow_tpu/spmd/mesh.py`` (``DerivedMesh.to_plan`` and
``to_data_plan``, ``build_mesh``, ``per_host_batch``).

The derivation itself (accelerator, topology and slice count to hosts and
chips a host, from the TPU topology tables) imports no JAX and stays the
reference's: these functions take any object with a ``DerivedMesh``'s
fields (``shape``, ``num_slices``, ``num_hosts``, ``chips_per_host``) and
turn it into the port's ``MeshPlan`` and ``DeviceMesh``:

    dcn    = num_slices      (data parallelism across slices)
    data   = num_hosts       (batch parallelism across a slice's hosts)
    tensor = chips_per_host  (``model`` in the derivation's vocabulary), or
    fsdp   = chips_per_host  for a batch-parallel workload (``data_parallel``)
"""
from __future__ import annotations

from kubeflow_tpu_torch.parallel import mesh as meshlib


def to_plan(dm) -> meshlib.MeshPlan:
    """The derivation in ``parallel/mesh.py``'s vocabulary (model -> tensor)."""
    return meshlib.MeshPlan(dcn=dm.num_slices, data=dm.num_hosts, tensor=dm.chips_per_host)


def to_data_plan(dm) -> meshlib.MeshPlan:
    """The pure data-parallel projection: the intra-host block folds into
    fsdp, so the batch shards over every chip and the parameters ZeRO-shard
    over a host's chips."""
    return meshlib.MeshPlan(dcn=dm.num_slices, data=dm.num_hosts, fsdp=dm.chips_per_host)


def build_mesh(dm, devices=None, *, data_parallel: bool = False):
    """The ``DeviceMesh`` of this derivation over ``devices`` (the default
    process group's ranks by default), through ``create_mesh`` with the
    slice's chip cuboid as its physical topology when there is one slice.
    ``data_parallel=True`` builds :func:`to_data_plan`'s projection."""
    plan = to_data_plan(dm) if data_parallel else to_plan(dm)
    physical = tuple(dm.shape) if dm.num_slices == 1 else None
    return meshlib.create_mesh(plan, devices, physical_topology=physical)


def per_host_batch(dm, global_batch: int) -> int:
    """The global batch split over every host (dcn x data), never over the
    chips of a host; a batch that does not split evenly is an error."""
    hosts = dm.num_hosts * dm.num_slices
    if global_batch < 1 or global_batch % hosts:
        raise ValueError(
            f"global batch {global_batch} does not divide over "
            f"{hosts} hosts ({dm.num_hosts} hosts x {dm.num_slices} slices)"
        )
    return global_batch // hosts
