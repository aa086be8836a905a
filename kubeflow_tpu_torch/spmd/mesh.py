"""A placement's derived mesh as the port's mesh; counterpart of
``kubeflow_tpu/spmd/mesh.py`` (``DerivedMesh``, ``from_topology``,
``derive``, ``build_mesh``, ``per_host_batch``).

:func:`derive` turns an (accelerator, topology, slice count) triple into a
:class:`DerivedMesh` from the port's copy of the TPU topology tables
(``spmd/topology.py``), field for field the reference's; ``bench_mfu``
derives its mesh so. The mesh functions take any object with a
``DerivedMesh``'s fields (``shape``, ``num_slices``, ``num_hosts``,
``chips_per_host``; the reference's own too) and turn it into the port's
``MeshPlan`` and ``DeviceMesh``:

    dcn    = num_slices      (data parallelism across slices)
    data   = num_hosts       (batch parallelism across a slice's hosts)
    tensor = chips_per_host  (``model`` in the derivation's vocabulary), or
    fsdp   = chips_per_host  for a batch-parallel workload (``data_parallel``)
"""
from __future__ import annotations

import dataclasses
import math

from kubeflow_tpu_torch.parallel import mesh as meshlib
from kubeflow_tpu_torch.spmd.topology import SliceTopology, parse_topology


@dataclasses.dataclass(frozen=True)
class DerivedMesh:
    """The mesh every host of a gang derives from its placement, fully
    determined by (accelerator, topology, num_slices)."""

    accelerator: str
    topology: str
    shape: tuple[int, ...]
    host_grid: tuple[int, ...]    # hosts along each dim (shape / host_block)
    num_slices: int
    num_hosts: int                # a slice's
    chips_per_host: int

    @property
    def num_chips(self) -> int:
        return math.prod(self.shape)

    @property
    def num_processes(self) -> int:
        """The gang's process count: hosts x slices."""
        return self.num_hosts * self.num_slices

    @property
    def num_devices(self) -> int:
        """The chips the mesh spans."""
        return self.num_chips * self.num_slices

    def axes(self) -> dict[str, int]:
        """The derived axes in the derivation's vocabulary (dcn, data, model)."""
        return {"dcn": self.num_slices, "data": self.num_hosts, "model": self.chips_per_host}


def from_topology(topo: SliceTopology, num_slices: int = 1) -> DerivedMesh:
    """Derive from a validated slice topology."""
    if num_slices < 1:
        raise ValueError(f"numSlices must be >= 1; got {num_slices}")
    block = topo.accelerator.host_block
    # single-host sub-blocks (v5e 1x1, 2x2) do not tile the block: their host
    # grid is the identity
    host_grid = tuple(max(1, d // b) for d, b in zip(topo.shape, block))
    if math.prod(host_grid) != topo.num_hosts:
        host_grid = (1,) * len(topo.shape)
    return DerivedMesh(accelerator=topo.accelerator.name, topology=topo.topology_str,
                       shape=topo.shape, host_grid=host_grid, num_slices=num_slices,
                       num_hosts=topo.num_hosts, chips_per_host=topo.chips_per_host)


def derive(accelerator: str, topology: str, num_slices: int = 1) -> DerivedMesh:
    """Derive from the raw strings; a ``ValueError`` with the reference's
    message on bad input."""
    return from_topology(parse_topology(accelerator, topology), num_slices)


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
