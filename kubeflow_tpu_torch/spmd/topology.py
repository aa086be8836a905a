"""TPU slice topologies, as far as a gang's derived mesh needs them; the
port's own copy of the accelerator table and ``parse_topology`` in
``kubeflow_tpu/tpu/topology.py`` (``:37-99, 113-166``).

A slice is an N-d torus of chips (3-d for v4/v5p, 2-d for v5e/v6e), grouped
onto hosts of ``host_block`` chips each; a topology must tile onto whole
hosts, except the small single-host shapes an accelerator offers. The
derivation (``spmd/mesh.py``'s ``derive``) reads the hosts and the chips a
host from here. Only the fields the derivation reads are kept: the
scheduler's and the controller's (GKE labels, cores, HBM, host names) stay
with the reference's control plane.
"""
from __future__ import annotations

import dataclasses
import math
import re


@dataclasses.dataclass(frozen=True)
class TpuAccelerator:
    """A TPU generation: its torus rank and the sub-torus one host owns."""

    name: str
    dims: int
    host_block: tuple[int, ...]
    supports_single_host_sub_blocks: tuple[tuple[int, ...], ...] = ()

    @property
    def chips_per_host(self) -> int:
        return math.prod(self.host_block)


_SUB_BLOCKS = ((1, 1), (2, 2), (2, 4), (1, 2))
ACCELERATORS = {
    a.name: a
    for a in (
        TpuAccelerator("v4", 3, (2, 2, 1)),
        TpuAccelerator("v5p", 3, (2, 2, 1)),
        TpuAccelerator("v5e", 2, (2, 4), _SUB_BLOCKS),
        TpuAccelerator("v6e", 2, (2, 4), _SUB_BLOCKS),
    )
}

_TOPOLOGY_RE = re.compile(r"^\d+(x\d+)*$")


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A validated slice: its accelerator and chip cuboid."""

    accelerator: TpuAccelerator
    shape: tuple[int, ...]

    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.shape)

    @property
    def num_chips(self) -> int:
        return math.prod(self.shape)

    @property
    def chips_per_host(self) -> int:
        # single-host sub-blocks (v5e 1x1, 2x2) expose only their chips
        return min(self.num_chips, self.accelerator.chips_per_host)

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.accelerator.chips_per_host)


def parse_topology(accelerator: str, topology: str) -> SliceTopology:
    """Parse and validate an (accelerator, topology) pair; a ``ValueError``
    with the reference's message on bad input."""
    accel = ACCELERATORS.get(accelerator)
    if accel is None:
        raise ValueError(
            f"unknown TPU accelerator {accelerator!r}; supported: {sorted(ACCELERATORS)}")
    if not _TOPOLOGY_RE.match(topology or ""):
        raise ValueError(
            f"malformed topology {topology!r}; expected e.g. "
            + ("'2x2x2'" if accel.dims == 3 else "'2x4'"))
    shape = tuple(int(d) for d in topology.split("x"))
    if len(shape) != accel.dims:
        raise ValueError(f"{accelerator} topologies are {accel.dims}-d; got {topology!r}")
    if any(d < 1 for d in shape):
        raise ValueError(f"topology dimensions must be >= 1; got {topology!r}")
    tiles = all(d % b == 0 for d, b in zip(shape, accel.host_block))
    if not tiles and shape not in accel.supports_single_host_sub_blocks:
        raise ValueError(
            f"topology {topology!r} does not tile the {accelerator} host block "
            f"{'x'.join(map(str, accel.host_block))}; the slice cannot be "
            "mapped onto whole hosts")
    if tiles and math.prod(shape) % accel.chips_per_host:
        raise ValueError(
            f"topology {topology!r} spans {math.prod(shape)} chips, which do "
            f"not divide onto whole {accelerator} hosts "
            f"({accel.chips_per_host} chips/host)")
    return SliceTopology(accelerator=accel, shape=shape)
