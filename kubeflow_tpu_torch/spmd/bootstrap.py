"""This host's mesh from its SPMD context; counterpart of ``local_mesh`` in
``kubeflow_tpu/spmd/bootstrap.py``. The context itself (the injected env
parsed and validated) imports no JAX and stays the reference's; this takes
any object with its ``mesh`` field (a derived mesh, or None)."""
from __future__ import annotations

from kubeflow_tpu_torch.spmd import mesh as spmd_mesh


def local_mesh(ctx, devices=None):
    """The ``DeviceMesh`` this host should build, identical on every host.

    Call after ``parallel.bootstrap.auto_initialize()``, so the default
    process group spans the whole gang; tests pass the ranks directly."""
    if ctx.mesh is None:
        raise ValueError("cannot build a mesh without TPU_TOPOLOGY/TPU_ACCELERATOR_TYPE")
    return spmd_mesh.build_mesh(ctx.mesh, devices)
