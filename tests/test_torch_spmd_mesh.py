"""The port's mesh build from a gang's placement (``kubeflow_tpu_torch/spmd/``)
against the reference's (``kubeflow_tpu/spmd/mesh.py``, ``spmd/bootstrap.py``).

The derivation stays the reference's (``derive``, ``read_env``: no JAX); the
port turns it into its own ``MeshPlan``s, equal field by field to the
reference's, and its ``DeviceMesh``, whose axis sizes on 4 gloo ranks (a
``file://`` store under ``tmp_path``) equal those of the reference's mesh on
the 8-device CPU mesh. The reference also orders its devices by the torus
placement solver; the port's ranks stay in order (every card of a host
reaches every other over NVLink), so only the sizes are compared."""
from __future__ import annotations

import dataclasses
import multiprocessing as mp

import jax
import pytest
import torch

from kubeflow_tpu.spmd import bootstrap as jboot
from kubeflow_tpu.spmd import mesh as jspmd
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.spmd import bootstrap as tboot
from kubeflow_tpu_torch.spmd import mesh as tspmd

DERIVED = [("v4", "2x2x2", 1), ("v4", "2x2x1", 1), ("v5e", "2x2", 1), ("v4", "2x2x2", 2),
           ("v5e", "4x4", 2)]


@pytest.mark.parametrize("accel,topology,slices", DERIVED)
def test_plans_match_the_reference(accel, topology, slices):
    dm = jspmd.derive(accel, topology, slices)
    for port, ref in ((tspmd.to_plan(dm), dm.to_plan()),
                      (tspmd.to_data_plan(dm), dm.to_data_plan())):
        assert isinstance(port, tmesh.MeshPlan)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.size == ref.size == dm.num_devices


@pytest.mark.parametrize("accel,topology,slices", DERIVED)
def test_per_host_batch_matches_the_reference(accel, topology, slices):
    dm = jspmd.derive(accel, topology, slices)
    for batch in (0, 1, 2, 3, 8, 12, 64, -4):
        try:
            want = jspmd.per_host_batch(dm, batch)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tspmd.per_host_batch(dm, batch)
            assert str(got.value) == str(e)
        else:
            assert tspmd.per_host_batch(dm, batch) == want


def test_local_mesh_refuses_without_a_topology():
    ctx = jboot.read_env({"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0"})
    assert ctx.mesh is None
    with pytest.raises(jboot.SpmdEnvError) as want:
        jboot.local_mesh(ctx)
    with pytest.raises(ValueError) as got:
        tboot.local_mesh(ctx)
    assert str(got.value) == str(want.value)


def _rank_main(rank, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    try:
        dm = jspmd.derive("v4", "2x2x1")
        ctx = jboot.read_env({"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0",
                              "TPU_TOPOLOGY": "2x2x1", "TPU_ACCELERATOR_TYPE": "v4-8"})
        sizes = {"model": tmesh.axis_sizes(tspmd.build_mesh(dm)),
                 "data": tmesh.axis_sizes(tspmd.build_mesh(dm, data_parallel=True)),
                 "local": tmesh.axis_sizes(tboot.local_mesh(ctx))}
        try:
            tspmd.build_mesh(jspmd.derive("v4", "2x2x2"))
        except ValueError as e:
            sizes["error"] = str(e)
        torch.save(sizes, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_build_mesh_on_four_ranks_has_the_references_axes(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.exitcode, p.is_alive()) for p in procs]
    dm = jspmd.derive("v4", "2x2x1")
    devices = jax.devices()[:4]
    want = {"model": dict(jspmd.build_mesh(dm, devices).shape),
            "data": dict(jspmd.build_mesh(dm, devices, data_parallel=True).shape)}
    assert want["model"]["tensor"] == 4 and want["data"]["fsdp"] == 4
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["model"] == want["model"] and got["local"] == want["model"]
        assert got["data"] == want["data"]
        assert "needs 8 devices" in got["error"]    # a derivation of another size
