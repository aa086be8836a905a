"""The port's ``bench_mfu`` (``kubeflow_tpu_torch/benchmarks/bench_mfu.py``)
and its derivation (``spmd/topology.py``, ``spmd/mesh.py``'s ``derive``)
against the reference's (``kubeflow_tpu/tpu/topology.py``,
``kubeflow_tpu/spmd/mesh.py``).

The derivation: every accelerator, and two unknown ones, against a table of
valid and invalid topologies and slice counts: the same fields, axes and
counts, or the same ``ValueError`` text. The bench: ``main(argv,
device="cpu")`` on 2 gloo CPU ranks, one process a simulated chip, for
``v5e 1x2`` (fsdp 2 inside one host) and ``v5e 1x1 --num-slices 2`` (dcn 2,
two hosts, so ``per_host_batch`` halves the batch), the second through
``resnet_bench --mfu``: the ``MFU_BENCH`` line has ``run()``'s keys (read
from the reference's source) plus ``card`` and ``power_limit_w``, and its
axes, device count, global and per-host batch are the reference
derivation's. ``--check-against`` exits 0 and 1 against temporary
baselines, and ``resnet_bench --mfu`` exits with that code. Tiny images
(16 px), one step a window unit, one repeat."""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import pytest
import torch

from kubeflow_tpu.spmd import mesh as jspmd
from kubeflow_tpu.tpu import topology as jtopo
from kubeflow_tpu_torch.benchmarks import bench_mfu, resnet_bench
from kubeflow_tpu_torch.spmd import mesh as tspmd
from kubeflow_tpu_torch.spmd import topology as ttopo

REPO = Path(__file__).resolve().parents[1]
TOPOLOGIES = ["1x1", "1x2", "2x2", "2x4", "4x4", "4x8", "8x16", "16x16", "2x3", "3x3", "4x2",
              "1x4", "2x2x1", "2x2x2", "4x4x4", "2x2x4", "1x1x1", "2x1x1", "4x4x2", "2x2x2x2",
              "0x2", "2x2x0", "4", "", "2x", "x2", "abc", "2 x2"]
SMALL = ["--per-chip-batch", "2", "--image", "16", "--k-inner", "1", "--n-short", "1",
         "--n-long", "2", "--repeats", "1"]


def test_accelerator_table_matches_the_reference():
    assert sorted(ttopo.ACCELERATORS) == sorted(jtopo.ACCELERATORS)
    for name, got in ttopo.ACCELERATORS.items():
        want = jtopo.ACCELERATORS[name]
        assert (got.dims, got.host_block, got.supports_single_host_sub_blocks,
                got.chips_per_host) == (want.dims, want.host_block,
                                        want.supports_single_host_sub_blocks, want.chips_per_host)


@pytest.mark.parametrize("accel", sorted(jtopo.ACCELERATORS) + ["v3", "V4"])
def test_derive_matches_the_reference(accel):
    for topology in TOPOLOGIES:
        for slices in (1, 2, 0):
            try:
                want = jspmd.derive(accel, topology, slices)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tspmd.derive(accel, topology, slices)
                assert str(got.value) == str(e), (accel, topology, slices)
                continue
            got = tspmd.derive(accel, topology, slices)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (accel, topology)
            assert (got.num_chips, got.num_processes, got.num_devices, got.axes()) == (
                want.num_chips, want.num_processes, want.num_devices, want.axes())
            assert dataclasses.asdict(tspmd.to_data_plan(got)) == dataclasses.asdict(
                want.to_data_plan())


def _reference_run_keys() -> set[str]:
    tree = ast.parse((REPO / "benchmarks/bench_mfu.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "run")
    lit = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "bench" for k in n.keys))
    return {k.value for k in lit.keys}


def _baseline(tmp, value):
    path = tmp / f"baseline_{value}.json"
    path.write_text(json.dumps({"imgs_per_sec_per_chip": value}))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two 2-rank runs: (topology flags, printed stdout, stderr, exit code)."""
    tmp = tmp_path_factory.mktemp("mfu")
    out = {}
    cases = [
        # a floor under any rate, even the negative one a loaded CPU's one
        # short and one long window can give
        ("fsdp", ["--accelerator", "v5e", "--topology", "1x2", "--native"], -1e12,
         lambda argv: bench_mfu.main(argv, device="cpu")),
        # a baseline no CPU run reaches, through resnet_bench --mfu
        ("dcn", ["--accelerator", "v5e", "--topology", "1x1", "--num-slices", "2"], 1e12,
         lambda argv: resnet_bench.main(["--mfu", *argv], cell={"device": "cpu"})),
    ]
    for name, flags, base, run in cases:
        stdout, stderr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            try:
                code = run(flags + SMALL + ["--check-against", _baseline(tmp, base)])
            except SystemExit as e:
                code = e.code
        out[name] = (flags, stdout.getvalue(), stderr.getvalue(), code)
    return out


@pytest.mark.parametrize("name", ["fsdp", "dcn"])
def test_mfu_bench_on_two_gloo_ranks_prints_the_reference_line(runs, name):
    flags, stdout, _, _ = runs[name]
    lines = [x for x in stdout.splitlines() if x.startswith("MFU_BENCH ")]
    assert len(lines) == 1
    text = lines[0].split(" ", 1)[1]
    line = json.loads(text)
    assert set(line) == _reference_run_keys() | {"card", "power_limit_w"}
    assert text == json.dumps(line, sort_keys=True)
    args = bench_mfu._parser().parse_args(flags + SMALL)
    dm = jspmd.derive(args.accelerator, args.topology, args.num_slices)
    global_batch = args.per_chip_batch * dm.num_devices
    assert line["axes"] == dm.axes() and line["n_devices"] == dm.num_devices == 2
    assert line["global_batch"] == global_batch == 4
    assert line["per_host_batch"] == jspmd.per_host_batch(dm, global_batch)
    assert (line["accelerator"], line["topology"], line["num_slices"]) == (
        dm.accelerator, dm.topology, dm.num_slices)
    assert (line["per_chip_batch"], line["image"], line["backend"]) == (2, 16, "cpu")
    assert line["card"] == "cpu" and line["power_limit_w"] is None and line["mfu"] is None
    assert isinstance(line["train_flops_per_image"], int) and line["train_flops_per_image"] > 0
    for key in ("imgs_per_sec_per_chip", "imgs_per_sec_per_chip_single", "scaling_efficiency"):
        assert isinstance(line[key], float)


def test_check_against_gates_and_resnet_bench_passes_the_code_through(runs):
    assert runs["fsdp"][3] == 0 and "ok" in runs["fsdp"][2]
    assert runs["dcn"][3] == 1 and "PERF GATE FAILED" in runs["dcn"][2]
    assert runs["dcn"][1].count("MFU_BENCH ") == 1


def test_without_a_card_bench_mfu_stops_with_a_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would measure it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_mfu.main(["--accelerator", "v5e", "--topology", "1x1"])


def test_on_the_card_a_larger_derivation_stops_with_the_references_message(monkeypatch):
    """A world of one (no launcher) cannot hold v4 2x2x2's 8 chips: the
    reference's message, before anything touches a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for var in ("WORLD_SIZE", "TPU_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as got:
        bench_mfu.main([])
    assert str(got.value).startswith("v4:2x2x2 x1 needs 8 devices, have 1 — ")
