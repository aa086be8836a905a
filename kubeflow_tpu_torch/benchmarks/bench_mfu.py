"""MFU_BENCH: ResNet training throughput under a placement's derived mesh;
counterpart of ``benchmarks/bench_mfu.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.bench_mfu --accelerator v5e --topology 1x1
    python3 -m kubeflow_tpu_torch.benchmarks.resnet_bench --mfu [the same flags]
    torchrun --nproc-per-node N -m kubeflow_tpu_torch.benchmarks.bench_mfu [flags]

It derives the gang's mesh from an (accelerator, topology, numSlices)
triple (``spmd.mesh.derive``), builds its data-parallel projection
(``spmd.build_mesh(dm, data_parallel=True)``: batch over dcn x data x fsdp,
the parameters ZeRO-sharded over a host's chips), and times the ResNet train
step there at global batch ``per_chip_batch x num_devices``, with
``spmd.per_host_batch``'s split reported beside it. The cell is the
reference's: ResNet-18 depths at width 16, 100 classes, fp32,
``bn_impl="xla"``, nesterov SGD 0.1/0.9, seeded standard-normal images.

Two arms: ``single``, the same cell on one device (rank 0), and ``mesh``,
the derived mesh over every rank. A window runs ``k_inner`` steps a unit,
carrying the state; the rate comes from ``_timing.min_window_step_seconds``.
The FLOPs a train image are ``torch.utils.flop_counter.FlopCounterMode``'s
count of one mesh-arm step (matmuls and convolutions, forward and backward),
summed over the ranks and divided by the global batch, where the reference
reads XLA's ``cost_analysis``; None where it counts nothing. MFU divides by
989 TFLOP/s, the card's bf16 peak, as the reference divides its fp32 cell by
the TPU's bf16 peak; None on the CPU.

Where it runs: on the card by default (``--native`` says the same and is
accepted for the reference's command line), one rank a card. Under a
launcher's environment (torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``,
or the slice env ``parallel/bootstrap.py`` reads) each process joins the
group over NCCL; otherwise the run is a world of one, so one card runs a
derivation of one chip (``--accelerator v5e --topology 1x1``) and a larger
one stops with the reference's message. ``main(argv, device="cpu")`` is the
reference's default simulation: one gloo CPU process for each simulated
chip, which shows whether the sharded program runs, not how it scales.

Prints one line, ``MFU_BENCH {json}``, with ``run()``'s keys
(``benchmarks/bench_mfu.py:207-225``) plus the card's name and power limit.
``--check-against PATH`` then gates ``imgs_per_sec_per_chip`` against the
baseline file it names (exit 1 below ``baseline x (1 - tolerance)``).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.benchmarks import _timing
from kubeflow_tpu_torch.parallel import bootstrap
from kubeflow_tpu_torch.spmd import mesh as spmd_mesh

NUM_CLASSES, WIDTH, STAGES = 100, 16, [2, 2, 2, 2]


def _parser():
    ap = argparse.ArgumentParser(prog="bench_mfu", description=__doc__.split("\n")[0])
    ap.add_argument("--accelerator", default="v4", help="accelerator short name (default v4)")
    ap.add_argument("--topology", default="2x2x2",
                    help="slice chip cuboid, e.g. 2x2x2 (default: 8 chips = 2 hosts x 4 chips)")
    ap.add_argument("--num-slices", type=int, default=1)
    ap.add_argument("--per-chip-batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=32, help="image side (default 32)")
    ap.add_argument("--k-inner", type=int, default=4, help="train steps a window unit")
    ap.add_argument("--n-short", type=int, default=1)
    ap.add_argument("--n-long", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--native", action="store_true",
                    help="run on the card (the default; kept for the reference's command line)")
    ap.add_argument("--check-against", metavar="BASELINE_JSON",
                    help="compare img/s/chip against a baseline file and exit 1 on a "
                         "regression beyond --tolerance")
    ap.add_argument("--tolerance", type=float, default=0.50,
                    help="allowed fractional regression for --check-against (default 0.50)")
    return ap


def _flops_per_step(step, state, batch) -> float | None:
    """One train step under ``FlopCounterMode``: its matmul and convolution
    FLOPs, forward and backward (the step runs and updates ``state``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step(state, batch)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def _measure_arm(mesh, *, per_arm_batch, image, k_inner, n_short, n_long, repeats, seed,
                 device, count_flops):
    """(img/s, this rank's FLOPs of one step or None) of the cell's train
    step on ``mesh`` (None: one device), every rank feeding the same
    global batch of ``per_arm_batch`` images."""
    model = kt.ResNet(STAGES, num_classes=NUM_CLASSES, width=WIDTH, dtype=torch.float32,
                      device=device)
    model.load_state_dict(kt.resnet_init_state_dict(STAGES, num_classes=NUM_CLASSES, width=WIDTH,
                                                    seed=seed, device=device))
    bundle = kt.make_classifier_train_step(model, kt.sgd(0.1, momentum=0.9, nesterov=True), mesh)
    rng = np.random.default_rng(seed)
    batch = {
        "image": torch.from_numpy(rng.standard_normal(
            (per_arm_batch, image, image, 3)).astype(np.float32)).to(device),
        "label": torch.from_numpy(rng.integers(0, NUM_CLASSES, per_arm_batch)).to(device),
    }
    state = bundle.init()
    flops = _flops_per_step(bundle.step, state, batch) if count_flops else None
    window = _timing.step_window(bundle.step, state, batch, device, k=k_inner)
    window(n_short)                              # build, allocate, warm
    window(n_long)
    sec_per_unit, _, _ = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    return per_arm_batch / (sec_per_unit / k_inner), flops


def _run(args, dm, device: str) -> dict | None:
    """Both arms on this rank of the default process group; the result on
    rank 0, None elsewhere."""
    import torch.distributed as dist

    rank = dist.get_rank()
    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    global_batch = args.per_chip_batch * dm.num_devices
    host_batch = spmd_mesh.per_host_batch(dm, global_batch)
    timing = dict(image=args.image, k_inner=args.k_inner, n_short=args.n_short,
                  n_long=args.n_long, repeats=args.repeats, seed=args.seed, device=dev)
    single_ips = None
    if rank == 0:
        single_ips, _ = _measure_arm(None, per_arm_batch=args.per_chip_batch, count_flops=False,
                                     **timing)
    dist.barrier()
    mesh = spmd_mesh.build_mesh(dm, data_parallel=True)
    mesh_ips, flops = _measure_arm(mesh, per_arm_batch=global_batch, count_flops=True, **timing)
    total = torch.tensor([flops or 0.0], dtype=torch.float64)
    dist.all_reduce(total)                       # FlopCounterMode counts this rank's share
    mesh_flops = float(total) if float(total) > 0 else None
    if rank:
        return None
    per_chip = mesh_ips / dm.num_devices
    return {
        "bench": "MFU_BENCH",
        "accelerator": dm.accelerator,
        "topology": dm.topology,
        "num_slices": dm.num_slices,
        "axes": dm.axes(),
        "n_devices": dm.num_devices,
        "global_batch": global_batch,
        "per_host_batch": host_batch,
        "per_chip_batch": args.per_chip_batch,
        "image": args.image,
        "imgs_per_sec_per_chip": round(per_chip, 2),
        "imgs_per_sec_per_chip_single": round(single_ips, 2),
        "scaling_efficiency": round(per_chip / single_ips, 4),
        "train_flops_per_image": round(mesh_flops / global_batch) if mesh_flops else None,
        "mfu": _timing.mfu(per_chip, mesh_flops / global_batch, dev) if mesh_flops else None,
        "backend": device,
        **_timing.device_fields(dev),
    }


def _spawned_rank(rank: int, world: int, folder: str, argv: list) -> None:
    """One simulated chip of ``main(device="cpu")`` (a spawned process)."""
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{folder}/store", rank=rank,
                            world_size=world)
    try:
        args = _parser().parse_args(argv)
        result = _run(args, spmd_mesh.derive(args.accelerator, args.topology, args.num_slices),
                      "cpu")
    finally:
        dist.destroy_process_group()
    if result is not None:
        Path(folder, "result.json").write_text(json.dumps(result))


def _simulate(argv: list, n: int) -> dict:
    """``_run`` on n spawned gloo CPU processes; rank 0's result."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        procs = [ctx.Process(target=_spawned_rank, args=(r, n, folder, argv)) for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=1800)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if any(p.exitcode for p in procs):
            raise RuntimeError(f"bench_mfu: a simulated chip failed, exit codes "
                               f"{[p.exitcode for p in procs]}")
        return json.loads(Path(folder, "result.json").read_text())


def _on_cards(args, dm) -> dict | None:
    """``_run`` on the card(s): under a launcher, this process is one rank of
    its group; otherwise a world of one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        bootstrap.auto_initialize(device="cuda")          # a slice's env joins its gang
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("cpu:gloo,cuda:nccl")       # torchrun's env:// rendezvous
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != dm.num_devices:
        raise SystemExit(
            f"{args.accelerator}:{args.topology} x{args.num_slices} needs "
            f"{dm.num_devices} devices, have {have} — launch {dm.num_devices} ranks, one a "
            f"card (torchrun --nproc-per-node), or pass a smaller --topology")
    if dist.is_initialized():
        return _run(args, dm, "cuda")
    with tempfile.TemporaryDirectory() as folder:
        dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{folder}/store",
                                rank=0, world_size=1)
        try:
            return _run(args, dm, "cuda")
        finally:
            dist.destroy_process_group()


def check_against(result: dict, baseline_path: str, tolerance: float) -> int:
    """The perf gate: 1 when the derived mesh's img/s/chip fell more than
    ``tolerance`` below the baseline file's, else 0."""
    with open(baseline_path) as f:
        baseline = json.load(f)
    base = float(baseline["imgs_per_sec_per_chip"])
    new = float(result["imgs_per_sec_per_chip"])
    floor = base * (1.0 - tolerance)
    verdict = "ok" if new >= floor else "REGRESSED"
    print(f"MFU_BENCH gate: {new:.1f} img/s/chip on the derived mesh vs baseline {base:.1f} "
          f"(floor {floor:.1f} at {tolerance:.0%} tolerance) {verdict}", file=sys.stderr)
    if verdict == "REGRESSED":
        print("PERF GATE FAILED: ResNet throughput under the placement-derived mesh regressed "
              f"against {baseline_path}: fix the regression (mesh derivation, rank order, "
              "train-step sharding) or record a new baseline with its reason", file=sys.stderr)
        return 1
    return 0


def main(argv=None, *, device: str = "cuda") -> int:
    """Run both arms, print the ``MFU_BENCH`` line on rank 0 and return the
    exit code (the gate's with ``--check-against``). ``device="cpu"`` runs
    one gloo CPU process a simulated chip."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    dm = spmd_mesh.derive(args.accelerator, args.topology, args.num_slices)
    _timing.require_card(device, "bench_mfu")
    result = _simulate(argv, dm.num_devices) if device == "cpu" else _on_cards(args, dm)
    if result is None:                           # a rank other than 0
        return 0
    print("MFU_BENCH " + json.dumps(result, sort_keys=True), flush=True)
    if args.check_against:
        return check_against(result, args.check_against, args.tolerance)
    return 0


if __name__ == "__main__":
    sys.exit(main())
