"""Whether a trace captured from a second thread keeps the kernels that the
training thread launches, on the card.

    python3 -m kubeflow_tpu_torch.benchmarks.capture_threads [--captures 10] [--modes ...]

Each mode named (every mode by default; a mode named twice runs twice) runs
in a fresh process: the dense flagship of ``_cells.py`` (``dense_train()``,
B 4, S 2048) warms up two steps and runs ``trace_n_steps(steps=1)`` on the
main thread, then ``--captures`` times a second thread captures the process
for 0.4 s (``TorchTraceProfiler(step_hint_s=0.2).capture(2)``'s window, as
``chip_smoke.py``'s session phase calls it) while the main thread steps, each
step in ``step_annotation``, until the capture has ended. Modes:

- ``loop``: the port's capture, ``TorchTraceProfiler.capture(2)``, which
  runs on the stepping loop's thread (``utils/profiling.capture_window``);
- ``caller``: the trace started and stopped on the second thread
  (``utils/profiling._traced``, which synchronises the card before the
  trace stops), the route the port takes where no loop steps;
- ``caller_no_sync``: the same without that synchronisation;
- ``caller_profile_all_threads`` and ``caller_profile_all_threads_no_sync``:
  with ``torch.profiler``'s ``profile_all_threads`` option, which adds the
  other threads' operators, with and without the synchronisation;
- ``caller_per_thread_buffer_false_no_sync``: no synchronisation, and
  Kineto's ``CUPTI_PER_THREAD_BUFFER_ENABLED=false`` (a ``KINETO_CONFIG``
  file);
- ``caller_profile_all_threads_no_sync_big_buffers``: ``profile_all_threads``,
  no synchronisation, and Kineto's ``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=2048``.

For each capture it prints the route, the kernels in the trace, the flash
forward, dq and dk/dv kernels among them, the main thread's step regions and
the CUDA runtime calls of each thread;
then, for each mode, how many captures lack one of the flash kernels, and
the distinct lines the profiler wrote to standard error. Exits with a
message where there is no card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

MODES = {  # mode: (profile_all_threads, synchronise before the stop), or None: the port's
    "loop": None,
    "caller": None,
    "caller_no_sync": (False, False),
    "caller_profile_all_threads": (True, True),
    "caller_profile_all_threads_no_sync": (True, False),
    "caller_per_thread_buffer_false_no_sync": (False, False),
    "caller_profile_all_threads_no_sync_big_buffers": (True, False),
}
KINETO_CONFIG = {
    "caller_per_thread_buffer_false_no_sync": "CUPTI_PER_THREAD_BUFFER_ENABLED=false",
    "caller_profile_all_threads_no_sync_big_buffers": "ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=2048",
}
WINDOW_S = 0.4
FLASH = {"fwd": "flash_fwd", "dq": "flash_dq", "dkv": "flash_dkv"}


def _count(logdir: Path) -> dict:
    """Kernels, flash kernels and CUDA runtime calls by thread in the traces
    under ``logdir``."""
    out = dict(kernels=0, runtime={}, steps=0, **{k: 0 for k in FLASH})
    for f in logdir.rglob("*.pt.trace.json"):
        for e in json.loads(f.read_text())["traceEvents"]:
            cat = e.get("cat")
            if cat == "kernel":
                out["kernels"] += 1
                for k, sym in FLASH.items():
                    out[k] += sym in e.get("name", "")
            elif cat == "user_annotation":
                out["steps"] += e.get("name", "").startswith("train#")
            elif cat == "cuda_runtime":
                tid = str(e.get("tid"))
                out["runtime"][tid] = out["runtime"].get(tid, 0) + 1
    return out


def _traced_with(mode: str):
    """``utils/profiling._traced`` with the change ``mode`` names."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.utils import profiling

    all_threads, sync = MODES[mode]

    @contextlib.contextmanager
    def traced(logdir: str):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=all_threads)) as prof:
            yield
            if sync:
                torch.cuda.synchronize()
        out = profiling._profile_dir(logdir)
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "capture.pt.trace.json"))

    return traced


def child(mode: str, captures: int, root: Path) -> None:
    import time

    import torch

    from kubeflow_tpu_torch.benchmarks import _cells as cells
    from kubeflow_tpu_torch.telemetry.agent import TorchTraceProfiler
    from kubeflow_tpu_torch.utils import profiling

    cell = cells.dense_train()
    state = cell.bundle.init()
    for _ in range(2):
        cell.bundle.step(state, cell.tokens)
    torch.cuda.synchronize()
    profiling.trace_n_steps(str(root / "main"), cell.bundle.step, state, cell.tokens, steps=1)
    traced = profiling._traced if MODES[mode] is None else _traced_with(mode)
    for i in range(captures):
        logdir = root / f"{mode}-{i}"
        profiler = TorchTraceProfiler(logdir_base=str(logdir), step_hint_s=WINDOW_S / 2)

        def capture():
            if mode == "loop":
                profiler.capture(2)
                return
            with traced(str(logdir)):
                time.sleep(WINDOW_S)
            profiler.last_route = "caller"

        thread = threading.Thread(target=capture)
        thread.start()
        steps = 0
        while steps < 4 or thread.is_alive():
            with profiling.step_annotation(100 + steps):
                cell.bundle.step(state, cell.tokens)
            steps += 1
        torch.cuda.synchronize()
        thread.join()
        row = dict(mode=mode, capture=i, route=profiler.last_route, main_steps=steps,
                   **_count(logdir))
        print("CAPTURE " + json.dumps(row), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--captures", type=int, default=10)
    parser.add_argument("--modes", nargs="+", choices=list(MODES), default=list(MODES))
    parser.add_argument("--child", choices=list(MODES))
    parser.add_argument("--root")
    args = parser.parse_args(argv)
    if args.child:
        child(args.child, args.captures, Path(args.root))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("capture_threads: no CUDA device", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.benchmarks._timing import card

    print(f"[capture threads] {card()}, torch {torch.__version__}", flush=True)
    failed = 0
    for mode in args.modes:
        with tempfile.TemporaryDirectory(prefix="capture-threads-") as root:
            env = dict(os.environ)
            if mode in KINETO_CONFIG:
                conf = Path(root) / "kineto.conf"
                conf.write_text(KINETO_CONFIG[mode] + "\n")
                env["KINETO_CONFIG"] = str(conf)
            proc = subprocess.run(
                [sys.executable, "-m", "kubeflow_tpu_torch.benchmarks.capture_threads", "--child",
                 mode, "--captures", str(args.captures), "--root", root],
                capture_output=True, text=True, timeout=900, env=env)
        rows = [json.loads(line.split(" ", 1)[1]) for line in proc.stdout.splitlines()
                if line.startswith("CAPTURE ")]
        for r in rows:
            print(f"[capture threads] {mode} capture {r['capture']} ({r['route']}): "
                  f"{r['main_steps']} main steps; kernels {r['kernels']}, flash fwd/dq/dkv "
                  f"{r['fwd']}/{r['dq']}/{r['dkv']}; step regions {r['steps']}; "
                  f"CUDA runtime calls by thread {sorted(r['runtime'].values(), reverse=True)}",
                  flush=True)
        lacking = sum(1 for r in rows if not all(r[k] for k in FLASH))
        print(f"[capture threads] {mode}: {lacking} of {len(rows)} captures lack a flash kernel",
              flush=True)
        said = sorted({line.strip()[:160] for line in proc.stderr.splitlines()
                       if any(w in line.lower() for w in ("kineto", "cupti", "profil", "drop"))})
        print(f"[capture threads] {mode}: exit {proc.returncode}; the profiler's standard error: "
              f"{said[:8]}", flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
