"""Timing for the port's benchmarks: device time of a kernel for the probes'
``main()`` (CUDA events around calls that queue behind a spin kernel), the
reference's long-minus-short window estimator for the bench entry points,
and the card's name and power limit."""
from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, *, iters: int = 20, warmup: int = 3, flush_l2: bool = True) -> float:
    """Mean device ms of one call of ``fn``. The stream first runs a spin
    kernel while the host enqueues every timed call, so the events measure
    the device's work and not the host's launch rate; ``flush_l2`` writes
    128 MB before each call, so the call finds the 50 MB L2 cold."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda") if flush_l2 else None
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def min_window_step_seconds(window, n_short: int, n_long: int, repeats: int):
    """Seconds a unit from interleaved short and long windows: ``window(n)``
    runs n units and returns its elapsed seconds, its work finished
    (:func:`sync` closes it). Stalls only lengthen a window, so the
    minimum of each length over the repeats is its clean time, and the fixed
    cost of a window cancels in the difference (the reference's
    ``benchmarks/_timing.py``). Returns ``(sec_per_unit, shorts, longs)``."""
    shorts, longs = [], []
    for _ in range(repeats):
        shorts.append(window(n_short))
        longs.append(window(n_long))
    return (min(longs) - min(shorts)) / (n_long - n_short), shorts, longs


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_fields(device) -> dict:
    """The device a bench line was measured on: the card's name and power
    limit in watts (``nvidia-smi``), or ``"cpu"`` and None."""
    if torch.device(device).type != "cuda":
        return {"card": "cpu", "power_limit_w": None}
    limit = card().rsplit(",", 1)[-1].strip()
    return {"card": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit() else None}


def require_card(device, what: str) -> None:
    """A bench entry point measures the card: without one it stops with a
    message, unless the caller asked for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{what}: no CUDA device; the benchmark runs on the card")
