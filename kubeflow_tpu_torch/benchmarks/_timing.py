"""Timing for the port's benchmarks: device time of a kernel for the probes'
``main()`` (CUDA events around calls that queue behind a spin kernel), the
reference's long-minus-short window estimator for the bench entry points and
its in-process A B B A comparison of two variants, the card's name and
power limit, and MFU against its peak."""
from __future__ import annotations

import subprocess
import time

import torch

PEAK_FLOPS = 989e12             # H100 SXM dense bf16


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


def ab_palindrome(windows: dict, n_short: int, n_long: int, repeats: int) -> dict:
    """Seconds a unit of each of two window functions, run in one process in
    the order A B B A each repeat (which cancels a linear drift), a short
    and a long window at each turn; each side's rate from the minimum of
    each window length (the reference's ``benchmarks/_timing.py:44-69``,
    call for call). Wall times spread between calls on the card, so only
    such a palindrome ranks two variants. Returns ``{name: sec_per_unit}``."""
    names = list(windows)
    if len(names) != 2:
        raise ValueError(f"ab_palindrome compares two windows, got {names}")
    raw = {n: ([], []) for n in names}
    for _ in range(repeats):
        for n in (names[0], names[1], names[1], names[0]):
            raw[n][0].append(windows[n](n_short))
            raw[n][1].append(windows[n](n_long))
    return {n: (min(longs) - min(shorts)) / (n_long - n_short)
            for n, (shorts, longs) in raw.items()}


def step_window(step, state, batch, device, k: int = 1):
    """``window(n)`` for the estimators: n units of k train steps each,
    carrying ``state``, closed by :func:`sync`; returns the seconds."""
    def window(n):
        t = time.perf_counter()
        for _ in range(n * k):
            step(state, batch)
        sync(device)
        return time.perf_counter() - t

    return window


def ab_compare(windows: dict, counters: dict, n_short: int, n_long: int, repeats: int):
    """The bench entry points' A/B: each side's window warmed once (build,
    allocate), then :func:`ab_palindrome`. Returns ``(sec_per_unit,
    launches)``: for each side, the units its windows ran (``"steps"``,
    the warm one too) and how far each of ``counters`` (a name to a
    function reading that counter) moved while they ran, whatever the order
    of the sides' windows."""
    tallies = {name: dict.fromkeys(["steps", *counters], 0) for name in windows}

    def tallied(name):
        def run(n):
            before = {c: read() for c, read in counters.items()}
            sec = windows[name](n)
            tallies[name]["steps"] += n
            for c, read in counters.items():
                tallies[name][c] += read() - before[c]
            return sec

        return run

    runs = {name: tallied(name) for name in windows}
    for run in runs.values():
        run(n_short)
    return ab_palindrome(runs, n_short, n_long, repeats), tallies


def mfu(rate: float, flops_per_unit: float, device):
    """Model FLOPs utilisation of ``rate`` units a second at
    ``flops_per_unit`` each, against the card's dense bf16 peak; None off the
    card (a CPU rate is no device metric)."""
    if torch.device(device).type != "cuda":
        return None
    return round(rate * flops_per_unit / PEAK_FLOPS, 4)


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
