"""Device timing for the probes' ``main()``: CUDA events around calls that
queue behind a spin kernel, and the card's name and power limit."""
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
