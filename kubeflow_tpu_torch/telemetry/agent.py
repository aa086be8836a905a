"""The in-pod telemetry agent's PyTorch backends; counterparts of the three
JAX-bound classes of ``kubeflow_tpu/telemetry/agent.py``.

They are duck-typed to the agent's interfaces (``samples()``, ``totals()``,
``capture(steps)``), so the reference's ``TelemetryAgent``, which imports no
JAX itself, runs on them unchanged:

- :class:`TorchDeviceBackend` (``JaxDeviceBackend``): a sample for each
  visible card, its bytes in use the allocator's bytes of this process and
  its total the card's memory; the duty cycle is left to the agent's step
  ring, as the reference's is;
- :class:`TorchCompileMonitor` (``JaxCompileMonitor``): the port's runtime
  compiles are the ``nvcc`` builds of ``ops/_build.py``; it counts each build
  with its seconds, and each kernel found already built as a cache hit. The
  port does not use ``torch.compile``, so there is nothing else to count;
- :class:`TorchTraceProfiler` (``JaxTraceProfiler``): a bounded capture of
  the process, asked for from the caller's thread while the training loop
  runs in another; it runs on the loop's thread between its step
  boundaries where the loop wraps its steps in
  ``kubeflow_tpu_torch.utils.profiling.step_annotation``
  (``utils/profiling.capture_window`` says why).

The agent's step hook wraps each step in the reference's JAX step
annotation, which an image without JAX replaces by a null context: a torch
trace carries the agent's step numbers only where the loop also wraps its
steps in ``kubeflow_tpu_torch.utils.profiling.step_annotation``.
"""
from __future__ import annotations

import os
import threading

import torch


class DeviceSample:
    """One device's reading. ``duty_cycle=None`` means the backend cannot
    measure it; the agent derives it from step timing."""

    __slots__ = ("duty_cycle", "hbm_used_bytes", "hbm_total_bytes")

    def __init__(self, *, duty_cycle: float | None, hbm_used_bytes: float,
                 hbm_total_bytes: float) -> None:
        self.duty_cycle = duty_cycle
        self.hbm_used_bytes = hbm_used_bytes
        self.hbm_total_bytes = hbm_total_bytes


class TorchDeviceBackend:
    """Reads this host's cards through ``torch.cuda``; ``device="cpu"`` is
    one device without memory statistics (zeros), as a JAX CPU device."""

    def __init__(self, device: str = "cuda") -> None:
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: TorchDeviceBackend reads the cards "
                               "(pass device='cpu' for a host without one)")
        self.device = device

    def samples(self) -> list[DeviceSample]:
        if self.device == "cpu":
            return [DeviceSample(duty_cycle=None, hbm_used_bytes=0.0, hbm_total_bytes=0.0)]
        return [DeviceSample(duty_cycle=None,     # derived from the step ring
                             hbm_used_bytes=float(torch.cuda.memory_allocated(i)),
                             hbm_total_bytes=float(torch.cuda.mem_get_info(i)[1]))
                for i in range(torch.cuda.device_count())]


class TorchCompileMonitor:
    """Cumulative (count, seconds, cache hits) of the port's kernel builds,
    from ``ops/_build.py``'s listener hook, from its construction on."""

    def __init__(self) -> None:
        from kubeflow_tpu_torch.ops import _build

        self._count = 0
        self._seconds = 0.0
        self._cache_hits = 0
        self._lock = threading.Lock()
        self._build = _build
        _build.add_listener(self._on_build)

    def _on_build(self, name: str, seconds: float | None) -> None:
        with self._lock:
            if seconds is None:
                self._cache_hits += 1
            else:
                self._count += 1
                self._seconds += max(0.0, seconds)

    def totals(self) -> tuple[int, float, int]:
        with self._lock:
            return self._count, self._seconds, self._cache_hits

    def close(self) -> None:
        """Stop counting."""
        self._build.remove_listener(self._on_build)


class TorchTraceProfiler:
    """Real capture backend: traces the live process for a bounded window
    sized to ``steps`` recent step durations and returns one line for each
    file the trace wrote. Any failure raises and the capture endpoint
    reports it."""

    def __init__(self, *, logdir_base: str = "/tmp/tpu-profiles", step_hint_s: float = 1.0,
                 max_window_s: float = 30.0) -> None:
        self.logdir_base = logdir_base
        self.step_hint_s = step_hint_s
        self.max_window_s = max_window_s
        self._captures = 0
        self.last_route: str | None = None    # capture_window's route, "loop" or "caller"

    def capture(self, steps: int) -> str:
        """Trace ``steps`` step hints (at most ``max_window_s``); a loop that
        is stepping is waited for up to ten windows (1 s at least, at most
        ``max_window_s``) to start its next step."""
        from kubeflow_tpu_torch.utils.profiling import capture_window

        self._captures += 1
        logdir = os.path.join(self.logdir_base, f"capture-{self._captures}")
        window = min(self.max_window_s, max(0.1, steps * self.step_hint_s))
        self.last_route = capture_window(
            logdir, window, pickup_s=min(self.max_window_s, max(1.0, 10 * window)))
        parts = []
        for root, _dirs, files in os.walk(logdir):
            for f in sorted(files):
                path = os.path.join(root, f)
                parts.append(f"# file={os.path.relpath(path, logdir)} "
                             f"bytes={os.path.getsize(path)}")
        return "\n".join(parts) + "\n"
