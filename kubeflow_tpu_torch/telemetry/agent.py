"""The in-pod telemetry agent of the PyTorch port; counterpart of
``kubeflow_tpu/telemetry/agent.py``.

:class:`TelemetryAgent` answers the collector's scrape with Prometheus text
(the port's ``utils/metrics.Registry``, the reference's families and bytes):
device memory, the duty cycle derived from its step ring, step timing and
the per-step record stream, compile totals; and it runs on-demand captures.
Its step hook, ``agent.step()``, wraps each step in the port's
``utils/profiling.step_annotation(n)``: a torch trace then holds a
``train#n`` region for each of the agent's step numbers, and a capture asked
for from another thread (``agent.capture``, the ``/capture`` endpoint) runs
on the stepping loop's thread between its steps (``capture_window``'s
"loop" route). :class:`StepRing` and the deterministic doubles
(:class:`FakeDeviceBackend`, :class:`FakeStepSchedule`,
:class:`FakeCompileSchedule`, :class:`FakeProfiler`) are the reference's.

The backends for the card, counterparts of the reference's three JAX-bound
classes, are duck-typed to the agent's interfaces (``samples()``,
``totals()``, ``capture(steps)``):

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

The agent's own default is :class:`TorchDeviceBackend` (the card), as
the reference's is ``JaxDeviceBackend``; :func:`main`, the notebook image's
entry point, serves an agent on all three backends.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Iterator, Sequence

import torch

from kubeflow_tpu_torch.telemetry import (
    CAPTURE_DEFAULT_STEPS,
    CAPTURE_MAX_STEPS,
    CAPTURE_PATH,
    FAMILY_COMPILE_CACHE_HITS,
    FAMILY_COMPILE_SECONDS,
    FAMILY_COMPILE_TOTAL,
    FAMILY_DEVICE_COUNT,
    FAMILY_DUTY_CYCLE,
    FAMILY_DUTY_KNOWN,
    FAMILY_HBM_TOTAL,
    FAMILY_HBM_USED,
    FAMILY_STEP_END,
    FAMILY_STEP_START,
    FAMILY_STEP_TOTAL,
    STEP_WINDOW,
)
from kubeflow_tpu_torch.utils.metrics import Registry

# step durations span ms (decode loops) to minutes (full eval passes)
STEP_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)
DEFAULT_WINDOW_S = 60.0
DEFAULT_RING_LEN = 512


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


class FakeDeviceBackend:
    """Deterministic device double for tests and the chaos soak: an explicit
    duty cycle and HBM split across ``devices`` fake devices; ``jitter``
    perturbs the duty cycle a read from a seeded PRNG."""

    def __init__(self, *, duty_cycle: float = 0.0, hbm_used_bytes: float = 0.0,
                 hbm_total_bytes: float = float(16 << 30), devices: int = 4,
                 jitter: float = 0.0, seed: int = 0) -> None:
        import random

        self.duty_cycle = duty_cycle
        self.hbm_used_bytes = hbm_used_bytes
        self.hbm_total_bytes = hbm_total_bytes
        self.devices = max(1, devices)
        self.jitter = jitter
        self._rng = random.Random(f"fake-devices-{seed}")

    def set_duty_cycle(self, duty_cycle: float) -> None:
        self.duty_cycle = duty_cycle

    def set_hbm(self, used_bytes: float, total_bytes: float | None = None) -> None:
        self.hbm_used_bytes = used_bytes
        if total_bytes is not None:
            self.hbm_total_bytes = total_bytes

    def samples(self) -> list[DeviceSample]:
        out = []
        for _ in range(self.devices):
            duty = self.duty_cycle
            if self.jitter:
                duty += self._rng.uniform(-self.jitter, self.jitter)
            out.append(DeviceSample(duty_cycle=min(1.0, max(0.0, duty)),
                                    hbm_used_bytes=self.hbm_used_bytes / self.devices,
                                    hbm_total_bytes=self.hbm_total_bytes / self.devices))
        return out


class FakeStepSchedule:
    """Deterministic per-host step stream, a pure function of the clock: step
    i (1-based) starts at ``start_at + (behind_steps + i - 1) * period_s``
    and runs ``duration_s * slow_factor`` (plus seeded per-step jitter,
    capped at the period). A slow host (``slow_factor > 1``), a lagging one
    (``behind_steps > 0``) and a stalled one (``stall_after=N``: step N + 1
    opens and never ends) are the shapes the gang aggregator must catch."""

    def __init__(self, *, period_s: float = 10.0, duration_s: float = 8.0,
                 start_at: float = 0.0, slow_factor: float = 1.0, behind_steps: int = 0,
                 stall_after: int | None = None, jitter_s: float = 0.0, seed: int = 0) -> None:
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.period_s = period_s
        self.duration_s = duration_s
        self.start_at = start_at
        self.slow_factor = slow_factor
        self.behind_steps = max(0, behind_steps)
        self.stall_after = stall_after
        self.jitter_s = jitter_s
        self.seed = seed

    def _duration(self, step: int) -> float:
        dur = self.duration_s * self.slow_factor
        if self.jitter_s:
            # a seeded per-step hash (Weyl/Knuth mix)
            x = (step * 2654435761 + self.seed * 40503 + 12345) % (1 << 32)
            dur += (x / float(1 << 32) - 0.5) * 2.0 * self.jitter_s
        return max(0.001, min(self.period_s, dur))

    def _start(self, step: int) -> float:
        return self.start_at + (self.behind_steps + step - 1) * self.period_s

    def window(self, now: float, n: int
               ) -> tuple[list[tuple[int, float, float]], tuple[int, float] | None, int]:
        """(the last <= n completed records, the open interval, completed total)."""
        if now < self._start(1):
            return [], None, 0
        started = int((now - self._start(1)) // self.period_s) + 1
        completed = started
        if self._start(started) + self._duration(started) > now:
            completed = started - 1
        if self.stall_after is not None:
            completed = min(completed, self.stall_after)
        records = [(i, self._start(i), self._start(i) + self._duration(i))
                   for i in range(max(1, completed - n + 1), completed + 1)]
        open_: tuple[int, float] | None = None
        nxt = completed + 1
        if self._start(nxt) <= now:
            # a stalled host holds its next step open for ever; a healthy one
            # shows the one in flight
            if self.stall_after is None or nxt == self.stall_after + 1:
                open_ = (nxt, self._start(nxt))
        return records, open_, completed


class FakeCompileSchedule:
    """Deterministic compile-event stream, a pure function of the clock: a
    healthy host compiles ``warmup_compiles`` times at ``start_at`` and then
    only hits the cache; a storm host (``recompile_every_s``) keeps
    recompiling."""

    def __init__(self, *, start_at: float = 0.0, warmup_compiles: int = 2,
                 compile_s: float = 3.0, recompile_every_s: float | None = None,
                 hit_every_s: float | None = 30.0, seed: int = 0) -> None:
        self.start_at = start_at
        self.warmup_compiles = max(0, warmup_compiles)
        self.compile_s = compile_s
        self.recompile_every_s = recompile_every_s
        self.hit_every_s = hit_every_s
        self.seed = seed

    def _duration(self, i: int) -> float:
        x = (i * 2654435761 + self.seed * 40503 + 97531) % (1 << 32)
        return self.compile_s * (0.75 + 0.5 * (x / float(1 << 32)))

    def totals(self, now: float) -> tuple[int, float, int]:
        """Cumulative (compile count, compile seconds, cache hits) at ``now``."""
        if now < self.start_at:
            return 0, 0.0, 0
        count = self.warmup_compiles
        if self.recompile_every_s:
            count += int((now - self.start_at) // self.recompile_every_s)
        seconds = sum(self._duration(i) for i in range(count))
        hits = int((now - self.start_at) // self.hit_every_s) if self.hit_every_s else 0
        return count, seconds, hits


class FakeProfiler:
    """Deterministic capture backend: a trace payload from the host, the
    requested step count, the step schedule's window at capture time and the
    seed; the same request against the same clock gives the same text."""

    def __init__(self, *, host: str = "host", seed: int = 0,
                 clock: Callable[[], float] = time.time,
                 step_schedule: FakeStepSchedule | None = None,
                 fail_every: int | None = None) -> None:
        self.host = host
        self.seed = seed
        self.clock = clock
        self.step_schedule = step_schedule
        self.fail_every = fail_every
        self.captures = 0

    def capture(self, steps: int) -> str:
        self.captures += 1
        if self.fail_every and self.captures % self.fail_every == 0:
            raise RuntimeError(f"fake profiler fault on {self.host}")
        base = 0
        if self.step_schedule is not None:
            _, _, base = self.step_schedule.window(self.clock(), 1)
        lines = [f"# fake-xla-trace host={self.host} steps={steps} seed={self.seed} "
                 f"from_step={base + 1}"]
        for i in range(steps):
            x = ((base + i) * 2654435761 + self.seed * 40503 + 777) % (1 << 32)
            lines.append(f"step={base + 1 + i} device_us={x % 100000} op=fusion.{x % 97}")
        return "\n".join(lines) + "\n"


class StepRing:
    """Bounded ring of (step, start, end) intervals; the duty cycle is the
    fraction of a trailing window they cover (steps never overlap). The step
    running now is an open interval counted up to ``now``; ``has_signal()``
    says whether any step was ever recorded."""

    def __init__(self, maxlen: int = DEFAULT_RING_LEN) -> None:
        self.maxlen = maxlen
        self._steps: list[tuple[int, float, float]] = []
        self._open: tuple[int, float] | None = None
        self._lock = threading.Lock()

    def begin(self, step: int, start: float) -> None:
        with self._lock:
            self._open = (step, start)

    def add(self, step: int, start: float, end: float) -> None:
        with self._lock:
            if self._open is not None and self._open[0] == step:
                self._open = None
            self._steps.append((step, start, max(start, end)))
            if len(self._steps) > self.maxlen:
                del self._steps[: len(self._steps) - self.maxlen]

    def has_signal(self) -> bool:
        with self._lock:
            return bool(self._steps) or self._open is not None

    def busy_fraction(self, window_s: float, now: float) -> float:
        if window_s <= 0:
            return 0.0
        cutoff = now - window_s
        with self._lock:
            busy = sum(max(0.0, min(end, now) - max(start, cutoff))
                       for _, start, end in self._steps if end > cutoff)
            if self._open is not None:
                busy += max(0.0, now - max(self._open[1], cutoff))
        return min(1.0, busy / window_s)

    def last(self) -> tuple[int, float, float] | None:
        with self._lock:
            return self._steps[-1] if self._steps else None

    def recent(self, n: int) -> tuple[list[tuple[int, float, float]], tuple[int, float] | None]:
        """The last ``n`` completed (step, start, end) records and the open
        (step, start) interval, if any."""
        with self._lock:
            return list(self._steps[-n:]), self._open

    def replace(self, steps: Sequence[tuple[int, float, float]],
                open_: tuple[int, float] | None) -> None:
        """Install a whole window at once (the schedule-driven fakes)."""
        with self._lock:
            self._steps = list(steps)[-self.maxlen:]
            self._open = open_


class TelemetryAgent:
    """One host's device and step signals in a registry, served as
    Prometheus text, pre-aggregated across local devices (mean duty cycle,
    summed memory) into unlabeled families, with the reference's names and
    help texts. ``backend`` defaults to :class:`TorchDeviceBackend` (the
    card: it raises without one; pass ``TorchDeviceBackend("cpu")`` or a
    fake on a host without one)."""

    def __init__(self, backend=None, *, registry: Registry | None = None,
                 clock: Callable[[], float] = time.time, window_s: float = DEFAULT_WINDOW_S,
                 ring_len: int = DEFAULT_RING_LEN, step_schedule: FakeStepSchedule | None = None,
                 step_window: int = STEP_WINDOW, compile_monitor=None,
                 compile_schedule: FakeCompileSchedule | None = None, profiler=None) -> None:
        self.backend = backend or TorchDeviceBackend()
        self.clock = clock
        self.window_s = window_s
        self.step_schedule = step_schedule
        self.step_window = step_window
        self.compile_monitor = compile_monitor
        self.compile_schedule = compile_schedule
        self.profiler = profiler
        self.ring = StepRing(ring_len)
        self.registry = registry or Registry()
        reg = self.registry
        self.duty = reg.gauge(
            FAMILY_DUTY_CYCLE, "Fraction of the trailing window the TPU devices were busy, 0..1")
        self.duty_known = reg.gauge(
            FAMILY_DUTY_KNOWN,
            "1 when tpu_duty_cycle is a real measurement; 0 when the agent "
            "has no duty signal (unknown must not read as idle)")
        self.hbm_used = reg.gauge(FAMILY_HBM_USED, "HBM bytes in use across this host's devices")
        self.hbm_total = reg.gauge(FAMILY_HBM_TOTAL,
                                   "HBM bytes available across this host's devices")
        self.device_count = reg.gauge(FAMILY_DEVICE_COUNT, "TPU devices visible to this host")
        self.steps = reg.counter(FAMILY_STEP_TOTAL, "Steps executed through the agent's step hook")
        self.step_duration = reg.histogram(
            "tpu_step_duration_seconds", "Wall time of one user step (agent step hook)",
            buckets=STEP_BUCKETS)
        self.step_start = reg.gauge(
            FAMILY_STEP_START,
            "Wall start timestamp of a recent step (labeled by step id; the "
            "currently-open step has a start but no end sample)",
            labelnames=("step",))
        self.step_end = reg.gauge(
            FAMILY_STEP_END, "Wall end timestamp of a recent completed step (labeled by id)",
            labelnames=("step",))
        self.compiles = reg.counter(FAMILY_COMPILE_TOTAL,
                                    "XLA compilations observed on this host (jax.monitoring)")
        self.compile_seconds = reg.counter(FAMILY_COMPILE_SECONDS,
                                           "Cumulative seconds this host spent in XLA compilation")
        self.compile_cache_hits = reg.counter(FAMILY_COMPILE_CACHE_HITS,
                                              "Compilation-cache hits observed on this host")
        self._compile_synced = (0, 0.0, 0)
        self._step_counter = 0
        self._sched_total = 0       # schedule: completed steps already synced
        self._sched_observed = 0    # schedule: highest step id histogrammed
        self._step_lock = threading.Lock()
        reg.pre_expose(self.sample)

    @contextlib.contextmanager
    def step(self) -> Iterator[int]:
        """Time one user step, inside ``step_annotation(n)``: the scrape's
        step n and a trace's ``train#n`` region are the same step, and the
        step's boundaries are where a capture asked for from another thread
        starts and stops on this one."""
        from kubeflow_tpu_torch.utils.profiling import step_annotation

        with self._step_lock:
            self._step_counter += 1
            n = self._step_counter
        t0 = self.clock()
        self.ring.begin(n, t0)        # a scrape mid-step sees the open interval
        try:
            with step_annotation(n):
                yield n
        finally:
            t1 = self.clock()
            self.ring.add(n, t0, t1)
            self.steps.inc()
            self.step_duration.observe(max(0.0, t1 - t0))

    def _sync_schedule(self) -> None:
        """Fold the fake schedule's stream into the ring and the cumulative
        families (by the completed-step delta)."""
        steps, open_, total = self.step_schedule.window(self.clock(), self.step_window)
        delta = total - self._sched_total
        if delta > 0:
            self.steps.inc(delta)
            self._sched_total = total
        for s, t0, t1 in steps:
            if s > self._sched_observed:
                self.step_duration.observe(max(0.0, t1 - t0))
                self._sched_observed = s
        self.ring.replace(steps, open_)
        self._step_counter = max(self._step_counter, total)

    def _export_steps(self) -> None:
        """Republish the ring's recent window as the labeled step stream."""
        steps, open_ = self.ring.recent(self.step_window)
        self.step_start.clear()
        self.step_end.clear()
        for s, t0, t1 in steps:
            self.step_start.set(t0, step=str(s))
            self.step_end.set(t1, step=str(s))
        if open_ is not None:
            self.step_start.set(open_[1], step=str(open_[0]))

    def _sync_compiles(self) -> None:
        """Fold the compile source's cumulative totals into the families by
        delta; a total that went back (a restarted source) re-bases at 0."""
        if self.compile_schedule is not None:
            totals = self.compile_schedule.totals(self.clock())
        elif self.compile_monitor is not None:
            try:
                totals = self.compile_monitor.totals()
            except Exception:
                return          # a monitor hiccup: the families stay where they are
        else:
            return
        count, seconds, hits = totals
        pc, ps, ph = self._compile_synced
        if count < pc or seconds < ps or hits < ph:
            pc, ps, ph = 0, 0.0, 0
        if count > pc:
            self.compiles.inc(count - pc)
        if seconds > ps:
            self.compile_seconds.inc(seconds - ps)
        if hits > ph:
            self.compile_cache_hits.inc(hits - ph)
        self._compile_synced = (count, seconds, hits)

    def sample(self) -> None:
        """Refresh the gauges from the backend, the duty cycle from the step
        ring where the backend cannot measure it."""
        if self.step_schedule is not None:
            self._sync_schedule()
        self._export_steps()
        self._sync_compiles()
        try:
            samples: Sequence[DeviceSample] = self.backend.samples()
        except Exception:
            samples = []        # a device runtime hiccup: keep serving the last values
        if not samples:
            return
        duties = [s.duty_cycle for s in samples if s.duty_cycle is not None]
        if duties:
            duty, known = sum(duties) / len(duties), True
        elif self.ring.has_signal():
            duty, known = self.ring.busy_fraction(self.window_s, self.clock()), True
        else:
            # a blind backend and a loop that never stepped through the agent:
            # unknown, not idle
            duty, known = 0.0, False
        self.duty.set(duty)
        self.duty_known.set(1.0 if known else 0.0)
        self.hbm_used.set(sum(s.hbm_used_bytes for s in samples))
        self.hbm_total.set(sum(s.hbm_total_bytes for s in samples))
        self.device_count.set(len(samples))

    def exposition(self) -> str:
        return self.registry.expose()        # its pre_expose hook runs sample()

    def capture(self, steps: int = CAPTURE_DEFAULT_STEPS) -> str:
        """One bounded trace capture through the profiler backend; returns
        its payload."""
        if steps <= 0 or steps > CAPTURE_MAX_STEPS:
            raise ValueError(f"steps must be in 1..{CAPTURE_MAX_STEPS}, got {steps}")
        if self.profiler is None:
            raise RuntimeError("no profiler backend configured")
        return self.profiler.capture(steps)

    def _capture_wsgi(self, environ, start_response):
        import urllib.parse

        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", "") or "")
        try:
            steps = int(qs.get("steps", [str(CAPTURE_DEFAULT_STEPS)])[0])
        except ValueError:
            steps = -1
        try:
            body, status = self.capture(steps).encode(), "200 OK"
        except ValueError as e:
            body, status = str(e).encode(), "400 Bad Request"
        except Exception as e:  # no backend, or it failed mid-capture: the caller retries
            body, status = str(e).encode(), "503 Service Unavailable"
        start_response(status, [("Content-Type", "text/plain"),
                                ("Content-Length", str(len(body)))])
        return [body]

    def wsgi(self, environ, start_response):
        """The scrape endpoint (GET <any path>) and the capture endpoint
        (GET /capture?steps=N)."""
        if (environ.get("PATH_INFO", "") or "/") == CAPTURE_PATH:
            return self._capture_wsgi(environ, start_response)
        body = self.exposition().encode()
        start_response("200 OK", [("Content-Type", "text/plain; version=0.0.4"),
                                  ("Content-Length", str(len(body)))])
        return [body]

    def serve(self, port: int, host: str = "0.0.0.0") -> threading.Thread:
        """Serve both endpoints from a daemon thread; returns it."""
        from wsgiref.simple_server import make_server

        server = make_server(host, port, self.wsgi)
        t = threading.Thread(target=server.serve_forever, daemon=True, name="telemetry-agent")
        t.start()
        return t


def main() -> None:
    """Entry point for the notebook image: serve the card's telemetry on
    TELEMETRY_PORT (env-overridable) until the pod dies, with the port's
    three backends."""
    from kubeflow_tpu_torch.telemetry import TELEMETRY_PORT

    agent = TelemetryAgent(TorchDeviceBackend(), compile_monitor=TorchCompileMonitor(),
                           profiler=TorchTraceProfiler())
    agent.serve(int(os.environ.get("TELEMETRY_PORT", str(TELEMETRY_PORT))))
    threading.Event().wait()


if __name__ == "__main__":
    main()
