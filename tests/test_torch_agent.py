"""The port's telemetry agent (``kubeflow_tpu_torch/telemetry/agent.py``)
against the reference's (``kubeflow_tpu/telemetry/agent.py``), and its step
hook in a torch trace.

The two agents get the same fake backends (``FakeDeviceBackend``,
``FakeStepSchedule``, ``FakeCompileSchedule``, ``FakeProfiler``; each side its
own copy of the same settings), the same fake clock and the same steps
through ``agent.step()``; their Prometheus texts, capture payloads and
endpoint answers must be equal byte for byte. Then the port's agent on the
CPU: a loop that steps only through ``agent.step()`` inside a torch trace
gets a ``train#n`` region for each of the agent's step numbers, and a
capture asked for through the agent from another thread
(``TorchTraceProfiler``) runs on the loop's thread (route "loop") and holds
whole steps, each one of the agent's."""
from __future__ import annotations

import json
import threading

import pytest
import torch

from kubeflow_tpu.telemetry import agent as ref
from kubeflow_tpu_torch.telemetry import agent as port
from kubeflow_tpu_torch.utils.profiling import trace


class _Clock:
    """A clock that moves ``tick`` seconds at every read."""

    def __init__(self, start: float = 1000.0, tick: float = 0.37) -> None:
        self.now, self.tick = start, tick

    def __call__(self) -> float:
        self.now += self.tick
        return self.now


class _Blind:
    """A backend that cannot measure the duty cycle (as the card's cannot):
    the agent derives it from its step ring."""

    def __init__(self, mod) -> None:
        self.mod = mod

    def samples(self):
        return [self.mod.DeviceSample(duty_cycle=None, hbm_used_bytes=2e9, hbm_total_bytes=8e10)]


def _agents(**settings):
    """(reference agent, port agent) built from the same settings, each with
    its own module's fakes and its own clock."""
    out = []
    for mod in (ref, port):
        clock = _Clock()
        backend = (_Blind(mod) if settings.get("blind")
                   else mod.FakeDeviceBackend(**settings.get("device", {})))
        kw = dict(clock=clock, backend=backend)
        if "steps" in settings:
            kw["step_schedule"] = mod.FakeStepSchedule(**settings["steps"])
        if "compiles" in settings:
            kw["compile_schedule"] = mod.FakeCompileSchedule(**settings["compiles"])
        if "profiler" in settings:
            kw["profiler"] = mod.FakeProfiler(clock=clock, step_schedule=kw.get("step_schedule"),
                                              **settings["profiler"])
        out.append(mod.TelemetryAgent(window_s=settings.get("window_s", 60.0), **kw))
    return out


SETTINGS = {
    "hooked_steps": dict(blind=True, window_s=2.0),
    "duty_from_backend": dict(device=dict(duty_cycle=0.42, hbm_used_bytes=1.5e9, devices=4,
                                          jitter=0.05, seed=3)),
    "schedules": dict(device=dict(devices=8), steps=dict(period_s=2.0, duration_s=1.5,
                                                         start_at=1000.0, jitter_s=0.2, seed=1),
                      compiles=dict(start_at=1000.0, recompile_every_s=3.0, hit_every_s=1.0),
                      profiler=dict(host="h0", seed=5)),
    "stalled_host": dict(steps=dict(period_s=1.0, duration_s=0.5, start_at=1000.0,
                                    stall_after=3)),
    "no_signal": dict(),
}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_the_scrape_equals_the_references(name):
    """Scrapes before, between and after steps, and the steps' own
    numbers, are the reference agent's."""
    a, b = _agents(**SETTINGS[name])
    assert b.exposition() == a.exposition()
    hooked = name in ("hooked_steps", "duty_from_backend")
    for _ in range(3 if hooked else 0):
        with a.step() as na, b.step() as nb:
            assert nb == na
            assert b.exposition() == a.exposition()      # mid-step: the open interval
    for _ in range(4):
        assert b.exposition() == a.exposition()
    if "profiler" in SETTINGS[name]:
        assert b.capture(3) == a.capture(3)
        assert b.capture() == a.capture()


def test_the_endpoints_answer_as_the_references():
    """The scrape and capture endpoints: status, headers and body, for a
    good request, an out-of-range one and an agent without a profiler."""
    for settings in (SETTINGS["schedules"], SETTINGS["no_signal"]):
        a, b = _agents(**settings)
        for path, query in (("/metrics", ""), ("/capture", "steps=2"), ("/capture", "steps=0"),
                            ("/capture", "steps=x"), ("/capture", "steps=65")):
            got = []
            for agent in (a, b):
                seen = {}
                body = agent.wsgi({"PATH_INFO": path, "QUERY_STRING": query},
                                  lambda status, headers: seen.update(status=status,
                                                                      headers=headers))
                got.append((seen["status"], seen["headers"], b"".join(body)))
            assert got[1] == got[0], (path, query)


def test_the_ring_and_the_fakes_are_the_references():
    ring_a, ring_b = ref.StepRing(4), port.StepRing(4)
    for ring in (ring_a, ring_b):
        ring.begin(1, 10.0)
        for i in range(1, 7):
            ring.add(i, 10.0 * i, 10.0 * i + 6.0)
        ring.begin(7, 70.0)
    for now in (71.0, 75.0, 100.0):
        assert ring_b.busy_fraction(30.0, now) == ring_a.busy_fraction(30.0, now)
    assert ring_b.recent(3) == ring_a.recent(3) and ring_b.last() == ring_a.last()
    sched = dict(period_s=3.0, duration_s=2.0, start_at=5.0, slow_factor=1.2, behind_steps=2,
                 jitter_s=0.5, seed=9)
    for now in (0.0, 5.0, 17.3, 60.0):
        assert port.FakeStepSchedule(**sched).window(now, 4) == \
            ref.FakeStepSchedule(**sched).window(now, 4)
        assert port.FakeCompileSchedule(recompile_every_s=7.0).totals(now) == \
            ref.FakeCompileSchedule(recompile_every_s=7.0).totals(now)


def _regions(logdir):
    """The ``train#n`` step numbers in the Chrome traces under ``logdir``."""
    steps = []
    for f in sorted(logdir.rglob("*.pt.trace.json")):
        for e in json.loads(f.read_text())["traceEvents"]:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train#"):
                steps.append(int(e["name"][len("train#"):]))
    return sorted(steps)


def _work():
    x = torch.randn(64, 64)
    return (x @ x).sum()


def test_a_loop_stepping_through_the_agent_has_its_step_regions(tmp_path):
    agent = port.TelemetryAgent(port.TorchDeviceBackend("cpu"))
    numbers = []
    with trace(str(tmp_path)):
        for _ in range(3):
            with agent.step() as n:
                numbers.append(n)
                _work()
    assert numbers == [1, 2, 3]
    assert _regions(tmp_path) == numbers
    assert "tpu_step_total 3" in agent.exposition().splitlines()


def test_a_capture_through_the_agent_runs_on_the_loop_thread(tmp_path):
    """A capture asked for through the agent from another thread while the
    loop steps only through ``agent.step()``: route "loop", and the trace's
    regions are whole steps of the loop, numbered as the agent numbers
    them; the scrape counts every step."""
    profiler = port.TorchTraceProfiler(logdir_base=str(tmp_path), step_hint_s=0.05)
    agent = port.TelemetryAgent(port.TorchDeviceBackend("cpu"), profiler=profiler)
    numbers, payload = [], {}
    with agent.step() as n:           # the loop is stepping before the request
        numbers.append(n)
    capture = threading.Thread(target=lambda: payload.update(text=agent.capture(2)))
    capture.start()
    while len(numbers) < 6 or capture.is_alive():
        with agent.step() as n:
            numbers.append(n)
            _work()
    capture.join()
    assert profiler.last_route == "loop"
    assert payload["text"].startswith("# file=")
    got = _regions(tmp_path)
    assert got and got == list(range(got[0], got[0] + len(got))) and set(got) <= set(numbers)
    assert f"tpu_step_total {len(numbers)}" in agent.exposition().splitlines()
