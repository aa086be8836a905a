"""The port's telemetry backends (``kubeflow_tpu_torch/telemetry/agent.py``)
handed to the reference's ``TelemetryAgent`` (``kubeflow_tpu/telemetry/agent.py``),
against the JAX backends they replace.

- The same steps on a fake clock give the same exposition through
  ``TorchDeviceBackend("cpu")`` as through ``JaxDeviceBackend``, but for
  ``tpu_device_count``: 1 (the port's CPU device) against the 8 CPU devices
  that ``tests/conftest.py`` pins JAX to. Both read zero bytes there (no
  memory statistics). ``compile_monitor`` is unset on both agents for this
  comparison: ``JaxCompileMonitor`` counts every XLA compile of this test
  process, so its totals are not reproducible.
- ``TorchCompileMonitor`` counts each source of ``ops/_build.py`` as one
  compile with its seconds on a first ``build_all()`` and as a cache hit on
  a second, against a stub ``nvcc`` that ``CUDA_HOME`` points at.
- The agent's ``/capture`` with ``TorchTraceProfiler``: 200 with one line a
  trace file, 503 when the profiler fails.
"""
from __future__ import annotations

import os

import pytest
from werkzeug.test import Client

from kubeflow_tpu.telemetry.agent import JaxDeviceBackend, TelemetryAgent
from kubeflow_tpu.webapps.metrics_source import parse_prometheus_text
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.telemetry import agent as tagent


class FakeClock:
    def __init__(self, t: float = 1_000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def _drive(backend):
    """An agent on ``backend``: three timed steps, a scrape mid-step, a
    last scrape; returns both scrapes."""
    clock = FakeClock()
    agent = TelemetryAgent(backend, clock=clock, window_s=30.0)
    scrapes = []
    for dur in (2.0, 0.5, 7.0):
        with agent.step():
            clock.advance(dur)
        clock.advance(1.0)
    with agent.step():
        clock.advance(3.0)
        scrapes.append(agent.exposition())
    clock.advance(4.0)
    scrapes.append(agent.exposition())
    return scrapes


def _without_device_count(text):
    return [line for line in text.splitlines() if "tpu_device_count" not in line]


def test_exposition_matches_the_jax_backend():
    port, ref = _drive(tagent.TorchDeviceBackend("cpu")), _drive(JaxDeviceBackend())
    for a, b in zip(port, ref):
        assert _without_device_count(a) == _without_device_count(b)
        fa, fb = parse_prometheus_text(a), parse_prometheus_text(b)
        assert fa["tpu_device_count"] == 1 and fb["tpu_device_count"] == 8
        assert fa["tpu_hbm_used_bytes"] == fa["tpu_hbm_total_bytes"] == 0
        assert fa["tpu_duty_cycle_known"] == 1    # derived from the step ring, as the reference's
    assert parse_prometheus_text(port[1])["tpu_step_total"] == 4


def test_device_backend_samples_like_the_jax_one():
    (s,) = tagent.TorchDeviceBackend("cpu").samples()
    (r, *_) = JaxDeviceBackend().samples()
    assert type(s).__slots__ == type(r).__slots__
    assert (s.duty_cycle, s.hbm_used_bytes, s.hbm_total_bytes) == (
        r.duty_cycle, r.hbm_used_bytes, r.hbm_total_bytes)


def test_device_backend_for_the_card_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagent.TorchDeviceBackend()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tagent.TorchDeviceBackend("tpu")


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A stub nvcc under ``CUDA_HOME`` that writes its ``-o`` target, and a
    build directory of the test's own."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    'echo "ptxas info    : Used 32 registers"\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_compile_monitor_counts_builds_then_cache_hits(stub_nvcc):
    monitor = tagent.TorchCompileMonitor()
    try:
        n = len(_build.SIGNATURES)
        assert monitor.totals() == (0, 0.0, 0)
        libs = _build.build_all()
        count, seconds, hits = monitor.totals()
        assert (count, hits) == (n, 0) and seconds > 0
        assert all(p.is_file() and p.parent == stub_nvcc for p in libs.values())
        assert "Used 32 registers" in _build.build_log("flash_decode")
        _build.build_all()
        assert monitor.totals() == (n, seconds, n)
        # the agent's compile families, fed by the monitor
        agent = TelemetryAgent(tagent.TorchDeviceBackend("cpu"), clock=FakeClock(),
                               compile_monitor=monitor)
        families = parse_prometheus_text(agent.exposition())
        assert families["tpu_compile_total"] == n
        assert families["tpu_compile_cache_hits_total"] == n
        assert families["tpu_compile_seconds_total"] == pytest.approx(seconds)
    finally:
        monitor.close()
    _build.build_all()
    assert monitor.totals() == (n, seconds, n)      # closed: no longer counting


def test_agent_capture_endpoint_with_the_torch_profiler(tmp_path):
    profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path / "caps"), step_hint_s=0.05)
    agent = TelemetryAgent(tagent.TorchDeviceBackend("cpu"), clock=FakeClock(),
                           profiler=profiler)
    resp = Client(agent.wsgi).get("/capture?steps=2")
    assert resp.status_code == 200
    lines = resp.get_data(as_text=True).strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("# file=plugins/profile/")
    assert os.path.isfile(tmp_path / "caps" / "capture-1" / lines[0].split()[1][5:])
    # a profiler that fails (its log directory lies under a file): 503
    (tmp_path / "blocker").write_text("")
    agent.profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path / "blocker" / "x"),
                                               step_hint_s=0.05)
    resp = Client(agent.wsgi).get("/capture?steps=2")
    assert resp.status_code == 503
