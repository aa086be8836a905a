"""The port's profiling (``kubeflow_tpu_torch/utils/profiling.py``) against the
reference's (``kubeflow_tpu/utils/profiling.py``): the trace directory layout
beside the reference's own trace (``tests/test_aux.py:173-193``), the skip
on a worker other than 0, ``trace_n_steps`` (its error, the warm-up outside
the trace, a step region a traced step), the annotations, and the live
server's singleton rules (``tests/test_telemetry.py:268-345``) with one real
capture over HTTP; and the port's own capture routes (``capture_window``): a
capture asked for from another thread runs on a stepping loop's thread, or
on the caller's where no loop steps, and its failures reach the caller and
not the loop. On the CPU a trace holds the host's operators; the card's
kernels in a trace are checked on the card (``chip_smoke.py``)."""
from __future__ import annotations

import functools
import json
import os
import re
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.utils import profiling as jprof
from kubeflow_tpu_torch.telemetry import agent as tagent
from kubeflow_tpu_torch.utils import profiling as tprof


def _trace_files(logdir):
    return [os.path.join(root, f) for root, _, files in os.walk(logdir) for f in files]


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_trace_writes_the_references_profile_layout(tmp_path):
    with jprof.trace(str(tmp_path / "jax")):
        jnp.dot(jnp.ones((64, 64)), jnp.ones((64, 64))).block_until_ready()
    with tprof.trace(str(tmp_path / "torch")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    for side in ("jax", "torch"):
        profile = tmp_path / side / "plugins" / "profile"
        assert os.path.isdir(profile) and len(os.listdir(profile)) == 1  # one capture
    (run,) = os.listdir(tmp_path / "torch" / "plugins" / "profile")
    (f,) = os.listdir(tmp_path / "torch" / "plugins" / "profile" / run)
    assert f.endswith(".pt.trace.json")
    assert any("mm" in e.get("name", "") for e in _events(
        tmp_path / "torch" / "plugins" / "profile" / run / f))


def test_trace_skips_non_coordinator(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", "2")
    for impl, d in ((jprof, "jax"), (tprof, "torch")):
        with impl.trace(str(tmp_path / d), host_only_on_coordinator=True):
            pass
        assert not os.path.exists(tmp_path / d)
    with tprof.trace(str(tmp_path / "all")):      # every worker traces by default
        pass
    assert os.path.isdir(tmp_path / "all" / "plugins" / "profile")


@pytest.mark.parametrize("steps", [0, -2])
def test_trace_n_steps_rejects_non_positive_steps(tmp_path, steps):
    for impl in (jprof, tprof):
        with pytest.raises(ValueError, match="steps must be positive"):
            impl.trace_n_steps(str(tmp_path), lambda s, b: (s, {}), None, None, steps=steps)


def test_trace_n_steps_warms_up_outside_the_trace(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(state)
        with tprof.annotate("body"):
            out = batch @ batch
        return state + 1, {"loss": out.sum()}

    state, metrics = tprof.trace_n_steps(str(tmp_path), step_fn, 0, torch.ones(8, 8), steps=3)
    assert calls == [0, 1, 2, 3] and state == 4      # steps + 1 calls
    assert float(metrics["loss"]) == 512.0
    (path,) = _trace_files(tmp_path)
    names = [e["name"] for e in _events(path) if e.get("cat") == "user_annotation"]
    assert sorted(n for n in names if n.startswith("train#")) == ["train#1", "train#2", "train#3"]
    assert names.count("body") == 3                  # the warm-up step is not in it


def test_step_annotation_names_the_step(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.step_annotation(1234):
            torch.zeros(4).add_(1)
        with tprof.step_annotation(7, name="eval"):
            pass
    (path,) = _trace_files(tmp_path)
    names = {e["name"] for e in _events(path)}
    assert {"train#1234", "eval#7"} <= names


def _loop_beside_a_capture(profiler, steps, step_body=None):
    """Step a loop on this thread, each step in ``step_annotation(100 + n)``,
    while another thread runs ``profiler.capture(steps)``; four steps at
    least, then until the capture ends. Returns (the capture's text or
    exception, the loop's step count)."""
    out = {}

    def capture():
        try:
            out["text"] = profiler.capture(steps)
        except Exception as e:
            out["error"] = e

    thread = threading.Thread(target=capture)
    thread.start()
    x = torch.ones(32, 32)
    n = 0
    while n < 4 or thread.is_alive():
        with tprof.step_annotation(100 + n):
            (step_body or (lambda: x @ x))()
        n += 1
    thread.join()
    return out.get("text", out.get("error")), n


def test_a_capture_from_another_thread_runs_on_the_stepping_loop(tmp_path):
    with tprof.step_annotation(0):      # the loop has stepped
        pass
    profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path), step_hint_s=0.05)
    text, _ = _loop_beside_a_capture(profiler, 2)
    assert profiler.last_route == "loop" and text.startswith("# file=plugins/profile/")
    (path,) = _trace_files(tmp_path)
    events = _events(path)
    regions = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert regions and all(r.startswith("train#") and int(r[6:]) >= 100 for r in regions)
    assert any(e.get("name") == "aten::mm" for e in events)   # the loop's own operators
    assert tprof._loop_running is None and tprof._loop_requests == []


def test_a_capture_with_no_stepping_loop_runs_on_the_caller(tmp_path, monkeypatch):
    monkeypatch.setattr(tprof, "_last_step_end", None)
    profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path), step_hint_s=0.05)
    (line,) = profiler.capture(2).strip().splitlines()
    assert profiler.last_route == "caller" and line.startswith("# file=plugins/profile/")


def test_a_failed_loop_capture_raises_in_the_caller_and_the_loop_steps_on(tmp_path):
    with tprof.step_annotation(0):
        pass
    (tmp_path / "blocker").write_text("")   # the log directory lies under a file
    profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path / "blocker" / "x"),
                                         step_hint_s=0.05)
    error, steps = _loop_beside_a_capture(profiler, 2)
    assert isinstance(error, OSError) and steps >= 4
    assert tprof._loop_running is None and not torch._C._autograd._profiler_enabled()


def test_a_step_that_raises_ends_the_loop_capture(tmp_path):
    with tprof.step_annotation(0):
        pass
    profiler = tagent.TorchTraceProfiler(logdir_base=str(tmp_path), step_hint_s=5.0)
    out = {}
    thread = threading.Thread(target=lambda: out.update(text=profiler.capture(2)))
    thread.start()
    with pytest.raises(RuntimeError, match="step failed"):
        while True:         # the window is 10 s: only the failed step ends it
            with tprof.step_annotation(1):
                if tprof._loop_running is not None:
                    raise RuntimeError("step failed")
    thread.join(timeout=60)
    assert profiler.last_route == "loop" and out["text"].startswith("# file=")
    assert tprof._loop_running is None and not torch._C._autograd._profiler_enabled()


class TestServer:
    """``server``/``stop``: one live server a process, typed errors."""

    @pytest.fixture(autouse=True)
    def _reset(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tagent, "TorchTraceProfiler", functools.partial(
            tagent.TorchTraceProfiler, logdir_base=str(tmp_path / "captures"), step_hint_s=0.05))
        yield
        if tprof._server is not None:
            tprof.stop()

    def test_server_idempotent_per_port(self):
        a = tprof.server(0)
        b = tprof.server(0)       # repeat: the running server, no second start
        assert a is b and a.port > 0 and a.thread.is_alive()

    def test_second_port_raises_typed_error(self):
        tprof.server(0)
        with pytest.raises(tprof.ProfilerServerError) as err:
            tprof.server(9999)
        assert "port 0" in str(err.value)

    def test_stop_then_restart_on_new_port(self):
        first = tprof.server(0)
        tprof.stop()
        assert not first.thread.is_alive()
        second = tprof.server(0)
        assert second is not first and second.thread.is_alive()

    def test_stop_without_server_raises(self):
        for impl in (jprof, tprof):
            with pytest.raises(impl.ProfilerServerError):
                impl.stop()

    def test_capture_over_http(self):
        port = tprof.server(0).port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?steps=2", timeout=30) as r:
            assert r.status == 200
            body = r.read().decode()
        (line,) = body.strip().splitlines()
        match = re.fullmatch(r"# file=plugins/profile/\w+/.+\.pt\.trace\.json bytes=(\d+)", line)
        assert match and int(match.group(1)) > 0, line
        for bad in ("steps=0", "steps=65", "steps=x"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?{bad}", timeout=30)
            assert err.value.code == 400
