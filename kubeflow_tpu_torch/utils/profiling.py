"""Profiler trace capture; counterpart of ``kubeflow_tpu/utils/profiling.py``,
on ``torch.profiler``.

Notebooks capture traces into the logdir layout the platform's TensorBoard
controller ingests (``<logdir>/plugins/profile/<timestamp>/<host>...``, which
``obs/profiler.py`` also reads): here one Chrome trace a capture,
``<host>.pt.trace.json``, with the host's operators and, when a card is in
use, its kernels and copies.

    from kubeflow_tpu_torch.utils.profiling import trace
    with trace("/home/jovyan/runs/run1"):
        state, metrics = bundle.step(state, batch)

The live server differs from the reference's: PyTorch has no counterpart of
JAX's profiler server, which TensorBoard attaches to over gRPC. The port's
:func:`server` is the on-demand capture endpoint over HTTP instead, the
telemetry agent's (``telemetry/agent.py``): ``GET /capture?steps=N``
answers with a ``TorchTraceProfiler`` capture of this process, from a
daemon thread.
"""
from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Iterator

import torch

from kubeflow_tpu_torch.telemetry import CAPTURE_DEFAULT_STEPS, CAPTURE_MAX_STEPS, CAPTURE_PATH


class ProfilerServerError(RuntimeError):
    """The live profiler server is in the wrong state for the request
    (double start, stop without start). Raised by :func:`server` /
    :func:`stop`."""


def _profile_dir(logdir: str) -> str:
    """``<logdir>/plugins/profile/<timestamp>``, JAX's run layout."""
    return os.path.join(logdir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))


@contextlib.contextmanager
def trace(logdir: str, *, host_only_on_coordinator: bool = False) -> Iterator[None]:
    """Trace a block: the host's operators, and the card's kernels when one
    is available, into ``<logdir>/plugins/profile/<ts>/<host>.pt.trace.json``."""
    worker = int(os.environ.get("TPU_WORKER_ID", "0"))
    if host_only_on_coordinator and worker != 0:
        yield
        return
    with _traced(logdir):
        yield


@contextlib.contextmanager
def _traced(logdir: str) -> Iterator[None]:
    """:func:`trace`'s capture: the calling thread's operators, and the
    card's kernels and every thread's CUDA runtime calls. The card is
    synchronised before the trace stops, so the block's last kernels are in
    it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = _profile_dir(logdir)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"{socket.gethostname()}.pt.trace.json"))


def trace_n_steps(logdir: str, step_fn, state, batch, *, steps: int = 3):
    """Warm up one step outside the trace, then trace ``steps`` steps, each
    in a :func:`step_annotation` region numbered from 1; the device is
    synchronised before the trace closes, so the last steps' kernels are
    in it."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    state, metrics = step_fn(state, batch)  # warm-up outside the trace
    _block(metrics)
    with trace(logdir):
        for n in range(1, steps + 1):
            with step_annotation(n):
                state, metrics = step_fn(state, batch)
        _block(metrics)
    return state, metrics


def annotate(name: str):
    """Named region in the trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def step_annotation(step_num: int, name: str = "train") -> Iterator[None]:
    """Step marker in the trace: a region named ``<name>#<step_num>``, as
    PyTorch names its own ``ProfilerStep#<n>``. The telemetry agent's step
    numbers and a captured trace share one numbering when the training
    loop wraps each step in it.

    Its step boundaries are also where a capture asked for from another
    thread (:func:`capture_window`) starts and stops, on this thread."""
    _loop_step_starts()
    try:
        with torch.profiler.record_function(f"{name}#{step_num}"):
            yield
    except BaseException:
        _loop_step_ends(failed=True)
        raise
    _loop_step_ends(failed=False)


# Captures asked for from another thread (the agent's, the live server's)
# run on the training loop's thread, between its step boundaries: with
# torch 2.11 on an H100, a trace started and stopped on a second thread
# while the loop launched kernels lost every kernel the loop's thread
# launched in 20 of 60 captures across six profiler settings, where a
# trace run by the loop's thread kept them in 20 of 20
# (``benchmarks/capture_threads.py``).
_loop_lock = threading.Lock()
_loop_requests: list = []           # _LoopCapture, oldest first
_loop_running = None                # (_LoopCapture, thread ident) while one runs
_last_step_end: float | None = None  # perf_counter at the last step's end


class _LoopCapture:
    """A capture run by the training loop: started as its next step starts,
    stopped as the first step ends that ends ``window_s`` or more later."""

    def __init__(self, logdir: str, window_s: float) -> None:
        self.logdir, self.window_s = logdir, window_s
        self.state = "pending"      # -> "running" -> "done", or "cancelled"
        self.picked = threading.Event()
        self.done = threading.Event()
        self.error: BaseException | None = None
        self._cm = None
        self._t0 = 0.0


def _loop_step_starts() -> None:
    global _loop_running
    with _loop_lock:
        if (_loop_running is not None or not _loop_requests
                or torch._C._autograd._profiler_enabled()):   # the caller's own trace
            return
        req = _loop_requests.pop(0)
        req.state = "running"
        _loop_running = (req, threading.get_ident())
    req.picked.set()
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        req._cm = _traced(req.logdir)
        req._cm.__enter__()
        req._t0 = time.perf_counter()
    except Exception as e:          # the requester raises it, not the loop
        _loop_finish(req, e)


def _loop_step_ends(*, failed: bool) -> None:
    global _last_step_end
    _last_step_end = time.perf_counter()
    run = _loop_running
    if run is None or run[1] != threading.get_ident():
        return
    req = run[0]
    if not failed and time.perf_counter() - req._t0 < req.window_s:
        return
    error = None
    try:
        req._cm.__exit__(None, None, None)     # synchronises, stops, exports
    except Exception as e:
        error = e
    _loop_finish(req, error)


def _loop_finish(req: _LoopCapture, error: BaseException | None) -> None:
    global _loop_running
    with _loop_lock:
        _loop_running = None
    req.error = error
    req.state = "done"
    req.done.set()


def capture_window(logdir: str, window_s: float, *, pickup_s: float,
                   done_timeout_s: float = 600.0) -> str:
    """Trace this process for ``window_s`` seconds into ``logdir``, from any
    thread; returns the route taken.

    ``"loop"``: a loop that ended a :func:`step_annotation` step within the
    last ``pickup_s`` seconds is stepping, and the capture runs on its
    thread from the start of its next step to the end of the first step that
    ends ``window_s`` or more later (whole steps, the loop's operators in the
    trace). ``"caller"``: no loop stepping, or none started a step within
    ``pickup_s``: the trace runs on the calling thread for ``window_s``,
    with the card's kernels and every thread's CUDA runtime calls, but only
    this thread's operators, and kernels that another thread launches can
    be lost (the note above)."""
    last = _last_step_end
    if last is not None and time.perf_counter() - last < pickup_s:
        req = _LoopCapture(logdir, window_s)
        with _loop_lock:
            _loop_requests.append(req)
        req.picked.wait(pickup_s)
        with _loop_lock:
            if req.state == "pending":
                _loop_requests.remove(req)
                req.state = "cancelled"
        if req.state != "cancelled":
            if not req.done.wait(window_s + done_timeout_s):
                raise TimeoutError(f"the training loop did not end a step within "
                                   f"{window_s + done_timeout_s:.0f} s of the capture's start")
            if req.error is not None:
                raise req.error
            return "loop"
    with _traced(logdir):
        time.sleep(window_s)
    return "caller"


def _block(tree) -> None:
    """Wait for the card when ``tree`` holds a tensor on it."""
    leaves = list(tree.values()) if isinstance(tree, dict) else (
        list(tree) if isinstance(tree, (list, tuple)) else [tree])
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        torch.cuda.synchronize()


class _CaptureServer:
    """The HTTP capture endpoint in a daemon thread."""

    def __init__(self, port: int, profiler) -> None:
        from wsgiref.simple_server import WSGIRequestHandler, make_server

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        self.profiler = profiler
        self._httpd = make_server("0.0.0.0", port, self._app, handler_class=Quiet)
        self.port = self._httpd.server_port
        self.thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                       name="profiler-server")
        self.thread.start()

    def _app(self, environ, start_response):
        import urllib.parse

        def reply(status, body: bytes):
            start_response(status, [("Content-Type", "text/plain"),
                                    ("Content-Length", str(len(body)))])
            return [body]

        if (environ.get("PATH_INFO", "") or "/") != CAPTURE_PATH:
            return reply("404 Not Found", f"GET {CAPTURE_PATH}?steps=N\n".encode())
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", "") or "")
        try:
            steps = int(qs.get("steps", [str(CAPTURE_DEFAULT_STEPS)])[0])
        except ValueError:
            steps = -1
        if steps <= 0 or steps > CAPTURE_MAX_STEPS:
            return reply("400 Bad Request",
                         f"steps must be in 1..{CAPTURE_MAX_STEPS}, got {steps}".encode())
        try:
            body = self.profiler.capture(steps).encode()
        except Exception as e:   # the profiler failed mid-capture: the caller retries
            return reply("503 Service Unavailable", str(e).encode())
        return reply("200 OK", body)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.thread.join(timeout=10)


# the one live server a process may run, as the reference allows one
_server_lock = threading.Lock()
_server = None
_server_port: int | None = None


def server(port: int = 9012):
    """Start the live capture endpoint (module docstring) on ``port``, with
    a ``TorchTraceProfiler()`` behind it, and return its handle (``.port``,
    ``.stop()``). A repeat call for the same port returns the running
    server; another port raises :class:`ProfilerServerError`."""
    global _server, _server_port
    with _server_lock:
        if _server is not None:
            if _server_port == port:
                return _server
            raise ProfilerServerError(
                f"profiler server already running on port {_server_port}; "
                f"stop() it before starting on port {port}"
            )
        from kubeflow_tpu_torch.telemetry.agent import TorchTraceProfiler

        _server = _CaptureServer(port, TorchTraceProfiler())
        _server_port = port
        return _server


def stop() -> None:
    """Stop the live server started by :func:`server`. Raises
    :class:`ProfilerServerError` when no server is running."""
    global _server, _server_port
    with _server_lock:
        if _server is None:
            raise ProfilerServerError("no profiler server is running")
        try:
            _server.stop()
        finally:
            _server = None
            _server_port = None
