"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes``. Nothing
here includes PyTorch's headers, so a build takes seconds. Libraries land in
``kubeflow_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads.

The build happens at first use (a wrapper's first launch) or, for every
kernel at once and in parallel, through :func:`build_all`. Neither this
module nor the wrappers import anything CUDA-specific at import time: the
CPU tests import every module.

Listeners (:func:`add_listener`; the telemetry agent's compile monitor) hear
of every build: ``fn(name, seconds)`` when an nvcc run ends, from its start,
and ``fn(name, None)`` when a library was found already built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

# C signature of each library's launcher: name -> (symbol, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention_fwd": (
        "flash_attention_fwd_launch",
        # q, k, v, o, lse, B, Sq, Sk, H, KV, D, causal, window, scale, f32,
        # block_q, smem, stream
        [_P] * 5 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
    ),
    "flash_decode": (
        "flash_decode_launch",
        # q, k_cache, v_cache, pos, o, ws_o, ws_ml, tickets, B, G, R, L, D,
        # dk, window, scale, f32, splits, split, cluster, smem, stream
        [_P] * 8 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
    ),
    "flash_decode_512": (
        # flash_decode's arguments; width 512 only (csrc/flash_decode_512.cu)
        "flash_decode_512_launch",
        [_P] * 8 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
    ),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd_dq_launch",
        # q, k, v, o, lse, do, dq, B, Sq, Sk, H, KV, D, causal, window, scale,
        # out_f32, f32, block_q, smem, stream
        [_P] * 7 + [_I] * 8 + [_F] + [_I] * 4 + [_P],
    ),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd_dkv_launch",
        # q, k, v, o, lse, do, dk, dv, B, Sq, Sk, H, KV, D, causal, window,
        # scale, out_f32, f32, block_k, smem, stream
        [_P] * 8 + [_I] * 8 + [_F] + [_I] * 4 + [_P],
    ),
    "moe_gather": (
        "moe_gather_launch",
        # x, idx, out, B, R, J, M, elem_bytes, stream
        [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "moe_scatter": (
        "moe_scatter_launch",
        # dy, idx, out, ws, tickets, B, J, R, M, dtype, accumulate,
        # item_max, stream
        [_P] * 5 + [_I] * 7 + [_P],
    ),
    "fused_head_fwd": (
        "fused_head_fwd_launch",
        # h, emb, tgt, lse, gold, ws, tickets, T, V, E, f32, ranges, stages,
        # smem, stream
        [_P] * 7 + [_I] * 7 + [_P],
    ),
    "fused_head_bwd_dh": (
        "fused_head_bwd_dh_launch",
        # h, emb, tgt, lse, dlse, dgold, dh, T, V, E, f32, cluster, slabs,
        # passes, rows, smem, cap, ws, flags, stream
        [_P] * 7 + [_I] * 10 + [_P] * 3,
    ),
    "fused_head_bwd_de": (
        "fused_head_bwd_de_launch",
        # h, emb, tgt, lse, dlse, dgold, de, T, V, E, f32, cluster, slabs,
        # passes, rows, smem, cap, ws, flags, stream
        [_P] * 7 + [_I] * 10 + [_P] * 3,
    ),
    "bn_moments": (
        "bn_moments_launch",
        # x, part, tickets, out, m, C, dtype, vec, tx, gy, c, stream
        [_P] * 4 + [_I] * 6 + [_F, _P],
    ),
    "bn_grad_sums": (
        "bn_grad_sums_launch",
        # x, dy, mean, rinv, part, out, m, C, dtype, vec, tx, gy, stream
        [_P] * 6 + [_I] * 6 + [_P],
    ),
    "fused_bn_relu_conv1x1_bwd": (
        "fused_bn_relu_conv1x1_bwd_launch",
        # dr, y, x, wt, scal, dx, part, dw, N, CI, CO, gx, ci_slice, co_pad,
        # stages, smem, stream
        [_P] * 8 + [_I] * 8 + [_P],
    ),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LISTENERS: list = []


def add_listener(fn) -> None:
    """Call ``fn(name, seconds)`` after each nvcc run (``seconds`` from its
    start) and ``fn(name, None)`` for each library found built."""
    _LISTENERS.append(fn)


def remove_listener(fn) -> None:
    _LISTENERS.remove(fn)


def _tell(name: str, seconds: float | None) -> None:
    for fn in list(_LISTENERS):
        fn(name, seconds)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "compiled from kubeflow_tpu_torch/csrc at first use"
        )
    return found


def _target(name: str, compiler: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join([compiler] + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, compiler: str):
    """Start one nvcc; returns (target, pending) or (target, None) if built."""
    target = _target(name, compiler)
    if target.is_file():
        _tell(name, None)
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # nvcc writes to a file, not a pipe: a full pipe would stall an nvcc
    # that build_all waits on to exit
    log = tmp.with_suffix(".log")
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return target, (proc, tmp, log, time.perf_counter())


def _finish(name: str, target: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp, log, t0 = pending
    proc.wait()
    seconds = time.perf_counter() - t0
    out = log.read_text()
    os.replace(log, BUILD_DIR / f"{name}.log")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)
    _tell(name, seconds)


def build_all() -> dict[str, Path]:
    """Compile every kernel, one nvcc per source, all started together;
    each is finished as its nvcc exits, so its seconds end there."""
    compiler = nvcc()
    started = {name: _start(name, compiler) for name in SIGNATURES}
    running = {name for name, (_, pending) in started.items() if pending is not None}
    while running:
        done = [n for n in running if started[n][1][0].poll() is not None]
        for name in done:
            _finish(name, *started[name])
            running.discard(name)
        if not done:
            time.sleep(0.02)
    return {name: target for name, (target, _) in started.items()}


def build_log(name: str) -> str:
    """What nvcc printed for the last build of ``name`` (registers, spills)."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.is_file() else ""


def load(name: str):
    """The launcher of kernel ``name``, building its library on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        compiler = nvcc()
        target, pending = _start(name, compiler)
        _finish(name, target, pending)
        lib = ctypes.CDLL(str(target))
        symbol, argtypes = SIGNATURES[name]
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s launcher; raise if CUDA reported an error."""
    lib = load(name)
    symbol, _ = SIGNATURES[name]
    rc = getattr(lib, symbol)(*args)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
