"""Copies of the port's kernel libraries for the probes that time a kernel
beside a variant of it (``pair_swap``, ``decode_combine``): built from this
checkout's ``csrc/`` with one header edited, or from another checkout's
``csrc/`` as it is (an A/B against its kernels), each into a directory of
its own under the git-ignored ``_build/``, all nvcc runs started together.
A probe swaps a copy in for the port's own library around its calls
(:func:`swapped`), so the copy runs behind the port's wrappers."""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

from kubeflow_tpu_torch.ops import _build


def build(tag: str, names, *, csrc: Path | None = None, header: str | None = None,
          edit=None) -> dict:
    """``{name: library}``: ``csrc/<name>.cu`` for each of ``names``, built
    from ``csrc`` (this checkout's by default) with ``edit(text)`` applied
    to the header named ``header``, into ``_build/<tag>/``."""
    csrc = _build.CSRC if csrc is None else Path(csrc)
    out = _build.BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        text = f.read_text()
        (out / f.name).write_text(edit(text) if f.name == header else text)
    procs = {}
    for name in names:
        (out / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({tag}) did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        symbol, argtypes = _build.SIGNATURES[name]
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def edited(src: str, old: str, new: str, what: str) -> str:
    """``src`` with its one line ``old`` replaced by ``new``; raises where
    ``what`` (the header's name) has no such single line."""
    if src.count(old) != 1:
        raise RuntimeError(f"{what} has no single line {old!r}")
    return src.replace(old, new)


@contextlib.contextmanager
def swapped(libs: dict):
    """The port's libraries replaced by ``libs`` (name -> library) inside
    the block, its own loaded back after it."""
    own = {name: _build.load(name) for name in libs}
    _build._LIBS.update(libs)
    try:
        yield
    finally:
        _build._LIBS.update(own)


def wrapper_module(root: Path, rel: str, alias: str):
    """Another checkout's wrapper module (``root / rel``, e.g. its
    ``kubeflow_tpu_torch/ops/flash_decode.py``) loaded under ``alias``: its
    own plan and launch arguments, with its imports of the package resolved
    to this checkout's modules; run it inside :func:`swapped` with that
    checkout's libraries."""
    spec = importlib.util.spec_from_file_location(alias, Path(root) / rel)
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module         # its dataclasses look their module up there
    spec.loader.exec_module(module)
    return module
