"""Input pipeline: host-to-device prefetch for training loops; counterpart of
``kubeflow_tpu/utils/data.py``.

    it = DevicePrefetcher(host_batches(), "cuda")
    for batch in it:            # batch is already on the card
        state, metrics = bundle.step(state, batch)

The reference keeps ``depth`` ``jax.device_put`` transfers in flight; here
each transfer is a copy from pinned host memory with ``non_blocking=True``
on a side stream of the target card, so it overlaps the compute the
consumer's stream has queued. Handing a batch out makes the consumer's
current stream wait on its copies' event and records that stream on every
output tensor (``record_stream``): the outputs were allocated on the side
stream, and without it the allocator could hand their memory to the next
copy while the consumer's kernels still read it.

``sharding`` names the target: a ``torch.device`` or a device string, or the
port's ``parallel/mesh.batch_sharding(mesh)``. The last means this rank's
device with the whole global batch: the port's train steps cut their own
rows from the global batch (``parallel/train.py``), as the JAX steps take the
global array. A batch is any nest of dicts, lists and tuples of host arrays
(numpy arrays or CPU tensors).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _target(sharding) -> torch.device:
    """The device a batch goes to: ``sharding`` itself, or this rank's
    device for a list of placements (``batch_sharding(mesh)``); None is
    the card."""
    if sharding is None:
        return torch.device("cuda")
    if isinstance(sharding, (str, torch.device)):
        return torch.device(sharding)
    from torch.distributed.tensor import Placement

    if isinstance(sharding, (list, tuple)) and all(isinstance(p, Placement) for p in sharding):
        from kubeflow_tpu_torch.parallel.mesh import default_device_type

        if default_device_type() == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    raise TypeError(f"sharding must be a device, a device string or batch_sharding(mesh)'s "
                    f"placements, got {sharding!r}")


class DevicePrefetcher:
    """Wraps a host batch iterator; yields device-resident batches while
    keeping ``depth`` transfers in flight."""

    def __init__(self, batches: Iterable[Any], sharding: Any, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = iter(batches)
        self._device = _target(sharding)
        self._depth = depth
        self._stream = None
        self._queue: collections.deque = collections.deque()

    def _put(self, batch: Any):
        """(device batch, (copies' event, pinned sources) or None)."""
        if self._device.type != "cuda":
            return _tree_map(lambda x: _host_tensor(x).to(self._device, copy=True), batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        pinned = _tree_map(lambda x: _host_tensor(x).pin_memory(), batch)
        with torch.cuda.stream(self._stream):
            out = _tree_map(lambda x: x.to(self._device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, (done, pinned)

    def _fill(self) -> None:
        while len(self._queue) < self._depth:
            try:
                batch = next(self._it)
            except StopIteration:
                return
            self._queue.append(self._put(batch))

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        self._fill()
        if not self._queue:
            raise StopIteration
        out, pending = self._queue.popleft()
        if pending is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(pending[0])
            _tree_map(lambda t: t.record_stream(consumer), out)
        self._fill()  # immediately dispatch the replacement transfer
        return out


def synthetic_token_batches(
    *, batch: int, seq_len: int, vocab_size: int, seed: int = 0,
    steps: int | None = None,
) -> Iterator[np.ndarray]:
    """Endless (or ``steps``-bounded) random token batches, the reference's
    draws: the benchmark and smoke-test data source."""
    rng = np.random.default_rng(seed)
    n = 0
    while steps is None or n < steps:
        yield rng.integers(0, vocab_size, (batch, seq_len), dtype=np.int32)
        n += 1


def map_batches(batches: Iterable[Any], fn: Callable[[Any], Any]) -> Iterator[Any]:
    """Host-side transform stage (tokenize, augment, pack) applied before
    transfer; composes with DevicePrefetcher so the transform of batch N+1
    overlaps the device compute of batch N."""
    for b in batches:
        yield fn(b)
