"""Sharded checkpoint and resume for notebook training state; counterpart of
``kubeflow_tpu/utils/checkpoint.py``, on ``torch.distributed.checkpoint`` (DCP).

The reference's policy layer over orbax, kept call for call: ``save`` starts
a save when orbax's ``CheckpointManager`` would (``save_interval_steps``,
``force``, a step at or below the latest refused), ``max_to_keep`` keeps the
latest steps in the order they were saved, and ``latest_step`` /
``all_steps`` list only finished steps.

- A step is written by ``dcp.async_save`` into ``<directory>/<step>.tmp``
  and counts as saved only once it is renamed to ``<directory>/<step>``,
  which happens when its write has finished and the next ``save``,
  ``wait_until_finished`` or ``close`` sees it (then the steps that
  ``max_to_keep`` dropped are deleted). One save is in flight at a time.
- ``save`` returns only once every tensor of the state has been copied off
  the device, into host buffers kept for the next save (pinned when the
  state is on the card): the port's steps update the state in place, where
  a JAX step returns new arrays, so the caller may step on at once and the
  checkpoint still holds one step.
- The state is a train bundle's (``parallel/train.py``'s ``TrainState``):
  ``{"params": {name: tensor}, "opt_state": ..., "step": int}``. Under a
  mesh each tensor is this rank's shard, saved as a ``DTensor`` of the
  bundle's mesh with its ``state_shardings`` placements, so a step written
  under one plan restores under another, or onto one device, and one
  device's step restores under a mesh. Ints (the step, the optimizer's
  count) are saved as they are.
- ``restore`` loads a step into fresh buffers and only then copies them
  into ``state_like``'s tensors, in place: a step that fails to load
  leaves the state as it was, so ``resume_or_init`` can fall back to the
  step before, or to the fresh state, after a torn step.
- Under a process group every rank calls every method; the manager makes
  its own gloo group for DCP's collectives, which run in the save's
  background thread and must not interleave with the training's on the
  default group (``async_save`` also needs a CPU backend, which an nccl
  group lacks: ``parallel/bootstrap.auto_initialize`` joins
  ``"cpu:gloo,cuda:nccl"``). Steps live on a filesystem every rank sees.
"""
from __future__ import annotations

import functools
import logging
import os
import shutil
from pathlib import Path
from typing import Any

import torch

log = logging.getLogger(__name__)


def _leaves(tree, specs, path=()):
    """(key, container, slot, value, spec) of every leaf of ``tree`` that is
    not None, walking dicts, lists and tuples; ``specs`` is the same nest of
    sharding specs or None."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"a state is a nest of dicts and lists, got {type(tree)} at {path}")
    for slot, value in items:
        spec = None if specs is None else specs[slot]
        if isinstance(value, (dict, list, tuple)):
            yield from _leaves(value, spec, path + (str(slot),))
        elif value is not None:
            yield "/".join(path + (str(slot),)), tree, slot, value, spec


def _flat(state, fresh: bool = False) -> dict:
    """The DCP state dict of ``state``: its tensors by path (DTensors over
    ``state.mesh`` where it has one) and its other leaves as they are;
    ``fresh`` puts uninitialised buffers of the same layout in the tensors'
    place, to load into."""
    mesh = getattr(state, "mesh", None)
    specs = getattr(state, "shardings", None) if mesh is not None else None
    out = {}
    for key, _, _, value, spec in _leaves(state, specs):
        if isinstance(value, torch.Tensor):
            value = torch.empty_like(value) if fresh else value.detach()
            if mesh is not None:
                from torch.distributed.tensor import DTensor

                from kubeflow_tpu_torch.parallel.mesh import placements

                value = DTensor.from_local(value, mesh, placements(mesh, spec), run_check=False)
        out[key] = value
    return out


class _Stager:
    """Copies a DCP state dict's tensors into host buffers kept from one
    save to the next (pinned where the source is on the card, so the copies
    run at the link's rate), before ``async_save`` returns. A DTensor keeps
    its layout around its host copy, as DCP's own stager leaves it. DCP's
    ``DefaultStager`` would do the copying, but under torch 2.11 a stager
    given to ``async_save`` fails its second save (its copier table is
    gone), so its buffers could not serve the next save. A buffer is
    written again only once the save that read it has finished: the
    manager keeps one save in flight."""

    def __init__(self) -> None:
        self._buffers: dict = {}

    def __call__(self, flat: dict) -> dict:
        from torch.distributed.tensor import DTensor

        out, card = {}, False
        for key, value in flat.items():
            if isinstance(value, torch.Tensor):
                local = value.to_local() if isinstance(value, DTensor) else value
                buf = self._buffers.get(key)
                if buf is None or buf.shape != local.shape or buf.dtype != local.dtype:
                    buf = torch.empty(local.shape, dtype=local.dtype, pin_memory=local.is_cuda)
                    self._buffers[key] = buf
                buf.copy_(local, non_blocking=local.is_cuda)
                card |= local.is_cuda
                value = DTensor(buf, value._spec, requires_grad=False) if isinstance(
                    value, DTensor) else buf
            out[key] = value
        if card:
            torch.cuda.synchronize()
        return out

    def clear(self) -> None:
        self._buffers.clear()


@functools.cache
def _as_is():
    """A DCP stager that hands the state dict on unchanged (it is staged)."""
    from torch.distributed.checkpoint.staging import AsyncStager

    class AsIs(AsyncStager):
        _synchronize_after_execute = False

        def stage(self, state_dict):
            return state_dict

    return AsIs()


class CheckpointManager:
    """The reference's policy layer (over orbax there), on DCP here."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> None:
        import torch.distributed as dist

        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._root = Path(directory)
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._rank = dist.get_rank() if self._group is not None else 0
        if self._rank == 0:
            self._root.mkdir(parents=True, exist_ok=True)
            for stale in self._root.glob("*.tmp"):   # a save torn before its rename
                shutil.rmtree(stale)
        self._barrier()
        # the steps orbax's manager would list, in the order they were saved
        # (sorted when read from disk), the step in flight included
        self._steps = self._committed()
        self._pending = None           # (step, future, steps max_to_keep dropped)
        self._stage = _Stager()

    # ------------------------------------------------------------------ policy

    def _committed(self) -> list[int]:
        return sorted(int(p.name) for p in self._root.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def _should_save(self, step: int) -> bool:
        """orbax's ``should_save``: above the latest step, and on the
        interval or with nothing saved yet."""
        if self._steps and self._steps[-1] >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def _finished(self) -> list[int]:
        pending = None if self._pending is None else self._pending[0]
        return [s for s in self._steps if s != pending]

    def latest_step(self) -> int | None:
        finished = self._finished()
        return finished[-1] if finished else None

    def all_steps(self) -> list[int]:
        """Retained steps, ascending (fallback order for torn-step recovery)."""
        return sorted(self._finished())

    # ------------------------------------------------------------------ saving

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Start an async save of ``state`` at ``step``; returns True if a
        save was started, once the state has been copied off the device."""
        import torch.distributed.checkpoint as dcp

        if not force and not self._should_save(step):
            return False
        self.wait_until_finished()
        if step in self._steps:
            raise ValueError(f"Checkpoint for step {step} already exists.")
        future = dcp.async_save(self._stage(_flat(state)),
                                checkpoint_id=str(self._root / f"{step}.tmp"),
                                process_group=self._group, async_stager=_as_is(),
                                no_dist=self._group is None)
        self._steps.append(step)
        drop = (self._steps[:len(self._steps) - self.max_to_keep]
                if self.max_to_keep is not None and len(self._steps) > self.max_to_keep else [])
        self._steps = [s for s in self._steps if s not in drop]
        self._pending = (step, future, drop)
        return True

    def wait_until_finished(self) -> None:
        """Block until the save in flight is durable: its write has finished
        and its directory has been renamed into place. ``save()`` returning
        only means the save was *started*. The suspend barrier (``sessions/``)
        calls this before reporting snapshot-committed: an ack must never
        point at bytes that are still in flight."""
        if self._pending is None:
            return
        step, future, drop = self._pending
        self._pending = None
        try:
            (future.upload_completion if hasattr(future, "upload_completion") else future).result()
        except BaseException:
            if self._rank == 0:
                shutil.rmtree(self._root / f"{step}.tmp", ignore_errors=True)
            self._steps = self._committed()
            raise
        if self._rank == 0:
            os.replace(self._root / f"{step}.tmp", self._root / str(step))
            fd = os.open(self._root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            for old in drop:
                shutil.rmtree(self._root / str(old), ignore_errors=True)
        self._barrier()

    def wait(self) -> None:
        """Alias kept for existing callers (cull paths)."""
        self.wait_until_finished()

    def _barrier(self) -> None:
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    # --------------------------------------------------------------- restoring

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Load ``step`` (the latest by default, once a save in flight has
        landed) into the tensors of ``state_like``, in place, in its own
        layout (this rank's shards of its mesh, or whole tensors), and set
        its other leaves; returns it."""
        import torch.distributed.checkpoint as dcp

        self.wait_until_finished()    # DCP's collectives of a save in flight share the group
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        fresh = _flat(state_like, fresh=True)
        dcp.load(fresh, checkpoint_id=str(self._root / str(step)), process_group=self._group,
                 no_dist=self._group is None)
        from torch.distributed.tensor import DTensor

        mesh = getattr(state_like, "mesh", None)
        specs = getattr(state_like, "shardings", None) if mesh is not None else None
        with torch.no_grad():
            for key, parent, slot, value, _ in _leaves(state_like, specs):
                loaded = fresh[key]
                if isinstance(value, torch.Tensor):
                    value.copy_(loaded.to_local() if isinstance(loaded, DTensor) else loaded)
                else:
                    parent[slot] = loaded
        return state_like

    def close(self) -> None:
        """Drain first: closing with an async save in flight would abandon it."""
        self.wait_until_finished()
        self._stage.clear()
        if self._group is not None:
            import torch.distributed as dist

            dist.destroy_process_group(self._group)
            self._group = None


def snapshot_for_suspend(manager: CheckpointManager, step: int, state: Any) -> int | None:
    """The suspend barrier's save: force a checkpoint and BLOCK until it is
    durable, then report the step that may be acked as snapshot-committed
    (None if nothing was saved). Only after it returns may the in-pod agent
    answer the snapshot RPC (``sessions/controller.py``)."""
    manager.save(step, state, force=True)
    manager.wait_until_finished()
    return manager.latest_step()


def snapshot_for_precopy(manager: CheckpointManager) -> int | None:
    """The suspend pre-copy pass's read: the newest step that is already
    durable, without forcing a save and without blocking the kernel; None
    when no step has landed yet."""
    return manager.latest_step()


def resume_or_init(directory: str, init_fn, *args, **kwargs):
    """Restore the latest checkpoint if one exists, else build fresh state:

        state = resume_or_init("/home/jovyan/ckpt", bundle.init)

    A torn or corrupt step is treated as absent, not fatal: it is logged and
    the step before it is tried, down to the fresh state when none restores.
    A failed restore leaves the state as ``init_fn`` built it."""
    # DCP raises a failed load as CheckpointException, a BaseException
    from torch.distributed.checkpoint.api import CheckpointException

    state = init_fn(*args, **kwargs)
    mgr = CheckpointManager(directory)
    try:
        for step in reversed(mgr.all_steps()):
            try:
                return mgr.restore(state, step)
            except (Exception, CheckpointException) as exc:
                log.warning(
                    "checkpoint step %d under %s is torn/corrupt (%s); "
                    "falling back to the previous step",
                    step, directory, exc,
                )
    finally:
        mgr.close()
    return state
