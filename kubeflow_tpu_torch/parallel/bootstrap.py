"""In-image distributed bootstrap: env contract -> process group; counterpart of
``kubeflow_tpu/parallel/bootstrap.py``.

The same env contract that admission injects (``webhooks/tpu_env.py``):

    TPU_WORKER_ID / TPU_WORKER_HOSTNAMES / JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID

``auto_initialize()`` joins the default ``torch.distributed`` process group
where the reference calls ``jax.distributed.initialize``: the rendezvous is
``JAX_COORDINATOR_ADDRESS`` (``host:port``), the rank the process id and the
world the process count. A single host skips it. The backend is
``"cpu:gloo,cuda:nccl"`` (nccl for CUDA tensors, gloo for CPU ones, which
the checkpoint manager's ``async_save`` needs, ``utils/checkpoint.py``), or
``gloo`` alone when the caller passes ``device="cpu"``; nothing switches
between them on its own.

The reference's ``parallel/compat.py`` (a shim across JAX versions for
``shard_map`` and a cross-process sum) has no counterpart: the port's
cross-process sum is ``torch.distributed.all_reduce``.
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def env_worker_context() -> dict | None:
    """Parse the injected worker-identity env; None when not on a slice."""
    if "TPU_WORKER_ID" not in os.environ:
        return None
    hostnames = [
        h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ]
    return {
        "worker_id": int(os.environ["TPU_WORKER_ID"]),
        "hostnames": hostnames,
        "num_processes": int(
            os.environ.get("JAX_NUM_PROCESSES", str(max(1, len(hostnames))))
        ),
        "process_id": int(
            os.environ.get("JAX_PROCESS_ID", os.environ["TPU_WORKER_ID"])
        ),
        "coordinator": os.environ.get("JAX_COORDINATOR_ADDRESS"),
        "topology": os.environ.get("TPU_TOPOLOGY"),
        "accelerator_type": os.environ.get("TPU_ACCELERATOR_TYPE"),
    }


def auto_initialize(*, device: str = "cuda", force: bool = False) -> dict | None:
    """Join the slice-wide process group if (and only if) this is a
    multi-host pod: ``"cpu:gloo,cuda:nccl"`` for ``device="cuda"``,
    ``gloo`` for ``device="cpu"``.

    Idempotent: a process already in the group keeps it unless ``force``
    (the culler restart path re-forms the identical group because admission
    re-injects the same identity).
    """
    ctx = env_worker_context()
    if ctx is None:
        return None
    if ctx["num_processes"] <= 1:
        return ctx  # single host: no process group to join
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' (nccl) or 'cpu' (gloo), got {device!r}")
    if not ctx["coordinator"]:
        raise ValueError("JAX_COORDINATOR_ADDRESS is not set: a multi-host pod needs the "
                         "coordinator's host:port to join its process group")
    import torch.distributed as dist

    if dist.is_initialized():
        if not force:
            return ctx
        dist.destroy_process_group()
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://{ctx['coordinator']}",
        world_size=ctx["num_processes"],
        rank=ctx["process_id"],
    )
    log.info(
        "joined slice %s as process %d/%d (coordinator %s)",
        ctx["topology"],
        ctx["process_id"],
        ctx["num_processes"],
        ctx["coordinator"],
    )
    return ctx
