"""Entry points of the port: a one-card forward check and the
multi-rank dry run; counterpart of ``__graft_entry__.py``.

    python -m kubeflow_tpu_torch.graft_entry N [--device cpu]

runs ``dryrun_multichip(N)``: N ranks, one process each, joined by nccl on N
cards (``device="cuda"``, the default) or by gloo on the CPU
(``device="cpu"``, the reference's "multi-chip sharding sanity without
hardware"). Every rank runs the reference's sections in its order, with its
plans for each N, its configurations, seeds, batch shapes and optimizer
(``optax.adamw(1e-3)``: ``adamw_lowmem(1e-3, b2=0.999, weight_decay=1e-4)``
with fp32 moments), each through the port's own train step:

- ResNet (``stage_sizes=[1, 1]``, 16 classes, width 16, bf16, ``bn_impl='xla'``)
  under data x fsdp and, for even N, dcn x fsdp; the reference's parity (the
  loss and global gradient norm of a ``train=False`` forward, the batch
  sharded over the ranks, against one device), then each step's loss and
  global gradient norm held to the one-device step's, its global-batch
  BatchNorm statistics included, all at rtol 2e-4;
- the LM under fsdp x tensor x seq (ring attention where seq > 1, the
  chunked head, the tensor rule);
- the MoE LM (einsum dispatch) under data x expert x tensor (the MoE rule),
  and for N a multiple of 8 with the ``a2a`` dispatch at expert=4;
- the pipeline under stage x data x fsdp (2 microbatches), where N is even.

Rank 0 prints the reference's ``[dryrun] ...`` lines; a failure on any rank
fails the call.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import multiprocessing.connection
import tempfile
import time

import numpy as np
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.ops import optimizers as opt
from kubeflow_tpu_torch.parallel import mesh as meshlib

DRYRUN_TIMEOUT_S = 1800


def entry(device=None):
    """(fn, example_args): the flagship ResNet-50's inference forward
    (seeded weights at flax's init scale) and its example input, a batch of
    8 bf16 images of 224x224 of ones, on the card unless ``device`` says
    otherwise; ``fn(*example_args)`` gives the logits [8, 1000]."""
    model = kt.ResNet50(num_classes=1000, device=device)
    dev = model.head.weight.device
    model.load_state_dict(kt.resnet_init_state_dict(model.stage_sizes, 1000, seed=0, device=dev))
    x = torch.ones((8, 224, 224, 3), dtype=torch.bfloat16, device=dev)

    def forward(model, x):
        with torch.no_grad():
            return model(x, train=False)

    return forward, (model, x)


def _adamw():
    """``optax.adamw(1e-3)``'s defaults: b2 0.999, decay 1e-4, fp32 moments."""
    return kt.adamw_lowmem(1e-3, b2=0.999, weight_decay=1e-4, mu_dtype=None, nu_dtype=None)


def _first_step(model, mesh, batch, classifier: bool, **step_kw):
    """One step of the port's train step on ``mesh`` (None: one device):
    (loss, global norm of the gradients the optimizer got)."""
    got = []
    tx = _adamw()

    def update(grads, state, params):
        got.extend(g.detach().clone() for g in grads)
        return tx.update(grads, state, params)

    make = kt.make_classifier_train_step if classifier else kt.make_lm_train_step
    bundle = make(model, opt.GradientTransformation(tx.init, update), mesh, **step_kw)
    _, metrics = bundle.step(bundle.init(), batch)
    if mesh is not None:
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        got = list(bundle.gather(dict(zip(names, got))).values())
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in got)).item()
    return metrics["loss"].item(), norm


def _eval_parity(model, mesh, batch):
    """The reference's parity check: (loss, global gradient norm) of the
    ``train=False`` forward's mean cross entropy, on one device
    (``mesh=None``) or with the batch in equal shards over every rank of
    ``mesh`` (a data x fsdp or dcn x fsdp plan, whose ranks all hold
    different rows, in rank order), each rank differentiating its share of
    the global mean, as GSPMD differentiates the global loss."""
    import torch.distributed as dist

    image, label = batch["image"], batch["label"]
    n = 1
    if mesh is not None:
        n, r = dist.get_world_size(), dist.get_rank()
        rows = image.shape[0] // n
        image, label = image[r * rows:(r + 1) * rows], label[r * rows:(r + 1) * rows]
    params = [p for p in model.parameters() if p.requires_grad]
    loss = kt.cross_entropy_loss(model(image, train=False), label)
    grads = [g.clone() for g in torch.autograd.grad(loss / n, params)]
    loss = loss.detach() / n
    if mesh is not None:
        for t in (loss, *grads):
            dist.all_reduce(t)
    return loss.item(), torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).item()


def _sections(n: int, device, say) -> None:
    """The reference's sections, in its order, on this rank."""
    rng = np.random.default_rng(0)

    # ---- ResNet under dp x fsdp, and parity with one device
    resnet_kw = dict(stage_sizes=[1, 1], num_classes=16, width=16)

    def resnet(device):
        model = kt.ResNet(**resnet_kw, device=device)
        model.load_state_dict(kt.resnet_init_state_dict(**resnet_kw, seed=0, device=device))
        return model

    def resnet_step(mesh, batch):
        return _first_step(resnet(device), mesh, batch, classifier=True)

    dp = 2 if n % 2 == 0 else 1
    plan = meshlib.MeshPlan(data=dp, fsdp=n // dp)
    batch = {"image": torch.from_numpy(rng.standard_normal((2 * n, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 16, 2 * n))}
    batch = {k: v.to(device) for k, v in batch.items()}
    mesh = meshlib.create_mesh(plan)
    loss, gnorm = resnet_step(mesh, batch)
    say(f"[dryrun] resnet dp={plan.data} fsdp={plan.fsdp}: loss={loss:.4f}")
    got = _eval_parity(resnet(device), mesh, batch)
    want = _eval_parity(resnet(device), None, batch)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    say(f"[dryrun] parity dp={plan.data} fsdp={plan.fsdp} vs 1-device: loss {got[0]:.6f}~"
        f"{want[0]:.6f} |g| {got[1]:.6f}~{want[1]:.6f}")
    ref_loss, ref_gnorm = resnet_step(None, batch)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
    np.testing.assert_allclose(gnorm, ref_gnorm, rtol=2e-4)
    say(f"[dryrun] step parity dp={plan.data} fsdp={plan.fsdp} vs 1-device (train step, "
        f"global BatchNorm statistics): loss {loss:.6f}~{ref_loss:.6f} |g| {gnorm:.6f}~"
        f"{ref_gnorm:.6f}")

    # ---- ResNet under dcn x fsdp (data parallel over DCN)
    if n % 2 == 0:
        plan = meshlib.MeshPlan(dcn=2, fsdp=n // 2)
        loss, gnorm = resnet_step(meshlib.create_mesh(plan), batch)
        say(f"[dryrun] resnet dcn={plan.dcn} fsdp={plan.fsdp} (2-slice multislice): "
            f"loss={loss:.4f}")
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
        np.testing.assert_allclose(gnorm, ref_gnorm, rtol=2e-4)

    # ---- Transformer under fsdp x tensor x seq (ring attention)
    if n % 4 == 0:
        plan = meshlib.MeshPlan(fsdp=n // 4, tensor=2, seq=2)
    elif n % 2 == 0:
        plan = meshlib.MeshPlan(fsdp=n // 2, seq=2)
    else:
        plan = meshlib.MeshPlan(fsdp=n)
    mesh = meshlib.create_mesh(plan)
    cfg = kt.TransformerConfig(
        vocab_size=128, num_layers=2, num_heads=4, embed_dim=128, mlp_dim=256, max_seq_len=64,
        attention_impl="ring" if plan.seq > 1 else "block", attention_block_size=32,
        dtype=torch.float32, mesh=mesh if plan.seq > 1 else None)
    lm = kt.TransformerLM(cfg, device=device)
    lm.load_state_dict(kt.init_state_dict(cfg, seed=0, device=device))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2 * max(1, plan.fsdp), 64)))
    loss, _ = _first_step(lm, mesh, tokens.to(device), classifier=False,
                          param_rule=meshlib.tensor_param_spec, chunk=32)
    say(f"[dryrun] transformer fsdp={plan.fsdp} tensor={plan.tensor} seq={plan.seq} "
        f"({cfg.attention_impl} attention): loss={loss:.4f}")

    # ---- MoE under data x expert x tensor (einsum dispatch)
    if n % 8 == 0:
        plan = meshlib.MeshPlan(data=n // 4, expert=2, tensor=2)
    elif n % 2 == 0:
        plan = meshlib.MeshPlan(data=n // 2, expert=2)
    else:
        plan = meshlib.MeshPlan(data=n)
    mesh = meshlib.create_mesh(plan)
    moe_cfg = kt.MoEConfig(
        vocab_size=128, num_layers=2, num_heads=4, embed_dim=128, expert_hidden_dim=256,
        num_experts=4, experts_per_token=2, max_seq_len=32, attention_impl="xla",
        dtype=torch.float32)

    def moe_step(cfg, mesh, tokens):
        model = kt.MoETransformerLM(cfg, device=device)
        model.load_state_dict(kt.moe_init_state_dict(cfg, seed=0, device=device))
        return _first_step(model, mesh, tokens.to(device), classifier=False,
                           param_rule=meshlib.moe_param_spec, loss_fn=kt.moe_lm_loss)[0]

    tokens = torch.from_numpy(rng.integers(0, moe_cfg.vocab_size, (2 * plan.data, 32)))
    loss = moe_step(moe_cfg, mesh, tokens)
    say(f"[dryrun] moe data={plan.data} expert={plan.expert} tensor={plan.tensor}: "
        f"loss={loss:.4f}")

    # ---- MoE ep=4 with the all-to-all dispatch
    if n % 8 == 0:
        plan = meshlib.MeshPlan(data=n // 4, expert=4)
        mesh = meshlib.create_mesh(plan)
        a2a_cfg = dataclasses.replace(moe_cfg, dispatch="a2a", mesh=mesh)
        tokens = torch.from_numpy(rng.integers(0, a2a_cfg.vocab_size, (2 * n, 32)))
        loss = moe_step(a2a_cfg, mesh, tokens)
        say(f"[dryrun] moe-a2a data={plan.data} expert=4: loss={loss:.4f}")

    # ---- Pipeline under stage x data x fsdp (GPipe)
    if n % 8 == 0:
        plan = meshlib.MeshPlan(stage=2, data=2, fsdp=n // 4)
    elif n % 2 == 0:
        plan = meshlib.MeshPlan(stage=2, data=n // 2)
    else:
        plan = meshlib.MeshPlan(data=n)
    mesh = meshlib.create_mesh(plan)
    pp_cfg = kt.TransformerConfig(
        vocab_size=128, num_layers=2, num_heads=4, embed_dim=128, mlp_dim=256, max_seq_len=32,
        attention_impl="xla", dtype=torch.float32)
    tokens = torch.from_numpy(
        rng.integers(0, pp_cfg.vocab_size, (4 * plan.data * plan.fsdp, 32)))
    if plan.stage > 1:
        init, step = kt.make_pipeline_train_step(pp_cfg, mesh, _adamw(), num_microbatches=2)
        params, opt_state = init(0, device=device)
        _, _, loss = step(params, opt_state, tokens.to(device))
        say(f"[dryrun] pipeline stage={plan.stage} data={plan.data} fsdp={plan.fsdp} "
            f"(2 microbatches): loss={loss.item():.4f}")


def _rank_main(rank: int, world: int, store: str, device: str) -> None:
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        _sections(world, dev, (lambda line: print(line, flush=True)) if rank == 0 else
                  (lambda line: None))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device: str = "cuda") -> None:
    """Run the full training steps over an ``n_devices``-rank mesh, one
    process a rank: nccl on as many cards (``device="cuda"``), or gloo on
    the CPU (``device="cpu"``). Raises if any rank fails (its exit code) or
    the ranks outlast ``DRYRUN_TIMEOUT_S``; stops every rank it started."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' (nccl) or 'cpu' (gloo), got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on device='cuda' takes {n_devices} cards, this host "
            f"has {torch.cuda.device_count()}; pass device='cpu' for {n_devices} gloo ranks on "
            "the CPU")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as folder:
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, f"{folder}/store", device))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline, failed, timed_out = time.monotonic() + DRYRUN_TIMEOUT_S, [], False
        try:
            pending = list(procs)
            while pending and not failed:
                left = deadline - time.monotonic()
                done = multiprocessing.connection.wait([p.sentinel for p in pending],
                                                       timeout=max(left, 0))
                if not done:
                    timed_out = True
                    break
                for p in [p for p in pending if p.sentinel in done]:
                    p.join()
                    pending.remove(p)
                    if p.exitcode:
                        failed.append((procs.index(p), p.exitcode))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed or timed_out:
            raise RuntimeError(f"dry run over {n_devices} ranks failed: (rank, exit code) "
                               f"{failed}" + (f", {len(pending)} ranks still running after "
                                              f"{DRYRUN_TIMEOUT_S} s" if timed_out else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    # the ranks' target must come from the package module, not __main__
    from kubeflow_tpu_torch import graft_entry

    graft_entry.main()
