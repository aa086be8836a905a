"""The port's train steps under ``seq > 1`` on both routes
(``parallel/train.py``), on gloo CPU ranks, against the port's one-device step
and the JAX step on the same plan; and the MoE routing scan over spans alone.

The span route: a ring model whose loss takes a span (``start``, ``S``), each
seq rank running the model and the loss on its span of every row. Here the
MoE LM (gather dispatch, ring attention), whose routing takes the whole row's
capacity and slots through the scan over the seq ranks' counts
(``models/moe.py`` ``route_top_k``), under the step's own chunked loss, under
``moe_lm_loss_chunked`` and under ``moe_lm_loss_fused``. The whole-row route:
every seq rank holds whole rows and computes the same loss, averaged over
seq. Here the dense ring LM under a plain caller's ``loss_fn`` (its attention
cuts its span and gathers the output, ``ring_attention_rows``), the dense
flash LM under the step's own loss, and the ResNet classifier (its BatchNorm
statistics over the row ranks only, checked through the running statistics
after the step).

Each case runs on seq=2 (2 ranks) and fsdp=2 x seq=2 (4 ranks), the worlds one
after the other (``file://`` stores under ``tmp_path``). Tolerances, as in
``tests/test_torch_sharded_axes.py``: against the one-device step (flash
attention, the same loss), loss rtol 1e-5 and every parameter (and running
statistic) after one fp32 SGD step atol 1e-5; against the JAX step on the
same plan on the 8-device CPU mesh (its ring attention in interpret mode for
the ring cases, XLA attention for the flash one), loss and global gradient
norm rtol 2e-4."""
from __future__ import annotations

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.parallel import mesh as tmesh

LR = 0.1
LM = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, embed_dim=64, mlp_dim=128,
          max_seq_len=32)
MOE = dict(vocab_size=256, num_layers=2, num_heads=2, embed_dim=64, expert_hidden_dim=128,
           num_experts=4, experts_per_token=2, capacity_factor=1.25, max_seq_len=32)
RESNET = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, width=8)
BATCH, RESNET_BATCH, IMAGE, CHUNK = 4, 4, 64, 8

PLANS = {2: dict(seq=2), 4: dict(fsdp=2, seq=2)}
# (kind, loss): the model and the loss the step takes
KINDS = [("moe", "own"), ("moe", "chunked"), ("moe", "fused"), ("lm_ring", "caller"),
         ("lm_flash", "own"), ("resnet", "own")]
CASES = [(f"{kind}_{loss}_{'_'.join(f'{a}{n}' for a, n in plan.items())}", world, kind, loss, plan)
         for world, plan in PLANS.items() for kind, loss in KINDS]
_RANK_INPUTS = None                # a rank's copy of the parent's inputs


@functools.cache
def _inputs():
    """Weights (flax inits carried across, numpy trees) and batches."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import resnet as jr
    from kubeflow_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, LM["vocab_size"], (BATCH, LM["max_seq_len"])).astype(np.int32)
    moe_tokens = rng.integers(0, MOE["vocab_size"], (BATCH, MOE["max_seq_len"])).astype(np.int32)
    images = rng.standard_normal((RESNET_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, RESNET["num_classes"], RESNET_BATCH).astype(np.int32)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    lm = tree(jt.TransformerLM(jt.TransformerConfig(**LM, attention_impl="xla", dtype=jnp.float32))
              .init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    moe = tree(jm.MoETransformerLM(jm.MoEConfig(**MOE, attention_impl="xla", dtype=jnp.float32))
               .init(jax.random.PRNGKey(1), jnp.asarray(moe_tokens))["params"])
    shapes = jax.eval_shape(lambda: jr.ResNet(**RESNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    draw_rng = np.random.default_rng(7)

    def draw(path, leaf):
        # kernels at lecun scale; norm scales around 1 (flax's zero bn3
        # scales would hide their blocks' gradients)
        name = path[-1].key
        if name == "kernel":
            return (draw_rng.standard_normal(leaf.shape) * np.prod(leaf.shape[:-1]) ** -0.5
                    ).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * draw_rng.random(leaf.shape)).astype(np.float32)
        center = 1.0 if name == "scale" else 0.0
        return (center + 0.2 * draw_rng.standard_normal(leaf.shape)).astype(np.float32)

    resnet = jax.tree_util.tree_map_with_path(draw, shapes)
    return dict(lm=(lm, tokens), moe=(moe, moe_tokens), resnet=(resnet, (images, labels)))


def _weights(kind):
    inputs = _RANK_INPUTS if _RANK_INPUTS is not None else _inputs()
    return inputs["lm" if kind.startswith("lm") else kind]


def _port_model(kind, weights, mesh=None):
    """The port's model; ring attention over ``mesh`` for the ring kinds on
    a mesh, flash attention otherwise (the one-device reference)."""
    ring = mesh is not None and kind in ("moe", "lm_ring")
    impl = dict(attention_impl="ring" if ring else "flash", mesh=mesh if ring else None)
    if kind == "moe":
        model = kt.MoETransformerLM(kt.MoEConfig(**MOE, dispatch="gather", dtype=torch.float32,
                                                 **impl), device="cpu")
        model.load_state_dict(kt.moe_params_from_flax(weights))
    elif kind == "resnet":
        model = kt.ResNet(**RESNET, dtype=torch.float32, bn_impl="pallas", device="cpu")
        model.load_state_dict(kt.resnet_params_from_flax(weights))
    else:
        model = kt.TransformerLM(kt.TransformerConfig(**LM, dtype=torch.float32, **impl),
                                 device="cpu")
        model.load_state_dict(kt.params_from_flax(weights))
    return model


def _caller_loss(model, tokens):
    """A caller's loss without the span keywords: the full-logits loss."""
    return kt.lm_loss(model(tokens), tokens)


def _loss_fn(loss):
    return {"own": None, "caller": _caller_loss,
            "chunked": functools.partial(kt.moe_lm_loss_chunked, chunk=CHUNK,
                                         compute_dtype=torch.float32),
            "fused": functools.partial(kt.moe_lm_loss_fused, compute_dtype=torch.float32)}[loss]


def _step_port(kind, loss, mesh=None):
    """One fp32 SGD step: (loss, names, the gradients the optimizer got, bundle, state, model)."""
    weights, batch = _weights(kind)
    model = _port_model(kind, weights, mesh)
    seen = []
    sgd = topt.sgd(LR, momentum=0.9)

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return sgd.update(grads, state, params)

    tx = topt.GradientTransformation(sgd.init, update)
    if kind == "resnet":
        bundle = kt.make_classifier_train_step(model, tx, mesh)
        batch = {"image": torch.from_numpy(batch[0]), "label": torch.from_numpy(batch[1]).long()}
    else:
        bundle = kt.make_lm_train_step(model, tx, mesh, loss_fn=_loss_fn(loss), chunk=CHUNK,
                                       loss_dtype=torch.float32)
        batch = torch.from_numpy(batch).long()
    state = bundle.init()
    state, metrics = bundle.step(state, batch)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return metrics["loss"].item(), names, seen[0], bundle, state, model


# ------------------------------------------------------------------ the ranks


def _run_case(case, rank):
    name, world, kind, loss, plan = case
    mesh = tmesh.create_mesh(tmesh.MeshPlan(**plan))
    value, names, grads, bundle, state, model = _step_port(kind, loss, mesh)
    out = dict(loss=value, buffers={n: b.clone() for n, b in model.named_buffers()},
               released=[getattr(m, a) in (None, False) for m in model.modules()
                         for a in ("group", "seq_group", "whole_rows") if hasattr(m, a)])
    params = bundle.gather(state["params"])
    grads = bundle.gather(dict(zip(names, grads)))
    if rank == 0:
        out.update(params=params, grads=grads)
    return out


def _rank_main(rank, world, store, cases, inputs, out):
    import torch.distributed as dist

    global _RANK_INPUTS
    torch.set_num_threads(1)
    _RANK_INPUTS = inputs          # the parent's flax init: no JAX in the ranks
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save({c[0]: _run_case(c, rank) for c in cases}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case name: [each rank's report]}, the worlds of 2 and 4 one after the other."""
    inputs = _inputs()
    ctx = mp.get_context("spawn")
    out = {}
    for world in PLANS:
        d = tmp_path_factory.mktemp(f"world{world}")
        cases = [c for c in CASES if c[1] == world]
        procs = [ctx.Process(target=_rank_main, args=(r, world, str(d / "store"), cases, inputs,
                                                      str(d)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
            [(p.exitcode, p.is_alive()) for p in procs]
        reports = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
        for name in reports[0]:
            out[name] = [rep[name] for rep in reports]
    return out


@functools.cache
def _single(kind, loss):
    """The port's one-device step on the whole batch: (loss, parameters, buffers after it)."""
    value, _, _, _, _, model = _step_port(kind, loss)
    return value, {n: p.detach().clone() for n, p in model.named_parameters()}, \
        {n: b.clone() for n, b in model.named_buffers()}


@functools.cache
def _jax(kind, loss, plan_items):
    """(loss, global gradient norm) of the JAX step's loss on the same plan
    over the first devices of the 8-device CPU mesh: the batch over the
    batch axes, every seq rank holding whole rows, the ring models' ring over
    seq."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import resnet as jr
    from kubeflow_tpu.models import transformer as jt
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.train import cross_entropy_loss

    plan = jmesh.MeshPlan(**dict(plan_items))
    mesh = jmesh.create_mesh(plan, devices=jax.devices()[:plan.size])
    weights, batch = _weights(kind)
    place = functools.partial(jax.device_put, device=jmesh.batch_sharding(mesh))
    if kind == "resnet":
        model = jr.ResNet(**RESNET, dtype=jnp.float32, bn_impl="xla")
        params = jax.device_put(weights["params"], jmesh.param_shardings(mesh, weights["params"]))
        stats = jax.device_put(weights["batch_stats"], jmesh.replicated(mesh))
        images, labels = place(jnp.asarray(batch[0])), place(jnp.asarray(batch[1]))

        def loss_fn(p):
            logits, _ = model.apply({"params": p, "batch_stats": stats}, images, train=True,
                                    mutable=["batch_stats"])
            return cross_entropy_loss(logits, labels)
    else:
        params = jax.device_put(weights, jmesh.param_shardings(mesh, weights))
        tokens = place(jnp.asarray(batch))
        ring = dict(attention_impl="ring", mesh=mesh)
        if kind == "moe":
            model = jm.MoETransformerLM(jm.MoEConfig(**MOE, dispatch="gather", dtype=jnp.float32,
                                                     **ring))
        else:
            model = jt.TransformerLM(jt.TransformerConfig(
                **LM, dtype=jnp.float32, **(ring if kind == "lm_ring" else dict(
                    attention_impl="xla"))))

        def loss_fn(p):
            if loss == "chunked":
                return jm.moe_lm_loss_chunked(model, p, tokens, chunk=CHUNK,
                                              compute_dtype=jnp.float32)
            if loss == "fused":
                return jm.moe_lm_loss_fused(model, p, tokens, compute_dtype=jnp.float32)
            if loss == "caller":
                return jt.lm_loss(model.apply({"params": p}, tokens), tokens)
            hidden = model.apply({"params": p}, tokens, return_hidden=True)
            return jt.lm_loss_chunked(hidden, p["embed"]["embedding"], tokens, chunk=CHUNK,
                                      compute_dtype=jnp.float32)
    with mesh:
        value, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(value), float(optax.global_norm(grads))


# ------------------------------------------------------------------ checks


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_seq_step_matches_the_single_device_step(ranks, name):
    """Every rank's loss, every parameter after the step and (ResNet) every
    rank's running statistics equal the one-device step's; no module keeps
    a group or the whole-row flag after the step."""
    _, _, kind, loss, _ = _case(name)
    value, params, buffers = _single(kind, loss)
    reports = ranks[name]
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], value, rtol=1e-5)
        for n, b in buffers.items():
            np.testing.assert_allclose(rep["buffers"][n].numpy(), b.numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)
        assert all(rep["released"]), "a module keeps a group or whole_rows after the step"
    got = reports[0]["params"]
    assert set(got) == set(params)
    for n, p in params.items():
        np.testing.assert_allclose(got[n].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_seq_step_matches_the_jax_step_on_the_same_plan(ranks, name):
    _, _, kind, loss, plan = _case(name)
    loss_j, norm_j = _jax(kind, loss, tuple(sorted(plan.items())))
    reports = ranks[name]
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in reports[0]["grads"].values())).item()
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss_j, rtol=2e-4)
    np.testing.assert_allclose(norm, norm_j, rtol=2e-4)


def test_each_route_is_taken():
    """The span route for a ring model whose loss takes ``start`` and ``S``
    (the MoE losses, the step's own); the whole-row route for a caller's
    loss without them, a model off the ring and the classifier."""
    from kubeflow_tpu_torch.parallel.train import takes_span

    assert takes_span(_loss_fn("chunked")) and takes_span(_loss_fn("fused"))
    assert not takes_span(_caller_loss) and not takes_span(kt.moe_lm_loss)
    assert not takes_span(lambda model, tokens, **kw: 0.0)


# ------------------------------------------------------------------ the scan alone


def _spans_plans(logits, k, capacity, n):
    """route_top_k on each of the n spans of ``logits`` [B, S, E], its
    slots from the scan over the spans' counts (the seq group's all-gather
    replaced by the spans' own counts, as the ranks' would be), and the
    whole rows' capacity."""
    spans = logits.chunk(n, dim=1)
    counts = torch.stack([
        torch.stack([tm._one_hot(e, logits.shape[2]).sum(dim=1)
                     for e in tm.route_top_k(s, k, capacity).experts]) for s in spans])
    plans = []
    size, gather = tm._seq_size, tm._seq_counts
    try:
        for r, s in enumerate(spans):
            tm._seq_size = lambda group: n
            tm._seq_counts = lambda c, group, r=r: (counts[:r].sum(dim=0), counts.sum(dim=0))
            plans.append(tm.route_top_k(s, k, capacity, seq_group="virtual"))
    finally:
        tm._seq_size, tm._seq_counts = size, gather
    return plans


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [8, 64])
def test_the_scan_over_spans_gives_the_whole_row_plan(n, k, capacity):
    """Each span's experts, gates, slots and keeps equal the whole-row
    plan's at its positions, bit for bit; capacity 8 drops tokens (checked),
    64 drops none."""
    gen = torch.Generator().manual_seed(10 * n + k)
    logits = torch.randn((3, 32, 4), generator=gen) * 2.0
    whole = tm.route_top_k(logits, k, capacity)
    plans = _spans_plans(logits, k, capacity, n)
    for field in ("experts", "gates", "pos", "keep"):
        got = torch.cat([getattr(p, field) for p in plans], dim=2)
        assert torch.equal(got, getattr(whole, field)), field
    assert (whole.keep == 0).any().item() == (capacity == 8)
