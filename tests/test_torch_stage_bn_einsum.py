"""Three plans the JAX steps compute and the port's sharded train steps
(``parallel/train.py`` under a mesh) once refused, on gloo CPU ranks, against
the port's one-device step and the JAX step on the same plan:

- ``stage > 1`` in ``make_lm_train_step`` and ``make_classifier_train_step``:
  the JAX steps replicate over stage (no rule names it, the batch spec is
  dcn x data x fsdp), so stage ranks hold the same rows and shards and
  nothing is summed over stage; the dense LM and a small ResNet on stage=2
  and stage=2 x data=2;
- ``bn_impl='xla'`` under more than one batch rank: flax's ``BatchNorm``
  normalises with the global batch's moments under GSPMD, so the port's
  ``BatchNorm`` sums its fp32 Σx and Σx² over the batch group with their
  gradient; the dry run's ResNet (``__graft_entry__.py:72``) on data=2,
  data=2 x fsdp=2 and stage=2 x data=2;
- ``dispatch='einsum'`` with the expert tables split over expert (the JAX
  default dispatch on an expert mesh, ``kubeflow_tpu/models/moe.py:228-246``):
  every expert rank routes the same rows and runs its E/ep experts' slots;
  the dry run's MoE config (``__graft_entry__.py:230-241``) on expert=2,
  data=2 x expert=2 and expert=2 x tensor=2 under ``moe_param_spec``.

Two seeded faults must fail the same checks: the xla BatchNorm left out of
the batch reducers (per-rank statistics), and the einsum experts' partial
outputs not summed over the expert group.

One module fixture spawns a world of 4 ranks and a world of 2 (a
``file://`` store under ``tmp_path``); each rank builds the model from the
same weights, steps once (fp32 SGD) on the same global batch and reports
its loss, its stored shards, its buffers and (rank 0) the gathered
parameters and gradients. Tolerances as ``tests/test_torch_sharded_train.py``:
against the one-device step loss rtol 1e-5, parameters and running
statistics atol 1e-5 (summation order only); against the JAX step on the
same plan on the 8-device CPU mesh, loss and global gradient norm rtol 2e-4
(``__graft_entry__.py``'s dry run)."""
from __future__ import annotations

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import moe as tmoe
from kubeflow_tpu_torch.models.resnet import BatchNorm
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import train as ttrain

LR = 0.1
LM = dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128, max_seq_len=32)
MOE = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=128, expert_hidden_dim=256,
           num_experts=4, experts_per_token=2, max_seq_len=32)
RESNET = dict(stage_sizes=[1, 1], num_classes=16, width=16)
LM_BATCH, MOE_BATCH, RESNET_BATCH, IMAGE = 8, 4, 8, 32

# (name, world, kind, plan, fault)
CASES = [
    ("lm_stage2", 2, "lm", dict(stage=2), None),
    ("resnet_stage2", 2, "resnet", dict(stage=2), None),
    ("resnet_data2", 2, "resnet", dict(data=2), None),
    ("moe_expert2", 2, "moe", dict(expert=2), None),
    ("lm_stage2_data2", 4, "lm", dict(stage=2, data=2), None),
    ("resnet_stage2_data2", 4, "resnet", dict(stage=2, data=2), None),
    ("resnet_data2_fsdp2", 4, "resnet", dict(data=2, fsdp=2), None),
    ("moe_data2_expert2", 4, "moe", dict(data=2, expert=2), None),
    ("moe_expert2_tensor2", 4, "moe", dict(expert=2, tensor=2), None),
    ("resnet_data2_local_bn", 2, "resnet", dict(data=2), "local_bn"),
    ("moe_expert2_partial_y", 2, "moe", dict(expert=2), "partial_y"),
]
GOOD = [c[0] for c in CASES if c[4] is None]
RULES = {"lm": tmesh.fsdp_param_spec, "resnet": tmesh.fsdp_param_spec,
         "moe": tmesh.moe_param_spec}


@functools.cache
def _inputs():
    """Weights (flax inits carried across, numpy trees) and batches, per kind."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import resnet as jr
    from kubeflow_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, LM["vocab_size"], (LM_BATCH, LM["max_seq_len"])).astype(np.int32)
    moe_tokens = rng.integers(0, MOE["vocab_size"], (MOE_BATCH, MOE["max_seq_len"])).astype(np.int32)
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


def _port_model(kind, weights):
    if kind == "lm":
        model = kt.TransformerLM(kt.TransformerConfig(**LM, attention_impl="xla",
                                                      dtype=torch.float32), device="cpu")
        model.load_state_dict(kt.params_from_flax(weights))
    elif kind == "moe":
        model = kt.MoETransformerLM(kt.MoEConfig(**MOE, attention_impl="xla", dispatch="einsum",
                                                 dtype=torch.float32), device="cpu")
        model.load_state_dict(kt.moe_params_from_flax(weights))
    else:
        model = kt.ResNet(**RESNET, dtype=torch.float32, bn_impl="xla", device="cpu")
        model.load_state_dict(kt.resnet_params_from_flax(weights))
    return model


def _step_port(kind, weights, batch, mesh=None):
    """One fp32 SGD step: (loss, names, the gradients the optimizer got, bundle, state, model)."""
    model = _port_model(kind, weights)
    seen = []
    sgd = topt.sgd(LR, momentum=0.9)

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return sgd.update(grads, state, params)

    tx = topt.GradientTransformation(sgd.init, update)
    if kind == "resnet":
        bundle = kt.make_classifier_train_step(model, tx, mesh, param_rule=RULES[kind])
        batch = {"image": torch.from_numpy(batch[0]), "label": torch.from_numpy(batch[1]).long()}
    elif kind == "moe":
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=RULES[kind],
                                       loss_fn=kt.moe_lm_loss)
        batch = torch.from_numpy(batch).long()
    else:
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=RULES[kind], chunk=16,
                                       loss_dtype=torch.float32)
        batch = torch.from_numpy(batch).long()
    state = bundle.init()
    state, metrics = bundle.step(state, batch)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return metrics["loss"].item(), names, seen[0], bundle, state, model


# ------------------------------------------------------------------ the ranks


def _run_case(case, inputs, rank):
    name, world, kind, plan, fault = case
    weights, batch = inputs[kind]
    mesh = tmesh.create_mesh(tmesh.MeshPlan(**plan))
    reducers, reduce_y = ttrain._BATCH_REDUCERS, tmoe.reduce_from_group
    if fault == "local_bn":       # BatchNorm never given the batch group
        ttrain._BATCH_REDUCERS = tuple(t for t in reducers if t is not BatchNorm)
    if fault == "partial_y":      # the experts' partial outputs not summed over the expert group
        tmoe.reduce_from_group = lambda x, group: x
    try:
        loss, names, grads, bundle, state, model = _step_port(kind, weights, batch, mesh)
    finally:
        ttrain._BATCH_REDUCERS, tmoe.reduce_from_group = reducers, reduce_y
    out = dict(loss=loss, shards={n: t.clone() for n, t in state["params"].items()},
               buffers={n: b.clone() for n, b in model.named_buffers()},
               coord=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
               released=[getattr(m, a) is None for m in model.modules()
                         for a in ("group", "tensor_group", "expert_group") if hasattr(m, a)])
    params = bundle.gather(state["params"])
    grads = bundle.gather(dict(zip(names, grads)))
    if rank == 0:
        out.update(params=params, grads=grads)
    return out


def _rank_main(rank, world, store, cases, inputs, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save({c[0]: _run_case(c, inputs, rank) for c in cases}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case name: [each rank's report]} from one spawn of each world."""
    inputs = _inputs()
    ctx = mp.get_context("spawn")
    procs, dirs = [], {}
    for world in (4, 2):
        d = dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        cases = [c for c in CASES if c[1] == world]
        procs += [ctx.Process(target=_rank_main, args=(r, world, str(d / "store"), cases, inputs,
                                                       str(d)))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.exitcode, p.is_alive()) for p in procs]
    out = {}
    for world, d in dirs.items():
        reports = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
        for name in reports[0]:
            out[name] = [rep[name] for rep in reports]
    return out


@functools.cache
def _single(kind):
    """The port's one-device step on the whole batch: (loss, parameters and
    buffers after it)."""
    weights, batch = _inputs()[kind]
    loss, _, _, _, _, model = _step_port(kind, weights, batch)
    return loss, {n: p.detach().clone() for n, p in model.named_parameters()}, \
        {n: b.clone() for n, b in model.named_buffers()}


@functools.cache
def _jax(kind, plan_items):
    """(loss, global gradient norm) of the JAX step's loss on the same plan
    over the first devices of the 8-device CPU mesh: the parameters placed by
    the case's rule, the batch over the batch axes (the MoE tokens over
    (data, fsdp), as ``__graft_entry__.py:255-257``), the einsum dispatch's
    sharding constraints under the mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import resnet as jr
    from kubeflow_tpu.models import transformer as jt
    from kubeflow_tpu.models.transformer import lm_loss_chunked
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.train import cross_entropy_loss

    plan = jmesh.MeshPlan(**dict(plan_items))
    mesh = jmesh.create_mesh(plan, devices=jax.devices()[:plan.size])
    weights, batch = _inputs()[kind]
    rule = {"lm": jmesh.fsdp_param_spec, "resnet": jmesh.fsdp_param_spec,
            "moe": jmesh.moe_param_spec}[kind]
    place = functools.partial(jax.device_put, device=jmesh.batch_sharding(mesh))
    if kind == "resnet":
        model = jr.ResNet(**RESNET, dtype=jnp.float32, bn_impl="xla")
        params = jax.device_put(weights["params"],
                                jmesh.param_shardings(mesh, weights["params"], rule))
        stats = jax.device_put(weights["batch_stats"], jmesh.replicated(mesh))
        images, labels = place(jnp.asarray(batch[0])), place(jnp.asarray(batch[1]))

        def loss_fn(p):
            logits, _ = model.apply({"params": p, "batch_stats": stats}, images, train=True,
                                    mutable=["batch_stats"])
            return cross_entropy_loss(logits, labels)
    elif kind == "lm":
        params = jax.device_put(weights, jmesh.param_shardings(mesh, weights, rule))
        model = jt.TransformerLM(jt.TransformerConfig(**LM, attention_impl="xla",
                                                      dtype=jnp.float32))
        tokens = place(jnp.asarray(batch))

        def loss_fn(p):
            hidden = model.apply({"params": p}, tokens, return_hidden=True)
            return lm_loss_chunked(hidden, p["embed"]["embedding"], tokens, chunk=16,
                                   compute_dtype=jnp.float32)
    else:
        params = jax.device_put(weights, jmesh.param_shardings(mesh, weights, rule))
        model = jm.MoETransformerLM(jm.MoEConfig(**MOE, attention_impl="xla", dispatch="einsum",
                                                 dtype=jnp.float32))
        tokens = jax.device_put(jnp.asarray(batch), NamedSharding(mesh, P(("data", "fsdp"))))

        def loss_fn(p):
            return jm.moe_lm_loss(model, p, tokens)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(grads))


# ------------------------------------------------------------------ checks


def _check_against_single(kind, reports):
    """The sharded step reproduces the one-device step: the loss on every
    rank, every parameter after the step, and the running statistics on
    every rank."""
    loss, params, buffers = _single(kind)
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss, rtol=1e-5)
    got = reports[0]["params"]
    assert set(got) == set(params)
    for n, p in params.items():
        np.testing.assert_allclose(got[n].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=n)
    for rep in reports:
        for n, b in buffers.items():
            np.testing.assert_allclose(rep["buffers"][n].numpy(), b.numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", GOOD)
def test_step_matches_the_single_device_step(ranks, name):
    _check_against_single(_case(name)[2], ranks[name])


@pytest.mark.parametrize("name", GOOD)
def test_step_matches_the_jax_step_on_the_same_plan(ranks, name):
    _, _, kind, plan, _ = _case(name)
    loss_j, norm_j = _jax(kind, tuple(sorted(plan.items())))
    reports = ranks[name]
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in reports[0]["grads"].values())).item()
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss_j, rtol=2e-4)
    np.testing.assert_allclose(norm, norm_j, rtol=2e-4)


@pytest.mark.parametrize("name", GOOD)
def test_replicas_hold_the_same_parts(ranks, name):
    """Ranks that differ only on the axes that split neither rows nor
    parameters (stage; expert under the einsum dispatch, for every parameter
    but the expert tables) hold bit-equal parts after the step; no module
    keeps a group."""
    _, _, kind, plan, _ = _case(name)
    reports = ranks[name]
    for rep in reports:
        assert all(rep["released"]), "a module keeps a group after the step"
    for axis in ("stage", "expert"):
        if plan.get(axis, 1) == 1:
            continue
        for a in reports:
            for b in reports:
                if {k for k in a["coord"] if a["coord"][k] != b["coord"][k]} != {axis}:
                    continue
                assert a["loss"] == b["loss"]
                for n, t in a["shards"].items():
                    if axis == "expert" and "experts_w" in n:
                        continue
                    assert torch.equal(t, b["shards"][n]), (axis, n)


def test_per_rank_xla_batch_norm_statistics_are_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("resnet", ranks["resnet_data2_local_bn"])


def test_unsummed_einsum_expert_outputs_are_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("moe", ranks["moe_expert2_partial_y"])
