"""The port's sharded train steps (``parallel/train.py`` under a mesh) on gloo
CPU ranks, against the port's one-device step and the JAX step on the same
plan.

One module fixture spawns a world of 4 ranks and a world of 2 (a ``file://``
store under ``tmp_path``, so no TCP port is shared between test workers);
each rank builds the model from the same weights, steps once on the same
global batch and reports its loss, its stored shard shapes, the state's
specs and (rank 0) the gathered parameters and gradients. The cases: the
dense LM on data=2 x fsdp=2 and on fsdp=4, the MoE LM (gather dispatch) on
data=2, ResNet (train-mode BatchNorm through ``PallasBatchNorm``) on data=2 x
fsdp=2 and on dcn=2 x fsdp=2, the dense LM under the tensor rule on data=2 x
fsdp=2 and the MoE LM under the MoE rule on data=2 (their tensor and expert
entries name axes of size 1, which split nothing); and two seeded faults, a
no-op gradient reduction (dense LM) and per-rank BatchNorm statistics
(ResNet), which the same checks must catch.

Tolerances: against the one-device step, loss rtol 1e-5 and every parameter
after one fp32 SGD step atol 1e-5 (``tests/test_parallel.py``'s sharded-step
test: summation order only); against the JAX step on the same plan on the
8-device CPU mesh, loss and global gradient norm rtol 2e-4
(``__graft_entry__.py``'s dry run). The JAX side runs its XLA attention,
einsum dispatch and XLA BatchNorm, whose numbers the port's plain versions
match in the other ``test_torch_*`` files, and is computed once in this
process."""
from __future__ import annotations

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import train as ttrain

LR = 0.1
LM = dict(vocab_size=256, num_layers=2, num_heads=4, embed_dim=64, mlp_dim=128, max_seq_len=32)
MOE = dict(vocab_size=256, num_layers=1, num_heads=2, embed_dim=64, expert_hidden_dim=128,
           num_experts=4, experts_per_token=2, capacity_factor=1.25, max_seq_len=32)
RESNET = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, width=8)
LM_BATCH, MOE_BATCH, RESNET_BATCH, IMAGE = 8, 4, 8, 64

# (name, world, kind, plan, variant): "accum2" two microbatches a rank,
# "tensor_rule" / "moe_rule" that parameter rule in place of the fsdp rule,
# "no_reduction" and "local_bn" the seeded faults
CASES = [
    ("lm_data2_fsdp2", 4, "lm", dict(data=2, fsdp=2), None),
    ("lm_data2_fsdp2_accum2", 4, "lm", dict(data=2, fsdp=2), "accum2"),
    ("lm_data2_fsdp2_tensor_rule", 4, "lm", dict(data=2, fsdp=2), "tensor_rule"),
    ("lm_fsdp4", 4, "lm", dict(fsdp=4), None),
    ("moe_data2", 2, "moe", dict(data=2), None),
    ("moe_data2_moe_rule", 2, "moe", dict(data=2), "moe_rule"),
    ("resnet_data2_fsdp2", 4, "resnet", dict(data=2, fsdp=2), None),
    ("resnet_dcn2_fsdp2", 4, "resnet", dict(dcn=2, fsdp=2), None),
    ("lm_data2_fsdp2_no_reduction", 4, "lm", dict(data=2, fsdp=2), "no_reduction"),
    ("resnet_data2_fsdp2_local_bn", 4, "resnet", dict(data=2, fsdp=2), "local_bn"),
]
GOOD = [c[0] for c in CASES if c[4] not in ("no_reduction", "local_bn")]
RULES = {"tensor_rule": tmesh.tensor_param_spec, "moe_rule": tmesh.moe_param_spec}


# ------------------------------------------------------------------ inputs


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


def _state_dict(kind, weights):
    if kind == "lm":
        return kt.params_from_flax(weights)
    if kind == "moe":
        return kt.moe_params_from_flax(weights)
    return kt.resnet_params_from_flax(weights)


def _port_model(kind, sd):
    if kind == "lm":
        model = kt.TransformerLM(kt.TransformerConfig(**LM, attention_impl="flash",
                                                      dtype=torch.float32), device="cpu")
    elif kind == "moe":
        model = kt.MoETransformerLM(kt.MoEConfig(**MOE, attention_impl="flash", dispatch="gather",
                                                 dtype=torch.float32), device="cpu")
    else:
        model = kt.ResNet(**RESNET, dtype=torch.float32, bn_impl="pallas", device="cpu")
    model.load_state_dict(sd)
    return model


def _recording_sgd(seen):
    """``sgd(LR, momentum=0.9)`` that keeps the gradients it is given
    (shards under a mesh). Its first update is -LR * g, as plain SGD's, and
    its trace is a slot shaped like the parameters."""
    sgd = topt.sgd(LR, momentum=0.9)

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return sgd.update(grads, state, params)

    return topt.GradientTransformation(sgd.init, update)


def _step_port(kind, sd, batch, mesh=None, variant=None):
    """One fp32 SGD step of the port: (loss, names, gradients, bundle, state, model)."""
    model = _port_model(kind, sd)
    seen = []
    tx = _recording_sgd(seen)
    rule = RULES.get(variant, tmesh.fsdp_param_spec)
    if kind == "resnet":
        bundle = kt.make_classifier_train_step(model, tx, mesh, param_rule=rule)
        batch = {"image": torch.from_numpy(batch[0]), "label": torch.from_numpy(batch[1]).long()}
    elif kind == "moe":
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=rule, loss_fn=functools.partial(
            kt.moe_lm_loss_chunked, chunk=16, compute_dtype=torch.float32))
        batch = torch.from_numpy(batch).long()
    else:
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=rule, chunk=16,
                                       loss_dtype=torch.float32,
                                       accum_steps=2 if variant == "accum2" else 1)
        batch = torch.from_numpy(batch).long()
    state = bundle.init()
    state, metrics = bundle.step(state, batch)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return metrics["loss"].item(), names, seen[0], bundle, state, model


# ------------------------------------------------------------------ the ranks


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in x for t in _tensors(v)] if isinstance(x, (list, tuple)) else []


def _run_case(case, inputs, rank):
    name, world, kind, plan, variant = case
    weights, batch = inputs[kind]
    mesh = tmesh.create_mesh(tmesh.MeshPlan(**plan))
    reduce, reducers = ttrain._Sharded.reduce, ttrain._BATCH_REDUCERS
    if variant == "no_reduction":
        ttrain._Sharded.reduce = lambda self, n, g: self.shard(n, g)
    if variant == "local_bn":     # BatchNorm never given the batch group
        ttrain._BATCH_REDUCERS = tuple(t for t in reducers if t is not kt.PallasBatchNorm)
    try:
        loss, names, grads, bundle, state, model = _step_port(kind, _state_dict(kind, weights),
                                                              batch, mesh, variant)
    finally:
        ttrain._Sharded.reduce, ttrain._BATCH_REDUCERS = reduce, reducers
    params = bundle.gather(state["params"])
    grads = bundle.gather(dict(zip(names, grads)))
    out = dict(loss=loss, shapes={n: tuple(t.shape) for n, t in state["params"].items()},
               shardings=bundle.state_shardings,
               buffers={n: b.clone() for n, b in model.named_buffers()},
               # bytes each stored shard and optimizer slot keeps alive, and its own
               stored=[(t.untyped_storage().nbytes(), t.numel() * t.element_size())
                       for t in _tensors(state["params"]) + _tensors(state["opt_state"])],
               released=[m.group is None for m in model.modules() if hasattr(m, "group")])
    if kind == "lm":
        # the reference's errors: a batch the ranks cannot share equally, and
        # accum_steps that does not divide the batch
        errors = []
        for rows in (6, 7, 4):
            try:
                bundle.step(state, torch.zeros((rows, LM["max_seq_len"]), dtype=torch.long))
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = errors
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
        d = tmp_path_factory.mktemp(f"world{world}")
        dirs[world] = d
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
    """The port's one-device step on the whole batch."""
    weights, batch = _inputs()[kind]
    loss, names, grads, _, _, model = _step_port(kind, _state_dict(kind, weights), batch)
    return loss, {n: p.detach().clone() for n, p in model.named_parameters()}, \
        {n: b.clone() for n, b in model.named_buffers()}


@functools.cache
def _jax(kind, plan_items, variant=None):
    """(loss, global gradient norm) of the JAX model on the same plan over
    the first devices of the 8-device CPU mesh, the batch and the
    parameters placed by the JAX rule of the case, as ``__graft_entry__.py``
    does."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import resnet as jr
    from kubeflow_tpu.models import transformer as jt
    from kubeflow_tpu.models.transformer import lm_loss_chunked
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.train import cross_entropy_loss

    plan = jmesh.MeshPlan(**dict(plan_items))
    rule = {"tensor_rule": jmesh.tensor_param_spec,
            "moe_rule": jmesh.moe_param_spec}.get(variant, jmesh.fsdp_param_spec)
    mesh = jmesh.create_mesh(plan, devices=jax.devices()[:plan.size])
    weights, batch = _inputs()[kind]
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
    else:
        params = jax.device_put(weights, jmesh.param_shardings(mesh, weights, rule))
        tokens = place(jnp.asarray(batch))
        if kind == "lm":
            model = jt.TransformerLM(jt.TransformerConfig(**LM, attention_impl="xla",
                                                          dtype=jnp.float32))

            def loss_fn(p):
                hidden = model.apply({"params": p}, tokens, return_hidden=True)
                return lm_loss_chunked(hidden, p["embed"]["embedding"], tokens, chunk=16,
                                       compute_dtype=jnp.float32)
        else:
            model = jm.MoETransformerLM(jm.MoEConfig(**MOE, attention_impl="xla", dispatch="einsum",
                                                     dtype=jnp.float32))

            def loss_fn(p):
                return jm.moe_lm_loss_chunked(model, p, tokens, chunk=16,
                                              compute_dtype=jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(grads))


# ------------------------------------------------------------------ checks


def _check_against_single(kind, reports):
    """The sharded step reproduces the one-device step: the loss on every
    rank, every parameter after the step, and ResNet's running statistics
    on every rank."""
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
def test_sharded_step_matches_the_single_device_step(ranks, name):
    _check_against_single(_case(name)[2], ranks[name])


@pytest.mark.parametrize("name", GOOD)
def test_sharded_step_matches_the_jax_step_on_the_same_plan(ranks, name):
    _, _, kind, plan, variant = _case(name)
    loss_j, norm_j = _jax(kind, tuple(sorted(plan.items())), variant)
    reports = ranks[name]
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in reports[0]["grads"].values())).item()
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss_j, rtol=2e-4)
    np.testing.assert_allclose(norm, norm_j, rtol=2e-4)


@pytest.mark.parametrize("name", GOOD)
def test_each_rank_stores_the_rules_shards(ranks, name):
    """Each rank's stored parameter shapes are the rule's shards: the
    sharded dim divided by its axes' sizes, a replicated parameter whole;
    optimizer slots shaped like the parameters follow their specs. Each
    stored shard and slot is an allocation of its own size (a view of the
    whole parameter would keep all of it alive), and after the step no
    module holds the batch group."""
    _, world, kind, plan, variant = _case(name)
    weights, _ = _inputs()[kind]
    model = _port_model(kind, _state_dict(kind, weights))
    mesh_plan = tmesh.MeshPlan(**plan)
    specs = tmesh.param_shardings(mesh_plan, model, RULES.get(variant, tmesh.fsdp_param_spec))
    sizes = mesh_plan.axis_sizes()
    names = [n for n, _ in model.named_parameters()]
    split = 0
    for rep in ranks[name]:
        assert rep["shardings"]["params"] == specs
        assert rep["shardings"]["step"] == ()
        assert rep["shardings"]["opt_state"] == [{"trace": [specs[n] for n in names]}, ()]
        for n, p in model.named_parameters():
            want = list(p.shape)
            for d, entry in enumerate(specs[n]):
                if entry is not None:
                    want[d] //= int(np.prod([sizes[a] for a in np.atleast_1d(entry)]))
                    split += 1
            assert rep["shapes"][n] == tuple(want), n
        assert rep["stored"] and all(kept == own for kept, own in rep["stored"]), rep["stored"]
        assert all(rep["released"]), "a module keeps the batch group after the step"
    assert split, "the rule splits no parameter of this model"


def test_indivisible_batches_keep_the_reference_errors(ranks):
    """Rows the 4 batch ranks cannot share equally are refused; with two
    microbatches the reference's accum_steps check comes first, and a
    rank's share of 1 row cannot be cut in two."""
    refused = "batch {} must be divisible by the 4 batch ranks (dcn x data x fsdp)"
    for rep in ranks["lm_data2_fsdp2"]:
        assert rep["errors"] == [refused.format(6), refused.format(7)]
    for rep in ranks["lm_data2_fsdp2_accum2"]:
        assert rep["errors"] == [refused.format(6), "accum_steps 2 must divide batch 7",
                                 "accum_steps 2 must divide the local batch 1 of each of the 4 "
                                 "batch ranks"]


def test_a_missing_gradient_reduction_is_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("lm", ranks["lm_data2_fsdp2_no_reduction"])


def test_per_rank_batch_norm_statistics_are_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("resnet", ranks["resnet_data2_fsdp2_local_bn"])
