"""The port's train steps on the seq, tensor and expert axes (``parallel/train.py``
under a mesh) on gloo CPU ranks, against the port's one-device step and the
JAX step on the same plan.

One module fixture spawns a world of 4 ranks and a world of 2 (a ``file://``
store under ``tmp_path``, as ``tests/test_torch_sharded_train.py`` does);
each rank builds the model from the same weights, steps once on the same
global batch and reports its loss, its stored shard shapes and (rank 0) the
gathered parameters and gradients. The cases: the dense LM (GQA, 4 query
heads over 2 kv heads) under ``tensor_param_spec`` on seq=2 and data=2 x
seq=2 (ring attention, each row cut into two spans), tensor=2 and data=2 x
tensor=2 (Megatron: 2 query heads and 1 kv head a rank), and the layers half
split over tensor, whose KV heads do not divide over it (k and v held whole,
each rank projecting the KV head its query heads read): tensor=4 (1 query
head a rank over the 2 kv heads) and, with 1 kv head, tensor=2; the MoE LM with the
``a2a`` dispatch under ``moe_param_spec`` on expert=2, data=2 x expert=2 and
expert=2 x tensor=2 (the JAX ``ep2xtp2`` case, ``tests/test_moe.py``), and
with the gather dispatch on tensor=2 (its experts' hidden dim split); and
two seeded faults, which the same checks must catch: the seq ranks'
gradients not summed, and the tensor split's backward all-reduce (the
gradient that ``copy_to_group`` sums over the tensor ranks at each split
layer's input) left out.

Tolerances: against the one-device step, loss rtol 1e-5 and every parameter
after one fp32 SGD step atol 1e-5 (summation order only); against the JAX
step on the same plan on the 8-device CPU mesh, loss and global gradient
norm rtol 2e-4, as in ``tests/test_torch_sharded_train.py``. The JAX side
runs ring attention (its Pallas kernels in interpret mode) on the seq plans,
XLA attention elsewhere, and the ``a2a`` dispatch on the expert plans (the
gather dispatch on the others).
Also here: the steps' refusals (``a2a`` without an expert axis, ``gather``
on an expert mesh, in the model and in the step, a ring over another mesh
than the step's, a half split other than whole k/v), on stand-in meshes
before any process group is touched. (The seq cases the step once refused,
an MoE model, a caller's loss, the classifier and a model off the ring, are
``tests/test_torch_seq_routes.py``'s.)"""
from __future__ import annotations

import functools
import multiprocessing as mp
import types

import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.ops import optimizers as topt
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import train as ttrain

LR = 0.1
LM = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, embed_dim=64, mlp_dim=128,
          max_seq_len=32)
MOE = dict(vocab_size=256, num_layers=1, num_heads=2, embed_dim=64, expert_hidden_dim=128,
           num_experts=4, experts_per_token=2, capacity_factor=1.25, max_seq_len=32)
BATCH, CHUNK = 8, 16

# (name, world, kind, plan, fault)
CASES = [
    ("lm_seq2", 2, "lm", dict(seq=2), None),
    ("lm_data2_seq2", 4, "lm", dict(data=2, seq=2), None),
    ("lm_tensor2", 2, "lm", dict(tensor=2), None),
    ("lm_data2_tensor2", 4, "lm", dict(data=2, tensor=2), None),
    ("lm_tensor4", 4, "lm", dict(tensor=4), None),
    ("lm_kv1_tensor2", 2, "lm_kv1", dict(tensor=2), None),
    ("moe_expert2", 2, "moe", dict(expert=2), None),
    ("moe_data2_expert2", 4, "moe", dict(data=2, expert=2), None),
    ("moe_expert2_tensor2", 4, "moe", dict(expert=2, tensor=2), None),
    ("moe_tensor2", 2, "moe", dict(tensor=2), None),
    ("lm_seq2_no_seq_sum", 2, "lm", dict(seq=2), "no_seq_sum"),
    ("lm_tensor2_no_tensor_all_reduce", 2, "lm", dict(tensor=2), "no_tensor_all_reduce"),
]
GOOD = [c[0] for c in CASES if c[4] is None]
RULES = {"lm": tmesh.tensor_param_spec, "lm_kv1": tmesh.tensor_param_spec,
         "moe": tmesh.moe_param_spec}
LM_KV1 = dict(LM, num_kv_heads=1)


@functools.cache
def _inputs():
    """Weights (flax inits carried across, numpy trees) and token batches."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, LM["vocab_size"], (BATCH, LM["max_seq_len"])).astype(np.int32)
    moe_tokens = rng.integers(0, MOE["vocab_size"], (BATCH, MOE["max_seq_len"])).astype(np.int32)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    lm = tree(jt.TransformerLM(jt.TransformerConfig(**LM, attention_impl="xla", dtype=jnp.float32))
              .init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    moe = tree(jm.MoETransformerLM(jm.MoEConfig(**MOE, attention_impl="xla", dtype=jnp.float32))
               .init(jax.random.PRNGKey(1), jnp.asarray(moe_tokens))["params"])
    # one kv head: the first of the LM's, its k and v kernels [E, KV, D] cut to it
    kv1 = jax.tree_util.tree_map_with_path(
        lambda path, w: w[:, :1] if any(getattr(k, "key", None) in ("k_proj", "v_proj")
                                        for k in path) else w, lm)
    return dict(lm=(lm, tokens), lm_kv1=(kv1, tokens), moe=(moe, moe_tokens))


def _port_model(kind, weights, mesh=None, plan=None):
    """The port's model: on a mesh, ring attention where the plan splits seq
    and the a2a dispatch where it splits expert, both over that mesh."""
    plan = plan or {}
    if kind in ("lm", "lm_kv1"):
        ring = plan.get("seq", 1) > 1
        model = kt.TransformerLM(kt.TransformerConfig(
            **(LM if kind == "lm" else LM_KV1), attention_impl="ring" if ring else "flash",
            dtype=torch.float32,
            mesh=mesh if ring else None), device="cpu")
        model.load_state_dict(kt.params_from_flax(weights))
    else:
        a2a = plan.get("expert", 1) > 1
        model = kt.MoETransformerLM(kt.MoEConfig(
            **MOE, attention_impl="flash", dispatch="a2a" if a2a else "gather",
            dtype=torch.float32, mesh=mesh if a2a else None), device="cpu")
        model.load_state_dict(kt.moe_params_from_flax(weights))
    return model


def _step_port(kind, weights, batch, mesh=None, plan=None):
    """One fp32 SGD step: (loss, names, the gradients the optimizer got, bundle, state, model)."""
    model = _port_model(kind, weights, mesh, plan)
    seen = []
    sgd = topt.sgd(LR, momentum=0.9)

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return sgd.update(grads, state, params)

    tx = topt.GradientTransformation(sgd.init, update)
    if kind != "moe":
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=RULES[kind], chunk=CHUNK,
                                       loss_dtype=torch.float32)
    else:
        bundle = kt.make_lm_train_step(model, tx, mesh, param_rule=RULES[kind],
                                       loss_fn=functools.partial(
                                           kt.moe_lm_loss_chunked, chunk=CHUNK,
                                           compute_dtype=torch.float32))
    state = bundle.init()
    state, metrics = bundle.step(state, torch.from_numpy(batch).long())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return metrics["loss"].item(), names, seen[0], bundle, state, model


# ------------------------------------------------------------------ the ranks


def _run_case(case, inputs, rank):
    name, world, kind, plan, fault = case
    weights, batch = inputs[kind]
    mesh = tmesh.create_mesh(tmesh.MeshPlan(**plan))
    reduce_axes, copy_backward = ttrain._Sharded._reduce_axes, collectives._CopyToGroup.backward
    if fault == "no_seq_sum":
        ttrain._Sharded._reduce_axes = lambda self, n: tuple(
            a for a in reduce_axes(self, n) if a != "seq")
    if fault == "no_tensor_all_reduce":
        collectives._CopyToGroup.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        loss, names, grads, bundle, state, model = _step_port(kind, weights, batch, mesh, plan)
    finally:
        ttrain._Sharded._reduce_axes = reduce_axes
        collectives._CopyToGroup.backward = copy_backward
    out = dict(loss=loss, shapes={n: tuple(t.shape) for n, t in state["params"].items()},
               released=[getattr(m, a) is None for m in model.modules()
                         for a in ("group", "tensor_group") if hasattr(m, a)])
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
    """The port's one-device step on the whole batch: (loss, parameters after it)."""
    weights, batch = _inputs()[kind]
    loss, _, _, _, _, model = _step_port(kind, weights, batch)
    return loss, {n: p.detach().clone() for n, p in model.named_parameters()}


@functools.cache
def _jax(kind, plan_items):
    """(loss, global gradient norm) of the JAX step's loss on the same plan
    over the first devices of the 8-device CPU mesh, the parameters placed by
    the case's rule and the batch over the batch axes (the a2a layout's
    (data, fsdp, expert) on the expert plans)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.models import moe as jm
    from kubeflow_tpu.models import transformer as jt
    from kubeflow_tpu.models.transformer import lm_loss_chunked
    from kubeflow_tpu.parallel import mesh as jmesh

    plan = jmesh.MeshPlan(**dict(plan_items))
    mesh = jmesh.create_mesh(plan, devices=jax.devices()[:plan.size])
    weights, batch = _inputs()[kind]
    rule = jmesh.moe_param_spec if kind == "moe" else jmesh.tensor_param_spec
    params = jax.device_put(weights, jmesh.param_shardings(mesh, weights, rule))
    if kind != "moe":
        ring = plan.seq > 1
        model = jt.TransformerLM(jt.TransformerConfig(
            **(LM if kind == "lm" else LM_KV1), attention_impl="ring" if ring else "xla",
            dtype=jnp.float32,
            mesh=mesh if ring else None))
        tokens = jax.device_put(jnp.asarray(batch), jmesh.batch_sharding(mesh))

        def loss_fn(p):
            hidden = model.apply({"params": p}, tokens, return_hidden=True)
            return lm_loss_chunked(hidden, p["embed"]["embedding"], tokens, chunk=CHUNK,
                                   compute_dtype=jnp.float32)
    else:
        a2a = plan.expert > 1
        model = jm.MoETransformerLM(jm.MoEConfig(**MOE, attention_impl="xla",
                                                 dispatch="a2a" if a2a else "gather",
                                                 dtype=jnp.float32, mesh=mesh if a2a else None))
        tokens = jax.device_put(jnp.asarray(batch),
                                NamedSharding(mesh, P(("data", "fsdp", "expert"))))

        def loss_fn(p):
            return jm.moe_lm_loss_chunked(model, p, tokens, chunk=CHUNK,
                                          compute_dtype=jnp.float32)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(grads))


# ------------------------------------------------------------------ checks


def _check_against_single(kind, reports):
    """The sharded step reproduces the one-device step: the loss on every
    rank and every parameter after the step."""
    loss, params = _single(kind)
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss, rtol=1e-5)
    got = reports[0]["params"]
    assert set(got) == set(params)
    for n, p in params.items():
        np.testing.assert_allclose(got[n].numpy(), p.numpy(), atol=1e-5, rtol=0, err_msg=n)


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", GOOD)
def test_axis_step_matches_the_single_device_step(ranks, name):
    _check_against_single(_case(name)[2], ranks[name])


@pytest.mark.parametrize("name", GOOD)
def test_axis_step_matches_the_jax_step_on_the_same_plan(ranks, name):
    _, _, kind, plan, _ = _case(name)
    loss_j, norm_j = _jax(kind, tuple(sorted(plan.items())))
    reports = ranks[name]
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in reports[0]["grads"].values())).item()
    for rep in reports:
        np.testing.assert_allclose(rep["loss"], loss_j, rtol=2e-4)
    np.testing.assert_allclose(norm, norm_j, rtol=2e-4)


@pytest.mark.parametrize("name", GOOD)
def test_each_rank_holds_its_part(ranks, name):
    """Each rank stores the rule's part of every parameter (a dim split over
    tensor or expert divided by that axis's size); after the step no module
    keeps a batch or tensor group."""
    _, _, kind, plan, _ = _case(name)
    model = _port_model(kind, _inputs()[kind][0])
    mesh_plan = tmesh.MeshPlan(**plan)
    sizes = mesh_plan.axis_sizes()
    specs = tmesh.param_shardings(mesh_plan, model, RULES[kind])
    split = set()
    for rep in ranks[name]:
        for n, p in model.named_parameters():
            want = list(p.shape)
            for d, entry in enumerate(specs[n]):
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        want[d] //= sizes[a]
                        split |= {a} if sizes[a] > 1 else set()
            assert rep["shapes"][n] == tuple(want), n
        assert all(rep["released"]), "a module keeps a group after the step"
    assert split & {"tensor", "expert"} or plan.get("seq", 1) > 1


def test_unsummed_seq_gradients_are_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("lm", ranks["lm_seq2_no_seq_sum"])


def test_a_missing_tensor_all_reduce_is_caught(ranks):
    with pytest.raises(AssertionError):
        _check_against_single("lm", ranks["lm_tensor2_no_tensor_all_reduce"])


# ------------------------------------------------------------------ refusals


def _stand_in(**plan):
    """A mesh stand-in with a mesh's dim names and shape: enough for every
    check the steps make before they touch a process group."""
    shape = [plan.get(a, 1) for a in tmesh.AXES]
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXES, mesh=torch.zeros(shape))


def test_refusals():
    moe_cfg = functools.partial(kt.MoEConfig, **MOE, dtype=torch.float32)
    with pytest.raises(ValueError, match="expert axis"):
        kt.MoETransformerLM(moe_cfg(dispatch="a2a"), device="cpu")
    with pytest.raises(ValueError, match="expert axis"):
        kt.MoETransformerLM(moe_cfg(dispatch="a2a", mesh=tmesh.MeshPlan(data=2)), device="cpu")
    with pytest.raises(ValueError, match="expert-parallel"):
        kt.MoETransformerLM(moe_cfg(dispatch="gather", mesh=tmesh.MeshPlan(expert=2)),
                            device="cpu")
    moe = kt.MoETransformerLM(moe_cfg(dispatch="gather"), device="cpu")
    with pytest.raises(ValueError, match="expert-split tables run dispatch='einsum', or 'a2a'"):
        kt.make_lm_train_step(moe, kt.sgd(0.1), _stand_in(expert=2),
                              param_rule=tmesh.moe_param_spec, loss_fn=kt.moe_lm_loss_chunked)
    # a ring over another mesh's seq axis than the step's
    ring = kt.TransformerLM(kt.TransformerConfig(**LM, attention_impl="ring", dtype=torch.float32,
                                                 mesh=tmesh.MeshPlan(seq=2)), device="cpu")
    with pytest.raises(ValueError, match="must be the step's mesh"):
        kt.make_lm_train_step(ring, kt.sgd(0.1), _stand_in(seq=2))


def test_a_layer_half_split_over_tensor_is_refused_with_its_shapes(ranks):
    """One kv head cannot be split over two tensor ranks, nor two over
    four: the legalised rule splits q_proj and o_proj but leaves k_proj and
    v_proj whole. The step computes that layer (each rank projects the kv
    head its query heads read, the whole k/v gradients summed over tensor),
    as the JAX step does: it matches the one-device step. A half split of
    another shape (here a rule that splits an MLP's gate but not its up
    projection) is still refused, with the shapes."""
    specs = tmesh.param_shardings(tmesh.MeshPlan(tensor=2), _port_model(
        "lm_kv1", _inputs()["lm_kv1"][0]), tmesh.tensor_param_spec)
    assert specs["layers.0.attn.q_proj.weight"] == ("tensor", "fsdp")
    assert specs["layers.0.attn.k_proj.weight"] == (None, "fsdp")
    _check_against_single("lm_kv1", ranks["lm_kv1_tensor2"])
    _check_against_single("lm", ranks["lm_tensor4"])

    def gate_only(path, value):
        spec = tmesh.tensor_param_spec(path, value)
        return tuple(None if a == "tensor" else a for a in spec) if "up_proj" in path else spec

    lm = kt.TransformerLM(kt.TransformerConfig(**LM, attention_impl="flash", dtype=torch.float32),
                          device="cpu")
    with pytest.raises(ValueError, match=r"layers\.0\.mlp: the rule splits .*gate_proj.* over "
                                         r"tensor=2 and leaves .*up_proj.*\(128, 64\).*half split"):
        kt.make_lm_train_step(lm, kt.sgd(0.1), _stand_in(tensor=2), param_rule=gate_only)


@pytest.mark.parametrize("heads,kv,tp", [(4, 1, 2), (4, 2, 4), (6, 3, 2), (6, 2, 3)])
def test_a_half_split_attention_over_virtual_tensor_ranks_is_the_whole_layer(
        monkeypatch, heads, kv, tp):
    """An ``Attention`` whose k/v stay whole under a tensor split, walked over
    ``tp`` virtual ranks in one process (each rank's q rows and o columns,
    the whole k/v, the rank from a stand-in group; the partials summed as the
    all-reduce sums them) gives the unsplit layer's output and gradients.
    The rank's query heads read their KV heads in equal groups (4/1 over 2,
    4/2 over 4, 6/2 over 3: rank 1's heads 2-3 read KV 0 and 1, one each) or
    unevenly (6/3 over 2: heads 0-2 read KV 0, 0, 1), expanded to one a head."""
    from kubeflow_tpu_torch.models import transformer as tt

    cfg = kt.TransformerConfig(vocab_size=32, num_layers=1, num_heads=heads, num_kv_heads=kv,
                               embed_dim=16 * heads, mlp_dim=32, attention_impl="flash",
                               dtype=torch.float32)
    torch.manual_seed(heads * 10 + kv)
    attn = tt.Attention(cfg, device="cpu")
    for w in attn.parameters():
        torch.nn.init.normal_(w, std=0.2)
    x = torch.randn(2, 8, cfg.embed_dim, requires_grad=True)
    rope = tt.rope_tables(torch.arange(8), cfg.head_dim, cfg.rope_theta)
    g = torch.randn(2, 8, cfg.embed_dim)
    weights = dict(attn.named_parameters())
    want = attn(x, rope)
    want_grads = torch.autograd.grad((want * g).sum(), (x, *weights.values()))

    monkeypatch.setattr(tt, "copy_to_group", lambda t, group: t)
    monkeypatch.setattr(tt, "reduce_from_group", lambda t, group: t)
    rows = heads // tp * cfg.head_dim
    got = 0
    for r in range(tp):
        monkeypatch.setattr(tt.dist, "get_rank", lambda group, r=r: r)
        part = {n: w for n, w in weights.items()}
        part["q_proj.weight"] = weights["q_proj.weight"][r * rows:(r + 1) * rows]
        part["o_proj.weight"] = weights["o_proj.weight"][:, r * rows:(r + 1) * rows]
        attn.tensor_group = "virtual"
        got = got + torch.func.functional_call(attn, part, (x, rope))
    attn.tensor_group = None
    got_grads = torch.autograd.grad((got * g).sum(), (x, *weights.values()))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for name, a, b in zip(["x", *weights], got_grads, want_grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
