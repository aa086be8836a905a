"""The port's mesh module (``parallel/mesh.py``) and bootstrap against the JAX
package's: the three parameter rules and ``_legalize`` on every parameter of
the flagship models (as the JAX rule sees it: flax path and shape), the
layout map from each port parameter to its flax twin, the split carried
through that map (the same values land on each shard), ``auto_plan``,
``create_mesh``'s size errors, the batch spec and placements, and the env
contract of the bootstrap (``tests/test_parallel.py``'s cases)."""
from __future__ import annotations

import functools
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.models import resnet as jr
from kubeflow_tpu.models import transformer as jt
from kubeflow_tpu.parallel import mesh as jmesh
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.parallel import bootstrap as tboot
from kubeflow_tpu_torch.parallel import mesh as tmesh

# the flagship configurations of chip_smoke.py (dense train, MoE train),
# with two layers: the rules see shapes, and every layer repeats the first
DENSE = dict(vocab_size=32_000, num_layers=2, num_heads=8, embed_dim=1024, mlp_dim=4096,
             max_seq_len=2048)
DECODE = dict(DENSE, num_kv_heads=4)
MOE = dict(vocab_size=32_000, num_layers=2, num_heads=8, embed_dim=1024, expert_hidden_dim=2048,
           num_experts=8, experts_per_token=2, max_seq_len=2048)
RESNET50 = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, width=64)
RULES = [("fsdp_param_spec", "fsdp"), ("tensor_param_spec", "tensor"), ("moe_param_spec", "moe")]
PLANS = [dict(fsdp=4), dict(data=2, fsdp=2, tensor=2), dict(fsdp=8), dict(fsdp=3),
         dict(expert=2, fsdp=2, tensor=2), dict(dcn=2, fsdp=4), dict()]


def _flax_leaves(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(k, "key", k)) for k in kp)] = leaf
    return out


@functools.cache
def _models():
    """(name, port model on the meta device, flax param shapes by path)."""
    tokens = jnp.zeros((1, 8), jnp.int32)
    out = []
    for name, cfg_kw in (("dense", DENSE), ("decode", DECODE)):
        port = kt.TransformerLM(kt.TransformerConfig(**cfg_kw), device="meta")
        shapes = jax.eval_shape(lambda: jt.TransformerLM(jt.TransformerConfig(**cfg_kw)).init(
            jax.random.PRNGKey(0), tokens)["params"])
        out.append((name, port, _flax_leaves(shapes)))
    port = kt.MoETransformerLM(kt.MoEConfig(**MOE), device="meta")
    shapes = jax.eval_shape(lambda: jm.MoETransformerLM(jm.MoEConfig(**MOE)).init(
        jax.random.PRNGKey(0), tokens)["params"])
    out.append(("moe", port, _flax_leaves(shapes)))
    port = kt.ResNet(**RESNET50, device="meta")
    shapes = jax.eval_shape(lambda: jr.ResNet(**RESNET50).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)["params"])
    out.append(("resnet50", port, _flax_leaves(shapes)))
    return out


def _head_dim(model):
    return tmesh._head_dim(model)


@pytest.mark.parametrize("which", ["dense", "decode", "moe", "resnet50"])
def test_every_port_parameter_maps_onto_its_flax_twin(which):
    """Each port parameter's flax path exists in the JAX model with the
    layout's shape, and the map is one to one."""
    _, port, leaves = next(m for m in _models() if m[0] == which)
    seen = set()
    for name, p in port.named_parameters():
        layout = tmesh.flax_layout(name, p.shape, _head_dim(port))
        assert layout.path in leaves, (name, layout.path)
        assert tuple(leaves[layout.path].shape) == layout.shape, name
        held = sorted(d for dims in layout.dims for d in dims)
        assert held == list(range(len(layout.shape))), name
        seen.add(layout.path)
    assert seen == set(leaves)


@pytest.mark.parametrize("which", ["dense", "decode", "moe", "resnet50"])
@pytest.mark.parametrize("rule,_tag", RULES)
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "x".join(f"{k}{v}" for k, v in p.items()) or "one")
def test_rules_and_legalize_match_jax(which, rule, _tag, plan):
    """The port's rule, legalised, gives the JAX rule's legalised
    PartitionSpec entries on every parameter, and ``param_shardings``
    carries them to the port's dims."""
    _, port, leaves = next(m for m in _models() if m[0] == which)
    mplan = tmesh.MeshPlan(**plan)
    jax_mesh = jmesh.create_mesh(jmesh.MeshPlan(**plan), devices=jax.devices()[:mplan.size])
    jrule, trule = getattr(jmesh, rule), getattr(tmesh, rule)
    specs = tmesh.param_shardings(mplan, port, trule)
    for name, p in port.named_parameters():
        layout = tmesh.flax_layout(name, p.shape, _head_dim(port))
        leaf = leaves[layout.path]
        want = jmesh._legalize(jrule(layout.path, leaf), leaf.shape, jax_mesh)
        got = tmesh._legalize(trule(layout.path, leaf), layout.shape, mplan)
        assert got == tuple(want), name
        assert specs[name] == tmesh.port_spec(got, layout), name


def _unique_flax(shape, seed):
    return np.random.default_rng(seed).permutation(int(np.prod(shape))).reshape(shape).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["lm", "moe", "resnet"])
def test_the_split_carries_the_same_values_through_the_layout(kind):
    """Flax weights of unique values through ``interop``: for the fsdp
    split of each parameter, the port's shard i (a chunk along the port
    dim) holds exactly the values of the JAX shard i (a split along the
    flax dim), e.g. a split of H is a contiguous block of H·D rows."""
    if kind == "lm":
        cfg = dict(vocab_size=256, num_layers=1, num_heads=4, embed_dim=128, mlp_dim=256,
                   max_seq_len=16)
        model = jt.TransformerLM(jt.TransformerConfig(**cfg))
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 8), jnp.int32))["params"])
        port = kt.TransformerLM(kt.TransformerConfig(**cfg), device="meta")
        convert, rule = kt.params_from_flax, tmesh.tensor_param_spec
    elif kind == "moe":
        cfg = dict(vocab_size=256, num_layers=1, num_heads=2, embed_dim=128, expert_hidden_dim=256,
                   num_experts=4, max_seq_len=16)
        model = jm.MoETransformerLM(jm.MoEConfig(**cfg))
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 8), jnp.int32))["params"])
        port = kt.MoETransformerLM(kt.MoEConfig(**cfg), device="meta")
        convert, rule = kt.moe_params_from_flax, tmesh.moe_param_spec
    else:
        cfg = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, width=32)
        model = jr.ResNet(**cfg)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))["params"]
        port = kt.ResNet(**cfg, device="meta")
        convert, rule = (lambda p: kt.resnet_params_from_flax({"params": p})), \
            tmesh.fsdp_param_spec
    leaves = _flax_leaves(shapes)
    values = jax.tree_util.tree_map_with_path(
        lambda kp, leaf: _unique_flax(leaf.shape, zlib.crc32(str(kp).encode())), shapes)
    flat = _flax_leaves(values)
    sd = convert(values)
    plan = tmesh.MeshPlan(fsdp=2, tensor=2, expert=2 if kind == "moe" else 1)
    specs = tmesh.param_shardings(plan, port, rule)
    n_split = 0
    for name, p in port.named_parameters():
        layout = tmesh.flax_layout(name, p.shape, _head_dim(port))
        flax_spec = tmesh._legalize(rule(layout.path, leaves[layout.path]), layout.shape, plan)
        for axis in ("fsdp", "tensor", "expert"):
            dims = [d for d, e in enumerate(flax_spec) if e == axis]
            port_dims = [d for d, e in enumerate(specs[name]) if e == axis]
            assert len(dims) == len(port_dims) <= 1, name
            if not dims:
                continue
            n_split += 1
            flax_parts = np.split(flat[layout.path], 2, axis=dims[0])
            port_parts = sd[name].chunk(2, dim=port_dims[0])
            for f, t in zip(flax_parts, port_parts):
                assert np.array_equal(np.sort(f.ravel()), np.sort(t.numpy().ravel())), (name, axis)
    assert n_split


def test_a_split_the_layout_interleaves_is_refused():
    layout = tmesh.flax_layout("layers.0.attn.q_proj.weight", (8 * 256, 128), 256)
    assert layout.shape == (128, 8, 256) and layout.dims == ((1, 2), (0,))
    assert tmesh.port_spec((None, "tensor", None), layout) == ("tensor", None)
    with pytest.raises(ValueError, match="interleaves"):
        tmesh.port_spec((None, None, "fsdp"), layout, "q_proj")


@pytest.mark.parametrize("n,tensor,seq", [(8, 1, 1), (8, 2, 1), (8, 2, 2), (4, 4, 1), (6, 2, 1),
                                          (1, 1, 1)])
def test_auto_plan_matches_jax(n, tensor, seq):
    got = tmesh.auto_plan(n, tensor=tensor, seq=seq)
    assert got.axis_sizes() == jmesh.auto_plan(n, tensor=tensor, seq=seq).axis_sizes()
    assert got.size == n and tmesh.AXES == jmesh.AXES


def test_auto_plan_and_create_mesh_refuse_what_does_not_fit():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.auto_plan(6, tensor=4)
    with pytest.raises(ValueError, match=r"mesh plan needs 4 devices .* have 3"):
        tmesh.create_mesh(tmesh.MeshPlan(fsdp=4), devices=[0, 1, 2])
    with pytest.raises(ValueError, match="physical topology"):
        tmesh.create_mesh(tmesh.MeshPlan(fsdp=4), devices=[0, 1, 2, 3], physical_topology=(2, 2, 2))


def test_batch_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert tmesh.batch_spec() == tuple(jmesh.batch_spec())
    fake = types.SimpleNamespace(mesh_dim_names=tmesh.AXES)
    want = [Shard(0) if a in ("dcn", "data", "fsdp") else Replicate() for a in tmesh.AXES]
    assert tmesh.batch_sharding(fake) == want
    assert tmesh.replicated(fake) == [Replicate()] * 7
    assert tmesh.placements(fake, (None, "tensor")) == [
        Shard(1) if a == "tensor" else Replicate() for a in tmesh.AXES]


def test_bootstrap_without_env_returns_none(monkeypatch):
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    assert tboot.env_worker_context() is None
    assert tboot.auto_initialize() is None


def test_bootstrap_parses_the_injected_contract(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES",
                       "nb-0.nb-tpu.ns.svc.cluster.local,nb-1.nb-tpu.ns.svc.cluster.local")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "nb-0.nb-tpu.ns.svc.cluster.local:8476")
    monkeypatch.setenv("TPU_TOPOLOGY", "2x2x2")
    from kubeflow_tpu.parallel import bootstrap as jboot

    ctx = tboot.env_worker_context()
    assert ctx == jboot.env_worker_context()
    assert ctx["worker_id"] == 1 and ctx["num_processes"] == 2
    assert ctx["coordinator"].endswith(":8476") and len(ctx["hostnames"]) == 2
    with pytest.raises(ValueError, match="'cuda' \\(nccl\\) or 'cpu' \\(gloo\\)"):
        tboot.auto_initialize(device="tpu")


def test_bootstrap_single_host_skips_the_process_group(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("TPU_WORKER_ID", "0")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    ctx = tboot.auto_initialize()
    assert ctx is not None and ctx["num_processes"] == 1
    assert not dist.is_initialized()


def test_bootstrap_passes_the_contract_to_init_process_group(monkeypatch):
    """A multi-host contract reaches ``init_process_group`` as the
    rendezvous (the coordinator), the world (the process count) and the rank
    (the process id), with gloo for ``device="cpu"`` and otherwise nccl
    beside a gloo CPU backend (``"cpu:gloo,cuda:nccl"``)."""
    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "nb-0:8476")
    tboot.auto_initialize(device="cpu")
    assert seen == dict(backend="gloo", init_method="tcp://nb-0:8476", world_size=2, rank=1)
    tboot.auto_initialize()
    assert seen["backend"] == "cpu:gloo,cuda:nccl"
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        tboot.auto_initialize(device="cpu")
