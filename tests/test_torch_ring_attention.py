"""Ring attention (``kubeflow_tpu_torch/parallel/ring_attention.py``) on gloo
CPU ranks, against the naive oracle and the JAX ring.

One module fixture spawns a world of 4 ranks and a world of 2 (a ``file://``
store under ``tmp_path``, as ``tests/test_torch_sharded_train.py`` does), on
``MeshPlan(seq=4)`` and ``MeshPlan(seq=2)``. Each rank runs the ring on its
chunk of q, k, v (``tests/test_attention.py``'s B 2, S 256, D 32, with 4
query heads over 2 kv heads), causal and non-causal, then the backward of
sum(o²), and reports its o, dq, dk and dv. The references: ``naive_attention``
on k and v repeated to the query heads, and the JAX ``ring_attention`` on
``MeshPlan(data=2, seq=n)`` of the 8-device CPU mesh (its Pallas kernels in
interpret mode), given the repeated k and v too: its backward adds dk and dv
of the query heads into accumulators shaped like them, so their gradients
are summed over each group here. Tolerances: atol 2e-5 on o and 5e-4 on dq,
dk and dv, those of ``tests/test_attention.py``'s ring tests. Also: ``_merge``
against the JAX ``_merge`` with empty (+inf) rows, the ring's branch
schedule, and ``chip_smoke.py``'s one-process walk of the ring (the card's
check of the same schedule) against the same references."""
from __future__ import annotations

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch

import chip_smoke
from kubeflow_tpu_torch.parallel import ring_attention as ra

B, S, H, KV, D = 2, 256, 4, 2, 32
WORLDS = (4, 2)
O_ATOL, GRAD_ATOL = 2e-5, 5e-4


@functools.cache
def _qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def _rank_main(rank, world, store, qkv, out):
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = tmesh.create_mesh(tmesh.MeshPlan(seq=world))
        c = S // world
        res = {}
        for causal in (True, False):
            q, k, v = (torch.from_numpy(x[:, rank * c:(rank + 1) * c]).requires_grad_()
                       for x in qkv)
            o = ra.ring_attention(q, k, v, mesh, causal=causal)
            (o ** 2).sum().backward()
            res[causal] = (o.detach(), q.grad, k.grad, v.grad)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{(world, causal): (o, dq, dk, dv) of the whole sequence}, each rank's
    chunk in its place."""
    qkv = _qkv()
    ctx = mp.get_context("spawn")
    procs, dirs = [], {}
    for world in WORLDS:
        d = dirs[world] = tmp_path_factory.mktemp(f"ring{world}")
        procs += [ctx.Process(target=_rank_main, args=(r, world, str(d / "store"), qkv, str(d)))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.exitcode, p.is_alive()) for p in procs]
    out = {}
    for world, d in dirs.items():
        reports = [torch.load(d / f"rank{r}.pt") for r in range(world)]
        for causal in (True, False):
            out[world, causal] = tuple(torch.cat([rep[causal][i] for rep in reports], dim=1)
                                       .numpy() for i in range(4))
    return out


def _sum_groups(g):
    """[B, S, H, D] gradients of k or v repeated to the query heads -> [B, S, KV, D]."""
    return g.reshape(B, S, KV, H // KV, D).sum(axis=3)


@functools.cache
def _jax_refs(causal, n=None):
    """(o, dq, dk, dv) of sum(o²): ``naive_attention`` for ``n`` None, else
    the JAX ring over n seq ranks (``MeshPlan(data=2, seq=n)``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kubeflow_tpu.ops.attention import naive_attention
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel.ring_attention import ring_attention

    q, k, v = _qkv()
    k_rep, v_rep = (jnp.repeat(jnp.asarray(x), H // KV, axis=2) for x in (k, v))
    if n is None:
        def attend(q, k, v):
            return naive_attention(q, k, v, causal=causal)
    else:
        plan = jmesh.MeshPlan(data=2, seq=n)
        mesh = jmesh.create_mesh(plan, devices=jax.devices()[:plan.size])
        sh = NamedSharding(mesh, P(("data", "fsdp"), "seq", None, None))
        q, k_rep, v_rep = (jax.device_put(jnp.asarray(x), sh) for x in (q, k_rep, v_rep))

        def attend(q, k, v):
            return ring_attention(q, k, v, mesh, causal=causal)
    o = attend(jnp.asarray(q), k_rep, v_rep)
    dq, dk, dv = jax.grad(lambda *a: jnp.sum(attend(*a) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), k_rep, v_rep)
    return np.asarray(o), np.asarray(dq), _sum_groups(np.asarray(dk)), _sum_groups(np.asarray(dv))


def _check(got, want):
    for name, a, b, atol in zip(("o", "dq", "dk", "dv"), got, want, (O_ATOL,) + 3 * (GRAD_ATOL,)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_naive(ranks, world, causal):
    _check(ranks[world, causal], _jax_refs(causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_the_jax_ring(ranks, world, causal):
    _check(ranks[world, causal], _jax_refs(causal, world))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", WORLDS)
def test_chip_smoke_walk_matches_the_references(n, causal):
    """``chip_smoke.py``'s walk of the ring over n virtual ranks in one
    process (the card's check), on the CPU's plain versions."""
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    o, lse = chip_smoke.ring_walk_fwd(torch, q, k, v, n, causal, 512)
    dq, dk, dv = chip_smoke.ring_walk_bwd(torch, q, k, v, o, lse, 2 * o, n, causal)
    got = tuple(t.numpy() for t in (o, dq, dk, dv))
    _check(got, _jax_refs(causal))
    _check(got, _jax_refs(causal, n))
    want_lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=0)


def _scores(q, k, causal):
    """[B, H, S, S] scaled scores, masked to -inf above the diagonal when causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(H // KV, dim=2)) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    return s


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_schedule_runs_each_visible_chunk_once(n):
    """Rank i meets every chunk once over its n steps, starting with its own;
    causally it runs the diagonal once, the full kernel on the chunks before
    it and nothing on those after: n(n+1)/2 launches over the ring, n²
    non-causally."""
    for causal in (True, False):
        launches = 0
        for i in range(n):
            steps = ra._schedule(i, n, causal)
            assert [src for src, _ in steps] == [(i - r) % n for r in range(n)]
            for src, kind in steps:
                want = (ra.FULL if not causal or src < i else ra.DIAG if src == i else None)
                assert kind == want
                launches += kind is not None
        assert launches == (n * (n + 1) // 2 if causal else n * n)


def test_merge_matches_jax_with_empty_rows():
    """The streaming-lse merge against the JAX ``_merge`` on seeded partials
    with +inf (empty) rows in the first, the second and both."""
    import jax.numpy as jnp

    from kubeflow_tpu.parallel.ring_attention import _merge as jax_merge

    rng = np.random.default_rng(3)
    o, o_r = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32) for _ in range(2))  # [B,H,S,D]
    lse, lse_r = (rng.standard_normal((2, 3, 8)).astype(np.float32) * 4 for _ in range(2))
    lse[:, :, 1] = np.inf
    lse_r[:, :, 2] = np.inf
    lse[:, :, 3] = lse_r[:, :, 3] = np.inf
    o[:, :, 1] = o_r[:, :, 2] = 0.0
    o[:, :, 3] = o_r[:, :, 3] = 0.0
    want_o, want_lse = jax_merge(*(jnp.asarray(x) for x in (o, lse[..., None], o_r, lse_r[..., None])))
    to_port = functools.partial(np.moveaxis, source=1, destination=2)     # BHSD -> BSHD
    got_o, got_lse = ra._merge(*(torch.from_numpy(x) for x in (to_port(o), lse, to_port(o_r), lse_r)))
    np.testing.assert_allclose(got_o.numpy(), to_port(np.asarray(want_o)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-6, rtol=0)
    assert np.isneginf(got_lse.numpy()[:, :, 3]).all() and (got_o.numpy()[:, 3] == 0).all()


def test_ring_keeps_the_block_contract():
    """The chunk must divide into the block, as the flash kernels' tiling
    contract (the JAX ``_block_plan``) asks; chunks of other lengths are
    refused before any transfer."""
    q = torch.zeros((1, 64, 4, 32))
    kv = torch.zeros((1, 64, 2, 32))
    with pytest.raises(ValueError, match="must divide blocks"):
        ra.ring_attention(q, kv, kv, None, block=48)
    with pytest.raises(ValueError, match="chunks of one length"):
        ra.ring_attention(q, kv[:, :32], kv[:, :32], None)
