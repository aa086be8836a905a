"""The port's checkpoint and resume (``kubeflow_tpu_torch/utils/checkpoint.py``)
against the reference's (``kubeflow_tpu/utils/checkpoint.py``, on orbax).

- the save policy call for call against the reference's manager on orbax:
  which ``save(step, force=...)`` calls start a save, ``latest_step`` and
  ``all_steps`` after each (once both have drained);
- a small LM bundle on one device saved after 3 AdamW steps and restored
  into a bundle initialised from another seed: parameters, bf16 moments,
  count and step bit-equal, and the next two steps' losses equal to the
  uninterrupted run's (fp32 on the CPU: the same arithmetic, bit for bit);
- the in-place hazard: the port's steps update the state in place, so a
  save must have copied the state before it returns;
- torn steps: a truncated file in the newest step falls back to the one
  before, with a warning; all steps torn, or none, give the fresh state,
  untouched by the failed loads;
- the suspend barrier's save and the pre-copy read;
- 2 gloo ranks under fsdp=2 (a ``file://`` store under ``tmp_path``): a
  sharded state saved as DTensors restores at fsdp=2 and onto one device,
  equal to the gathered state, and a one-device step restores at fsdp=2;
- ``auto_initialize``'s backend for the card carries a CPU backend, which
  ``async_save`` needs.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu.utils import checkpoint as jck
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.utils import checkpoint as ck

LM = dict(vocab_size=128, num_layers=2, num_heads=2, embed_dim=32, mlp_dim=64, max_seq_len=16)
BATCH = 4


def _cfg():
    return kt.TransformerConfig(**LM, attention_impl="flash", dtype=torch.float32)


def _tokens(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (BATCH, LM["max_seq_len"])))


def _bundle(seed, mesh=None):
    """A small LM from ``seed``'s weights and its AdamW step (bf16 moments)."""
    model = kt.TransformerLM(_cfg(), device="cpu")
    model.load_state_dict(kt.init_state_dict(_cfg(), seed=seed, device="cpu"))
    return model, kt.make_lm_train_step(model, kt.adamw_lowmem(1e-2, b2=0.99, weight_decay=0.1),
                                        mesh, chunk=8, loss_dtype=torch.float32)


def _snapshot(state):
    """A deep copy of a state's tensors and ints."""
    if isinstance(state, dict):
        return {k: _snapshot(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_snapshot(v) for v in state]
    return state.detach().clone() if isinstance(state, torch.Tensor) else state


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_on_one_device_resumes_the_same_losses(tmp_path):
    tokens = _tokens()
    _, bundle = _bundle(0)
    state = bundle.init()
    assert set(state) == {"params", "opt_state", "step"} and state.mesh is None
    for _ in range(3):
        bundle.step(state, tokens)
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.save(3, state)
    saved = _snapshot(state)
    mgr.wait_until_finished()
    losses = [bundle.step(state, tokens)[1]["loss"].item() for _ in range(2)]

    model2, bundle2 = _bundle(1)
    fresh = bundle2.init()
    assert not torch.equal(fresh["params"]["embed.weight"], saved["params"]["embed.weight"])
    assert mgr.restore(fresh) is fresh
    mgr.close()
    _assert_equal(_snapshot(fresh), saved)
    assert fresh["step"] == 3 and fresh["opt_state"][0]["count"] == 3
    # the params entry is the model's own parameters: the model resumed too
    assert all(p is fresh["params"][n] for n, p in model2.named_parameters())
    assert [bundle2.step(fresh, tokens)[1]["loss"].item() for _ in range(2)] == losses


# (step, force) calls; a forced step below the latest is saved (orbax lists
# it last), a forced step that exists raises
POLICY_CALLS = [(0, False), (1, False), (2, False), (2, False), (3, False), (4, False),
                (5, True), (6, False), (6, True), (3, True), (7, False), (8, False),
                (9, False), (10, False), (11, True), (12, False)]


@pytest.mark.parametrize("interval,keep", [(2, 2), (1, 3), (3, 1)])
def test_save_policy_matches_orbax(tmp_path, interval, keep):
    """The same calls to the reference's manager (orbax) and the port's give
    the same returns, and, once each has drained, the same latest_step and
    all_steps."""
    ref = jck.CheckpointManager(str(tmp_path / "orbax"), max_to_keep=keep,
                                save_interval_steps=interval)
    port = ck.CheckpointManager(str(tmp_path / "port"), max_to_keep=keep,
                                save_interval_steps=interval)
    try:
        for step, force in POLICY_CALLS:
            results = []
            for mgr, state in ((ref, {"w": jnp.full((4,), float(step))}),
                               (port, {"w": torch.full((4,), float(step)), "step": step})):
                try:
                    results.append(mgr.save(step, state, force=force))
                except ValueError as e:
                    results.append(("raised", "already exists" in str(e)))
                mgr.wait_until_finished()
            assert results[0] == results[1], (step, force, results)
            assert (ref.latest_step(), ref.all_steps()) == (port.latest_step(), port.all_steps()), \
                (step, force)
        kept = sorted(int(p) for p in os.listdir(tmp_path / "port"))
        assert kept == port.all_steps()
    finally:
        ref.close()
        port.close()


def test_latest_step_lists_only_finished_saves(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    state = {"w": torch.ones(8), "step": 0}
    assert mgr.save(1, state)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert not mgr.save(1, state)        # in flight, but orbax's policy sees it
    mgr.wait_until_finished()
    assert mgr.latest_step() == 1 and os.listdir(tmp_path) == ["1"]
    mgr.close()


def test_save_copies_the_state_before_it_returns(tmp_path):
    """The step updates the state in place right after ``save`` returns;
    the checkpoint holds the values as they were at the save."""
    _, bundle = _bundle(0)
    state = bundle.init()
    bundle.step(state, _tokens())
    saved = _snapshot(state)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    bundle.step(state, _tokens(1))            # in place, while the save is in flight
    with torch.no_grad():
        for p in state["params"].values():
            p.add_(1.0)
    mgr.wait_until_finished()
    assert not torch.equal(state["params"]["embed.weight"], saved["params"]["embed.weight"])
    mgr.restore(state)
    mgr.close()
    _assert_equal(_snapshot(state), saved)


def test_restore_without_a_checkpoint_raises(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(2)})
    mgr.close()


def _save_steps(directory, steps):
    """Two saved steps of the small LM: {step: snapshot}."""
    _, bundle = _bundle(0)
    state = bundle.init()
    mgr = ck.CheckpointManager(directory)
    out = {}
    for step in steps:
        bundle.step(state, _tokens(step))
        mgr.save(step, state, force=True)
        out[step] = _snapshot(state)
    mgr.close()
    return out


def _truncate(step_dir):
    data = [f for f in os.listdir(step_dir) if f.endswith(".distcp")]
    assert data
    for f in data:
        path = os.path.join(step_dir, f)
        os.truncate(path, os.path.getsize(path) // 2)


def test_resume_falls_back_past_a_torn_latest_step(tmp_path, caplog):
    saved = _save_steps(str(tmp_path), [1, 2])
    _truncate(tmp_path / "2")
    _, bundle = _bundle(1)
    with caplog.at_level(logging.WARNING, logger="kubeflow_tpu_torch.utils.checkpoint"):
        state = ck.resume_or_init(str(tmp_path), bundle.init)
    assert "step 2" in caplog.text and "torn/corrupt" in caplog.text
    _assert_equal(_snapshot(state), saved[1])


def test_resume_gives_the_fresh_state_when_every_step_is_torn(tmp_path, caplog):
    _save_steps(str(tmp_path), [1, 2])
    _truncate(tmp_path / "1")
    _truncate(tmp_path / "2")
    _, bundle = _bundle(1)
    fresh = _snapshot(_bundle(1)[1].init())
    with caplog.at_level(logging.WARNING, logger="kubeflow_tpu_torch.utils.checkpoint"):
        state = ck.resume_or_init(str(tmp_path), bundle.init)
    assert caplog.text.count("torn/corrupt") == 2
    _assert_equal(_snapshot(state), fresh)      # the failed loads left it as it was


def test_resume_without_checkpoints_is_the_fresh_state(tmp_path):
    _, bundle = _bundle(1)
    fresh = _snapshot(_bundle(1)[1].init())
    state = ck.resume_or_init(str(tmp_path / "none"), bundle.init)
    _assert_equal(_snapshot(state), fresh)
    assert os.path.isdir(tmp_path / "none")


def test_snapshot_for_precopy_forces_no_save(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(str(tmp_path))
    assert ck.snapshot_for_precopy(mgr) is None
    state = {"w": torch.arange(4.0), "step": 7}
    assert ck.snapshot_for_suspend(mgr, 7, state) == 7
    assert os.path.isdir(tmp_path / "7") and mgr.all_steps() == [7]
    forbidden = []
    monkeypatch.setattr(mgr, "save", lambda *a, **k: forbidden.append("save"))
    monkeypatch.setattr(mgr, "wait_until_finished", lambda: forbidden.append("wait"))
    assert ck.snapshot_for_precopy(mgr) == 7
    assert forbidden == []


def test_snapshot_for_suspend_forces_off_interval_steps(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), save_interval_steps=10)
    state = {"w": torch.arange(4.0), "step": 3}
    assert mgr.save(1, state)                  # the first save always starts
    assert not mgr.save(3, state)              # off the interval
    assert ck.snapshot_for_suspend(mgr, 3, state) == 3
    restored = {"w": torch.zeros(4), "step": 0}
    mgr.restore(restored)
    mgr.close()
    assert restored["step"] == 3 and torch.equal(restored["w"], torch.arange(4.0))


# ------------------------------------------------------------- gloo ranks


def _gathered(bundle, model, state):
    """Whole parameters and AdamW moments of a state, and its ints."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    adam = state["opt_state"][0]
    gather = bundle.gather if state.mesh is not None else (
        lambda d: {n: t.detach().clone() for n, t in d.items()})
    return dict(params=gather(state["params"]), mu=gather(dict(zip(names, adam["mu"]))),
                nu=gather(dict(zip(names, adam["nu"]))), count=adam["count"], step=state["step"])


def _rank_main(rank, world, store, folder):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = tmesh.create_mesh(tmesh.MeshPlan(fsdp=2))
        out = {}
        # sharded: two steps, saved as DTensors
        model, bundle = _bundle(0, mesh)
        state = bundle.init()
        for i in range(2):
            bundle.step(state, _tokens(i))
        mgr = ck.CheckpointManager(f"{folder}/sharded")
        mgr.save(2, state)
        mgr.wait_until_finished()
        out["saved"] = _gathered(bundle, model, state)
        out["shard_rows"] = state["params"]["embed.weight"].shape[0]
        out["next_loss"] = bundle.step(state, _tokens(2))[1]["loss"].item()
        # ... restored at fsdp=2 from another seed's init, and stepped on
        model2, bundle2 = _bundle(1, mesh)
        state2 = mgr.restore(bundle2.init())
        out["restored_fsdp2"] = _gathered(bundle2, model2, state2)
        out["restored_fsdp2_loss"] = bundle2.step(state2, _tokens(2))[1]["loss"].item()
        # ... and onto one device
        model3, bundle3 = _bundle(1)
        out["restored_one"] = _gathered(bundle3, model3, mgr.restore(bundle3.init()))
        mgr.close()
        # a one-device step (every rank the same), restored at fsdp=2
        model4, bundle4 = _bundle(2)
        state4 = bundle4.init()
        bundle4.step(state4, _tokens(5))
        mgr = ck.CheckpointManager(f"{folder}/one")
        ck.snapshot_for_suspend(mgr, 1, state4)
        out["one_saved"] = _gathered(bundle4, model4, state4)
        model5, bundle5 = _bundle(1, mesh)
        out["one_to_fsdp2"] = _gathered(bundle5, model5, mgr.restore(bundle5.init()))
        mgr.close()
        torch.save(out, f"{folder}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ckpt_ranks")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(folder / "store"), str(folder)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [(p.exitcode, p.is_alive()) for p in procs]
    return [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_state_restores_at_fsdp2(ranks, rank):
    rep = ranks[rank]
    assert rep["shard_rows"] == LM["vocab_size"] // 2      # the shards really were shards
    _assert_equal(rep["restored_fsdp2"], rep["saved"])
    assert rep["restored_fsdp2_loss"] == rep["next_loss"]


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_state_restores_onto_one_device(ranks, rank):
    _assert_equal(ranks[rank]["restored_one"], ranks[rank]["saved"])


@pytest.mark.parametrize("rank", [0, 1])
def test_one_device_state_restores_at_fsdp2(ranks, rank):
    _assert_equal(ranks[rank]["one_to_fsdp2"], ranks[rank]["one_saved"])


def test_auto_initialize_for_the_card_joins_with_a_cpu_backend(monkeypatch):
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import bootstrap

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "h0,h1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h0:8476")
    bootstrap.auto_initialize(device="cuda")
    bootstrap.auto_initialize(device="cpu")
    assert [c["backend"] for c in calls] == ["cpu:gloo,cuda:nccl", "gloo"]
    assert calls[0]["rank"] == 1 and calls[0]["world_size"] == 2
