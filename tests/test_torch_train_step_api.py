"""The port's train-step factories take the reference's arguments in the
reference's order: ``mesh`` third and positional, then keyword-only
``param_rule`` ... ``donate``. ``mesh=None`` is one device; a seq=2 mesh
builds and steps for an LM off the ring and for the classifier (2 gloo
ranks); ``tests/test_torch_sharded_train.py`` runs the dcn, data and fsdp
axes."""
import functools
import inspect

import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import train as jtrain
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.parallel import train as ttrain


@pytest.mark.parametrize("name", ["make_lm_train_step", "make_classifier_train_step"])
def test_parameter_names_kinds_and_order_match_the_reference(name):
    want = inspect.signature(getattr(jtrain, name)).parameters.values()
    got = inspect.signature(getattr(ttrain, name)).parameters.values()
    assert [(p.name, p.kind) for p in got] == [(p.name, p.kind) for p in want]
    assert getattr(kt, name) is getattr(ttrain, name)


def _lm():
    cfg = kt.TransformerConfig(vocab_size=61, num_layers=1, num_heads=2, embed_dim=32,
                               mlp_dim=64, max_seq_len=16, dtype=torch.float32)
    model = kt.TransformerLM(cfg, device="cpu")
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cpu"))
    return model


def test_lm_step_takes_mesh_none_third():
    model = _lm()
    bundle = kt.make_lm_train_step(model, kt.sgd(0.1), None, chunk=8)
    assert bundle.state_shardings is None
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 61, (2, 16)))
    state, metrics = bundle.step(bundle.init(), tokens)
    assert state["step"] == 1 and torch.isfinite(metrics["loss"])


def test_classifier_step_takes_mesh_none_third():
    model = kt.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=5, width=8, dtype=torch.float32,
                      device="cpu")
    bundle = kt.make_classifier_train_step(model, kt.sgd(0.1), None)
    assert bundle.state_shardings is None
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 5, (2,)))}
    state, metrics = bundle.step(bundle.init(), batch)
    assert state["step"] == 1 and torch.isfinite(metrics["loss"])


def _seq2_rank(rank, store, out):
    """Rank ``rank`` of a world of 2 on ``MeshPlan(seq=2)``: each step
    factory built on that mesh (the LM without ring attention, the
    classifier) and stepped once; (step, loss) of each written to ``out``."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        mesh = tmesh.create_mesh(tmesh.MeshPlan(seq=2))
        rng = np.random.default_rng(0)
        got = {}
        bundle = kt.make_lm_train_step(_lm(), kt.sgd(0.1), mesh, chunk=8)
        state, metrics = bundle.step(bundle.init(), torch.from_numpy(rng.integers(0, 61, (2, 16))))
        got["make_lm_train_step"] = (state["step"], metrics["loss"].item())
        resnet = kt.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=5, width=8, dtype=torch.float32,
                           device="cpu")
        bundle = kt.make_classifier_train_step(resnet, kt.sgd(0.1), mesh)
        batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
                 "label": torch.from_numpy(rng.integers(0, 5, (2,)))}
        state, metrics = bundle.step(bundle.init(), batch)
        got["make_classifier_train_step"] = (state["step"], metrics["loss"].item())
        torch.save(got, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@functools.cache
def _seq2_steps(folder):
    """[each rank's {factory: (step, loss)}] from one world of 2."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_seq2_rank, args=(r, f"{folder}/store", folder)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(f"{folder}/rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    return _seq2_steps(str(tmp_path_factory.mktemp("seq2")))


@pytest.mark.parametrize("name", ["make_lm_train_step", "make_classifier_train_step"])
def test_a_mesh_or_donate_false_is_refused(name, seq2):
    """seq=2 builds and steps, for a model without ring attention and for
    the classifier (each seq rank holds whole rows or images, as in the
    JAX step; parity in ``tests/test_torch_seq_routes.py``): both ranks
    take one step to the same finite loss. donate=False is refused as
    before."""
    (step_a, loss_a), (step_b, loss_b) = (rep[name] for rep in seq2)
    assert step_a == step_b == 1 and loss_a == loss_b and np.isfinite(loss_a)
    build = getattr(kt, name)
    with pytest.raises(ValueError, match="donate=False"):
        build(_lm(), kt.sgd(0.1), None, donate=False)
