"""The port's train-step factories take the reference's arguments in the
reference's order: ``mesh`` third and positional, then keyword-only
``param_rule`` ... ``donate``. ``mesh=None`` is one device; a mesh over the
axes the steps do not split yet is refused with the slice that brings it
(``tests/test_torch_sharded_train.py`` runs the dcn, data and fsdp axes)."""
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


@pytest.mark.parametrize("name", ["make_lm_train_step", "make_classifier_train_step"])
def test_a_mesh_or_donate_false_is_refused(name):
    """A mesh the step cannot run is refused before any process group is
    touched (a stand-in with the mesh's dim names and shape is enough):
    seq=2 for a model without ring attention over that mesh, and for the
    classifier, whose batch has no sequence axis; donate=False is refused as
    before. (stage runs since slice 5d, its ranks replicas:
    ``tests/test_torch_stage_bn_einsum.py``; seq, expert and tensor since
    slices 5b and 5c: ``tests/test_torch_sharded_axes.py``.)"""
    import types

    from kubeflow_tpu_torch.parallel import mesh as tmesh

    build = getattr(kt, name)
    model = _lm()
    shape = [2 if a == "seq" else 1 for a in tmesh.AXES]
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXES, mesh=torch.zeros(shape))
    with pytest.raises((NotImplementedError, ValueError),
                       match="seq=2(: an image batch| cuts each row)"):
        build(model, kt.sgd(0.1), mesh)
    with pytest.raises(ValueError, match="donate=False"):
        build(model, kt.sgd(0.1), None, donate=False)
