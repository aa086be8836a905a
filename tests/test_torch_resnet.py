"""PyTorch port's ResNet slice vs the JAX package on the CPU: the model for
every ``bn_impl`` (logits in train and eval mode, running statistics after a
train-mode call, every gradient) on the same numpy-seeded weights carried
across by ``resnet_params_from_flax``, XLA's SAME padding, the
space-to-depth stem, ``trace``/``sgd`` against optax, the classifier train
step against the JAX step on a one-device mesh, the init scale and the
raising paths.

The small model is ResNet [1, 1, 1, 1] of width 8 on 4 images of 64x64: the
last stage still has 16 rows a channel (with fewer the batch variance nears
0 and rsqrt amplifies every rounding difference), and its 256 channels
against 16 rows take the ``mxu`` strategy's plain-reduction tail while the
early stages take its matrix products. Each JAX reference is computed once
per module (``functools.cache``); the Pallas kernels run in interpret mode,
as they do in the JAX package's own tests on the CPU."""
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import resnet as jr
from kubeflow_tpu.parallel import mesh as meshlib
from kubeflow_tpu.parallel import train as jtrain
import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.models import resnet as tr
from kubeflow_tpu_torch.ops import optimizers as topt

SMALL = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, width=8)
BATCH, IMAGE = 4, 64
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
IMPLS = ["xla", "pallas", "mxu"]


def _close(got, want, rel, what=""):
    """Every element within ``rel`` of the reference's largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(image=IMAGE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, image, image, 3)).astype(np.float32),
            rng.integers(0, SMALL["num_classes"], BATCH))


@functools.cache
def _variables(s2d_stem=False):
    """flax variables of the small model with every leaf drawn from a numpy
    seed: kernels at lecun scale, norm scales around 1 (also ``bn3``'s, which
    flax zeroes: a zero scale would hide its block's gradients), and running
    statistics away from their (0, 1) start."""
    model = jr.ResNet(**SMALL, s2d_stem=s2d_stem)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(leaf.shape) * np.prod(leaf.shape[:-1]) ** -0.5
        if name == "var":
            return 1.0 + 0.5 * rng.random(leaf.shape)
        center = 1.0 if name == "scale" else 0.0
        return center + 0.2 * rng.standard_normal(leaf.shape)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _port_model(dtype, bn_impl, s2d_stem=False):
    model = kt.ResNet(**SMALL, dtype=dtype, bn_impl=bn_impl, s2d_stem=s2d_stem, device="cpu")
    model.load_state_dict(kt.resnet_params_from_flax(_numpy_tree(_variables(s2d_stem))))
    return model


@functools.cache
def _jax_reference(bn_impl, dtype, image=IMAGE, s2d_stem=False):
    """Loss, train logits, new batch statistics and every gradient of one
    train-mode call, and the eval logits, from the JAX model."""
    model = jr.ResNet(**SMALL, dtype=JDT[dtype], bn_impl=bn_impl, s2d_stem=s2d_stem)
    variables = _variables(s2d_stem)
    images, labels = map(jnp.asarray, _batch(image))

    def loss_fn(params):
        logits, updates = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, images, train=True,
            mutable=["batch_stats"])
        return jtrain.cross_entropy_loss(logits, labels), (logits, updates["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    eval_logits = jax.jit(lambda v: model.apply(v, images, train=False))(variables)
    return (float(loss), np.asarray(logits), np.asarray(eval_logits),
            kt.resnet_params_from_flax({"params": {}, "batch_stats": _numpy_tree(stats)}),
            kt.resnet_params_from_flax({"params": _numpy_tree(grads)}))


# ------------------------------------------------------------- the model


def _train_call(model, dtype):
    """One train-mode call of the port: logits, loss, named gradients."""
    images, labels = map(torch.from_numpy, _batch())
    logits = model(images, train=True)
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, SMALL["num_classes"])
    loss = kt.cross_entropy_loss(logits, labels)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(g.dtype == torch.float32 for g in grads)
    return logits, loss, dict(zip(names, grads))


@pytest.mark.parametrize("bn_impl", IMPLS)
def test_model_matches_jax(bn_impl):
    """fp32 activations: summation order only, through 13 norms and their
    rsqrt. Measured: logits 6e-6 absolute, running statistics 1e-6 and
    gradients 1.6e-5 of their largest value; the limit is 1e-4."""
    rel = 1e-4
    loss_w, logits_w, eval_w, stats_w, grads_w = _jax_reference(bn_impl, torch.float32)
    model = _port_model(torch.float32, bn_impl)
    before = {name: b.clone() for name, b in model.named_buffers()}
    _close(model(torch.from_numpy(_batch()[0]), train=False), eval_w, rel, "eval logits")
    assert all(torch.equal(b, before[name]) for name, b in model.named_buffers())
    logits, loss, grads = _train_call(model, torch.float32)
    _close(logits, logits_w, rel, "train logits")
    np.testing.assert_allclose(loss.item(), loss_w, rtol=1e-5)
    # running statistics: 0.9 * old + 0.1 * (batch mean, biased batch var)
    assert set(stats_w) == set(before)
    for name, b in model.named_buffers():
        assert not torch.equal(b, before[name]), name
        _close(b, stats_w[name], rel, name)
    assert set(grads) == set(grads_w)
    for name, g in grads.items():
        _close(g, grads_w[name], rel, name)


@pytest.mark.parametrize("bn_impl", IMPLS)
def test_model_matches_jax_in_bf16(bn_impl):
    """bf16 activations. Forward: both sides round the same values at the
    same points, but a last-bit fp32 difference flips a bf16 rounding (2^-8),
    which then travels through the remaining norms: logits (of scale 1)
    within 0.15 (measured 0.08), the loss within 1% (measured 0.4%), the
    running statistics within 2% of their largest value (measured 0.5%).
    Backward: at this size the bf16 gradient itself is noisy: the JAX bf16
    model's gradient lies 0.27 to 0.31 (relative L2, all parameters
    together) from the JAX fp32 model's, since the per-channel sums cancel.
    So the port's bf16 gradient is held to the fp32 reference as the JAX bf16
    one is: no more than 1.5x as far (measured 0.35), with the same norm
    within 10% (measured 5%)."""
    loss_w, logits_w, eval_w, stats_w, grads_w = _jax_reference(bn_impl, torch.bfloat16)
    grads_f32 = _jax_reference(bn_impl, torch.float32)[4]
    model = _port_model(torch.bfloat16, bn_impl)
    got_eval = model(torch.from_numpy(_batch()[0]), train=False)
    np.testing.assert_allclose(got_eval.detach().numpy(), eval_w, atol=0.15, rtol=0)
    logits, loss, grads = _train_call(model, torch.bfloat16)
    np.testing.assert_allclose(logits.detach().numpy(), logits_w, atol=0.15, rtol=0)
    np.testing.assert_allclose(loss.item(), loss_w, rtol=1e-2)
    for name, b in model.named_buffers():
        _close(b, stats_w[name], 2e-2, name)

    def flat(d):
        return torch.cat([d[name].flatten() for name in sorted(grads_w)])

    mine, theirs, exact = flat(grads), flat(grads_w), flat(grads_f32)
    assert torch.isfinite(mine).all()
    far_mine = float((mine - exact).norm() / exact.norm())
    far_theirs = float((theirs - exact).norm() / exact.norm())
    assert far_mine <= 1.5 * far_theirs, (far_mine, far_theirs)
    assert float(mine.norm()) == pytest.approx(float(theirs.norm()), rel=0.1)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
def test_model_on_an_odd_image_matches_jax(bn_impl):
    """50x50 images: the stem gives 25x25, the pool 13x13, and each stride-2
    ``conv2`` an odd input (SAME pads (1, 1)), where 64x64 gives even ones
    (SAME pads (0, 1))."""
    _, logits_w, eval_w, stats_w, _ = _jax_reference(bn_impl, torch.float32, image=50)
    model = _port_model(torch.float32, bn_impl)
    images = torch.from_numpy(_batch(50)[0])
    _close(model(images, train=False), eval_w, 1e-4, "eval logits")
    _close(model(images, train=True), logits_w, 1e-4, "train logits")
    for name, b in model.named_buffers():
        _close(b, stats_w[name], 1e-4, name)


@pytest.mark.parametrize("size", [8, 9, 12, 13])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (1, 2), (3, 1), (7, 2)])
def test_same_padding_matches_xla(size, kernel, stride):
    """XLA pads SAME asymmetrically, the odd one at the high end: a 3x3
    stride-2 conv gets (0, 1) on an even input and (1, 1) on an odd one."""
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 6)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tr.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    assert got.is_contiguous()              # the NHWC array itself, no copy owed
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if kernel == 3 and stride == 2:
        assert tr._same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))


def test_conv_module_matches_flax():
    """flax ``nn.Conv`` (SAME, stride 2, bf16 compute on an fp32 kernel)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 10, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), (2, 2), use_bias=False, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(variables, jnp.asarray(x))
    mine = tr.Conv(4, 6, 3, 2, device="cpu")
    mine.load_state_dict(kt.resnet_params_from_flax(_numpy_tree(variables)))
    got = mine(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and mine.weight.dtype == torch.float32
    # bf16 products are exact and summed in fp32 on both sides; one rounding
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -8, rtol=2.0 ** -7)


def test_s2d_stem_equals_the_7x7_stem():
    """fp32: the same products in another order. Against the port's own 7x7
    stride-2 conv on the same weight, and against the JAX stem."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    stem = tr.SpaceToDepthStem(width=8, dtype=torch.float32, device="cpu")
    got = stem(torch.from_numpy(x))
    plain = tr.conv_nhwc(torch.from_numpy(x), stem.weight.detach(), 2, ((3, 3), (3, 3)))
    assert got.shape == plain.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got.detach().numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)
    kernel = jnp.asarray(stem.weight.detach().permute(2, 3, 1, 0).numpy())
    want = jr.SpaceToDepthStem(width=8, dtype=jnp.float32).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("image", [IMAGE, 50])
def test_s2d_model_matches_jax(image):
    """The space-to-depth model on the 7x7 weights; an odd image has no 2x2
    cells and takes the plain stem on the same weight, as in the JAX model."""
    _, logits_w, _, _, _ = _jax_reference("xla", torch.float32, image=image, s2d_stem=True)
    plain_w = _jax_reference("xla", torch.float32, image=image)[1]
    np.testing.assert_allclose(logits_w, plain_w, atol=1e-4)
    model = _port_model(torch.float32, "xla", s2d_stem=True)
    _close(model(torch.from_numpy(_batch(image)[0]), train=True), logits_w, 1e-4, "s2d logits")


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", ["pallas", "mxu"])
def test_pallas_batch_norm_module_matches_jax(strategy, dtype, average):
    """``PallasBatchNorm`` in train and ``use_running_average`` mode: output
    and buffers against the JAX module's on the same variables."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 6, 6, 16)) * 2 + 1).astype(np.float32)
    variables = {
        "params": {"scale": (1 + 0.3 * rng.standard_normal(16)).astype(np.float32),
                   "bias": (0.2 * rng.standard_normal(16)).astype(np.float32)},
        "batch_stats": {"mean": (0.5 * rng.standard_normal(16)).astype(np.float32),
                        "var": (1 + rng.random(16)).astype(np.float32)},
    }
    jmod = jr.PallasBatchNorm(use_running_average=average, dtype=JDT[dtype], strategy=strategy)
    want, updates = jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                               mutable=["batch_stats"])
    mod = tr.PallasBatchNorm(16, strategy=strategy, use_running_average=average, dtype=dtype,
                             device="cpu")
    mod.load_state_dict(kt.resnet_params_from_flax(variables))
    got = mod(torch.from_numpy(x))
    assert got.dtype == dtype
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5      # one bf16 step of the largest
    _close(got, np.asarray(want.astype(jnp.float32)), rel, "y")
    stats = updates["batch_stats"] if not average else variables["batch_stats"]
    _close(mod.mean, np.asarray(stats["mean"]), 1e-5, "running mean")
    _close(mod.var, np.asarray(stats["var"]), 1e-5, "running var")
    # the call's argument overrides the module's mode, as ResNet passes it
    _close(mod(torch.from_numpy(x), use_running_average=average), got, 2 * rel, "override")


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("momentum,nesterov,acc", [
    (None, False, None), (0.9, False, None), (0.9, True, None), (0.9, True, torch.bfloat16),
    (0.5, False, torch.bfloat16),
])
def test_sgd_trajectory_matches_optax(momentum, nesterov, acc):
    """Four steps on the same numpy gradients: the same arithmetic on both
    sides (1e-6), also with a bf16 trace, which is rounded for storage at the
    same point and multiplied by the decay rounded to bf16 (0.8984375 for
    0.9), as optax's weakly typed scalar is."""
    rng = np.random.default_rng(6)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(4)]
    jtx = optax.sgd(0.1, momentum=momentum, nesterov=nesterov,
                    accumulator_dtype=JDT[acc] if acc else None)
    ttx = kt.sgd(0.1, momentum=momentum, nesterov=nesterov, accumulator_dtype=acc)
    jp, tp = [jnp.asarray(p) for p in params], [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        updates, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.apply_updates(tp, ttx.update([torch.from_numpy(x) for x in g], tstate, tp))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    if momentum is not None:
        traces = tstate[0]["trace"]
        assert all(t.dtype == (acc or torch.float32) for t in traces)
        for t, w in zip(traces, jstate[0].trace):
            np.testing.assert_allclose(t.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                       atol=1e-6, rtol=0)


def test_trace_alone_matches_optax():
    g = np.random.default_rng(8).standard_normal((3, 6)).astype(np.float32)
    for nesterov in (False, True):
        jtx, ttx = optax.trace(0.8, nesterov), topt.trace(0.8, nesterov)
        jstate, tstate = jtx.init([jnp.asarray(g)]), ttx.init([torch.from_numpy(g)])
        for _ in range(3):
            want, jstate = jtx.update([jnp.asarray(g)], jstate)
            got = ttx.update([torch.from_numpy(g)], tstate)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)


# ------------------------------------------------------------- train step


@functools.cache
def _jax_steps(bn_impl):
    """Two steps of the JAX classifier train step on a one-device mesh, from
    flax's own init: the initial variables and, after each step, the
    metrics, the parameters and the batch statistics."""
    mesh = meshlib.create_mesh(meshlib.MeshPlan(data=1), devices=jax.devices()[:1])
    model = jr.ResNet(**SMALL, dtype=jnp.float32, bn_impl=bn_impl)
    bundle = jtrain.make_classifier_train_step(
        model, optax.sgd(0.1, momentum=0.9, nesterov=True), mesh, donate=False)
    images, labels = _batch(seed=1)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels, jnp.int32)}
    state = bundle.init(jax.random.PRNGKey(0), batch)
    start = _numpy_tree({"params": state["params"], "batch_stats": state["batch_stats"]})
    after = []
    for _ in range(2):
        state, metrics = bundle.step(state, batch)
        after.append((float(metrics["loss"]), float(metrics["accuracy"]),
                      kt.resnet_params_from_flax(_numpy_tree(
                          {"params": state["params"], "batch_stats": state["batch_stats"]}))))
    return start, after


@pytest.mark.parametrize("bn_impl", IMPLS)
def test_classifier_train_step_matches_jax(bn_impl):
    """One and two nesterov-SGD steps, fp32: loss, accuracy, every parameter
    and every running statistic. The first step starts from flax's init
    (``bn3`` scales zero); the second runs on what the first made of it.
    Summation order only (measured after two steps: loss 1e-6, parameters
    and statistics 4e-5 of their largest value; the limits are 1e-5 and
    2e-4)."""
    start, after = _jax_steps(bn_impl)
    model = kt.ResNet(**SMALL, dtype=torch.float32, bn_impl=bn_impl, device="cpu")
    model.load_state_dict(kt.resnet_params_from_flax(start))
    bundle = kt.make_classifier_train_step(model, kt.sgd(0.1, momentum=0.9, nesterov=True))
    images, labels = _batch(seed=1)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    state = bundle.init()
    for n, (loss_w, acc_w, want) in enumerate(after, start=1):
        state, metrics = bundle.step(state, batch)
        assert state["step"] == n and metrics["loss"].dtype == torch.float32
        np.testing.assert_allclose(metrics["loss"].item(), loss_w, rtol=1e-5)
        assert metrics["accuracy"].item() == pytest.approx(acc_w)
        got = model.state_dict()
        assert set(got) == set(want)
        for name, t in got.items():
            _close(t, want[name], 2e-4, f"step {n} {name}")
    assert after[1][0] < after[0][0]


def test_train_step_lowers_the_loss_in_bf16():
    """bf16 model at the seeded init through ``make_classifier_train_step``
    with the bf16 momentum of ``benchmarks/resnet_ab_probe.py``."""
    model = kt.ResNet(**SMALL, bn_impl="pallas", device="cpu")
    model.load_state_dict(kt.resnet_init_state_dict(**SMALL, seed=0, device="cpu"))
    tx = kt.sgd(0.1, momentum=0.9, nesterov=True, accumulator_dtype=torch.bfloat16)
    bundle = kt.make_classifier_train_step(model, tx)
    images, labels = _batch(seed=2)
    batch = {"image": torch.from_numpy(images).to(torch.bfloat16), "label": torch.from_numpy(labels)}
    state = bundle.init()
    losses = [bundle.step(state, batch)[1]["loss"].item() for _ in range(4)]
    assert abs(losses[0] - np.log(SMALL["num_classes"])) < 1.0
    assert losses[-1] < losses[0] and state["step"] == 4
    assert all(t.dtype == torch.bfloat16 for t in state["opt_state"][0]["trace"])
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------------------- init, errors


def test_init_state_dict_matches_flax_init():
    """Names, shapes and dtypes are the model's; the scale is flax's: every
    conv and the head lecun-normal (std fan_in^-1/2, within 2% over all
    kernels together and 15% on each large one against flax's own draw),
    ``bn3`` scales zero, the other norms at (1, 0) with statistics (0, 1)."""
    cfg = dict(stage_sizes=[2, 1], num_classes=10, width=16)
    sd = kt.resnet_init_state_dict(**cfg, seed=0, device="cpu")
    model = kt.ResNet(**cfg, device="cpu")
    own = model.state_dict()
    assert {k: (v.shape, v.dtype) for k, v in sd.items()} == {
        k: (v.shape, v.dtype) for k, v in own.items()}
    variables = jr.ResNet(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    flax_sd = kt.resnet_params_from_flax(_numpy_tree(variables))
    assert set(flax_sd) == set(sd)
    ratios = []
    for name, t in sd.items():
        if name.endswith("weight"):
            fan_in = t[0].numel()
            ratios.append(float(t.std()) * fan_in ** 0.5)
            if t.numel() >= 4096:
                assert float(t.std()) == pytest.approx(float(flax_sd[name].std()), rel=0.15), name
        else:
            assert torch.equal(t, flax_sd[name]), name
    assert np.mean(ratios) == pytest.approx(1.0, abs=0.02)
    assert not sd["stage1_block1.bn3.scale"].any() and sd["stage1_block1.bn1.scale"].all()
    again = kt.resnet_init_state_dict(**cfg, seed=0, device="cpu")
    other = kt.resnet_init_state_dict(**cfg, seed=1, device="cpu")
    assert torch.equal(sd["stem_conv.weight"], again["stem_conv.weight"])
    assert not torch.equal(sd["stem_conv.weight"], other["stem_conv.weight"])


def test_model_family_and_flops():
    assert kt.flops_per_image(224) == jr.flops_per_image(224)
    assert kt.flops_per_image(112) == pytest.approx(jr.flops_per_image(224) / 4)
    for mine, theirs in ((kt.ResNet18, jr.ResNet18), (kt.ResNet50, jr.ResNet50),
                         (kt.ResNet101, jr.ResNet101), (kt.ResNet152, jr.ResNet152)):
        assert mine.keywords["stage_sizes"] == theirs.keywords["stage_sizes"]
    model = kt.ResNet50(num_classes=7, width=8, device="cpu")
    norms = [m for m in model.modules() if isinstance(m, tr.BatchNorm)]
    assert len(model.blocks()) == 16 and len(norms) == 53
    assert model(torch.zeros(1, 32, 32, 3), train=False).shape == (1, 7)


def test_raising_paths():
    with pytest.raises(ValueError, match=r"bn_impl must be one of \('xla', 'pallas', 'mxu'\)"):
        kt.ResNet(**SMALL, bn_impl="MXU", device="cpu")
    with pytest.raises(ValueError, match="bn_impl must be one of"):
        jr.ResNet(**SMALL, bn_impl="MXU").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    # the entry points run on the card unless the caller asks for the CPU
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.ResNet(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.resnet_init_state_dict(**SMALL)
    # an NCHW-contiguous activation handed over as NHWC would need a copy
    model = _port_model(torch.float32, "pallas")
    nchw = torch.randn(BATCH, 8, 16, 16)
    with pytest.raises(ValueError, match="needs a copy"):
        model.stem_bn(nchw.permute(0, 2, 3, 1), False)
