"""PyTorch port's BatchNorm reductions (``ops/bn_pallas.py``) against the JAX
package's on the CPU: the plain versions of the two kernels against the
Pallas kernels in interpret mode, ``batch_norm_train`` forward, statistics
and all three gradients for both strategies, the MXU forms, the variance
clamp, and the raising paths.

Tolerances: fp32 inputs differ in summation order only (1e-5). bf16 inputs
hold the same values on both sides and every sum is fp32, so the statistics
agree as in fp32; y and dx are rounded to bf16 at the same point on both
sides, and a last-bit fp32 difference before that rounding can move a value
by one bf16 step (2^-8 of itself)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import bn_pallas as jbn
from kubeflow_tpu_torch.ops import bn_pallas as bn

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
BF16_STEP = 2.0 ** -8
SHAPES = [(4, 6, 6, 16), (3, 5, 7, 11), (2, 8, 8, 128), (40, 24)]


def _inputs(shape, dtype, seed=0, mean=1.0, std=3.0):
    """(x, dy) as numpy fp32 arrays holding values of ``dtype``."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * std + mean).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dtype).float().numpy() for a in (x, dy))


def _np(a):
    return np.asarray(a.astype(jnp.float32) if hasattr(a, "astype") else a, np.float32)


def _assert_close(got, want, dtype, what, atol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    rtol = BF16_STEP if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


@functools.cache
def _jax_sums(shape, dtype, seed):
    """The two Pallas kernels in interpret mode: (mean, var), (dbeta, dgamma)."""
    x, dy = _inputs(shape, dtype, seed)
    jx, jdy = jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(dy).astype(JDT[dtype])
    mean, var = jbn.channel_moments(jx, interpret=True)
    rinv = jax.lax.rsqrt(var + 1e-5)
    dbeta, dgamma = jbn._bn_grad_sums(jdy, jx, mean, rinv, interpret=True)
    return tuple(map(np.asarray, (mean, var, rinv, dbeta, dgamma)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_reductions_match_the_pallas_kernels(shape, dtype):
    """``channel_moments`` and ``bn_grad_sums`` on CPU tensors (their plain
    versions) against the JAX kernels; sums are fp32 on both sides."""
    x, dy = _inputs(shape, dtype, seed=1)
    mean_w, var_w, rinv, dbeta_w, dgamma_w = _jax_sums(shape, dtype, 1)
    xt, dyt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    mean, var = bn.channel_moments(xt)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (shape[-1],)
    _assert_close(mean, mean_w, torch.float32, "mean")
    _assert_close(var, var_w, torch.float32, "var")
    dbeta, dgamma = bn.bn_grad_sums(dyt, xt, torch.from_numpy(mean_w), torch.from_numpy(rinv))
    _assert_close(dbeta, dbeta_w, torch.float32, "dbeta")
    _assert_close(dgamma, dgamma_w, torch.float32, "dgamma")
    # the CPU path is the plain version and launches nothing
    assert torch.equal(mean, bn.channel_moments_plain(xt)[0])
    assert bn.channel_moments.launches == 0 and bn.bn_grad_sums.launches == 0


@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (3, 5, 7, 11)])
def test_mxu_reductions_match_jax(shape):
    x, dy = _inputs(shape, torch.bfloat16, seed=2)
    jx, jdy = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))
    xt, dyt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy))
    mean_w, var_w = jbn.channel_moments_mxu(jx)
    mean, var = bn.channel_moments_mxu(xt)
    _assert_close(mean, mean_w, torch.float32, "mean")
    _assert_close(var, var_w, torch.float32, "var")
    rinv = jax.lax.rsqrt(var_w + 1e-5)
    dbeta_w, dgamma_w = jbn._bn_grad_sums_mxu(jdy, jx, mean_w, rinv)
    dbeta, dgamma = bn._bn_grad_sums_mxu(
        dyt, xt, torch.from_numpy(np.asarray(mean_w)), torch.from_numpy(np.asarray(rinv)))
    _assert_close(dbeta, dbeta_w, torch.float32, "dbeta")
    # the raw-moment identity cancels: sum(dy x) - mean sum(dy)
    _assert_close(dgamma, dgamma_w, torch.float32, "dgamma", atol=1e-4)
    assert bn._mxu_ok(144, 16) and not bn._mxu_ok(8, 16)


@functools.cache
def _jax_bn_train(shape, dtype, strategy, seed):
    """JAX ``batch_norm_train``: y, (mean, var) and the gradients of
    sum(y * cot) in x, scale and bias (kernels in interpret mode on the CPU)."""
    x, cot = _inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 100)
    scale = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx, jcot = jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(cot).astype(JDT[dtype])

    def fn(x_, s_, b_):
        y, stats = jbn.batch_norm_train(x_, s_, b_, 1e-5, strategy=strategy)
        return jnp.sum(y.astype(jnp.float32) * jcot.astype(jnp.float32)), (y, stats)

    (_, (y, (mean, var))), grads = jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True)(
        jx, jnp.asarray(scale), jnp.asarray(bias))
    return (x, cot, scale, bias, _np(y), np.asarray(mean), np.asarray(var),
            tuple(_np(g) for g in grads))


@pytest.mark.parametrize("strategy", ["pallas", "mxu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (3, 5, 7, 11), (2, 2, 2, 64)])
def test_batch_norm_train_matches_jax(shape, dtype, strategy):
    """Forward, statistics and dx, dscale, dbias. (2, 2, 2, 64) has fewer
    rows than channels: the mxu strategy's plain-reduction tail."""
    x, cot, scale, bias, y_w, mean_w, var_w, (dx_w, ds_w, db_w) = _jax_bn_train(
        shape, dtype, strategy, 3)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, (mean, var) = bn.batch_norm_train(xt, st, bt, 1e-5, strategy=strategy)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    dx, ds, db = torch.autograd.grad(
        (y.float() * torch.from_numpy(cot).to(dtype).float()).sum(), (xt, st, bt))
    assert dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    # the mxu identity E[x^2] - mean^2 from Gram products cancels more
    loose = 1e-4 if strategy == "mxu" else 1e-5
    _assert_close(mean, mean_w, torch.float32, "mean")
    _assert_close(var, var_w, torch.float32, "var", atol=loose)
    _assert_close(y, y_w, dtype, "y", atol=loose)
    _assert_close(dx, dx_w, dtype, "dx", atol=max(loose, 2e-5))
    _assert_close(ds, ds_w, torch.float32, "dscale", atol=max(loose, 2e-5))
    _assert_close(db, db_w, torch.float32, "dbias", atol=loose)


@pytest.mark.parametrize("strategy", ["pallas", "mxu"])
def test_variance_clamps_at_zero(strategy):
    """A channel of large mean and low variance: E[x^2] - mean^2 cancels to
    below zero in fp32 and must clamp, here and in the JAX module."""
    rng = np.random.default_rng(4)
    x = (3000.3 + 1e-3 * rng.standard_normal((64, 8, 8, 16))).astype(np.float32)
    xt = torch.from_numpy(x)
    s, q = bn.moments_sums_plain(xt)
    raw = q / 4096 - (s / 4096) ** 2
    y, (mean, var) = bn.batch_norm_train(xt, torch.ones(16), torch.zeros(16), strategy=strategy)
    _, (_, var_w) = jbn.batch_norm_train(jnp.asarray(x), jnp.ones(16), jnp.zeros(16),
                                         strategy=strategy)
    assert (var >= 0).all() and torch.isfinite(y).all()
    assert (np.asarray(var_w) >= 0).all()
    if strategy == "pallas":
        assert (raw < 0).any() and (var[raw < 0] == 0).all()
    np.testing.assert_allclose(mean.numpy(), 3000.3, rtol=1e-6)


def test_bad_strategy_raises():
    x = torch.zeros(2, 3, 3, 4)
    with pytest.raises(ValueError, match="strategy must be 'pallas' or 'mxu'"):
        bn.batch_norm_train(x, torch.ones(4), torch.zeros(4), strategy="xla")
    with pytest.raises(ValueError, match="strategy must be"):
        jbn.batch_norm_train(jnp.zeros((2, 3, 3, 4)), jnp.ones(4), jnp.zeros(4), strategy="xla")


def test_non_cpu_tensor_without_a_card_raises():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device goes to the kernel's checks, which raise without a card."""
    x = torch.empty((8, 4, 4, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="bn_moments kernel takes CUDA tensors"):
        bn.channel_moments(x)
    v = torch.empty(16, device="meta")
    with pytest.raises(TypeError, match="bn_grad_sums kernel takes CUDA tensors"):
        bn.bn_grad_sums(x, x, v, v)
    assert bn.channel_moments.launches == 0 and bn.bn_grad_sums.launches == 0


def test_a_launch_is_counted_where_it_is_made(monkeypatch):
    """Each wrapper's count goes up on the launch itself and nowhere else:
    with the launcher replaced by a recorder, one pass through the launch
    path adds one to the count of the wrapper that was handed down and to
    no other; a CPU call launches nothing and counts nothing."""
    import types

    from kubeflow_tpu_torch.benchmarks import bn_stats_probe as probe

    calls = []
    monkeypatch.setattr(bn._build, "launch", lambda name, *args: calls.append(name))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    counters = (bn.channel_moments, bn.bn_grad_sums, probe.moments_scaled)
    for fn in counters:
        monkeypatch.setattr(fn, "launches", 0)
    x2 = torch.zeros(64, 16, dtype=torch.bfloat16)
    launchers = (lambda owner: bn._launch_moments(x2, 1.0, owner),
                 lambda owner: bn._launch_sums("bn_grad_sums", x2, (), (), owner),
                 lambda owner: bn._launch_moments(x2, 1.25, owner))
    for i, (launch, owner) in enumerate(zip(launchers, counters)):
        launch(owner)
        assert calls == ["bn_moments", "bn_grad_sums", "bn_moments"][:i + 1]
        assert [fn.launches for fn in counters] == [1] * (i + 1) + [0] * (2 - i)
    # CPU tensors take the plain versions: no launch, no count
    bn.channel_moments(x2)
    bn.bn_grad_sums(x2, x2, torch.zeros(16), torch.ones(16))
    probe.moments_scaled(x2, 1.25)
    assert len(calls) == 3 and [fn.launches for fn in counters] == [1, 1, 1]


def test_rows_view_that_needs_a_copy_raises():
    """No silent ``.contiguous()``: an NCHW-contiguous activation viewed as
    NHWC, or a transposed matrix, raises; so do mismatched operands."""
    nchw = torch.randn(2, 16, 5, 5)
    with pytest.raises(ValueError, match="needs a copy"):
        bn.channel_moments(nchw.permute(0, 2, 3, 1))
    good = nchw.permute(0, 2, 3, 1).contiguous()
    with pytest.raises(ValueError, match="needs a copy"):
        bn.bn_grad_sums(nchw.permute(0, 2, 3, 1), good, torch.zeros(16), torch.ones(16))
    with pytest.raises(ValueError, match="differ in shape"):
        bn.bn_grad_sums(good[:1], good, torch.zeros(16), torch.ones(16))
    with pytest.raises(ValueError, match="non-empty"):
        bn.channel_moments(torch.zeros(0, 16))
    # a channels_last conv output's NHWC view is free
    conv_out = torch.randn(2, 16, 5, 5).contiguous(memory_format=torch.channels_last)
    mean, _ = bn.channel_moments(conv_out.permute(0, 2, 3, 1))
    torch.testing.assert_close(mean, conv_out.mean(dim=(0, 2, 3)), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("m,ch,dtype", [
    (256 * 112 * 112, 64, torch.bfloat16), (256 * 49, 2048, torch.bfloat16),
    (16 * 49, 2048, torch.bfloat16), (5001, 3, torch.bfloat16), (105, 11, torch.float32),
    (3001, 100, torch.bfloat16), (3001, 100, torch.float32), (1, 256, torch.bfloat16),
    (100_000, 1, torch.float32),
])
def test_kernel_plan_covers_every_shape(m, ch, dtype):
    """The split the wrapper hands the kernels: 16-byte vectors where C
    allows, a power-of-two block width that fits 256 threads, every column
    covered, no more row groups than rows, and enough blocks to fill the
    card at both ends of the ResNet zoo."""
    vec, tx, gx, gy = bn._plan(m, ch, dtype, sms=132)
    wide = 8 if dtype == torch.bfloat16 else 4
    assert vec == (wide if ch % wide == 0 else 1) and ch % vec == 0
    assert tx & (tx - 1) == 0 and tx * vec <= bn.THREADS and bn.THREADS % tx == 0
    assert gx * tx * vec >= ch > (gx - 1) * tx * vec
    assert 1 <= gy <= max(1, -(-m // (bn.THREADS // tx)))
    if m * ch >= 1 << 24:
        assert gx * gy >= 2 * 132


# ResNet-50's BatchNorm inputs at batch 256 (rows, channels), the stats
# probe's at batch 16, and the chip smoke's edge cases
RESNET50_B256 = [(3211264, 64), (802816, 64), (802816, 256), (802816, 128), (200704, 128),
                 (200704, 512), (200704, 256), (50176, 256), (50176, 1024), (50176, 512),
                 (12544, 512), (12544, 2048)]
PROBE_B16 = [(200704, 64), (50176, 64), (50176, 256), (12544, 512), (3136, 1024), (784, 2048)]
EDGE = [(12347, 64, torch.bfloat16), (1, 256, torch.bfloat16), (5001, 3, torch.bfloat16),
        (105, 11, torch.bfloat16), (3001, 100, torch.bfloat16), (3001, 100, torch.float32),
        (777, 2048, torch.float32), (100_000, 1, torch.float32), (200_000, 64, torch.float32)]


@pytest.mark.parametrize("m,ch,dtype", [(m, c, torch.bfloat16) for m, c in RESNET50_B256 + PROBE_B16]
                         + EDGE)
def test_moments_plan_covers_every_shape(m, ch, dtype):
    """The one-launch moments kernel's split: 16-byte vectors where C
    allows, a power-of-two block width of at most 16 vectors (32 on rows of
    256 vectors or more), every column covered, a partial row of 2 x width4
    floats a block whose float4 quads the finish's lanes divide evenly, two
    blocks an SM at most and at least two batches of 8 rows a thread, and at
    least a block an SM on every activation of 16 M elements or more."""
    p = bn._moments_plan(m, ch, dtype, sms=132)
    wide = 8 if dtype == torch.bfloat16 else 4
    assert p.vec == (wide if ch % wide == 0 else 1) and ch % p.vec == 0
    cols = ch // p.vec
    cap = 32 if cols >= 256 else 16
    assert p.tx & (p.tx - 1) == 0 and p.tx // 2 < min(cols, cap) <= p.tx <= cap
    assert p.ty * p.tx == bn.THREADS and p.width == p.tx * p.vec <= bn.THREADS
    assert p.width4 == max(p.width, 4) and bn.THREADS % (p.width4 // 2) == 0
    assert p.gx * p.width >= ch > (p.gx - 1) * p.width
    assert 1 <= p.gy <= 65535 and p.gy <= -(-2 * 132 // p.gx)
    assert p.gy <= max(1, -(-m // (p.ty * 8 * 2)))
    assert p.part_floats == p.gx * p.gy * 2 * p.width4
    if m * ch >= 1 << 24:
        assert p.gx * p.gy >= 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (3, 5, 7, 11), (2, 8, 8, 128), (40, 24),
                                   (2, 7, 7, 256)])
def test_moments_finish_order_matches_the_pallas_kernel(shape, dtype):
    """The kernel's order of operations (``_moments_split_reference``: row
    lanes, block lanes, the last block's finish lanes) against the Pallas
    ``_moments_kernel`` in interpret mode and against the plain sums; fp32
    sums on every side, so they differ in summation order only."""
    x, _ = _inputs(shape, dtype, seed=2)
    xt = torch.from_numpy(x).to(dtype)
    ch = shape[-1]
    m = xt.numel() // ch
    plan = bn._moments_plan(m, ch, dtype, sms=132)
    s, q = bn._moments_split_reference(xt, 1.0, plan)
    mean, var = bn._mean_var(s, q, m)
    mean_w, var_w = jbn.channel_moments(jnp.asarray(x).astype(JDT[dtype]), interpret=True)
    _assert_close(mean, mean_w, torch.float32, "mean")
    _assert_close(var, var_w, torch.float32, "var")
    s0, q0 = bn.moments_sums_plain(xt)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-5 * s0.abs().max().item())
    torch.testing.assert_close(q, q0, rtol=1e-5, atol=1e-5 * q0.abs().max().item())


def test_moments_split_reference_splits_rows_and_columns_like_the_kernel():
    """A split with several row groups, column groups and finish lanes (the
    ResNet stem's channel count at a small row count on a card of 4 SMs),
    and the multiplier of the stats probe: the reference's sums match the
    plain version's to summation order, so each row is added exactly once."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4099, 96)).astype(np.float32) * 2 + 0.5)
    plan = bn._moments_plan(4099, 96, torch.float32, sms=4)
    assert plan.gx > 1 and plan.gy > 1 and bn.THREADS // (plan.width4 // 2) > 1
    s, q = bn._moments_split_reference(x, -1.25, plan)
    s0, q0 = bn.moments_sums_plain(x, -1.25)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-5 * s0.abs().max().item())
    torch.testing.assert_close(q, q0, rtol=1e-5, atol=1e-5 * q0.abs().max().item())
