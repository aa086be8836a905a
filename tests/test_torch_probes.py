"""PyTorch port's two probe kernels' plain versions against the JAX probes on
the CPU: ``benchmarks/pallas_bwd_probe.py``'s ``bwd_kernel`` and
``benchmarks/bn_stats_probe.py``'s ``_moments_kernel``, each run through
``pl.pallas_call(..., interpret=True)`` at a small shape built here (the
probes' own wrappers are fixed to their benchmark shapes), and against the
probes' XLA versions ``xla_bwd`` and ``xla_moments``.

Tolerances: every sum is fp32 on both sides and the inputs hold the same
bf16 values, so sums differ in order only (1e-5 of the largest value). dy is
rounded to bf16 at the same point on both sides from the same fp32 chain,
and dX is rounded to bf16 once: a last-bit fp32 difference can move a dX
value by one bf16 step (2^-8 of itself)."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kubeflow_tpu_torch.benchmarks import bn_stats_probe as stats_probe
from kubeflow_tpu_torch.benchmarks import pallas_bwd_probe as bwd_probe
from kubeflow_tpu_torch.ops import bn_pallas as bn

REPO = Path(__file__).resolve().parents[1]
BF16_STEP = 2.0 ** -8


@functools.cache
def _jax_probe(name):
    """The JAX probe module, loaded from its file: ``benchmarks/`` is a
    directory of scripts, not a package."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16_values(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _close(got, want, rel, what):
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


# ------------------------------------------------- fused BN + ReLU + 1x1 conv backward


def _bwd_operands(n, ci, co, seed):
    rng = np.random.default_rng(seed)
    return (_bf16_values(rng, n, co), _bf16_values(rng, n, co), _bf16_values(rng, n, ci),
            _bf16_values(rng, co, ci), rng.standard_normal((7, co)).astype(np.float32))


@functools.cache
def _jax_bwd(n, ci, co, tile, seed):
    """(dX, dW) from the probe's ``bwd_kernel`` over ``n // tile`` row tiles
    in interpret mode (dW carried in its scratch accumulator across the
    grid), and from its ``xla_bwd``."""
    probe = _jax_probe("pallas_bwd_probe")
    dr, y, x, wt, scal = _bwd_operands(n, ci, co, seed)
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (dr, y, x, wt)] + [jnp.asarray(scal)]
    kernel = pl.pallas_call(
        probe.bwd_kernel,
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec((tile, co), lambda i: (i, 0)),
            pl.BlockSpec((tile, co), lambda i: (i, 0)),
            pl.BlockSpec((tile, ci), lambda i: (i, 0)),
            pl.BlockSpec((co, ci), lambda i: (0, 0)),
            pl.BlockSpec((7, co), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((tile, ci), lambda i: (i, 0)),
            pl.BlockSpec((ci, co), lambda i: (0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n, ci), jnp.bfloat16),
            jax.ShapeDtypeStruct((ci, co), jnp.float32),
        ],
        scratch_shapes=[probe.pltpu.VMEM((ci, co), jnp.float32)],
        interpret=True,
    )
    return tuple(kernel(*args)), tuple(probe.xla_bwd(*args))


@pytest.mark.parametrize("n,ci,co,tile", [(256, 32, 16, 64), (192, 48, 80, 32), (128, 16, 128, 128)])
def test_bwd_plain_matches_the_pallas_kernel(n, ci, co, tile):
    (dx_k, dw_k), (dx_x, dw_x) = _jax_bwd(n, ci, co, tile, 0)
    dr, y, x, wt, scal = _bwd_operands(n, ci, co, 0)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (dr, y, x, wt)] + [torch.from_numpy(scal)]
    # on CPU tensors the wrapper is the plain version and launches nothing
    dx, dw = bwd_probe.fused_bn_relu_conv1x1_bwd(*args)
    assert dx.dtype == torch.bfloat16 and dx.shape == (n, ci)
    assert dw.dtype == torch.float32 and dw.shape == (ci, co)
    assert bwd_probe.fused_bn_relu_conv1x1_bwd.launches == 0
    dx_p, dw_p = bwd_probe.fused_bn_relu_conv1x1_bwd_plain(*args)
    assert torch.equal(dx, dx_p) and torch.equal(dw, dw_p)
    for want_dx, want_dw, which in ((dx_k, dw_k, "bwd_kernel"), (dx_x, dw_x, "xla_bwd")):
        want = np.asarray(want_dx.astype(jnp.float32))
        np.testing.assert_allclose(dx.float().numpy(), want, rtol=BF16_STEP,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"dX vs {which}")
        _close(dw, want_dw, 1e-5, f"dW vs {which}")


def test_bwd_dy_chain_is_bit_equal():
    """The elementwise chain (ReLU mask recomputed from the BN output, BN
    backward, rounding to bf16) against the same chain in jnp, op by op."""
    dr, y, _, _, scal = _bwd_operands(512, 16, 48, 1)
    got = bwd_probe.bn_relu_bwd_dy(torch.from_numpy(dr).to(torch.bfloat16),
                                   torch.from_numpy(y).to(torch.bfloat16), torch.from_numpy(scal))
    yf, s = jnp.asarray(y), jnp.asarray(scal)
    xhat = (yf - s[1]) * s[2]
    db = jnp.where(xhat * s[6] + s[3] > 0, jnp.asarray(dr), 0.0)
    want = (s[0] * (db - s[4] - xhat * s[5])).astype(jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    mask = np.asarray(xhat * s[6] + s[3] > 0)
    assert 0.2 < mask.mean() < 0.8                  # both branches of the mask are taken
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_bwd_operand_checks():
    dr, y, x, wt, scal = (torch.from_numpy(a) for a in _bwd_operands(64, 16, 32, 2))
    bf = torch.bfloat16
    with pytest.raises(TypeError, match="must be bfloat16"):
        bwd_probe.fused_bn_relu_conv1x1_bwd(dr, y.to(bf), x.to(bf), wt.to(bf), scal)
    with pytest.raises(ValueError, match="expected dr and y"):
        bwd_probe.fused_bn_relu_conv1x1_bwd(dr.to(bf), y.to(bf), x.to(bf), wt.to(bf).t(), scal)
    # only CPU tensors take the plain version: any other device goes to the
    # kernel's checks, which raise without a card
    meta = [t.to(bf).to("meta") for t in (dr, y, x, wt)] + [scal.to("meta")]
    with pytest.raises(TypeError, match="kernel takes CUDA tensors"):
        bwd_probe.fused_bn_relu_conv1x1_bwd(*meta)
    assert bwd_probe.fused_bn_relu_conv1x1_bwd.launches == 0
    assert (bwd_probe.N, bwd_probe.CI, bwd_probe.CO) == (256 * 56 * 56, 256, 128)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bwd_probe.main()


# ------------------------------------------------- scaled channel moments


@functools.cache
def _jax_moments(shape, c, block_rows, seed):
    """(sum, sumsq) from the probe's ``_moments_kernel`` (multiplier in SMEM,
    sums carried across the grid) in interpret mode, and ``xla_moments``."""
    probe = _jax_probe("bn_stats_probe")
    x = jnp.asarray(_bf16_values(np.random.default_rng(seed), *shape)).astype(jnp.bfloat16)
    ch = shape[-1]
    m = x.size // ch
    s, q = pl.pallas_call(
        probe._moments_kernel,
        grid=(m // block_rows,),
        in_specs=[
            pl.BlockSpec(memory_space=probe.pltpu.SMEM),
            pl.BlockSpec((block_rows, ch), lambda i: (i, 0)),
        ],
        out_specs=(
            pl.BlockSpec((1, ch), lambda i: (0, 0)),
            pl.BlockSpec((1, ch), lambda i: (0, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((1, ch), jnp.float32),
            jax.ShapeDtypeStruct((1, ch), jnp.float32),
        ),
        interpret=True,
    )(jnp.full((1,), c, jnp.float32), x.reshape(m, ch))
    return (s[0], q[0]), probe.xla_moments(x, jnp.float32(c))


@pytest.mark.parametrize("shape,c,block_rows", [
    ((2, 8, 8, 64), 1.25, 32), ((3, 4, 4, 24), -0.5, 16), ((1, 16, 16, 128), 1.0, 256),
])
def test_moments_scaled_plain_matches_the_pallas_kernel(shape, c, block_rows):
    (s_k, q_k), (s_x, q_x) = _jax_moments(shape, c, block_rows, 3)
    x = torch.from_numpy(_bf16_values(np.random.default_rng(3), *shape)).to(torch.bfloat16)
    s, q = stats_probe.moments_scaled(x, c)
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (shape[-1],)
    assert stats_probe.moments_scaled.launches == 0
    s_p, q_p = stats_probe.moments_scaled_plain(x, c)
    assert torch.equal(s, s_p) and torch.equal(q, q_p)
    for want_s, want_q, which in ((s_k, q_k, "_moments_kernel"), (s_x, q_x, "xla_moments")):
        _close(s, want_s, 1e-5, f"sum vs {which}")
        _close(q, want_q, 1e-5, f"sumsq vs {which}")
    # with c = 1 these are the sums behind channel_moments
    mean, var = bn.channel_moments(x)
    s1, q1 = stats_probe.moments_scaled(x, 1.0)
    m = x.numel() // shape[-1]
    torch.testing.assert_close(mean, s1 / m)
    torch.testing.assert_close(var, torch.clamp(q1 / m - (s1 / m) ** 2, min=0.0))


def test_stats_probe_surface():
    jax_probe = _jax_probe("bn_stats_probe")
    assert stats_probe.SHAPES == jax_probe.SHAPES and len(stats_probe.SHAPES) == 6
    x = torch.empty((2, 4, 4, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="bn_moments kernel takes CUDA tensors"):
        stats_probe.moments_scaled(x, 1.25)
    assert stats_probe.moments_scaled.launches == 0
    with pytest.raises(SystemExit, match="no CUDA device"):
        stats_probe.main()
