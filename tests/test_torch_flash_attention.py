"""PyTorch port's flash-attention forward (plain version, CPU) vs the JAX
Pallas kernel in interpret mode, and the port's attention oracle vs JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import naive_attention as jax_naive
from kubeflow_tpu.ops.pallas_attention import _flash_forward
from kubeflow_tpu.ops.pallas_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops.attention import naive_attention
from kubeflow_tpu_torch.ops.pallas_attention import flash_attention

TOL = dict(atol=2e-5, rtol=2e-5)   # fp32 on both sides; summation order only


def _qkv(B=2, S=32, H=4, KV=4, D=16, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("causal,window,kv", [
    (True, None, 4), (False, None, 4), (True, 8, 4), (True, None, 2),
    (True, 12, 1), (False, None, 2),
])
def test_plain_matches_jax_kernel(causal, window, kv):
    q, k, v = _qkv(KV=kv)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal, 8, 8, None, window))
    got = flash_attention(*_t(q, k, v), causal, 8, 8, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_lse_matches_jax_residual(window):
    q, k, v = _qkv(KV=2)
    _, lse = _flash_forward(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=True, block_q=8, block_k=8, interpret=True,
        save_residuals=True, window=window,
    )
    _, got = flash_attention(*_t(q, k, v), True, 8, 8, window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[..., 0], **TOL)


def test_fully_masked_rows_give_zero_and_inf_lse():
    """Rows past the keys' end with a short window see no key. The port gives
    0 and lse +inf (the l_safe contract); every other row matches JAX. (The
    JAX kernel gives those rows mean(V) and lse ~-1e30: its finite NEG_INF
    makes exp(s - m) = 1 on a block with no live key.)"""
    q, k, v = _qkv(S=16, Sk=8, KV=2)
    o, lse = flash_attention(*_t(q, k, v), True, 8, 8, 2, return_lse=True)
    dead = np.arange(16) - 2 >= 8 - 1           # no key in (q - 2, q]
    assert dead.sum() == 7
    np.testing.assert_array_equal(o.numpy()[:, dead], 0.0)
    assert torch.isinf(lse[:, :, dead]).all() and (lse[:, :, dead] > 0).all()
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), True, 8, 8, None, 2))
    np.testing.assert_allclose(o.numpy()[:, ~dead], want[:, ~dead], **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 5)])
def test_naive_oracle_matches_jax(causal, window):
    q, k, v = _qkv()
    want = np.asarray(jax_naive(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    got = naive_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_matches_oracle_in_bf16():
    """bf16 operands: the same rounding points as the kernel (probabilities
    cast to bf16 before the value product), within bf16 resolution."""
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(S=64, KV=2)))
    got = flash_attention(q, k, v, True, 16, 16)
    want = naive_attention(q, k.repeat_interleave(2, 2), v.repeat_interleave(2, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=3e-2, rtol=3e-2)


def test_validation_errors_match_jax():
    q, k, v = _t(*_qkv())
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k[:, :, :3], v[:, :, :3], True, 8, 8)
    with pytest.raises(ValueError, match="same head count"):
        flash_attention(q, k, v[:, :, :2], True, 8, 8)
    with pytest.raises(ValueError, match="must divide blocks"):
        flash_attention(q, k, v, True, 12, 12)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention(q, k, v, False, 8, 8, 4)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention(q, k, v, True, 8, 8, 0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _t(*_qkv())
    before = flash_attention.launches
    flash_attention(q, k, v, True, 8, 8)
    assert flash_attention.launches == before
