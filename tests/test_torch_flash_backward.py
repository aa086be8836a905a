"""PyTorch port's flash-attention backward (plain version, CPU) vs the JAX
Pallas backward in interpret mode, and the backward registered on the
port's forward op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas_attention import LSE_LANES, _flash_backward
from kubeflow_tpu.ops.pallas_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import pallas_attention as pa

# fp32 on both sides: the two differ only in summation order (the scores,
# the row sums of do*o, the products); gradients up to ~6 differed by at
# most 2.4e-6 over the cases below
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B=2, Sq=32, H=4, KV=4, D=16, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jax_grads(q, k, v, do, causal, bq, bk, window):
    """jax.grad of the JAX op (custom_vjp over the Pallas kernels, interpret
    mode on the CPU): the vjp of its output with cotangent ``do``."""
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, bq, bk, None, window),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, causal, window):
    q, k, v, do = _t(q, k, v, do)
    o, lse = pa.flash_attention_plain(q, k, v, causal=causal, window=window)
    return [g.numpy() for g in pa.flash_attention_backward_plain(
        q, k, v, o, lse, do, causal=causal, window=window)]


@pytest.mark.parametrize("causal,window,kv,bq,bk", [
    (True, None, 4, 8, 8),      # causal
    (False, None, 4, 8, 8),     # non-causal
    (True, None, 2, 8, 8),      # GQA 4/2
    (True, None, 1, 8, 8),      # GQA 4/1 (MQA)
    (True, 5, 2, 8, 8),         # window smaller than a tile
    (True, 12, 4, 8, 8),        # window larger than a tile
    (True, None, 2, 8, 16),     # unequal blocks (the JAX kernels then skip nothing)
])
def test_plain_backward_matches_jax_grad(causal, window, kv, bq, bk):
    q, k, v, do = _inputs(KV=kv)
    want = _jax_grads(q, k, v, do, causal, bq, bk, window)
    got = _port_grads(q, k, v, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("S,causal,window,kv,block", [
    (96, True, None, 2, 32),    # ragged against the fp32 kernels' 64-row tiles
    (96, False, None, 4, 32),
    (200, True, 48, 1, 40),     # ragged against 64- and 32-row tiles, MQA
    (200, True, None, 2, 40),
])
def test_plain_backward_matches_jax_grad_at_lengths_ragged_to_the_fp32_tiles(
        S, causal, window, kv, block):
    """fp32 at lengths that leave a ragged last tile of the fp32 dq and dk/dv
    kernels (64 rows and keys up to width 128, 32 at 256): the plain
    backward, which the card's kernels are held to, against the JAX kernels
    (interpret mode, blocks that divide S)."""
    q, k, v, do = _inputs(B=1, Sq=S, KV=kv, seed=S)
    want = _jax_grads(q, k, v, do, causal, block, block, window)
    got = _port_grads(q, k, v, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_dead_rows_get_zero_dq_and_match_jax_elsewhere():
    """Sq 16 > Sk 8 with window 2: rows 9-15 see no key. The port's forward
    gives them lse +inf, so p = 0 and dq = 0 there. The JAX forward gives
    them mean(V) (ROADMAP Queue 3), so its backward too sees p = 1/8 on those
    rows: dq is compared on the live rows, and dk/dv with do zeroed on the
    dead rows, where the dead rows then add nothing on either side."""
    q, k, v, do = _inputs(Sq=16, Sk=8, KV=2)
    dead = np.arange(16) - 2 >= 8 - 1
    assert dead.sum() == 7
    do[:, dead] = 0.0
    want = _jax_grads(q, k, v, do, True, 8, 8, 2)
    got = _port_grads(q, k, v, do, True, 2)
    np.testing.assert_allclose(got[0][:, ~dead], want[0][:, ~dead], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **TOL)
    # with a live cotangent on the dead rows the port still gives them dq = 0
    q, k, v, do = _inputs(Sq=16, Sk=8, KV=2)
    dq = _port_grads(q, k, v, do, True, 2)[0]
    np.testing.assert_array_equal(dq[:, dead], 0.0)
    assert np.abs(dq[:, 1:8]).max(axis=-1).min() > 0.0   # rows 1-7 see two keys


@pytest.mark.parametrize("causal,window,kv", [(True, None, 2), (True, 5, 4), (False, None, 1)])
def test_rounding_points_match_the_tpu_kernels_in_bf16(causal, window, kv):
    """bf16 operands, fp32 gradients (``grad_dtype``): the same inputs (o and
    lse from the port's plain forward) through ``_flash_backward`` and the
    port. Both round p and ds to bf16 at the same points; a score that
    differs in its last fp32 bit can flip one rounding of p or ds by one bf16
    step (2^-8 relative), which moves a gradient by ~1e-3 of its scale at
    most."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(KV=kv))
    o, lse = pa.flash_attention_plain(q, k, v, causal=causal, window=window)

    def bhsd(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).transpose(0, 2, 1, 3)

    lse_lanes = jnp.repeat(jnp.asarray(lse.numpy())[..., None], LSE_LANES, axis=-1)
    want = _flash_backward(*map(bhsd, (q, k, v, o)), lse_lanes, bhsd(do), causal=causal,
                           block_q=8, block_k=8, interpret=True, grad_dtype=jnp.float32,
                           window=window)
    want = [np.asarray(g.transpose(0, 2, 1, 3)) for g in want]
    got = pa.flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                            grad_dtype=torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=2e-3 * scale, rtol=0, err_msg=name)


def test_grad_dtype_defaults_to_the_inputs():
    q, k, v, do = (x.to(torch.bfloat16) for x in _t(*_inputs(KV=2)))
    o, lse = pa.flash_attention_plain(q, k, v)
    assert all(g.dtype == torch.bfloat16 for g in
               pa.flash_attention_backward_plain(q, k, v, o, lse, do))
    dq = pa.flash_attention_bwd_dq(q, k, v, o, lse, do, grad_dtype=torch.float32)
    dk, dv = pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, grad_dtype=torch.float32)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32,) * 3
    assert dk.shape == k.shape and dv.shape == v.shape and dq.shape == q.shape


@pytest.mark.parametrize("causal,window,kv,sk", [
    (True, None, 4, 12), (False, None, 2, 12), (True, 3, 2, 12), (True, 2, 1, 6),
])
def test_function_gradcheck_fp64(causal, window, kv, sk):
    """The op's registered backward (the two wrappers) against finite
    differences of its forward, in fp64 on the CPU."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 12, 4, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    k = torch.randn(1, sk, kv, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    v = torch.randn(1, sk, kv, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: pa.flash_attention(q, k, v, causal, 12, sk, window), (q, k, v))


def test_function_runs_the_wrappers_and_matches_the_plain_backward():
    q, k, v, do = _t(*_inputs(KV=2))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = pa.flash_attention(q, k, v, True, 8, 8, 5)
    o.backward(do)
    with torch.no_grad():
        o2, lse = pa.flash_attention_plain(q, k, v, causal=True, window=5)
        want = pa.flash_attention_backward_plain(q, k, v, o2, lse, do, causal=True, window=5)
    torch.testing.assert_close(o.detach(), o2, rtol=0, atol=0)
    for x, w in zip((q, k, v), want):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)


def test_inference_and_no_grad_stay_forward_only():
    """Serving calls under inference_mode/no_grad record no backward; with
    grad on, the op records one for o, and its lse never carries a gradient."""
    q, k, v, _ = _t(*_inputs(KV=2))
    q.requires_grad_()
    with torch.inference_mode():
        o, lse = pa.flash_attention(q, k, v, True, 8, 8, return_lse=True)
    assert o.grad_fn is None and lse.shape == (2, 4, 32)
    with torch.no_grad():
        assert pa.flash_attention(q, k, v, True, 8, 8).grad_fn is None
    o, lse = pa.flash_attention(q, k, v, True, 8, 8, return_lse=True)
    assert o.grad_fn is not None and not lse.requires_grad


def test_cpu_tensors_take_the_plain_backward():
    q, k, v, do = _t(*_inputs(KV=2))
    o, lse = pa.flash_attention_plain(q, k, v)
    before = (pa.flash_attention_bwd_dq.launches, pa.flash_attention_bwd_dkv.launches)
    pa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    pa.flash_attention_bwd_dkv(q, k, v, o, lse, do)
    assert (pa.flash_attention_bwd_dq.launches, pa.flash_attention_bwd_dkv.launches) == before


def test_backward_validation_errors():
    q, k, v, do = _t(*_inputs(KV=2))
    o, lse = pa.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        pa.flash_attention_bwd_dq(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1),
                                  o, lse, do)
    with pytest.raises(ValueError, match="shaped like q"):
        pa.flash_attention_bwd_dkv(q, k, v, o[:, :8], lse, do)
    with pytest.raises(ValueError, match="lse must be"):
        pa.flash_attention_bwd_dq(q, k, v, o, lse[..., None].expand(-1, -1, -1, LSE_LANES), do)
    with pytest.raises(ValueError, match="window requires causal"):
        pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=False, window=4)
    with pytest.raises(ValueError, match="grad_dtype"):
        pa.flash_attention_bwd_dq(q, k, v, o, lse, do, grad_dtype=torch.float16)
