"""Head sizes other than 64, 128 and 256: the port's kernels run them
zero-padded to the next of those widths with the true D's softmax scale
(width 256 on the flash kernels' scalar route, in bf16 and fp32 alike).

``_pad_heads`` takes the function it pads around as an argument: on the
card the kernel launch, here the plain version, so the padding itself is
held against the JAX kernels (interpret mode) at the true D. Flash-decode
reads the cache at its true D and zero-fills the rest of each row in shared
memory, which is the same as padding the cache: held here as the plain
version on padded operands. fp32 on both sides, so the two differ in
summation order only: forward and gradients within 1e-5 (the tolerance of
``test_torch_flash_backward.py``), decode within 2e-5 (that of
``test_torch_decode_plan.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from kubeflow_tpu.ops.pallas_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import flash_decode as fd
from kubeflow_tpu_torch.ops import pallas_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_DECODE = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))


@pytest.mark.parametrize("D", [16, 32, 48, 96, 160, 192, 256])
@pytest.mark.parametrize("causal,window,kv", [(True, None, 2), (False, None, 4), (True, 12, 1)])
def test_padded_flash_matches_jax_at_the_true_head_size(D, causal, window, kv):
    B, S, H = 2, 32, 4
    q, k, v, do = _inputs(B, S, S, H, kv, D, seed=D + kv)
    (o_j, vjp) = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 16, 16, True, window),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    width = pa._kernel_width(D)
    assert width == (64 if D <= 64 else 128 if D <= 128 else 256)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = pa._pad_heads(
        lambda q, k, v, scale: pa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                        scale=scale),
        (tq, tk, tv), width)
    # cut outputs come back contiguous (at D == width they are inner's own)
    assert o.shape == tq.shape and (o.is_contiguous() or D == width) and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    grads = pa._pad_heads(
        lambda q, k, v, o, do, scale: pa.flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, scale=scale),
        (tq, tk, tv, o, tdo), width)
    for name, g, want, t in zip(("dq", "dk", "dv"), grads, grads_j, (tq, tk, tv)):
        assert g.shape == t.shape, name
        np.testing.assert_allclose(g.numpy(), want, **TOL, err_msg=name)


def test_pad_heads_copies_nothing_at_the_kernel_widths():
    for D in (64, 128, 256):
        q = torch.zeros(1, 8, 2, D)
        seen = []

        def inner(*heads, scale):
            seen.append((heads, scale))
            return (heads[0],)

        (out,) = pa._pad_heads(inner, (q, q), pa._kernel_width(D))
        assert out is q and all(h is q for h in seen[0][0]) and seen[0][1] == D ** -0.5


@pytest.mark.parametrize("D,width", [(1, 64), (16, 64), (32, 64), (64, 64), (65, 128),
                                     (96, 128), (100, 128), (128, 128), (129, 256),
                                     (160, 256), (192, 256), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_are_made_at_the_padded_width(D, width, dtype):
    for kernel in ("fwd", "dq", "dkv"):
        plan = pa._plan(kernel, 4, 2048, 2048, 8, 8, D, dtype)
        assert plan == pa._plan(kernel, 4, 2048, 2048, 8, 8, width, dtype)
        assert plan.width == width and plan.smem_bytes <= pa.SMEM_LIMIT
        # bf16 takes the tensor cores up to 128; the scalar route beyond,
        # in 64-row tiles where they fit (the forward), else 32
        assert plan.route == ("wgmma" if dtype == torch.bfloat16 and width <= 128 else "scalar")
        if plan.route == "scalar":
            tile = 64 if width <= 128 or kernel == "fwd" else 32
            assert plan.block == tile and plan.threads == 256
            assert plan.smem_bytes == 4 * pa._scalar_floats(kernel, width, tile)
    for B, G, R, L in ((4, 4, 2, 2048), (2, 1, 16, 512)):
        p = fd._plan(B, G, R, L, D, dtype, 132)
        assert p == fd._plan(B, G, R, L, width, dtype, 132) and p.width == width
        elem = 4 if dtype == torch.float32 else 2
        assert p.kv_bytes == 2 * p.split * width * elem <= fd._KV_BYTES_MAX


def test_head_sizes_past_128_are_refused_with_their_limits():
    """Past 128 the bf16 tensor-core kernels would not fit (their sums at
    256), so widths up to 256 take the scalar route; past 256 the scalar
    kernels would not fit either, and that is the stated refusal."""
    assert [pa._wgmma_sums(k, 64, 256) for k in ("fwd", "dq", "dkv")] == [
        (164_904, 160), (197_928, 192), (264_232, 320)]
    assert pa._wgmma_sums("dkv", 64, 256)[0] > pa.SMEM_LIMIT
    assert pa._wgmma_sums("dq", 64, 256)[1] > pa._REGS_BESIDE_PRODUCER
    for D in (129, 200, 256):
        assert pa._kernel_width(D) == fd._kernel_width(D) == 256
    # the sums the refusal states are the scalar kernels' own at the next width
    assert [4 * pa._scalar_floats(k, 320, 32) for k in ("fwd", "dq", "dkv")] == [
        137_728, 229_888, 271_104]
    assert 4 * pa._scalar_floats("dkv", 320, 32) > pa.SMEM_LIMIT
    for D in (257, 320):
        with pytest.raises(ValueError, match=f"head_dim up to 256 .*got {D}.*dk/dv 271,104.*232,448"):
            pa._kernel_width(D)
        with pytest.raises(ValueError, match=f"flash_decode kernel takes head_dim up to 256 .*got {D}"):
            fd._plan(1, 1, 1, 64, D, torch.bfloat16, 132)


@pytest.mark.parametrize("D", [16, 32, 160, 256])
@pytest.mark.parametrize("window", [None, 40])
def test_padded_decode_matches_jax_at_the_true_head_size(D, window):
    """q and the cache zero-padded to the kernel's width with the true D's
    scale (the kernel pads q in the wrapper and the cache in shared
    memory), against the JAX kernel at D."""
    B, G, R, L = 2, 2, 4, 128
    rng = np.random.default_rng(D)
    q = rng.standard_normal((B, G, R, D)).astype(np.float32)
    kc = rng.standard_normal((B, G, L, D)).astype(np.float32)
    vc = rng.standard_normal((B, G, L, D)).astype(np.float32)
    pos = np.array([5, 100], np.int32)
    want = np.asarray(jax_flash_decode(*map(jnp.asarray, (q, kc, vc, pos)), window=window,
                                       block_k=64, interpret=True))
    width = fd._plan(B, G, R, L, D, torch.float32, 132).width
    pad = (0, width - D)
    tq, tk, tv = (torch.nn.functional.pad(torch.from_numpy(a), pad) for a in (q, kc, vc))
    got = fd.flash_decode_plain(tq, tk, tv, torch.from_numpy(pos), window=window,
                                scale=D ** -0.5)
    np.testing.assert_allclose(got[..., :D].numpy(), want, **TOL_DECODE)
    assert not got[..., D:].any()
