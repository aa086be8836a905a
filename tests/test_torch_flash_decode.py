"""PyTorch port's flash-decode (plain version, CPU) vs the JAX Pallas kernel
in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from kubeflow_tpu_torch.ops.flash_decode import flash_decode

TOL = dict(atol=2e-5, rtol=2e-5)   # fp32 on both sides; summation order only


def _mats(B=2, G=2, R=2, D=32, L=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, G, R, D)).astype(np.float32),
            rng.standard_normal((B, G, L, D)).astype(np.float32),
            rng.standard_normal((B, G, L, D)).astype(np.float32))


def _both(q, k, v, pos, window=None):
    pos = np.asarray(pos, np.int32)
    want = jax_flash_decode(
        *map(jnp.asarray, (q, k, v, pos)), window=window, block_k=64, interpret=True
    )
    got = flash_decode(*map(torch.from_numpy, (q, k, v, pos)), window=window, block_k=64)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pos", [0, 3, 63, 64, 200, 255])
def test_matches_jax_kernel(pos):
    got, want = _both(*_mats(), [pos, pos])
    np.testing.assert_allclose(got, want, **TOL)


def test_per_row_positions_differ():
    got, want = _both(*_mats(), [5, 230])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pos,window", [(200, 32), (200, 64), (250, 128), (10, 32)])
def test_sliding_window(pos, window):
    got, want = _both(*_mats(), [pos, pos - 7], window=window)
    np.testing.assert_allclose(got, want, **TOL)


def test_group_of_four_heads():
    got, want = _both(*_mats(G=1, R=4), [17, 130])
    np.testing.assert_allclose(got, want, **TOL)


def test_dead_slots_never_leak():
    """Garbage, even NaN, in dead cache slots must not reach the output."""
    q, k, v = _mats()
    pos = torch.tensor([100, 40], dtype=torch.int32)
    clean = flash_decode(*map(torch.from_numpy, (q, k, v)), pos, block_k=64)
    k2, v2 = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    for b, p in enumerate(pos.tolist()):
        k2[b, :, p + 1:] = torch.nan
        v2[b, :, p + 1:] = -1e9
    dirty = flash_decode(torch.from_numpy(q), k2, v2, pos, block_k=64)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), **TOL)
    _, want = _both(q, k, v, [100, 40])
    np.testing.assert_allclose(dirty.numpy(), want, **TOL)


def test_row_with_no_live_key_gives_zero():
    """pos < 0: no live slot; the JAX kernel's l_safe gives 0, so does the port."""
    got, want = _both(*_mats(), [-1, 9])
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


def test_validation_errors_match_jax():
    q, k, v = map(torch.from_numpy, _mats())
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cache must be"):
        flash_decode(q, k[:, :1], v[:, :1], pos)
    with pytest.raises(ValueError, match="multiple of block_k"):
        flash_decode(q, k[:, :, :200], v[:, :, :200], pos, block_k=64)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _mats())
    before = flash_decode.launches
    flash_decode(q, k, v, torch.zeros(2, dtype=torch.int32))
    assert flash_decode.launches == before


def _bf16_both(q, k, v, pos, window):
    """bf16 operands on both sides: JAX's kernel with one block over the
    cache, so it rounds p to bf16 at the same row max as the plain version."""
    pos = np.asarray(pos, np.int32)
    L = k.shape[2]
    want = jax_flash_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(pos),
                            window=window, block_k=L, interpret=True)
    got = flash_decode(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                       torch.from_numpy(pos), window=window, block_k=L)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 32])
def test_more_than_eight_heads_a_group_fp32(G, window):
    """R 16 (the kernel takes two chunks of 8 heads), fp32 throughout."""
    got, want = _both(*_mats(G=G, R=16, seed=G), [200, 37], window=window)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window", [None, 48])
def test_more_than_eight_heads_a_group_bf16(G, window):
    """R 12 in bf16: fp32 softmax on both sides, then one rounding of the
    output to bf16, which may land one bf16 step (2^-8 of the value) apart
    where the fp32 sums differ in their last bits."""
    got, want = _bf16_both(*_mats(G=G, R=12, L=128, seed=10 + G), [127, 60], window)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def test_card_operand_checks_take_fp32_and_wide_groups():
    """Off the CPU the wrapper checks the operands before any build: fp32
    and R 16 are taken (the meta tensors here only stop at the device
    check, as no card is present); fp16, mixed dtypes and D 640 raise."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    pos = meta(2, dtype=torch.int32)
    for dt, R in ((torch.float32, 16), (torch.bfloat16, 12), (torch.float32, 1)):
        with pytest.raises(TypeError, match="takes CUDA tensors"):
            flash_decode(meta(2, 1, R, 64, dtype=dt), meta(2, 1, 256, 64, dtype=dt),
                         meta(2, 1, 256, 64, dtype=dt), pos, block_k=64)
    with pytest.raises(TypeError, match="bf16 or fp32 operands of one dtype"):
        flash_decode(meta(2, 1, 4, 64, dtype=torch.float16), meta(2, 1, 256, 64, dtype=torch.float16),
                     meta(2, 1, 256, 64, dtype=torch.float16), pos, block_k=64)
    with pytest.raises(TypeError, match="bf16 or fp32 operands of one dtype"):
        flash_decode(meta(2, 1, 4, 64), meta(2, 1, 256, 64, dtype=torch.bfloat16),
                     meta(2, 1, 256, 64), pos, block_k=64)
    with pytest.raises(ValueError, match="head_dim up to 512 .*got 640.*232,448"):
        flash_decode(meta(2, 1, 4, 640), meta(2, 1, 256, 640), meta(2, 1, 256, 640), pos, block_k=64)
