"""PyTorch port's MoE row gather and its scatter backward against the JAX
package's Pallas kernels (interpret mode) on the CPU.

The shapes are ones the JAX function sends to its kernels (M a multiple of
128, J of 256, the table under the VMEM budget), with sentinel indices >= R.
Copies (the gather, the unique scatter) must be exactly equal; the fp32
accumulating scatter is held to a stated tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import moe_dispatch as jmd
from kubeflow_tpu_torch.ops import moe_dispatch as md

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _case(B, R, M, J, *, unique, seed):
    """x [B, R, M], idx [B, J] with sentinels and, in unique mode, one row
    that several indices hit (the combine's padding row); dy [B, J, M]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, M)).astype(np.float32)
    dy = rng.standard_normal((B, J, M)).astype(np.float32)
    if unique:
        idx = np.stack([rng.permutation(R)[:J] for _ in range(B)])
        idx[:, 1::9] = R - 1                     # collide on the last row
    else:
        idx = rng.integers(0, R, (B, J)) % 37    # heavy collisions
    idx[:, ::7] = R + rng.integers(0, 4, idx[:, ::7].shape)   # sentinels
    return x, idx.astype(np.int32), dy


def _collided(idx, R):
    """[B, R] bool: rows that two or more in-range indices hit."""
    return np.stack([np.bincount(i[i < R], minlength=R) >= 2 for i in idx])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unique,shape", [
    (False, (2, 300, 128, 512)),    # dispatch-like: J > R, rows collide
    (True, (2, 513, 256, 256)),     # combine-like: J < R, injective but one row
])
def test_gather_and_scatter_match_the_pallas_kernels(dtype, unique, shape):
    """The forward copy is exact. The scatter's fp32 sums: the JAX kernel
    adds a row's sources in j order, the plain version (``index_add_``) is
    not bound to an order, so each element may differ by the rounding of
    its partial sums: held to 1e-6 of the largest |dx| in fp32 and one bf16
    step (2^-8 relative) after the cast to bf16 (measured: equal). The
    unique scatter is a copy: exact on every row that one index hits."""
    B, R, M, J = shape
    x, idx, dy = _case(B, R, M, J, unique=unique, seed=R + J)
    jx = jnp.asarray(x).astype(JDT[dtype])
    jdy = jnp.asarray(dy).astype(JDT[dtype])
    want, vjp = jax.vjp(lambda a: jmd.gather_rows(a, jnp.asarray(idx), unique_indices=unique), jx)
    (want_dx,) = vjp(jdy)
    want = np.asarray(want.astype(jnp.float32))
    want_dx = np.asarray(want_dx.astype(jnp.float32))

    launches = (md.gather.launches, md.scatter.launches)
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    got = md.gather_rows(tx, torch.from_numpy(idx), unique_indices=unique)
    got.backward(torch.from_numpy(dy).to(dtype))
    assert got.dtype == dtype and tx.grad.dtype == dtype
    assert (md.gather.launches, md.scatter.launches) == launches   # CPU: plain versions
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    dx = tx.grad.float().numpy()
    if unique:
        keep = ~_collided(idx, R)
        assert (~keep).any() and keep.any()
        np.testing.assert_array_equal(dx[keep], want_dx[keep])
    else:
        if dtype == torch.float32:
            np.testing.assert_allclose(dx, want_dx, rtol=0, atol=1e-6 * np.abs(want_dx).max())
        else:
            np.testing.assert_allclose(dx, want_dx, rtol=2 ** -8, atol=0)
    # rows that no in-range index hits get exactly zero gradient
    hit = np.zeros((B, R), bool)
    for b in range(B):
        hit[b, idx[b][idx[b] < R]] = True
    assert not dx[~hit].any()


def _loop_gather(x, idx):
    B, R, M = x.shape
    out = torch.zeros((B, idx.shape[1], M), dtype=x.dtype)
    for b in range(B):
        for j, r in enumerate(idx[b].tolist()):
            if 0 <= r < R:
                out[b, j] = x[b, r]
    return out


@pytest.mark.parametrize("B,R,M,J", [(1, 5, 100, 3), (3, 4, 7, 11), (2, 9, 1, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_take_any_shape(B, R, M, J, dtype):
    """No shape fallback: any M, J < R and J > R, negative and >= R indices
    read zero; the accumulating scatter of an all-ones cotangent counts each
    row's in-range sources, the unique scatter of distinct indices puts each
    row back where it came from."""
    g = torch.Generator().manual_seed(B * 100 + J)
    x = torch.randn((B, R, M), generator=g).to(dtype)
    idx = torch.randint(-2, R + 3, (B, J), generator=g, dtype=torch.int32)
    torch.testing.assert_close(md.gather(x, idx), _loop_gather(x, idx), rtol=0, atol=0)

    dx = md.scatter(idx, torch.ones((B, J, M), dtype=dtype), R, accumulate=True)
    assert dx.dtype == torch.float32
    counts = torch.stack([torch.bincount(i[(i >= 0) & (i < R)].long(), minlength=R) for i in idx])
    torch.testing.assert_close(dx, counts[..., None].float().expand(B, R, M), rtol=0, atol=0)

    perm = torch.stack([torch.randperm(R, generator=g)[:min(J, R)] for _ in range(B)]).int()
    rows = md.gather(x, perm)
    back = md.scatter(perm, rows, R, accumulate=False)
    assert back.dtype == dtype
    for b in range(B):
        torch.testing.assert_close(back[b, perm[b].long()], x[b, perm[b].long()], rtol=0, atol=0)


def test_every_index_a_sentinel():
    x = torch.randn((2, 8, 128), requires_grad=True)
    idx = torch.full((2, 256), 8, dtype=torch.int32)
    out = md.gather_rows(x, idx)
    assert not out.any()
    out.sum().backward()
    assert not x.grad.any()


def test_kernel_path_takes_only_cuda_tensors():
    """A tensor that is neither on the CPU nor on a card raises: the
    wrappers never fall back to the plain versions off the CPU."""
    x = torch.empty((1, 4, 8), device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="CUDA tensors"):
        md.gather(x, idx)
    with pytest.raises(TypeError, match="CUDA tensors"):
        md.scatter(idx, torch.empty((1, 2, 8), device="meta"), 4, accumulate=True)
    with pytest.raises(ValueError, match=r"idx \[B, J\]"):
        md.gather(torch.zeros((2, 4, 8)), torch.zeros((1, 2), dtype=torch.int32))
