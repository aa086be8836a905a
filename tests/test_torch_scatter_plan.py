"""The MoE row scatter's index pass and summation order, on the CPU.

``scatter_plan`` mirrors what the kernel (``csrc/moe_scatter.cu``) derives
from the indices alone: each batch row's sources ordered by (destination,
j), the rows of more than ``SEG`` sources cut into segments, the direct
store's source a row (the largest j), and the workspace and ticket sizes the
wrapper allocates. Held here against numpy on the MoE training flagship's
indices (the port's own ``route_top_k`` on numpy-seeded router logits) and
on edge cases.

``scatter_replay`` is the row pass's order of operations: a row of at most
``SEG`` sources summed in j order from 0 in fp32, a heavier row summed a
segment at a time and the partials added in segment order. Against
``scatter_rows_plain`` (``index_add_``, which on the CPU adds in j order):
bit for bit on rows of at most ``SEG`` sources, and on the others within
n * 2^-23 * sum|sources| (each of the two orders is within (n - 1) * 2^-24 *
sum|sources| of the exact sum). Against the JAX Pallas kernel (interpret
mode), which adds a row's sources sequentially in j order: the same bounds;
the direct store's rows equal the JAX kernel's on every row, colliding rows
too (its sequential stores leave the largest j)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.moe_dispatch import _scatter_grid_call
from kubeflow_tpu_torch.models import moe
from kubeflow_tpu_torch.ops import moe_dispatch as md

EPS = 2.0 ** -23


def _flagship(seed=2):
    """The MoE training flagship's indices (B 4, S 2048, 8 experts, top-2,
    capacity 640): router logits of unit scale with expert 0 favoured, so
    choices drop and slots stay empty, as ``chip_smoke.py`` builds them."""
    B, S, E, k, C = 4, 2048, 8, 2, 640
    logits = np.random.default_rng(seed).standard_normal((B, S, E)).astype(np.float32)
    logits[..., 0] += 1.0
    plan = moe.route_top_k(torch.from_numpy(logits), k, C)
    slot_token, combine_idx = moe.slot_indices(plan, E, C, S)
    return slot_token, S + 1, combine_idx[0], E * C + 1


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "dispatch_flagship":
        idx, R, _, _ = _flagship()
        return idx.numpy(), R
    if name == "combine_flagship":
        _, _, idx, R = _flagship()
        return idx.numpy(), R
    if name == "sentinels":
        idx = rng.integers(0, 300, (2, 512))
        idx[:, ::7] = 300 + rng.integers(0, 4, idx[:, ::7].shape)
        return idx, 300
    if name == "negative":
        return rng.integers(-40, 80, (3, 257)), 77
    if name == "one_row":
        return np.full((2, 4096), 7), 300
    if name == "j_lt_r":
        return np.stack([rng.permutation(1000)[:64] for _ in range(2)]), 1000
    if name == "j_gt_r":
        return rng.integers(0, 50, (2, 4096)), 50
    if name == "r1":
        return rng.integers(-1, 3, (2, 512)), 1
    if name == "empty":
        return np.zeros((2, 0), np.int64), 5
    raise KeyError(name)


CASES = ["dispatch_flagship", "combine_flagship", "sentinels", "negative", "one_row", "j_lt_r",
         "j_gt_r", "r1", "empty"]


@pytest.mark.parametrize("name", CASES)
def test_index_pass_mirror_matches_numpy(name):
    idx, R = _case(name)
    B, J = idx.shape
    plan = md.scatter_plan(torch.from_numpy(idx), R, M=1024)
    heavy_rows, n_segments = 0, 0
    for b in range(B):
        valid = (idx[b] >= 0) & (idx[b] < R)
        j, r = np.nonzero(valid)[0], idx[b][valid]
        counts = np.bincount(r, minlength=R)
        np.testing.assert_array_equal(plan.counts[b].numpy(), counts)
        order = j[np.lexsort((j, r))]                   # by destination, then j
        np.testing.assert_array_equal(plan.order[b].numpy(), order)
        np.testing.assert_array_equal(plan.starts[b].numpy(), np.r_[0, np.cumsum(counts)])
        inv = np.full(R, -1)
        np.maximum.at(inv, r, j)
        np.testing.assert_array_equal(plan.inv[b].numpy(), inv)
        heavy_rows += int((counts > md.SEG).sum())
        n_segments += int(np.sum(-(-counts[counts > md.SEG] // md.SEG)))
    # every heavy row's run cut into segments of SEG in j order, nothing else
    for b, r, s, run in plan.segments:
        whole = plan.order[b][plan.starts[b, r]:plan.starts[b, r + 1]]
        assert len(whole) > md.SEG
        np.testing.assert_array_equal(run.numpy(), whole[s * md.SEG:(s + 1) * md.SEG].numpy())
    assert plan.heavy == heavy_rows and len(plan.segments) == n_segments
    # the launch's sizes bound what any indices of this shape can need
    heavy_max = B * J // (md.SEG + 1)            # rows of more than SEG sources, at most
    assert plan.heavy <= heavy_max
    assert plan.items == len(plan.segments) + 4 * plan.heavy   # 4 slices of 256 columns a row
    assert plan.item_max == -(-B * J // md.SEG) + 5 * heavy_max >= plan.items
    assert plan.ws_floats == plan.item_max * (1024 + 4 + md.SEG)
    assert plan.tickets == 4 + 3 * plan.item_max
    if name == "dispatch_flagship":
        # the padding row S takes every empty slot: ~1,600 sources a batch row
        assert plan.heavy == B and all(1500 < int(plan.counts[b, R - 1]) < 1700 for b in range(B))
        assert len(plan.segments) == sum(-(-int(plan.counts[b, R - 1]) // md.SEG) for b in range(B))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_against_the_plain_scatter(name, dtype):
    idx, R = _case(name)
    B, J = idx.shape
    M = 16
    dy = torch.from_numpy(np.random.default_rng(J).standard_normal((B, J, M)).astype(np.float32))
    dy = dy.to(dtype)
    tidx = torch.from_numpy(idx)
    plan = md.scatter_plan(tidx, R)
    got = md.scatter_replay(tidx, dy, R, plan)
    want = md.scatter_rows_plain(tidx, dy, R, accumulate=True)
    assert got.dtype == torch.float32 and got.shape == (B, R, M)
    n = plan.counts[..., None].float()
    light = (plan.counts <= md.SEG)[..., None].expand_as(got)
    assert torch.equal(got[light], want[light])
    bound = n * EPS * md.scatter_rows_plain(tidx, dy.float().abs(), R, accumulate=True)
    assert bool(((got - want).abs() <= bound).all())
    if plan.heavy:
        assert not light.all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_replay_and_direct_store_against_the_jax_kernel(dtype):
    """One shape the JAX kernel takes (M 128, J a multiple of 256), rows of
    3 to ~60 sources and sentinels past R."""
    B, J, R, M = 2, 512, 300, 128
    rng = np.random.default_rng(7)
    idx = (rng.integers(0, R, (B, J)) % 9) * 31            # 9 rows, ~57 sources each
    idx[:, 1::5] = rng.integers(0, R, idx[:, 1::5].shape)   # and rows of few sources
    idx[:, ::13] = R + 2                                    # sentinels
    idx = idx.astype(np.int32)
    dy = rng.standard_normal((B, J, M)).astype(np.float32)
    jdy = jnp.asarray(dy).astype(dtype)
    want = np.asarray(_scatter_grid_call(jnp.asarray(idx), jdy, R, jnp.float32, True, True))
    stored = np.asarray(_scatter_grid_call(jnp.asarray(idx), jdy, R, jdy.dtype, False, True)
                        .astype(jnp.float32))
    tdy = torch.from_numpy(np.array(jdy.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tidx = torch.from_numpy(idx)
    plan = md.scatter_plan(tidx, R)
    assert plan.heavy > 0 and bool((plan.counts[plan.counts > 0] <= 2).any())
    got = md.scatter_replay(tidx, tdy, R, plan).numpy()
    light = (plan.counts <= md.SEG).numpy()
    np.testing.assert_array_equal(got[light], want[light])
    n = plan.counts.numpy()[..., None]
    absum = md.scatter_rows_plain(tidx, tdy.float().abs(), R, accumulate=True).numpy()
    assert np.all(np.abs(got - want) <= n * EPS * absum)
    # the direct store copies the largest j of each row, as the JAX kernel's
    # sequential stores leave it, or zeros
    inv = plan.inv
    rows = torch.where((inv >= 0)[..., None], tdy[torch.arange(B)[:, None], inv.clamp(min=0)], 0)
    np.testing.assert_array_equal(rows.float().numpy(), stored)
