"""Flash-decode's split of the key range (``ops/flash_decode.py`` ``_plan``)
and its order of operations (``_split_reference``), on the CPU.

The plan decides what the card runs: enough blocks a (row, group) that the
grid fills about two waves of SMs at the cache's full length, each holding
at most 64 KB of K and V; the kernel cuts each row's live range into that
many runs of a multiple of 16 keys (``_row_splits``). The split reference is
the kernel's arithmetic in plain PyTorch: each run rounds its probabilities
against its own maximum, then the partials are combined in run order. Against the JAX kernel (interpret mode, 64-key
blocks, rounding against its running maximum) that order differs in where
bf16 rounds, so bf16 is held to the chip smoke's bound for the kernel
(``check_out``: 2^-6 of the value plus 0.05 of the output's rms); fp32 to the
summation-order tolerance of ``test_torch_flash_decode.py``."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from kubeflow_tpu_torch.ops import flash_decode as fd

SMEM_LIMIT = 232_448
TOL_F32 = dict(atol=2e-5, rtol=2e-5)
OUT_RTOL, OUT_ATOL_RMS = 2.0 ** -6, 0.05


def _bytes(plan, D, elem):
    """The kernel's shared memory (``smem_bytes`` in csrc/flash_decode.cuh),
    part by part: K and V of ``split`` keys, the chunk's queries, the
    scores and the combine's weights in fp32."""
    return (2 * plan.split * D * elem + fd.MAX_R * D * elem + fd.MAX_R * plan.split * 4
            + fd.MAX_R * plan.splits * 4)


@pytest.mark.parametrize("B,G,R,L,D", [
    (4, 4, 2, 2048, 128),     # the serving flagship
    (1, 1, 1, 2048, 128),
    (2, 1, 16, 512, 128),     # two chunks of 8 query heads
    (2, 2, 12, 512, 64),
    (64, 8, 2, 2048, 128),    # more blocks than two waves without a split
    (2, 2, 2, 100, 64),       # L no multiple of 16
    (1, 1, 2, 32768, 64),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_plan_covers_the_cache(B, G, R, L, D, dtype, sms):
    p = fd._plan(B, G, R, L, D, dtype, sms)
    elem = 4 if dtype == torch.float32 else 2
    assert p.split % 16 == 0 and p.split >= 16
    # the blocks of a row hold the whole cache, the last one some of it
    assert (p.splits - 1) * p.split < L <= p.splits * p.split
    assert p.chunks == -(-R // 8) and p.grid == (p.splits, p.chunks, B * G)
    assert p.cluster == (p.splits <= 16)          # a cluster holds at most 16 blocks
    assert 2 * p.split * D * elem <= 65536          # K and V of a block, staged whole
    assert p.smem_bytes == _bytes(p, D, elem) <= SMEM_LIMIT
    assert (p.kv_bytes, p.q_bytes, p.weight_bytes) == (2 * p.split * D * elem, 8 * D * elem,
                                                       8 * p.splits * 4)
    base = p.chunks * B * G
    cap = 65536 // (2 * D * elem) // 16 * 16
    if 16 < p.split < cap:
        # neither the shared memory nor the least run of 16 keys decided:
        # about two waves (the split rounded up to 16 keys takes at most half away)
        assert sms <= p.splits * base <= 2 * sms + base


def test_plan_at_the_serving_flagship():
    """B4 G4 R2 D128 L2048 in bf16 on 132 SMs: 16 blocks of up to 128 keys a
    row, 256 blocks (two waves) in clusters of 16, 72,192 bytes a block
    (three blocks an SM).
    At the request's mean position (191) each row's 192 live keys go to 12
    blocks of 16."""
    p = fd._plan(4, 4, 2, 2048, 128, torch.bfloat16, 132)
    assert (p.split, p.splits, p.grid, p.cluster) == (128, 16, (16, 1, 16), True)
    assert p.smem_bytes == 72_192 and 3 * p.smem_bytes <= 228 * 1024
    assert fd._row_splits(191, 2048, None, p.splits) == (0, 191, 16)
    assert fd._row_splits(2047, 2048, None, p.splits) == (0, 2047, 128)
    # fp32 operands: up to 64 keys a block, the same 64 KB of K and V
    p32 = fd._plan(4, 4, 2, 2048, 128, torch.float32, 132)
    assert (p32.split, p32.splits) == (64, 32)


@pytest.mark.parametrize("L,sms", [(2048, 132), (512, 132), (100, 132), (4096, 20)])
def test_every_live_key_in_exactly_one_block(L, sms):
    rng = np.random.default_rng(L)
    p = fd._plan(2, 2, 2, L, 64, torch.bfloat16, sms)
    for pos in [-1, 0, 15, 16, 17, 63, 64, 65, L - 1, *rng.integers(0, L, 6).tolist()]:
        for window in (None, 1, 50, 100, 3 * p.split):
            lo, hi, per = fd._row_splits(pos, L, window, p.splits)
            assert per % 16 == 0 and per <= p.split        # fits the block's shared memory
            owners = {k: [] for k in range(lo, hi + 1)}
            for s in range(p.splits):                      # the kernel's cut, block by block
                k0 = lo + s * per
                for k in range(k0, min(hi, k0 + per - 1) + 1):
                    owners[k].append(s)
            assert all(len(v) == 1 for v in owners.values()), (pos, window)
            assert (per == 0) == (hi < lo)


def _mats(B, G, R, D, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, G, R, D)).astype(np.float32),
            rng.standard_normal((B, G, L, D)).astype(np.float32),
            rng.standard_normal((B, G, L, D)).astype(np.float32))


@functools.cache
def _jax(shape, pos, window, bf16, seed):
    q, k, v = _mats(*shape, seed)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    out = jax_flash_decode(*(jnp.asarray(x, dt) for x in (q, k, v)),
                           jnp.asarray(np.asarray(pos, np.int32)), window=window, block_k=64,
                           interpret=True)
    return np.asarray(out.astype(jnp.float32))


# (name, (B, G, R, D, L), pos, window, sms): sms 132 gives 16 blocks a row
# at these sizes, 4 gives 2
CASES = [
    ("pos_63", (2, 2, 2, 64, 256), (63, 63), None, 132),
    ("pos_64", (2, 2, 2, 64, 256), (64, 64), None, 132),
    ("pos_65", (2, 2, 2, 64, 256), (65, 65), None, 132),
    ("pos_last", (2, 2, 2, 64, 256), (255, 255), None, 132),
    ("per_row_pos_two_blocks", (2, 2, 2, 64, 256), (127, 200), None, 4),
    ("window_across_a_block_edge", (2, 2, 2, 64, 256), (100, 140), 60, 132),
    ("r16_two_chunks", (2, 1, 16, 64, 256), (65, 255), None, 132),
    ("pos_below_zero", (2, 2, 2, 64, 256), (-1, 64), None, 132),
]


@pytest.mark.parametrize("name,shape,pos,window,sms", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_split_reference_matches_the_jax_kernel(name, shape, pos, window, sms, bf16):
    B, G, R, D, L = shape
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(x).to(dt) for x in _mats(B, G, R, D, L, 7))
    plan = fd._plan(B, G, R, L, D, dt, sms)
    assert plan.splits == (2 if sms == 4 else 16)
    got = fd._split_reference(q, k, v, torch.tensor(pos, dtype=torch.int32), window, plan)
    assert got.dtype == dt and got.shape == (B, G, R, D)
    got = got.float().numpy()
    want = _jax((B, G, R, D, L), pos, window, bf16, 7)
    if bf16:
        rms = np.sqrt(np.mean(want ** 2))
        ratio = np.abs(got - want) / (OUT_RTOL * np.abs(want) + OUT_ATOL_RMS * rms)
        assert ratio.max() <= 1.0, ratio.max()
    else:
        np.testing.assert_allclose(got, want, **TOL_F32)
    for b, p in enumerate(pos):
        if p < 0:
            assert (got[b] == 0).all()          # no live key: 0, the TPU kernel's l_safe


def test_split_reference_never_reads_a_dead_slot():
    """NaN in every dead slot changes nothing: the split reference, like the
    kernel, masks before it multiplies."""
    q, k, v = (torch.from_numpy(x) for x in _mats(2, 2, 2, 64, 256, 3))
    pos = torch.tensor([70, 190], dtype=torch.int32)
    plan = fd._plan(2, 2, 2, 256, 64, torch.float32, 132)
    clean = fd._split_reference(q, k, v, pos, 100, plan)
    live = torch.arange(256)[None, :] <= pos[:, None]
    live &= torch.arange(256)[None, :] > pos[:, None] - 100
    live = live[:, None, :, None]
    dirty = fd._split_reference(q, torch.where(live, k, torch.nan),
                                torch.where(live, v, torch.nan), pos, 100, plan)
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("B,G,R,L,D,dtype", [
    (4, 1, 2, 2048, 512, torch.bfloat16),    # the heads-of-512 decode flagship: 64 runs a row
    (4, 1, 2, 2048, 512, torch.float32),     # ... fp32: 128 runs
    (4, 4, 2, 2048, 256, torch.bfloat16),    # heads of 256: 32 runs
    (4, 4, 2, 2048, 128, torch.bfloat16),    # the serving flagship: a cluster of 16
    (2, 2, 2, 100, 64, torch.float32),
])
def test_live_runs_hold_every_live_key(B, G, R, L, D, dtype):
    """``_live_runs``, the kernel's ``n_live``: every live key lies in
    exactly one of runs ``0 .. n_live - 1``, each of them holds at least
    one, and the runs past them hold none (they write no partial and the
    combine reads none), over positions -1, 0, 15, 16, 191 and L - 1, with
    and without windows."""
    p = fd._plan(B, G, R, L, D, dtype, 132)
    for pos in (-1, 0, 15, 16, 191, L - 1):
        for window in (None, 1, 16, 100, 3 * p.split):
            lo, hi, per = fd._row_splits(pos, L, window, p.splits)
            n_live = fd._live_runs(lo, hi, per)
            assert 0 <= n_live <= p.splits and (n_live == 0) == (hi < lo)
            for s in range(p.splits):                      # the kernel's cut, block by block
                k0 = lo + s * per
                keys = range(k0, min(hi, k0 + per - 1) + 1)
                assert (len(keys) > 0) == (s < n_live), (pos, window, s)
                assert all(lo <= k <= hi for k in keys)
            covered = [k for s in range(n_live)
                       for k in range(lo + s * per, min(hi, lo + (s + 1) * per - 1) + 1)]
            assert covered == list(range(lo, hi + 1)), (pos, window)


def test_width_512_runs_and_combine_stages():
    """At the heads-of-512 decode flagship (B4 G1 R2 L2048) a block holds 32
    bf16 or 16 fp32 keys, so a row is cut into 64 or 128 runs and combines
    through the workspace; at the request's mean position (191) 12 of them
    are live and one block combines them, at 2047 all, in 4 or 8 groups of
    16 (each folded by its last block, then the groups by the last of
    those, past 32 runs; below width 512 every row is one level); the
    kernel's tickets, a row's and its groups', fit the wrapper's count."""
    for dtype, split, splits in ((torch.bfloat16, 32, 64), (torch.float32, 16, 128)):
        p = fd._plan(4, 1, 2, 2048, 512, dtype, 132)
        assert (p.split, p.splits, p.cluster) == (split, splits, False)
        live = {pos: fd._live_runs(*fd._row_splits(pos, 2048, None, p.splits))
                for pos in (-1, 191, 2047)}
        assert live == {-1: 0, 191: 12, 2047: splits}
        assert fd._combine_groups(live[191], p.cluster, p.width) is None
        groups = fd._combine_groups(live[2047], p.cluster, p.width)
        assert [len(g) for g in groups] == [fd.COMBINE_GROUP] * (splits // 16)
        assert 1 + len(groups) <= 1 + -(-p.splits // fd.COMBINE_GROUP)
    # a ragged last group, and none on the cluster route
    assert [len(g) for g in fd._combine_groups(33, False, 512)] == [16, 16, 1]
    assert [g.start for g in fd._combine_groups(40, False, 512)] == [0, 16, 32]
    assert fd._combine_groups(32, False, 512) is None and fd._combine_groups(64, True, 512) is None
    # heads of 256 and 128 stay one level, at any count
    assert fd._combine_groups(128, False, 256) is None
    assert fd._combine_groups(128, False, 128) is None


@pytest.mark.parametrize("pos", [(191, 2047), (1024, -1), (1100, 16)], ids=["191_2047", "1024_dead",
                                                                           "1100_16"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_split_reference_groups_keep_the_plain_result(pos, bf16):
    """The two-level combine of a row of more than 32 live runs (width 512,
    L 2048: past 32 of its 64 bf16 or 128 fp32 runs; a ragged
    last group at 1024 and 1100) gives what one level over the same runs
    gives, within fp32 summation order, and both agree with the plain
    version under the kernel checks' bound."""
    B, G, R, D, L = 2, 1, 2, 512, 2048
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(x).to(dt) for x in _mats(B, G, R, D, L, 5))
    plan = fd._plan(B, G, R, L, D, dt, 132)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = fd._split_reference(q, k, v, pos_t, None, plan).float()
    flat = fd._split_reference(q, k, v, pos_t, None, dataclasses.replace(plan, cluster=True))
    want = fd.flash_decode_plain(q, k, v, pos_t).float()
    assert any(fd._combine_groups(fd._live_runs(*fd._row_splits(p, L, None, plan.splits)), False,
                                  plan.width) for p in pos)
    if bf16:
        assert torch.allclose(got, flat.float(), rtol=2.0 ** -7, atol=2.0 ** -8)
    else:
        assert torch.allclose(got, flat, rtol=1e-6, atol=1e-7)
    rms = want.pow(2).mean().sqrt()
    assert ((got - want).abs() <= OUT_RTOL * want.abs() + OUT_ATOL_RMS * rms).all()
    for b, p in enumerate(pos):
        if p < 0:
            assert (got[b] == 0).all()


@pytest.mark.parametrize("pos", [(-1, 191), (0, 15), (16, 511)], ids=["dead_and_191", "0_15", "16_511"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_split_reference_at_width_512_matches_the_jax_kernel(pos, bf16):
    """At width 512 (B2 G1 R2 L512: 32 runs of 16 keys a row, the workspace
    combine) the split reference takes only the live runs: against the JAX
    kernel in interpret mode, bf16 under the kernel checks' bound and fp32
    within the summation-order tolerance; a row with no live key gives 0."""
    B, G, R, D, L = 2, 1, 2, 512, 512
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(x).to(dt) for x in _mats(B, G, R, D, L, 11))
    plan = fd._plan(B, G, R, L, D, dt, 132)
    assert (plan.splits, plan.cluster) == (32, False)
    got = fd._split_reference(q, k, v, torch.tensor(pos, dtype=torch.int32), None, plan)
    got = got.float().numpy()
    want = _jax((B, G, R, D, L), pos, None, bf16, 11)
    if bf16:
        rms = np.sqrt(np.mean(want ** 2))
        ratio = np.abs(got - want) / (OUT_RTOL * np.abs(want) + OUT_ATOL_RMS * rms)
        assert ratio.max() <= 1.0, ratio.max()
    else:
        np.testing.assert_allclose(got, want, **TOL_F32)
    for b, p in enumerate(pos):
        if p < 0:
            assert (got[b] == 0).all()


def test_decode_combine_probe_cuts_exactly_the_combine():
    """``benchmarks/decode_combine.py`` times flash-decode beside copies
    whose workspace combine takes a row in one level, and whose combine
    returns at once: each edit finds its line in ``csrc/flash_decode.cuh``
    once and changes only it; without a card the probe exits with a
    message."""
    from kubeflow_tpu_torch.benchmarks import decode_combine
    from kubeflow_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_decode.cuh").read_text()
    for edit, (old, new) in ((decode_combine.one_level, decode_combine.ONE_LEVEL),
                             (decode_combine.without_combine, decode_combine.NO_COMBINE)):
        out = edit(src)
        assert src.count(old) == 1 and out.count(new) == 1
        assert len(out) == len(src) - len(old) + len(new)
    assert f"FOLD_RUNS = {fd.FOLD_RUNS};" in decode_combine.ONE_LEVEL[0]
    assert f"constexpr int GROUP = {fd.COMBINE_GROUP};" in src
    with pytest.raises(RuntimeError, match="no single line"):
        decode_combine.one_level(decode_combine.one_level(src))
    assert decode_combine.main([]) == 1
