"""The fused head's launch plans (``ops/fused_head_loss.py`` ``_plan`` for the
backward, ``_fwd_plan`` for the forward), the zero-padding of E and the
forward's partition of the vocabulary (``_fwd_split_reference``), on the CPU.

The plan decides what the card runs: the route by dtype, the cluster that
splits E, the passes above E 2048, the padded E, the grid and each block's
shared memory, which the CUDA launcher checks against its own layout
(``BwdLayout`` in ``csrc/fused_head_common.cuh``, recomputed here from its
parts). The padding adds zero columns where E is not a multiple of 8: the
plain versions show that it changes no unpadded output. The scratch of a
launch whose row tiles are split between clusters holds one slot a cluster
and block for as many clusters as the launcher may take.

The forward's plan: 128-token blocks walking ranges of 128-column
vocabulary tiles through a TMA ring, the shared memory part by part as
``fwd_smem_bytes`` in ``csrc/fused_head_fwd.cu`` sums it, ranges that cover
the vocabulary once, about one wave at the MoE flagship. Its partition in
plain PyTorch is held against the plain version and against the Pallas
``_fwd_kernel`` in interpret mode."""
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import fused_head_loss as jfh
from kubeflow_tpu_torch.ops import fused_head_loss as fh

T, V = 8192, 32000

# E -> (cluster, columns a block owns, passes, 64-column slabs a pass,
# resident rows, ring stages, padded E)
BF16_PLANS = {
    1024: (4, 256, 1, 4, 128, 3, 1024),    # the MoE flagship
    768: (3, 256, 1, 4, 128, 3, 768),      # GPT-2 small
    2048: (8, 256, 1, 4, 128, 3, 2048),    # the largest single-pass cluster
    4096: (8, 512, 2, 4, 64, 3, 4096),     # two passes
    8192: (8, 1024, 4, 4, 64, 2, 8192),    # four passes: two stages fit
    256: (1, 256, 1, 4, 128, 3, 256),      # no cluster, no exchange
    128: (1, 128, 1, 2, 128, 3, 128),
    100: (1, 128, 1, 2, 128, 3, 104),      # padded to 104
    40: (1, 64, 1, 1, 128, 3, 40),
}


def _layout_bytes(rows, slabs, passes, stages):
    """BwdLayout<rows / 64, slabs, passes>::bytes, part by part."""
    resident = passes * slabs * rows * 128      # bf16 slabs of 64 columns
    ring = stages * slabs * 64 * 128            # streamed 64-row sub-tiles
    dp = rows * 128                             # the bf16 dP tile
    receive = (rows + 8) * 72 * 4               # fp32 partial logits, C slots, leading dim 72
    vectors = 4 * 128 * 4                       # lse, dlse, dgold, tgt
    barriers = 8 * (3 + 2 * stages)
    return 1024 + resident + ring + dp + receive + vectors + barriers


@pytest.mark.parametrize("E", list(BF16_PLANS))
def test_bf16_plan(E):
    cluster, cols, passes, slabs, rows, stages, e_pad = BF16_PLANS[E]
    p = fh._plan(T, V, E, torch.bfloat16)
    assert p.route == "wgmma"
    assert (p.cluster, p.slice, p.passes, p.slabs, p.rows, p.stages, p.e_pad) == (
        cluster, cols, passes, slabs, rows, stages, e_pad)
    assert p.slice == p.passes * p.slabs * 64
    # the cluster covers E, and its last block owns some of it
    assert (p.cluster - 1) * p.slice < p.e_pad <= p.cluster * p.slice
    assert p.cluster <= 8 and p.e_pad % 8 == 0 and p.e_pad - 8 < E <= p.e_pad
    assert p.grid_dh == (p.cluster * -(-T // rows),)
    assert p.grid_de == (p.cluster * -(-V // rows),)
    assert p.threads == 2 * rows
    assert p.smem_bytes == _layout_bytes(rows, slabs, passes, stages) <= fh.SMEM_LIMIT
    # a third stage is taken wherever it fits
    assert stages == 3 or _layout_bytes(rows, slabs, passes, 3) > fh.SMEM_LIMIT
    # FLOPs a backward kernel does, in units of T V E: the partial logits
    # once a pass and the product once; the bound's 4 up to E 2048
    assert 2 * p.passes + 2 == (4 if E <= 2048 else 2 * E // 2048 + 2)


def test_bf16_plan_at_the_flagship_fits_one_block_an_sm():
    """dh's grid at the MoE flagship: 64 clusters of 4 (256 blocks), dE's 250
    of 4; 222,536 bytes a block, so one block an SM."""
    p = fh._plan(T, V, 1024, torch.bfloat16)
    assert p.grid_dh == (256,) and p.grid_de == (1000,)
    assert p.smem_bytes == 222_536 and 2 * p.smem_bytes > 228 * 1024


def test_fp32_plan_takes_the_scalar_kernels():
    p = fh._plan(1024, 4096, 1024, torch.float32)
    assert (p.route, p.cluster, p.passes, p.e_pad, p.rows, p.stages) == ("scalar", 1, 1, 1024, 64, 1)
    assert p.grid_dh == (16, 8) and p.grid_de == (64, 8) and p.threads == 256
    # [32][68] chunks x 2, [64][68] dlogits, [64][132] slice, 4 x 64 vectors
    assert p.smem_bytes == 4 * (2 * 32 * 68 + 64 * 68 + 64 * 132 + 256) == 69_632
    assert fh._plan(300, 97, 100, torch.float32).e_pad == 100   # no padding


@pytest.mark.parametrize("rows_out, E, dtype, cap", [
    (8192, 1024, torch.bfloat16, 33),     # dh at the flagship: 64 row tiles, a cluster of 4 an SM
    (32000, 1024, torch.bfloat16, 33),    # dE at the flagship: 250 row tiles
    (2560, 1024, torch.bfloat16, 20),     # fewer row tiles than clusters of 4 the SMs hold
    (4096, 128, torch.bfloat16, 32),      # no cluster: a block a row tile
    (128, 1024, torch.bfloat16, 0),       # one row tile: nothing to split
    (8192, 4096, torch.bfloat16, 0),      # passes: one cluster a row tile
    (8192, 1024, torch.float32, 0),       # the scalar kernels
])
def test_scratch_holds_every_cluster_the_launcher_may_take(monkeypatch, rows_out, E, dtype, cap):
    """On a card of 132 SMs: cap = min(row tiles, SMs // cluster), ws one
    slot of [slabs * 32 accumulators][2 * rows threads] fp32 a (cluster,
    block), flags one zero int32 each; none where no row tile is split."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    plan = fh._plan(T, V, E, dtype)
    got, ws, flags = fh._scratch(plan, rows_out, torch.device("cpu"))
    assert got == cap
    if cap == 0:
        assert ws is None and flags is None
        return
    assert ws.dtype == torch.float32
    assert ws.numel() == cap * plan.cluster * (plan.slabs * 32) * (2 * plan.rows)
    assert flags.dtype == torch.int32 and flags.numel() == cap * plan.cluster
    assert not bool(flags.any())


def test_plan_refuses_other_dtypes_and_e_past_the_passes():
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fh._plan(T, V, 1024, torch.float16)
    assert fh._plan(T, V, 8192, torch.bfloat16).passes == 4
    with pytest.raises(ValueError, match="E up to 8192"):
        fh._plan(T, V, 8200, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padding_leaves_the_plain_versions_unchanged(dtype):
    """E 100 padded to 104, as the wrapper pads the kernels' operands: lse,
    gold, dh and dE of the plain versions agree on the unpadded columns to
    summation order (1e-6 of the largest value), and the padded columns of
    dh and dE are exactly 0."""
    rng = np.random.default_rng(11)
    Tn, Vn, En = 96, 70, 100
    h = torch.from_numpy(rng.standard_normal((Tn, En)).astype(np.float32)).to(dtype)
    emb = torch.from_numpy((rng.standard_normal((Vn, En)) * 0.1).astype(np.float32)).to(dtype)
    tgt = torch.from_numpy(rng.integers(0, Vn, (Tn,)))
    tgt[::9] = Vn
    dlse = torch.from_numpy(rng.standard_normal(Tn).astype(np.float32))
    dgold = torch.from_numpy(rng.standard_normal(Tn).astype(np.float32))
    e_pad = fh._plan(Tn, Vn, En, torch.bfloat16).e_pad
    assert e_pad == 104
    hp, ep = fh._pad_e(h, e_pad), fh._pad_e(emb, e_pad)
    assert hp.shape == (Tn, 104) and bool((hp[:, En:] == 0).all())
    assert fh._pad_e(h, En) is h

    lse, gold = fh.lse_gold_plain(h, emb, tgt)
    lse_p, gold_p = fh.lse_gold_plain(hp, ep, tgt)
    dh, de = fh.head_grads_plain(h, emb, tgt, lse, dlse, dgold)
    dh_p, de_p = fh.head_grads_plain(hp, ep, tgt, lse_p, dlse, dgold)
    for got, want in ((lse_p, lse), (gold_p, gold), (dh_p[:, :En], dh), (de_p[:, :En], de)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())
    assert bool((dh_p[:, En:] == 0).all()) and bool((de_p[:, En:] == 0).all())


# ---- the forward's plan (``_fwd_plan``) and its partition of the vocabulary

# (T, V, E): the MoE flagship and the head phase's edge shapes
FWD_SHAPES = [(8192, 32000, 1024), (1024, 32000, 1024), (300, 5000, 1024), (512, 97, 1024),
              (256, 40, 256), (1024, 50257, 1024), (200, 300, 100), (1024, 4096, 128),
              (512, 3000, 768), (384, 2000, 2048), (256, 1500, 4096), (1, 1, 8),
              (1024, 5000, 256), (2048, 3000, 200)]


def _fwd_bytes(stages):
    """``fwd_smem_bytes`` of csrc/fused_head_fwd.cu, part by part."""
    align = 1024
    ring = stages * (128 * 128 * 2 + 128 * 128 * 2)   # 128 rows of h and of emb, 128 bf16 columns
    barriers = stages * 2 * 8                        # full and empty
    return align + ring + barriers


@pytest.mark.parametrize("T,V,E", FWD_SHAPES)
def test_fwd_plan(T, V, E):
    p = fh._fwd_plan(T, V, E, torch.bfloat16, sms=132)
    assert p.route == "wgmma" and (p.rows, p.cols, p.chunk, p.threads) == (128, 128, 128, 288)
    assert p.e_pad % 8 == 0 and p.e_pad - 8 < E <= p.e_pad
    assert (p.token_tiles, p.vocab_tiles) == (-(-T // 128), -(-V // 128))
    # shared memory part by part, as the launcher checks it, within a block's
    # limit; as many stages as fit
    assert (p.align, p.h_stage_bytes, p.emb_stage_bytes, p.barrier_bytes) == (
        1024, 128 * 256, 128 * 256, 16 * p.stages)
    assert p.smem_bytes == _fwd_bytes(p.stages) == (
        p.align + p.stages * (p.h_stage_bytes + p.emb_stage_bytes) + p.barrier_bytes)
    assert p.smem_bytes <= fh.SMEM_LIMIT == 232_448 < _fwd_bytes(p.stages + 1)
    # the ranges cover the vocabulary tiles once each, in order, none empty
    tiles = [p.range_tiles(r) for r in range(p.ranges)]
    assert tiles[0][0] == 0 and tiles[-1][1] == p.vocab_tiles
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(hi > lo for lo, hi in tiles)
    assert 1 <= p.ranges <= min(p.vocab_tiles, 32)
    assert p.grid == (p.token_tiles * p.ranges,)


def test_fwd_plan_at_the_flagship_fills_the_card():
    """T 8192, V 32000, E 1024 on 132 SMs: 64 token tiles and 250 vocabulary
    tiles, cut into 2 ranges of 125 tiles, so 128 blocks run as one wave of
    one block an SM (0.97 of the SMs), three 64 KB stages each. One range
    would leave half the SMs idle; four would take two waves."""
    p = fh._fwd_plan(8192, 32000, 1024, torch.bfloat16, sms=132)
    assert (p.token_tiles, p.vocab_tiles, p.ranges, p.stages) == (64, 250, 2, 3)
    assert p.grid == (128,) and 0.95 * 132 <= p.grid[0] <= 132
    assert p.smem_bytes == 197_680 and 2 * p.smem_bytes > 228 * 1024
    assert [p.range_tiles(r) for r in range(2)] == [(0, 125), (125, 250)]


def _fwd_ring_schedule(nk, ntiles, stages):
    """Replays the consumer warps of ``head_fwd_wgmma`` (``run_tile`` and the
    loop's tail in csrc/fused_head_fwd.cu) on ``ntiles`` tiles of ``nk``
    E chunks, item ``it`` = chunk k of tile j in ring stage ``it % stages``.
    The producer fills item ``it`` once item ``it - stages`` is released, so
    an issue whose item waits for a release still to come is a deadlock.
    Checks that no stage is released before its group of wgmma is waited
    for, that a tile is folded once all its groups are, that an accumulator
    set is folded before the tile after next overwrites it, and returns the
    tiles in the order folded and the most items held at once."""
    issued = done = rel = held = 0
    folded = []

    def issue(it, j):
        nonlocal issued, held
        assert it - stages < rel, f"item {it} waits for item {it - stages}'s release"
        assert it % nk or j < 2 or j - 2 in folded, f"tile {j} overwrites tile {j - 2}"
        issued += 1
        held = max(held, issued - rel)

    def wait(n):                      # wgmma_wait<n>
        nonlocal done
        done = max(done, issued - n)

    def release_upto(upto):
        nonlocal rel
        assert upto <= done, f"item {upto - 1} released while its wgmma may run"
        rel = max(rel, upto)

    def fold(j):
        assert (j + 1) * nk <= done and j not in folded
        folded.append(j)

    it = 0
    for j in range(ntiles):
        for k in range(nk):
            issue(it, j)
            if j > 0 and k == min(1, nk - 1):
                last = k == nk - 1
                wait(1 if last else 2)
                release_upto(it if last else it - 1)
                fold(j - 1)
            elif k > 0 or j == 0:
                wait(1)
                release_upto(it)
            it += 1
    wait(0)
    if ntiles:
        release_upto(ntiles * nk)
        fold(ntiles - 1)
    assert rel == ntiles * nk
    return folded, held


@pytest.mark.parametrize("nk", [1, 2, 3, 4, 5, 8, 16, 32, 64])
def test_fwd_ring_schedule_never_waits_on_itself(nk):
    """Every chunk count the forward meets (E up to 8192 in 128-column
    chunks) over ranges of up to nine tiles: the three-stage ring never
    deadlocks (two chunks a tile once held four items over three stages),
    every tile is folded once, in order, from finished accumulators."""
    for ntiles in range(10):
        folded, held = _fwd_ring_schedule(nk, ntiles, 3)
        assert folded == list(range(ntiles))
        assert held <= 3


def test_two_chunk_shapes_walk_ranges_of_three_tiles():
    """The head phase's E 256 and E 200 cases (chip_smoke.py) give the forward
    two E chunks a tile and ranges of three vocabulary tiles, the schedule
    that once deadlocked."""
    for T, V, E in ((1024, 5000, 256), (2048, 3000, 200)):
        p = fh._fwd_plan(T, V, E, torch.bfloat16, sms=132)
        assert -(-p.e_pad // p.chunk) == 2
        assert max(hi - lo for lo, hi in map(p.range_tiles, range(p.ranges))) == 3


def test_fwd_plan_fp32_takes_the_scalar_kernel_and_refuses_float16():
    p = fh._fwd_plan(300, 97, 100, torch.float32)
    assert (p.route, p.rows, p.ranges, p.e_pad, p.grid, p.smem_bytes) == (
        "scalar", 64, 1, 100, (5,), 0)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fh._fwd_plan(300, 97, 100, torch.float16)


def _fwd_case(T, V, E, seed, dtype):
    """h, emb, tgt as the head phase draws them (logits ~ N(0, 1)), with
    targets in the last vocabulary tile and outside [0, V)."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(dtype)
    emb = torch.from_numpy((rng.standard_normal((V, E)) / E ** 0.5).astype(np.float32)).to(dtype)
    tgt = torch.from_numpy(rng.integers(0, V, (T,)).astype(np.int32))
    tgt[::7] = V - 1
    tgt[1::11], tgt[2::13] = V, -1
    return h, emb, tgt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,V,E,ranges", [
    (256, 1000, 64, None),      # the plan's own ranges
    (128, 1000, 64, 3),         # ranges of 2 and 3 tiles, the last tile partial
    (128, 300, 32, 4),          # more ranges than tiles: the fourth holds none
    (128, 300, 32, 7),
])
def test_fwd_split_reference_matches_the_plain_version(T, V, E, ranges, dtype):
    """The forward's partition (per-range max, sum and gold, combined in
    range order, empty ranges adding nothing) against ``lse_gold_plain``:
    fp32 logits from the same operands, so the two differ in summation order
    only (lse 2e-6 absolute at |lse| ~ 7), gold exactly where the target
    lies inside [0, V) and 0 outside."""
    import dataclasses

    h, emb, tgt = _fwd_case(T, V, E, 9, dtype)
    plan = fh._fwd_plan(T, V, E, torch.bfloat16)
    if ranges is not None:
        plan = dataclasses.replace(plan, ranges=ranges)
    lse, gold = fh._fwd_split_reference(h, emb, tgt, plan)
    lse_p, gold_p = fh.lse_gold_plain(h, emb, tgt)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=2e-6)
    torch.testing.assert_close(gold, gold_p, rtol=0, atol=1e-6)
    outside = (tgt < 0) | (tgt >= V)
    assert bool((gold[outside] == 0).all())


@functools.cache
def _jax_fwd(T, V, E, dtype_name, bv):
    """lse and gold of the Pallas ``_fwd_kernel`` in interpret mode, 128-row
    token blocks, ``bv``-column vocabulary blocks."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    h, emb, tgt = _fwd_case(T, V, E, 10, dtype)
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    lse, gold = jfh._fwd_call(jnp.asarray(h.float().numpy()).astype(jd),
                              jnp.asarray(emb.float().numpy()).astype(jd),
                              jfh._lanes(jnp.asarray(tgt.numpy())).astype(jnp.int32),
                              bt=128, bv=bv, interpret=True)
    return np.asarray(lse), np.asarray(gold)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,V,E,bv,ranges", [
    (256, 768, 128, 256, 2),    # the JAX kernel's 256-column blocks, the port's 128-column tiles
    (128, 640, 64, 128, 3),
    (128, 384, 64, 384, 4),     # the fourth range past V
])
def test_fwd_split_reference_matches_the_pallas_kernel(T, V, E, bv, ranges, dtype):
    """The forward's partition against the TPU kernel it replaces, run as
    the JAX package's tests run it: both fold fp32 logits of the same
    operands (bf16 products are exact in fp32), so lse and gold differ in
    summation order only (2e-6 absolute). Targets outside [0, V) give the JAX
    kernel no gold either."""
    import dataclasses

    lse_j, gold_j = _jax_fwd(T, V, E, str(dtype)[6:], bv)
    h, emb, tgt = _fwd_case(T, V, E, 10, dtype)
    plan = dataclasses.replace(fh._fwd_plan(T, V, E, torch.bfloat16), ranges=ranges)
    lse, gold = fh._fwd_split_reference(h, emb, tgt, plan)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(gold.numpy(), gold_j, rtol=0, atol=2e-6)
