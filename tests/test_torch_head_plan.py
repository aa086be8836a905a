"""The fused head's launch plans (``ops/fused_head_loss.py`` ``_plan`` for the
backward, ``_fwd_plan`` for the forward), the zero-padding of E and the
forward's partition of the vocabulary (``_fwd_split_reference``), on the CPU.

The plan decides what the card runs: the route by dtype, the cluster that
splits E, the passes above E 2048 (bf16), the padded E, the grid and each block's
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
``_fwd_kernel`` in interpret mode.

The fp32 route's plan (``_fma_plan``): E padded to a multiple of 4, cut
into 128-column slices a block, one pass up to E 1024 and passes above
with no limit on E, each block's shared memory part by part as ``Layout``
in ``csrc/fused_head_fma.cuh`` sums it. The backward's partition in plain
PyTorch (``_bwd_split_reference``: partial logits per slice summed in block
order, unrounded fp32 dlogits, per-slice products) is held against the
plain version at ragged shapes and against the Pallas ``_dh_kernel`` and
``_de_kernel`` in interpret mode."""
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


# E -> (cluster, columns a block owns, passes, rows a row tile, ring stages,
# padded E) of the fp32 route
FP32_PLANS = {
    40: (1, 128, 1, 128, 3, 40),        # no cluster, no exchange
    99: (1, 128, 1, 128, 3, 100),       # padded to 100
    100: (1, 128, 1, 128, 3, 100),
    128: (1, 128, 1, 128, 3, 128),
    768: (6, 128, 1, 128, 3, 768),      # GPT-2 small: a cluster of 6
    1024: (8, 128, 1, 128, 3, 1024),    # the MoE flagship: the widest single pass
    2048: (8, 256, 2, 64, 3, 2048),     # two passes
    4096: (8, 512, 4, 64, 3, 4096),
    8192: (8, 1024, 8, 64, 3, 8192),
    8200: (8, 1152, 9, 64, 3, 8200),    # past the bf16 route's limit: nine passes
}


def _fma_layout_bytes(rows, cluster, stages):
    """Layout(rows, cluster).bytes of csrc/fused_head_fma.cuh, part by part."""
    one = rows == 128
    resident = rows * 128 * 4 if one else 0           # fp32 [rows][128], one pass only
    stage = (0 if one else rows * 128 * 4) + 64 * 128 * 4   # passes: the row tile too
    dp = rows * 64 * 4                                # the fp32 dP tile
    receive = cluster * -(-rows // cluster) * 64 * 4  # C slots of ceil(rows / C) rows
    barriers = 8 * (3 + 2 * stages)
    return 1024 + resident + stages * stage + dp + receive + barriers


@pytest.mark.parametrize("E", list(FP32_PLANS))
def test_fp32_plan(E):
    """The fp32 route: E padded to a multiple of 4 and split across a
    cluster of 128-column blocks, every slice computed by one block only;
    one pass (the logits once: 4 T V E FLOP) up to E 1024, passes that
    recompute them above, no E refused."""
    cluster, cols, passes, rows, stages, e_pad = FP32_PLANS[E]
    p = fh._plan(T, V, E, torch.float32)
    assert p.route == "fma"
    assert (p.cluster, p.slice, p.passes, p.rows, p.stages, p.e_pad) == (
        cluster, cols, passes, rows, stages, e_pad)
    assert p.slice == p.passes * 128 and p.slabs == 4 and p.threads == 256
    # the cluster covers E once: its last block owns some of it, none
    # recomputes another's slice
    assert (p.cluster - 1) * p.slice < p.e_pad <= p.cluster * p.slice
    assert p.cluster <= 8 and p.e_pad % 4 == 0 and p.e_pad - 4 < E <= p.e_pad
    assert p.grid_dh == (p.cluster * -(-T // rows),)
    assert p.grid_de == (p.cluster * -(-V // rows),)
    assert p.smem_bytes == _fma_layout_bytes(rows, cluster, stages) <= fh.SMEM_LIMIT
    assert stages == 3 or _fma_layout_bytes(rows, cluster, 3) > fh.SMEM_LIMIT
    # FLOPs a kernel does, in units of T V E: the partial logits once a pass
    # and the product once
    assert 2 * p.passes + 2 == (4 if E <= 1024 else 2 * -(-e_pad // 1024) + 2)


def test_fp32_plan_at_the_flagship_computes_the_logits_once():
    """T 8192, V 32000, E 1024: one pass over clusters of 8 blocks of 128
    columns, 128 resident rows, three stages in 230,472 bytes."""
    p = fh._plan(T, V, 1024, torch.float32)
    assert (p.route, p.cluster, p.passes, p.slice) == ("fma", 8, 1, 128)
    assert p.grid_dh == (8 * 64,) and p.grid_de == (8 * 250,)
    assert p.smem_bytes == 230_472 and 2 * p.smem_bytes > 228 * 1024
    assert fh._plan(300, 97, 100, torch.float32).e_pad == 100   # no padding


@pytest.mark.parametrize("rows_out, E, dtype, cap", [
    (8192, 1024, torch.bfloat16, 33),     # dh at the flagship: 64 row tiles, a cluster of 4 an SM
    (32000, 1024, torch.bfloat16, 33),    # dE at the flagship: 250 row tiles
    (2560, 1024, torch.bfloat16, 20),     # fewer row tiles than clusters of 4 the SMs hold
    (4096, 128, torch.bfloat16, 32),      # no cluster: a block a row tile
    (128, 1024, torch.bfloat16, 0),       # one row tile: nothing to split
    (8192, 4096, torch.bfloat16, 0),      # passes: one cluster a row tile
    (8192, 1024, torch.float32, 16),      # fp32 dh at the flagship: clusters of 8
    (32000, 1024, torch.float32, 16),     # fp32 dE at the flagship
    (32000, 100, torch.float32, 132),     # fp32, no cluster: a block an SM
    (8192, 2048, torch.float32, 0),       # fp32 passes
])
def test_scratch_holds_every_cluster_the_launcher_may_take(monkeypatch, rows_out, E, dtype, cap):
    """On a card of 132 SMs: cap = min(row tiles, SMs // cluster), ws one
    slot of [accumulators a thread][threads] fp32 a (cluster, block), a
    block's [rows, slice] accumulators (bf16: slabs * 32 a thread, 2 * rows
    threads; fp32: 64 a thread at 128 rows, 256 threads), flags one zero
    int32 each; none where no row tile is split."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    plan = fh._plan(T, V, E, dtype)
    got, ws, flags = fh._scratch(plan, rows_out, torch.device("cpu"))
    assert got == cap
    if cap == 0:
        assert ws is None and flags is None
        return
    assert ws.dtype == torch.float32
    per_thread = plan.slabs * 32 if dtype == torch.bfloat16 else plan.rows * plan.slice // 256
    assert plan.threads * per_thread == plan.rows * plan.slice
    assert ws.numel() == cap * plan.cluster * per_thread * plan.threads
    assert flags.dtype == torch.int32 and flags.numel() == cap * plan.cluster
    assert not bool(flags.any())


def test_plan_refuses_other_dtypes_and_e_past_the_passes():
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fh._plan(T, V, 1024, torch.float16)
    assert fh._plan(T, V, 8192, torch.bfloat16).passes == 4
    with pytest.raises(ValueError, match="E up to 8192"):
        fh._plan(T, V, 8200, torch.bfloat16)


@pytest.mark.parametrize("dtype,En,plan_dtype,e_pad", [
    pytest.param(torch.float32, 100, torch.bfloat16, 104, id="dtype0"),
    pytest.param(torch.bfloat16, 100, torch.bfloat16, 104, id="dtype1"),
    pytest.param(torch.float32, 99, torch.float32, 100, id="fp32-e99"),
])
def test_zero_padding_leaves_the_plain_versions_unchanged(dtype, En, plan_dtype, e_pad):
    """E 100 padded to 104 (the bf16 route's multiple of 8) and E 99 to 100
    (the fp32 route's multiple of 4), as the wrapper pads the kernels'
    operands: lse, gold, dh and dE of the plain versions agree on the
    unpadded columns to summation order (1e-6 of the largest value), and the
    padded columns of dh and dE are exactly 0."""
    rng = np.random.default_rng(11)
    Tn, Vn = 96, 70
    h = torch.from_numpy(rng.standard_normal((Tn, En)).astype(np.float32)).to(dtype)
    emb = torch.from_numpy((rng.standard_normal((Vn, En)) * 0.1).astype(np.float32)).to(dtype)
    tgt = torch.from_numpy(rng.integers(0, Vn, (Tn,)))
    tgt[::9] = Vn
    dlse = torch.from_numpy(rng.standard_normal(Tn).astype(np.float32))
    dgold = torch.from_numpy(rng.standard_normal(Tn).astype(np.float32))
    assert fh._plan(Tn, Vn, En, plan_dtype).e_pad == e_pad
    hp, ep = fh._pad_e(h, e_pad), fh._pad_e(emb, e_pad)
    assert hp.shape == (Tn, e_pad) and bool((hp[:, En:] == 0).all())
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


@pytest.mark.parametrize("T,V,E,e_pad,ranges", [
    (300, 97, 100, 100, 1),         # one vocabulary tile: one range
    (200, 300, 99, 100, 3),         # E padded to a multiple of 4; a tile a range
    (8192, 32000, 1024, 1024, 2),   # the MoE flagship: 64 token tiles x 2 ranges, one wave
    (512, 4096, 2048, 2048, 32),
    (256, 1000, 8200, 8200, 8),     # past the bf16 backward's E 8192
])
def test_fwd_plan_fp32_takes_the_fma_kernel_and_refuses_float16(T, V, E, e_pad, ranges):
    """fp32 takes ``head_fwd_fma``: 128-token blocks over 128-column tiles,
    the bf16 route's range cut, three ring stages of 64 fp32 columns, E padded
    to a multiple of 4 (TMA's 16-byte rows), 256 threads; its shared memory
    part by part as ``fwd32::smem_bytes`` sums it, within the card's limit."""
    p = fh._fwd_plan(T, V, E, torch.float32, sms=132)
    ntt = -(-T // 128)
    assert (p.route, p.rows, p.cols, p.chunk, p.stages, p.e_pad, p.ranges, p.threads) == (
        "fma", 128, 128, 64, 3, e_pad, ranges, 256)
    assert p.grid == (ntt * ranges,) and p.token_tiles == ntt and p.vocab_tiles == -(-V // 128)
    assert (p.h_stage_bytes, p.emb_stage_bytes, p.barrier_bytes) == (128 * 64 * 4, 128 * 64 * 4,
                                                                      16 * 3)
    assert p.smem_bytes == (p.align + p.stages * (p.h_stage_bytes + p.emb_stage_bytes)
                            + p.barrier_bytes) == 197_680 <= fh.SMEM_LIMIT
    # the ranges cover the vocabulary tiles once, none empty
    tiles = [t for r in range(p.ranges) for t in range(*p.range_tiles(r))]
    assert tiles == list(range(p.vocab_tiles)) and all(
        hi > lo for lo, hi in map(p.range_tiles, range(p.ranges)))
    # the same cut as the bf16 route's at the same shape
    assert p.ranges == fh._fwd_plan(T, V, E, torch.bfloat16, sms=132).ranges
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fh._fwd_plan(T, V, E, torch.float16)


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
    (200, 300, 99, None),       # ragged T and E: the fp32 plan's 3 ranges, E padded to 100
    (300, 97, 100, None),       # one tile: one range
])
def test_fwd_split_reference_matches_the_plain_version(T, V, E, ranges, dtype):
    """The forward's partition (per-range max, sum and gold, combined in
    range order, empty ranges adding nothing) at each dtype's own plan
    against ``lse_gold_plain``: fp32 logits from the same operands, so the
    two differ in summation order only (lse 2e-6 absolute at |lse| ~ 7),
    gold exactly where the target lies inside [0, V) and 0 outside."""
    import dataclasses

    h, emb, tgt = _fwd_case(T, V, E, 9, dtype)
    plan = fh._fwd_plan(T, V, E, dtype)
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
    (256, 768, 100, 256, None),  # the plan's own 6 ranges, E not a multiple of 8
])
def test_fwd_split_reference_matches_the_pallas_kernel(T, V, E, bv, ranges, dtype):
    """The forward's partition at each dtype's plan against the TPU kernel
    it replaces, run as the JAX package's tests run it: both fold fp32
    logits of the same operands (bf16 products are exact in fp32), so lse
    and gold differ in summation order only (2e-6 absolute). Targets outside
    [0, V) give the JAX kernel no gold either."""
    import dataclasses

    lse_j, gold_j = _jax_fwd(T, V, E, str(dtype)[6:], bv)
    h, emb, tgt = _fwd_case(T, V, E, 10, dtype)
    plan = fh._fwd_plan(T, V, E, dtype)
    if ranges is not None:
        plan = dataclasses.replace(plan, ranges=ranges)
    lse, gold = fh._fwd_split_reference(h, emb, tgt, plan)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(gold.numpy(), gold_j, rtol=0, atol=2e-6)


# ---- the backward's partition of E (``_bwd_split_reference``)


def _bwd_case(T, V, E, seed):
    """fp32 h, emb and targets as ``_fwd_case`` draws them (targets in the
    last vocabulary tile and outside [0, V)), the plain forward's lse and
    random cotangents."""
    h, emb, tgt = _fwd_case(T, V, E, seed, torch.float32)
    rng = np.random.default_rng(seed + 1)
    dlse = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    dgold = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    lse, _ = fh.lse_gold_plain(h, emb, tgt)
    return h, emb, tgt, lse, dlse, dgold


@pytest.mark.parametrize("E", [100, 99, 300, 1100])
def test_bwd_split_reference_matches_the_plain_version(E):
    """fp32 at T 300, V 97 (ragged, targets outside [0, V)): one slice
    (E 100, and E 99 padded to 100), a cluster of 3 (E 300) and two passes
    over a cluster of 5 (E 1100). The partition's logits differ from the
    plain version's in summation order only, so dh and dE agree to 2e-6 of
    their largest value; a target outside [0, V) adds no one-hot term."""
    h, emb, tgt, lse, dlse, dgold = _bwd_case(300, 97, E, 12)
    plan = fh._plan(300, 97, E, torch.float32)
    assert plan.cluster == {100: 1, 99: 1, 300: 3, 1100: 5}[E]
    dh, de = fh._bwd_split_reference(h, emb, tgt, lse, dlse, dgold, plan)
    dh_p, de_p = fh.head_grads_plain(h, emb, tgt, lse, dlse, dgold)
    assert dh.shape == (300, E) and de.shape == (97, E)
    torch.testing.assert_close(dh, dh_p, rtol=0, atol=2e-6 * dh_p.abs().max().item())
    torch.testing.assert_close(de, de_p, rtol=0, atol=2e-6 * de_p.abs().max().item())


@functools.cache
def _jax_bwd(T, V, E, bt, bv):
    """dh and dE of the Pallas ``_dh_kernel`` and ``_de_kernel`` in
    interpret mode on fp32 operands."""
    h, emb, tgt, lse, dlse, dgold = _bwd_case(T, V, E, 13)
    lanes = [jfh._lanes(jnp.asarray(x.numpy())) for x in (tgt, lse, dlse, dgold)]
    dh, de = jfh._bwd_call(jnp.asarray(h.numpy()), jnp.asarray(emb.numpy()),
                           lanes[0].astype(jnp.int32), *lanes[1:], bt=bt, bv_dh=bv, bv_de=bv,
                           interpret=True)
    return np.asarray(dh), np.asarray(de)


@pytest.mark.parametrize("T,V,E,bt,bv", [
    (256, 384, 100, 128, 128),    # one slice
    (256, 384, 300, 128, 128),    # a cluster of 3
    (128, 256, 1100, 128, 256),   # two passes over a cluster of 5
])
def test_bwd_split_reference_matches_the_pallas_kernels(T, V, E, bt, bv):
    """The fp32 backward's partition against the TPU kernels it replaces,
    run as the JAX package's tests run them: both multiply fp32 operands in
    fp32 and leave the dlogits unrounded, so dh and dE differ in summation
    order only (5e-6 of their largest value). Targets outside [0, V) add no
    one-hot term to either."""
    dh_j, de_j = _jax_bwd(T, V, E, bt, bv)
    h, emb, tgt, lse, dlse, dgold = _bwd_case(T, V, E, 13)
    plan = fh._plan(T, V, E, torch.float32)
    dh, de = fh._bwd_split_reference(h, emb, tgt, lse, dlse, dgold, plan)
    np.testing.assert_allclose(dh.numpy(), dh_j, rtol=0, atol=5e-6 * np.abs(dh_j).max())
    np.testing.assert_allclose(de.numpy(), de_j, rtol=0, atol=5e-6 * np.abs(de_j).max())
