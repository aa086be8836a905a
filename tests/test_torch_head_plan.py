"""The fused head backward's launch plan (``ops/fused_head_loss.py`` ``_plan``)
and its zero-padding of E, on the CPU.

The plan decides what the card runs: the route by dtype, the cluster that
splits E, the passes above E 2048, the padded E, the grid and each block's
shared memory, which the CUDA launcher checks against its own layout
(``BwdLayout`` in ``csrc/fused_head_common.cuh``, recomputed here from its
parts). The padding adds zero columns where E is not a multiple of 8: the
plain versions show that it changes no unpadded output. The scratch of a
launch whose row tiles are split between clusters holds one slot a cluster
and block for as many clusters as the launcher may take."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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
