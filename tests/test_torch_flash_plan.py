"""The flash kernels' launch plan (route, tile rows, grid, threads, shared
memory), the fp32 plain path against the JAX kernels in fp32 (interpret
mode) at the shapes of the new kernels' edge cases, and the stated refusal
of other head sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas_attention import _flash_forward as _jax_flash_forward
from kubeflow_tpu.ops.pallas_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import pallas_attention as pa

SERVING = (4, 128, 128, 8, 4)     # B, Sq, Sk, H, KV: the decode flagship's prefill
TRAINING = (4, 2048, 2048, 8, 8)  # the training flagship
# fp32 on both sides: summation order only (as tests/test_torch_flash_backward.py)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [SERVING, TRAINING], ids=["serving", "training"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("D", [64, 128, 256, 512])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_plan_route_tiles_grid_and_shared_memory(kernel, D, dtype, shape):
    B, Sq, Sk, H, KV = shape
    plan = pa._plan(kernel, B, Sq, Sk, H, KV, D, dtype)
    assert 0 < plan.smem_bytes <= pa.SMEM_LIMIT and plan.width == D
    # width 512: dq and dk/dv a pair on both routes, the forward on fp32's
    assert plan.cluster == (2 if D == 512 and (kernel != "fwd" or dtype == torch.float32)
                            else 1)
    if dtype == torch.bfloat16 and D == 512:
        # width 512: 256 threads; the forward 64-row tiles, two warpgroups
        # each owning half of O's columns; dq (64 query rows) and dk/dv (64
        # keys) the width-256 launch on each column half, a cluster of two
        # blocks along the grid's last axis
        assert (plan.route, plan.block, plan.threads) == ("wgmma", 64, 256)
        assert plan.cluster == (1 if kernel == "fwd" else 2)
        assert plan.grid == ((KV, B, 2 * -(-Sk // 64)) if kernel == "dkv" else
                             (H, B, plan.cluster * -(-Sq // 64)))
    elif dtype == torch.bfloat16 and D == 256:
        # width 256: one consumer warpgroup of 64 rows beside the producer
        # at every shape (two would not fit beside it); dk/dv: 64 keys a
        # block, two warpgroups owning dV and dK
        assert (plan.route, plan.block, plan.threads) == ("wgmma", 64, 256)
        assert plan.grid == ((KV, B, -(-Sk // 64)) if kernel == "dkv" else (H, B, -(-Sq // 64)))
    elif dtype == torch.bfloat16 and D <= 128:
        # 128-row tiles (128 keys for dk/dv) at the training shape (512
        # blocks for 132 SMs); the serving prefill would get 32 (16 for
        # dk/dv), so it takes 64 (64 and 32 blocks)
        rows = 128 if shape == TRAINING else 64
        # a producer warpgroup beside the consumers; dk/dv's thread 0 produces
        consumers = 128 * (rows // 64)
        threads = consumers if kernel == "dkv" else consumers + 128
        assert (plan.route, plan.block, plan.threads) == ("wgmma", rows, threads)
        assert plan.grid == ((KV, B, Sk // rows) if kernel == "dkv" else (H, B, Sq // rows))
    elif kernel == "fwd":
        # fp32 forward: register-tiled FMAs, 128 query rows (64 from width
        # 256 on, with 32-key tiles) at every shape, 256 threads; at 512 the
        # width-256 kernel on each column half, a cluster of two blocks
        # along the grid's last axis
        rows = 128 if D <= 128 else 64
        assert (plan.route, plan.block, plan.threads) == ("fma", rows, 256)
        assert plan.grid == (H, B, plan.cluster * -(-Sq // rows))
        assert plan.smem_bytes == pa._fma_fwd_bytes(D)
    else:
        # fp32 dq and dk/dv: register-tiled FMAs, 256 threads, the bf16
        # route's grids; dq 64 query rows (64-key tiles), dk/dv 64 keys
        # (64-row tiles) up to width 128, 32 and 32 from 256 on, at every
        # shape; at 512 the width-256 kernels on each column half, a cluster
        # of two blocks along the grid's last axis
        block = 64 if D <= 128 else 32
        assert (plan.route, plan.block, plan.threads) == ("fma", block, 256)
        assert plan.grid == ((KV, B, plan.cluster * Sk // block) if kernel == "dkv" else
                             (H, B, plan.cluster * Sq // block))
        assert plan.smem_bytes == pa._fma_bwd_bytes(kernel, D)


@pytest.mark.parametrize("kernel,dtype,shape,want", [
    # the launchers check these against the kernels' own layouts
    ("fwd", torch.bfloat16, TRAINING, 99_368),    # Q 32 KiB + 2 x (K, V) 16 KiB + slack, barriers
    ("fwd", torch.bfloat16, SERVING, 82_984),
    ("dq", torch.bfloat16, TRAINING, 132_648),    # + dO 32 KiB + delta
    ("dq", torch.bfloat16, SERVING, 99_624),
    # the fp32 forward: Q 64 KiB + 2 x (K, V) 64 KiB + P 32 KiB + slack, barriers
    ("fwd", torch.float32, TRAINING, 230_440),
    ("fwd", torch.float32, SERVING, 230_440),
    # fp32 dq: Q and dO 64 KiB + 2 x (K, V) 128 KiB + dS 16 KiB + slack, barriers
    ("dq", torch.float32, TRAINING, 214_056),
    ("dq", torch.float32, SERVING, 214_056),
    # K + V 64 KiB resident + 2 x (Q, dO, O) 96 KiB + two delta/lse rows a
    # consumer 2 KiB + slack, barriers
    ("dkv", torch.bfloat16, TRAINING, 166_952),
    ("dkv", torch.bfloat16, SERVING, 133_160),    # 64 keys: K + V 32 KiB, one consumer
    # fp32 dk/dv: K and V 64 KiB + 2 x (Q, dO) 128 KiB + P^T and dS^T 32 KiB
    # + a delta row a stage + slack, seven barriers
    ("dkv", torch.float32, TRAINING, 230_968),
    ("dkv", torch.float32, SERVING, 230_968),
])
def test_plan_shared_memory_bytes_at_d128(kernel, dtype, shape, want):
    assert pa._plan(kernel, *shape, 128, dtype).smem_bytes == want


@pytest.mark.parametrize("kernel,shape,want", [
    # Q 32 KiB + 2 x (K, V) 64 KiB at four slabs + slack, barriers
    ("fwd", TRAINING, 164_904),
    ("fwd", SERVING, 164_904),
    ("dq", TRAINING, 197_928),    # + dO 32 KiB + delta
    ("dq", SERVING, 197_928),
    # K + V 64 KiB resident + 2 x (Q, dO, O) of 48 rows 144 KiB + the fp32
    # P^T slot 12 KiB + two delta rows + slack, seven barriers
    ("dkv", TRAINING, 226_744),
    ("dkv", SERVING, 226_744),
])
def test_plan_shared_memory_bytes_at_d256(kernel, shape, want):
    plan = pa._plan(kernel, *shape, 256, torch.bfloat16)
    assert plan.smem_bytes == want == pa._wgmma_sums(kernel, 64, 256)[0]
    assert want <= pa.SMEM_LIMIT


@pytest.mark.parametrize("kernel,dtype,parts", [
    # each kernel's layout at width 512, part by part as its Layout lays it
    # out (FwdHalvesLayout, DqLayout<512, 1, 2>, DkvPairLayout<512, 2>;
    # fwd32::Layout, dq32::Layout, dkv32::Layout), alignment slack and
    # barriers included: Q 64 KiB + 2 x (K, V) of 32 keys at eight slabs
    ("fwd", torch.bfloat16, dict(q=65_536, ring=2 * 2 * 8 * 32 * 128, barriers=8 * 5)),
    # a block of the pair, its 256 columns: Q and dO 64 KiB + 2 x (K, V) of
    # 64 keys + delta + the receive slot of the other block's S and dP [64,
    # 64] fp32 + five barriers and the slot's two
    ("dq", torch.bfloat16, dict(q_do=65_536, ring=2 * 2 * 4 * 64 * 128, delta=256,
                                rx=2 * 64 * 64 * 4, barriers=8 * 5 + 8 * 2)),
    # a block of the pair, its 256 columns: K + V 64 KiB resident + 2 x (Q,
    # dO) of 48 rows + one O tile + the fp32 P^T slot [64 keys, 48 rows] +
    # two delta rows + the receive slots of the other block's S^T and dP^T
    # [64, 48] fp32 and its delta row + seven barriers and five more
    ("dkv", torch.bfloat16, dict(kv=65_536, ring=2 * 2 * 4 * 48 * 128, o=4 * 48 * 128,
                                 slot=64 * 48 * 4, delta=2 * 48 * 4,
                                 rx=2 * 64 * 48 * 4 + 48 * 4, barriers=8 * 7 + 8 * 5)),
    # fp32 forward, a block of the pair, its 256 columns (eight 32-column
    # slabs): Q of 64 rows + 2 x (K, V) of 32 keys + P [64, 32] + the
    # receive slot of the other block's partial S (256 threads, 8 fp32
    # each) + three barriers a stage and Q's, and the slot's two
    ("fwd", torch.float32, dict(q=8 * 64 * 128, ring=2 * 2 * 8 * 32 * 128, p=64 * 32 * 4,
                                rx=256 * 8 * 4, barriers=8 * 5 + 8 * 2)),
    # fp32 dq, a block of the pair, its 256 columns (eight 32-column slabs):
    # Q and dO of 32 rows + 2 x (K, V) of 32 keys + dS [32, 32] + the
    # receive slot of the other block's S and dP (256 threads, 8 fp32 each)
    # + five barriers and the slot's two
    ("dq", torch.float32, dict(q_do=2 * 8 * 32 * 128, ring=2 * 2 * 8 * 32 * 128,
                               ds=32 * 32 * 4, rx=256 * 8 * 4, barriers=8 * 5 + 8 * 2)),
    # fp32 dk/dv, a block of the pair: K and V of 32 keys + 2 x (Q, dO) of
    # 32 rows + P^T and dS^T [32, 32] + a delta row a stage + each
    # warpgroup's receive slot of the other block's S^T or dP^T (128
    # threads, 8 fp32 each) and its partial delta row + seven barriers and
    # each warpgroup's two
    ("dkv", torch.float32, dict(kv=2 * 8 * 32 * 128, ring=2 * 2 * 8 * 32 * 128,
                                exchange=2 * 32 * 32 * 4, delta=2 * 32 * 4,
                                rx=2 * 128 * 8 * 4 + 32 * 4, barriers=8 * 7 + 8 * 4)),
])
def test_plan_shared_memory_bytes_at_d512(kernel, dtype, parts):
    want = 1024 + sum(parts.values())
    for shape in (SERVING, TRAINING, (4, 2048, 2048, 2, 2), (1, 200, 200, 2, 1)):
        plan = pa._plan(kernel, *shape, 512, dtype)
        assert plan.smem_bytes == want <= pa.SMEM_LIMIT and plan.width == 512
    if dtype == torch.bfloat16:
        smem, regs = pa._wgmma_sums(kernel, 64, 512)
        # a warpgroup's 256 columns of O, dQ, dV or dK (128 fp32) beside its
        # score tiles (the forward's S, dq's S and dP, dk/dv's S^T or dP^T)
        # leave room for addresses and the softmax's state in the 255
        # registers a thread may hold (ptxas gave 170, 254 and 235)
        assert smem == want and regs == 128 + {"fwd": 16, "dq": 64, "dkv": 24}[kernel]
        assert regs + 48 <= pa._REGS_MAX
    else:
        assert want == (pa._fma_fwd_bytes(512) if kernel == "fwd" else
                        pa._fma_bwd_bytes(kernel, 512))


def test_plan_ragged_and_small_grids():
    # a ragged last tile still gets a block; 128 rows only where the blocks fill the SMs
    assert pa._plan("fwd", 2, 200, 200, 8, 4, 128, torch.bfloat16).grid == (8, 2, 4)
    assert pa._plan("fwd", 9, 200, 200, 8, 4, 128, torch.bfloat16).grid == (8, 9, 2)
    assert pa._plan("dq", 1, 16, 8, 4, 2, 64, torch.bfloat16).grid == (4, 1, 1)
    assert pa._plan("dkv", 2, 64, 192, 4, 2, 128, torch.float32).grid == (2, 2, 3)
    assert pa._plan("dq", 9, 200, 200, 8, 4, 128, torch.float32).grid == (8, 9, 4)
    assert pa._plan("dkv", 2, 200, 200, 4, 4, 256, torch.float32).grid == (4, 2, 7)
    # dk/dv: 128 keys where B * KV * ceil(Sk / 128) fills the SMs (the GQA 8/2 case at S 2048)
    assert pa._plan("dkv", 8, 2048, 2048, 8, 2, 64, torch.bfloat16).grid == (2, 8, 16)
    assert pa._plan("dkv", 4, 2048, 2048, 8, 2, 64, torch.bfloat16).grid == (2, 4, 32)
    assert pa._plan("dkv", 9, 200, 200, 8, 4, 128, torch.bfloat16).grid == (4, 9, 4)
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 128, torch.bfloat16, sms=64).block == 128
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 128, torch.bfloat16, sms=132).block == 64
    # width 256 keeps 64-row tiles where 128 would fill the SMs, ragged tiles included
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 256, torch.bfloat16, sms=64).block == 64
    assert pa._plan("dq", 3, 200, 200, 4, 2, 256, torch.bfloat16).grid == (4, 3, 4)
    # width 512: 64-row tiles always; dq and dk/dv a cluster of two blocks
    # (one a column half) a query tile or key block
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 512, torch.bfloat16, sms=64).block == 64
    assert pa._plan("dkv", 3, 200, 200, 4, 2, 512, torch.bfloat16).grid == (2, 3, 8)
    assert pa._plan("dq", 3, 200, 200, 4, 2, 512, torch.bfloat16).grid == (4, 3, 8)
    assert pa._plan("dq", 3, 200, 200, 4, 2, 300, torch.bfloat16).cluster == 2
    # the fp32 pair too: two blocks for each of 7 blocks of 32 keys
    assert pa._plan("dkv", 3, 200, 200, 4, 2, 300, torch.float32).grid == (2, 3, 14)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None),       # non-causal, Sq != Sk
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None),
])
@pytest.mark.parametrize("keys", [64, 128])
def test_query_tiles_cover_exactly_the_visible_tiles(keys, Sq, Sk, causal, window):
    """dk/dv's walk: every (key block, query tile) pair with a visible
    element lies in ``_query_tiles``' range, and no pair outside it has
    one."""
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    rows = pa._QROWS
    n_tiles = -(-Sq // rows)
    for k0 in range(0, Sk, keys):
        first, count = pa._query_tiles(k0, keys, Sq, Sk, causal, window)
        assert count == 0 or 0 <= first and first + count <= n_tiles
        seen = torch.nn.functional.pad(keep[:, k0:k0 + keys], (0, 0, 0, n_tiles * rows - Sq))
        visible = seen.reshape(n_tiles, rows, -1).any(dim=(1, 2)).tolist()
        walked = [first <= i < first + count for i in range(n_tiles)]
        assert all(w for v, w in zip(visible, walked) if v)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None),       # non-causal, Sq != Sk
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None),
])
def test_query_tiles_of_the_width_256_walk(Sq, Sk, causal, window):
    """The width-256 dk/dv kernel's walk, 64 keys a block over query tiles
    of ``_PAIR_QROWS`` rows: every tile with a visible pair is walked, and
    none of them is hidden from the block's keys (``qtile_hidden``: the
    kernel only skips such a tile)."""
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    rows = pa._PAIR_QROWS
    n_tiles = -(-Sq // rows)
    for k0 in range(0, Sk, 64):
        first, count = pa._query_tiles(k0, 64, Sq, Sk, causal, window, rows)
        assert count == 0 or 0 <= first and first + count <= n_tiles
        seen = torch.nn.functional.pad(keep[:, k0:k0 + 64], (0, 0, 0, n_tiles * rows - Sq))
        visible = seen.reshape(n_tiles, rows, -1).any(dim=(1, 2)).tolist()
        walked = [first <= i < first + count for i in range(n_tiles)]
        assert walked == visible


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None), (256, 256, True, 2), (256, 256, True, 48),
    (200, 200, True, None), (200, 200, True, 48), (64, 192, False, None),
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None),
])
def test_query_tiles_of_the_width_512_walk(Sq, Sk, causal, window):
    """The width-512 dk/dv pair's walk (both blocks of a cluster walk it),
    64 keys a block over query tiles of ``_PAIR_QROWS`` rows: exactly the
    tiles that hold a visible pair (the kernel skips none, and each of its
    tiles is a swap both blocks make)."""
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    rows = pa._PAIR_QROWS
    n_tiles = -(-Sq // rows)
    for k0 in range(0, Sk, 64):
        first, count = pa._query_tiles(k0, 64, Sq, Sk, causal, window, rows)
        seen = torch.nn.functional.pad(keep[:, k0:k0 + 64], (0, 0, 0, n_tiles * rows - Sq))
        visible = seen.reshape(n_tiles, rows, -1).any(dim=(1, 2)).tolist()
        assert [first <= i < first + count for i in range(n_tiles)] == visible


@pytest.mark.parametrize("width", [64, 128, 256, 512])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_fma_backward_layout_fits_the_block(kernel, width):
    """The fp32 dq and dk/dv kernels' shared memory, part by part as their
    ``Layout`` in ``csrc/flash_attention_bwd_{dq,dkv}.cu`` lays it out: the
    resident tiles, two ring stages, the exchange tiles (dq's dS; dk/dv's
    P^T and dS^T, which its two warpgroups hand over), dk/dv's delta row a
    stage, the barriers and the alignment slack; at width 512 a block of
    the pair, over its 256 columns, with the receive slots of the other
    block's partials (dq's S and dP, dk/dv's S^T, dP^T and partial delta)
    and their barriers. It fits the block at every width; the block is a
    multiple of 16 rows (dq's thread holds rows g + 16 i, dk/dv's keys
    g + 8 i of its warpgroup's 8 row groups) and the streamed tile 64 or
    32 rows (a row of an exchange tile is 4 or 2 positions a lane)."""
    block, tile = pa._fma_bwd_tiles(kernel, width)
    assert block % 16 == 0 and tile in (64, 32)
    pair = width == 512
    cols = width // 2 if pair else width        # a block's columns
    slab = 128                                  # bytes of a 32-column fp32 row
    resident = 2 * (cols // 32) * block * slab
    stage = 2 * (cols // 32) * tile * slab
    exchange = (2 if kernel == "dkv" else 1) * 4 * block * tile
    rows = 2 * 4 * tile if kernel == "dkv" else 0
    bars = 8 * (1 + 2 * 2 + (2 if kernel == "dkv" else 0))
    # the pair's receive slots: 8 partials a thread of its slot's threads
    # (dq's 256, each dk/dv warpgroup's 128), dk/dv's partial delta row, and
    # each slot's full and free barriers
    rx = 0 if not pair else (256 * 8 * 4 + 8 * 2 if kernel == "dq" else
                             2 * 128 * 8 * 4 + 4 * tile + 2 * 8 * 2)
    want = 1024 + resident + 2 * stage + exchange + rows + bars + rx
    assert pa._fma_bwd_bytes(kernel, width) == want <= pa.SMEM_LIMIT
    plan = pa._plan(kernel, 4, 2048, 2048, 8, 8, width, torch.float32)
    assert (plan.route, plan.block, plan.smem_bytes) == ("fma", block, want)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None),       # non-causal, Sq != Sk
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None),
])
@pytest.mark.parametrize("width", [128, 256, 512])
def test_query_tiles_of_the_fp32_walk(width, Sq, Sk, causal, window):
    """The fp32 dk/dv kernel's walk, ``_fma_bwd_tiles("dkv", width)`` keys
    a block over query tiles of its rows (at 512 both blocks of a pair walk
    it): it visits exactly the tiles that hold a visible (query, key) pair,
    found by brute force, so the kernel skips none and both blocks of a
    pair swap as often."""
    keys, rows = pa._fma_bwd_tiles("dkv", width)
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    n_tiles = -(-Sq // rows)
    for k0 in range(0, Sk, keys):
        first, count = pa._query_tiles(k0, keys, Sq, Sk, causal, window, rows)
        assert count == 0 or 0 <= first and first + count <= n_tiles
        visible = [bool(keep[i * rows:(i + 1) * rows, k0:k0 + keys].any())
                   for i in range(n_tiles)]
        walked = [first <= i < first + count for i in range(n_tiles)]
        assert walked == visible


def test_other_head_sizes_and_dtypes_are_stated_refusals():
    with pytest.raises(ValueError, match=r"head_dim up to 512 .*got 640\. At width 640 .*bf16 "
                                         r"forward 246,824; dq 279,864; dk/dv 274,080; fp32 .*"
                                         r"dk/dv 263,640; .*232,448 bytes.*own 320 columns"):
        pa._plan("fwd", 1, 64, 64, 2, 2, 640, torch.bfloat16)
    with pytest.raises(ValueError, match=r"head_dim up to 512 .*got 513\. At width 576 .*"
                                         r"own 288 columns \(144 fp32 accumulator registers a "
                                         r"thread\), more than wgmma's widest product of 256"):
        pa._plan("dkv", 1, 64, 64, 2, 2, 513, torch.float32)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pa._plan("dq", 1, 64, 64, 2, 2, 128, torch.float16)


def _inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", [
    (2, 16, 48, 4, 2, False, None),    # Sq != Sk, non-causal
    (2, 40, 40, 4, 1, True, None),     # ragged against a 16-row tile, MQA
    (1, 32, 32, 4, 2, True, 100),      # batch 1, window longer than the sequence
])
def test_fp32_plain_forward_and_backward_match_jax(B, Sq, Sk, H, KV, causal, window):
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, 16, seed=Sq + Sk)
    bq, bk = 8, 8
    want_o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, bq, bk, None, window),
                          *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(want_o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = pa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    got = [o] + list(pa.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                                       window=window))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("D", [513, 576, 640])
def test_wider_heads_name_the_bytes_of_the_width_512_designs(D):
    """Past 512 the refusal states what the width-512 designs would need at
    D padded to 64: the forward's two warpgroups over all columns, and a
    block of dq's and dk/dv's pairs over its half (rounded up to 64-column
    slabs), the receive slots included; every bf16 design passes the card's
    shared memory or wgmma's widest product."""
    width = -(-D // 64) * 64
    sums = {k: pa._wgmma_sums(k, 64, width)[0] for k in ("fwd", "dq", "dkv")}
    half = -(-width // 2 // 64)
    assert sums["dq"] == (1024 + 2 * half * 64 * 128 + 2 * 2 * half * 64 * 128 + 4 * 64
                          + 2 * 64 * 64 * 4 + 8 * 5 + 8 * 2)
    assert sums["dkv"] == (1024 + 2 * half * 64 * 128 + 5 * half * 48 * 128 + 64 * 48 * 4
                           + 2 * 48 * 4 + 2 * 64 * 48 * 4 + 48 * 4 + 8 * 7 + 8 * 5)
    assert max(sums.values()) > pa.SMEM_LIMIT or width // 2 > pa._WGMMA_N_MAX
    want = f"bf16 forward {sums['fwd']:,}; dq {sums['dq']:,}; dk/dv {sums['dkv']:,}"
    for kernel in ("fwd", "dq", "dkv"):
        with pytest.raises(ValueError, match=f"got {D}\\. At width {width} .*{want}.*own "
                                             f"{width // 2} columns"):
            pa._plan(kernel, 1, 64, 64, 2, 1, D, torch.bfloat16)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None), (40, 200, False, None),
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None), (64, 256, True, None),
])
def test_key_tiles_of_the_width_512_dq_walk(Sq, Sk, causal, window):
    """The width-512 dq pair's walk (both blocks of a cluster walk it), 64
    query rows a block over 64-key tiles (``_key_tiles``, the kernel's
    ``key_tiles``): exactly the tiles that hold a visible pair, so each of
    them is a swap both blocks make and none is skipped."""
    plan = pa._plan("dq", 1, Sq, Sk, 2, 1, 512, torch.bfloat16)
    rows, keys = plan.block, pa._TILE_K
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    n_tiles = -(-Sk // keys)
    for q0 in range(0, Sq, rows):
        first, count = pa._key_tiles(q0, rows, Sq, Sk, causal, window)
        visible = [bool(keep[q0:q0 + rows, j * keys:(j + 1) * keys].any())
                   for j in range(n_tiles)]
        assert [first <= j < first + count for j in range(n_tiles)] == visible


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (1, 32, 32, 2, 2, 512, True, None),
    (1, 16, 48, 4, 2, 512, False, None),      # Sq != Sk, GQA
    (2, 32, 32, 2, 1, 512, True, 12),         # a window, MQA
    (1, 32, 32, 2, 1, 300, True, None),       # D 300: the second half is 44 columns
])
def test_pair_reference_matches_jax_backward(B, Sq, Sk, H, KV, D, causal, window):
    """``_pair_reference`` (S and dP as the sum of two column halves'
    partial products, dk/dv's delta as two partial row sums) against the
    JAX Pallas backward in interpret mode, fp32: the split adds one rounding
    to each score, dP and delta, within ``TOL``'s summation-order bound."""
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, seed=D + Sq + Sk)
    want_o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 16, 16, None, window),
                          *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = pa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    got = pa._pair_reference(tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("f32_grads", [False, True], ids=["bf16_grads", "fp32_grads"])
def test_pair_reference_in_bf16_keeps_the_plain_roundings(f32_grads):
    """In bf16 the split moves a score by one fp32 rounding, so a rounded p
    or ds lands at most one bf16 step from the plain backward's: the two
    agree within the card checks' bounds (``chip_smoke.check_out``: 2^-6
    of the value plus 0.05 of the rms), and in their dtypes."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(2, 40, 40, 4, 2, 512, seed=7))
    o, lse = pa.flash_attention_plain(q, k, v, causal=True)
    kw = dict(causal=True, grad_dtype=torch.float32 if f32_grads else None)
    got = pa._pair_reference(q, k, v, o, lse, do, **kw)
    want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == (torch.float32 if f32_grads else torch.bfloat16)
        g, w = g.float(), w.float()
        rms = w.pow(2).mean().sqrt()
        assert bool(((g - w).abs() <= 2.0 ** -6 * w.abs() + 0.05 * rms).all())


def test_pair_swap_probe_skips_exactly_the_swap():
    """``benchmarks/pair_swap.py`` times the width-512 pairs of both routes
    against copies whose four pair pieces return at once: it finds each
    piece's line in ``csrc/flash_common.cuh`` once; without a card it exits
    with a message."""
    from kubeflow_tpu_torch.benchmarks import pair_swap
    from kubeflow_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_common.cuh").read_text()
    out = pair_swap.skipped_swap_header(src)
    assert out.count("\n  return;") - src.count("\n  return;") == len(pair_swap.SKIPPED) == 4
    for line in pair_swap.SKIPPED:
        assert line + "\n  return;" in out
    assert pair_swap.main() == 1


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None), (40, 200, False, None),
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None), (64, 256, True, None),
])
def test_key_tiles_of_the_fp32_width_512_dq_walk(Sq, Sk, causal, window):
    """The fp32 width-512 dq pair's walk (both blocks of a cluster walk it),
    32 query rows a block over 32-key tiles (``_key_tiles``, the kernel's
    ``key_tiles<32>``): exactly the tiles that hold a visible pair, found by
    brute force, so each of them is a swap both blocks make."""
    plan = pa._plan("dq", 1, Sq, Sk, 2, 1, 512, torch.float32)
    rows, keys = pa._fma_bwd_tiles("dq", 512)
    assert (plan.block, plan.cluster, rows, keys) == (32, 2, 32, 32)
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    n_tiles = -(-Sk // keys)
    for q0 in range(0, Sq, rows):
        first, count = pa._key_tiles(q0, rows, Sq, Sk, causal, window, keys)
        visible = [bool(keep[q0:q0 + rows, j * keys:(j + 1) * keys].any())
                   for j in range(n_tiles)]
        assert [first <= j < first + count for j in range(n_tiles)] == visible


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_fma_pair_layout_offsets(kernel):
    """The fp32 width-512 pair's ``Layout`` (``dq32::Layout<512, 32, 32,
    2>``, ``dkv32::Layout<512, 32, 32, 2>``) as the ``.cu`` lays it out,
    offset by offset: every TMA tile starts on a 1024-byte boundary (the
    128-byte swizzle's period), the receive slot on 16 bytes (float4 by
    st.async), the barriers on 8; its end plus the alignment slack is
    ``_fma_bwd_bytes``, within the block's shared memory."""
    block, tile = pa._fma_bwd_tiles(kernel, 512)
    ns = 256 // 32                                  # a block's 32-column slabs
    res_slab, ring_slab = block * 128, tile * 128
    offsets = {"resident": 0, "resident2": ns * res_slab, "ring": 2 * ns * res_slab}
    stage = 2 * ns * ring_slab
    after_ring = offsets["ring"] + 2 * stage
    if kernel == "dq":
        offsets.update(ds=after_ring, rx=after_ring + 4 * block * tile)
        offsets["bar"] = offsets["rx"] + 256 * 8 * 4
        n_bars = 1 + 2 * 2 + 2
    else:
        offsets.update(p=after_ring, ds=after_ring + 4 * block * tile)
        offsets["rows"] = offsets["ds"] + 4 * block * tile
        offsets["rx"] = offsets["rows"] + 2 * 4 * tile
        offsets["rx_delta"] = offsets["rx"] + 2 * 128 * 8 * 4
        offsets["bar"] = offsets["rx_delta"] + 4 * tile
        n_bars = 1 + 2 * 2 + 2 + 4
    assert all(offsets[k] % 1024 == 0 for k in ("resident", "resident2", "ring"))
    assert stage % 1024 == 0 and offsets["rx"] % 16 == 0 and offsets["bar"] % 8 == 0
    want = 1024 + offsets["bar"] + 8 * n_bars
    assert pa._fma_bwd_bytes(kernel, 512) == want <= pa.SMEM_LIMIT
    assert want == {"dq": 209_976, "dkv": 214_488}[kernel]


def test_fma_forward_pair_layout_offsets():
    """The fp32 width-512 forward's ``fwd32::Layout<512, 64, 32, 2>`` as the
    ``.cu`` lays it out, offset by offset: the Q tile and each ring stage on
    1024 bytes (the 128-byte swizzle's period), the receive slot on 16 (float4
    by st.async), the barriers on 8; 8 partial scores a thread of its 256 fill
    the slot (64 rows by 32 keys); its end plus the alignment slack is
    ``_fma_fwd_bytes(512)``, within the block's shared memory. The plan
    launches it as a cluster of two blocks a query tile of 64 rows."""
    rows, keys = pa._fma_fwd_tiles(512)
    assert (rows, keys) == (64, 32) and rows * keys == 8 * pa._FMA_THREADS
    ns = 256 // 32                                  # a block's 32-column slabs
    q_slab, kv_slab = rows * 128, keys * 128
    offsets = {"q": 0, "ring": ns * q_slab}
    stage = 2 * ns * kv_slab
    offsets["p"] = offsets["ring"] + 2 * stage
    offsets["rx"] = offsets["p"] + 4 * rows * keys
    offsets["bar"] = offsets["rx"] + 4 * rows * keys
    assert offsets["q"] % 1024 == 0 and offsets["ring"] % 1024 == 0 and stage % 1024 == 0
    assert offsets["rx"] % 16 == 0 and offsets["bar"] % 8 == 0
    want = 1024 + offsets["bar"] + 8 * (1 + 2 * 2 + 2)
    assert pa._fma_fwd_bytes(512) == want == 214_072 <= pa.SMEM_LIMIT
    # the width-256 kernel's layout plus the slot and its two barriers
    assert want == pa._fma_fwd_bytes(256) + 4 * rows * keys + 8 * 2
    for B, S, H, KV in ((4, 2048, 2, 2), (4, 128, 2, 1), (3, 200, 2, 1), (1, 16, 8, 1)):
        plan = pa._plan("fwd", B, S, S, H, KV, 512, torch.float32)
        assert (plan.route, plan.block, plan.cluster, plan.smem_bytes) == ("fma", 64, 2, want)
        assert plan.grid == (H, B, 2 * -(-S // 64)) and plan.threads == 256
        # the bf16 forward keeps its two warpgroups' halves of O, one block
        assert pa._plan("fwd", B, S, S, H, KV, 512, torch.bfloat16).cluster == 1
    # D 300 runs the same pair at width 512
    assert pa._plan("fwd", 1, 40, 40, 2, 1, 300, torch.float32).cluster == 2


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, None),
    (256, 256, True, 2), (256, 256, True, 48), (256, 256, True, 100), (256, 256, True, 1000),
    (200, 200, True, None), (200, 200, True, 48),        # ragged query and key tiles
    (96, 96, False, None), (64, 192, False, None), (40, 200, False, None),
    (16, 8, True, 2), (300, 130, True, 100), (130, 300, True, None), (64, 256, True, None),
])
def test_key_tiles_of_the_fp32_width_512_forward_walk(Sq, Sk, causal, window):
    """The fp32 width-512 forward pair's walk (both blocks of a cluster walk
    it), 64 query rows a block over 32-key tiles (``_key_tiles``, the
    kernel's ``key_tiles<32>``): exactly the tiles that hold a visible pair,
    found by brute force, so each of them is a swap both blocks make."""
    plan = pa._plan("fwd", 1, Sq, Sk, 2, 1, 512, torch.float32)
    rows, keys = pa._fma_fwd_tiles(512)
    assert (plan.block, plan.cluster) == (rows, 2)
    keep = pa._keep_mask(Sq, Sk, causal, window, "cpu")
    n_tiles = -(-Sk // keys)
    for q0 in range(0, Sq, rows):
        first, count = pa._key_tiles(q0, rows, Sq, Sk, causal, window, keys)
        visible = [bool(keep[q0:q0 + rows, j * keys:(j + 1) * keys].any())
                   for j in range(n_tiles)]
        assert [first <= j < first + count for j in range(n_tiles)] == visible


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (1, 40, 40, 2, 1, 512, True, 12),         # a window; Sk 40 ragged to 32-key tiles
    (2, 24, 40, 2, 2, 512, True, None),       # Sq < Sk: causal from position 0
    (1, 16, 48, 4, 2, 512, False, None),      # non-causal, GQA
    (1, 40, 40, 2, 1, 300, True, 12),         # D 300: the second half is 44 columns
])
def test_pair_forward_reference_matches_jax_forward(B, Sq, Sk, H, KV, D, causal, window):
    """``_pair_forward_reference`` (S as the sum of two column halves'
    partial products, then the fp32 kernel's online softmax over 32-key
    tiles) against the JAX Pallas forward in interpret mode, fp32: o and lse
    within ``TOL``, the summation-order bound of the other fp32 checks (the
    split adds one rounding to each score)."""
    q, k, v, _ = _inputs(B, Sq, Sk, H, KV, D, seed=D + Sq + Sk + 1)
    bq = 8
    want_o, want_lse = _jax_flash_forward(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)), causal=causal, block_q=bq,
        block_k=8, interpret=True, save_residuals=True, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = pa._pair_forward_reference(tq, tk, tv, causal=causal, window=window)
    assert o.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o).transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], **TOL)
    # and the plain forward, whose single softmax it reorders
    o_p, lse_p = pa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), **TOL)


def test_pair_forward_reference_dead_rows_and_bf16():
    """Rows that see no key give o = 0 and lse = +inf, as the kernel; in
    bf16 the witness keeps the operands' dtype for o."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 16, 8, 2, 1, 512, seed=3))
    o, lse = pa._pair_forward_reference(q, k, v, causal=True, window=2)
    o_p, lse_p = pa.flash_attention_plain(q, k, v, causal=True, window=2)
    dead = ~lse_p.isfinite()
    assert int(dead.sum()) == 2 * 2 * 7
    assert bool((lse[dead] == torch.inf).all()) and bool((o.permute(0, 2, 1, 3)[dead] == 0).all())
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), **TOL)
    o16, _ = pa._pair_forward_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True,
                                        window=2)
    assert o16.dtype == torch.bfloat16
