"""The flash kernels' launch plan (route, tile rows, grid, threads, shared
memory), the fp32 plain path against the JAX kernels in fp32 (interpret
mode) at the shapes of the new kernels' edge cases, and the stated refusal
of other head sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import pallas_attention as pa

SERVING = (4, 128, 128, 8, 4)     # B, Sq, Sk, H, KV: the decode flagship's prefill
TRAINING = (4, 2048, 2048, 8, 8)  # the training flagship
# fp32 on both sides: summation order only (as tests/test_torch_flash_backward.py)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [SERVING, TRAINING], ids=["serving", "training"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_plan_route_tiles_grid_and_shared_memory(kernel, D, dtype, shape):
    B, Sq, Sk, H, KV = shape
    plan = pa._plan(kernel, B, Sq, Sk, H, KV, D, dtype)
    assert 0 < plan.smem_bytes <= pa.SMEM_LIMIT
    if dtype == torch.bfloat16:
        # 128-row tiles (128 keys for dk/dv) at the training shape (512
        # blocks for 132 SMs); the serving prefill would get 32 (16 for
        # dk/dv), so it takes 64 (64 and 32 blocks)
        rows = 128 if shape == TRAINING else 64
        # a producer warpgroup beside the consumers; dk/dv's thread 0 produces
        consumers = 128 * (rows // 64)
        threads = consumers if kernel == "dkv" else consumers + 128
        assert (plan.route, plan.block, plan.threads) == ("wgmma", rows, threads)
        assert plan.grid == ((KV, B, Sk // rows) if kernel == "dkv" else (H, B, Sq // rows))
    else:
        assert (plan.route, plan.block, plan.threads) == ("scalar", 64, 256)
        assert plan.grid == ((Sk // 64, KV, B) if kernel == "dkv" else (Sq // 64, H, B))


@pytest.mark.parametrize("kernel,dtype,shape,want", [
    # the launchers check these against the kernels' own layouts
    ("fwd", torch.bfloat16, TRAINING, 99_368),    # Q 32 KiB + 2 x (K, V) 16 KiB + slack, barriers
    ("fwd", torch.bfloat16, SERVING, 82_984),
    ("dq", torch.bfloat16, TRAINING, 132_648),    # + dO 32 KiB + delta
    ("dq", torch.bfloat16, SERVING, 99_624),
    ("fwd", torch.float32, TRAINING, 119_808),    # the scalar kernels' fp32 tiles
    ("dq", torch.float32, SERVING, 189_440),
    # K + V 64 KiB resident + 2 x (Q, dO, O) 96 KiB + two delta/lse rows a
    # consumer 2 KiB + slack, barriers
    ("dkv", torch.bfloat16, TRAINING, 166_952),
    ("dkv", torch.bfloat16, SERVING, 133_160),    # 64 keys: K + V 32 KiB, one consumer
    ("dkv", torch.float32, TRAINING, 222_720),    # the scalar kernel's fp32 tiles
])
def test_plan_shared_memory_bytes_at_d128(kernel, dtype, shape, want):
    assert pa._plan(kernel, *shape, 128, dtype).smem_bytes == want


def test_plan_ragged_and_small_grids():
    # a ragged last tile still gets a block; 128 rows only where the blocks fill the SMs
    assert pa._plan("fwd", 2, 200, 200, 8, 4, 128, torch.bfloat16).grid == (8, 2, 4)
    assert pa._plan("fwd", 9, 200, 200, 8, 4, 128, torch.bfloat16).grid == (8, 9, 2)
    assert pa._plan("dq", 1, 16, 8, 4, 2, 64, torch.bfloat16).grid == (4, 1, 1)
    assert pa._plan("dkv", 2, 64, 192, 4, 2, 128, torch.float32).grid == (3, 2, 2)
    # dk/dv: 128 keys where B * KV * ceil(Sk / 128) fills the SMs (the GQA 8/2 case at S 2048)
    assert pa._plan("dkv", 8, 2048, 2048, 8, 2, 64, torch.bfloat16).grid == (2, 8, 16)
    assert pa._plan("dkv", 4, 2048, 2048, 8, 2, 64, torch.bfloat16).grid == (2, 4, 32)
    assert pa._plan("dkv", 9, 200, 200, 8, 4, 128, torch.bfloat16).grid == (4, 9, 4)
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 128, torch.bfloat16, sms=64).block == 128
    assert pa._plan("fwd", 1, 2048, 2048, 8, 8, 128, torch.bfloat16, sms=132).block == 64


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


def test_other_head_sizes_and_dtypes_are_stated_refusals():
    with pytest.raises(ValueError, match=r"head_dim up to 256 .*got 320\. At width 320 .*dk/dv "
                                         r"271,104; .*232,448 bytes"):
        pa._plan("fwd", 1, 64, 64, 2, 2, 320, torch.bfloat16)
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
