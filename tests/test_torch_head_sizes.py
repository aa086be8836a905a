"""Head sizes other than 64, 128, 256 and 512: the port's kernels run them
zero-padded to the next of those widths with the true D's softmax scale
(width 256: bf16 on the tensor-core route, the forward and dq with 64-row
tiles; fp32 on the FMA kernels, the forward with 64-row tiles and 32-key
tiles, dq and dk/dv with 32-row tiles and 32 keys; width 512: bf16 with two
warpgroups each owning half of an accumulator's columns, fp32 the forward
with 32-row tiles and 16-key tiles, dq and dk/dv 16 and 16).

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
    _check_padded_flash(D, causal, window, kv)


@pytest.mark.parametrize("D,causal,window,kv", [
    (320, True, None, 2), (384, False, None, 4), (512, True, 12, 1)])
def test_padded_flash_matches_jax_past_256(D, causal, window, kv):
    """Head sizes of 257-512 run at width 512: 320 and 384 padded, 512 as it is."""
    _check_padded_flash(D, causal, window, kv)


def _check_padded_flash(D, causal, window, kv):
    B, S, H = 2, 32, 4
    q, k, v, do = _inputs(B, S, S, H, kv, D, seed=D + kv)
    (o_j, vjp) = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 16, 16, True, window),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    width = pa._kernel_width(D)
    assert width == (64 if D <= 64 else 128 if D <= 128 else 256 if D <= 256 else 512)
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


def test_width_256_dkv_layout_fits_the_block():
    """The two-warpgroup dk/dv kernel's shared memory, part by part as its
    layout (``DkvPairLayout`` in ``csrc/flash_attention_bwd_dkv.cu``) lays it
    out, fits a block, and the busier warpgroup's accumulators (dV and S^T,
    or dK and dP^T) fit a thread's registers with room for its addresses."""
    slab_kb, slab_q, rows = 64 * 128, pa._PAIR_QROWS * 128, pa._PAIR_QROWS
    parts = dict(kv=2 * 4 * slab_kb, ring=3 * pa._STAGES * 4 * slab_q,
                 slot=64 * rows * 4, delta=2 * rows * 4,
                 barriers=8 * (1 + 2 * pa._STAGES + 2))
    assert parts == dict(kv=65_536, ring=147_456, slot=12_288, delta=384, barriers=56)
    smem, regs = pa._wgmma_sums("dkv", 64, 256)
    assert smem == 1024 + sum(parts.values()) <= pa.SMEM_LIMIT
    assert regs == 128 + rows // 2 and regs + 64 <= pa._REGS_MAX
    # 64-row tiles would pass the block's shared memory
    assert 1024 + parts["kv"] + 3 * pa._STAGES * 4 * 64 * 128 > pa.SMEM_LIMIT


def test_pad_heads_copies_nothing_at_the_kernel_widths():
    for D in (64, 128, 256, 512):
        q = torch.zeros(1, 8, 2, D)
        seen = []

        def inner(*heads, scale):
            seen.append((heads, scale))
            return (heads[0],)

        (out,) = pa._pad_heads(inner, (q, q), pa._kernel_width(D))
        assert out is q and all(h is q for h in seen[0][0]) and seen[0][1] == D ** -0.5


@pytest.mark.parametrize("D,width", [(1, 64), (16, 64), (32, 64), (64, 64), (65, 128),
                                     (96, 128), (100, 128), (128, 128), (129, 256),
                                     (160, 256), (192, 256), (256, 256), (257, 512),
                                     (300, 512), (384, 512), (512, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_are_made_at_the_padded_width(D, width, dtype):
    for kernel in ("fwd", "dq", "dkv"):
        plan = pa._plan(kernel, 4, 2048, 2048, 8, 8, D, dtype)
        assert plan == pa._plan(kernel, 4, 2048, 2048, 8, 8, width, dtype)
        assert plan.width == width and plan.smem_bytes <= pa.SMEM_LIMIT
        # bf16 takes the tensor cores at every width, at 256 and 512 in
        # 64-row tiles (64-key blocks for dk/dv; at 512 dq and dk/dv a
        # cluster of two blocks, one a column half, a tile or key block);
        # fp32 the FMA kernels: the forward 128 query rows and 64-key tiles
        # up to 128, 64 and 32 from 256 on; dq 64 query rows and 64-key
        # tiles, dk/dv 64 keys and 64-row tiles, up to 128, both 32 and 32
        # from 256 on (at 512 all three a cluster of two blocks, one a
        # column half, a query tile or key block)
        assert plan.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
        if plan.route == "fma" and kernel == "fwd":
            rows, cluster = pa._fma_fwd_tiles(width)[0], 2 if width == 512 else 1
            assert (plan.block, plan.threads, plan.grid, plan.cluster) == (
                rows, 256, (8, 4, cluster * 2048 // rows), cluster)
            assert plan.smem_bytes == pa._fma_fwd_bytes(width) == {
                64: 132_136, 128: 230_440, 256: 205_864, 512: 214_072}[width]
        elif plan.route == "fma":
            block = 64 if width <= 128 else 32
            cluster = 2 if width == 512 else 1
            assert pa._fma_bwd_tiles(kernel, width) == (block, block)
            assert (plan.block, plan.threads, plan.grid, plan.cluster) == (
                block, 256, (8, 4, cluster * 2048 // block), cluster)
            assert plan.smem_bytes == pa._fma_bwd_bytes(kernel, width) == {
                ("dq", 64): 115_752, ("dq", 128): 214_056, ("dq", 256): 201_768,
                ("dq", 512): 209_976, ("dkv", 64): 132_664, ("dkv", 128): 230_968,
                ("dkv", 256): 206_136, ("dkv", 512): 214_488}[kernel, width]
        elif width == 256:
            assert (plan.block, plan.threads, plan.grid) == (64, 256, (8, 4, 32))
            assert plan.smem_bytes == pa._wgmma_sums(kernel, 64, 256)[0]
        elif width == 512:
            grid = (8, 4, 32) if kernel == "fwd" else (8, 4, 64)
            assert (plan.block, plan.threads, plan.grid) == (64, 256, grid)
            assert plan.cluster == (1 if kernel == "fwd" else 2)
            assert plan.smem_bytes == pa._wgmma_sums(kernel, 64, 512)[0] == {
                "fwd": 197_672, "dq": 230_712, "dkv": 226_976}[kernel]
    for B, G, R, L in ((4, 4, 2, 2048), (2, 1, 16, 512)):
        p = fd._plan(B, G, R, L, D, dtype, 132)
        assert p == fd._plan(B, G, R, L, width, dtype, 132) and p.width == width
        elem = 4 if dtype == torch.float32 else 2
        assert p.kv_bytes == 2 * p.split * width * elem <= fd._KV_BYTES_MAX


def test_head_sizes_past_128_are_refused_with_their_limits():
    """At width 256 the bf16 forward and dq fit the tensor-core route with
    one consumer warpgroup of 64 rows beside the producer (a thread may hold
    255 registers there) but not with two (168); dk/dv fits with 64 keys in
    two warpgroups, one owning dV and one dK, and 48-row tiles (not with 128
    keys). Width 512 splits every accumulator's columns in two: the
    forward's over two warpgroups, dq's and dk/dv's over the two blocks of
    a cluster; past 512 a warpgroup's or block's share would pass wgmma's
    widest product (and at 640 every layout a block's shared memory), and
    that is the stated refusal."""
    assert [pa._wgmma_sums(k, 64, 256) for k in ("fwd", "dq", "dkv")] == [
        (164_904, 160), (197_928, 192), (226_744, 152)]
    for kernel in ("fwd", "dq"):
        smem, regs = pa._wgmma_sums(kernel, 64, 256)
        assert smem <= pa.SMEM_LIMIT and regs <= pa._REGS_MAX
        # 64-row tiles even where 128 would give every SM a block
        plan = pa._plan(kernel, 4, 2048, 2048, 8, 8, 256, torch.bfloat16, sms=1)
        assert (plan.route, plan.block, plan.threads) == ("wgmma", 64, 256)
        assert pa._plan(kernel, 4, 2048, 2048, 8, 8, 128, torch.bfloat16, sms=1).block == 128
    # two consumers beside a producer (128 rows) leave a thread 168
    # registers: dq's accumulators alone pass that, and the forward's leave
    # 8 for its addresses, counters and the softmax's m and l
    assert pa._wgmma_sums("dq", 128, 256)[1] > pa._REGS_BESIDE_PRODUCER
    assert pa._REGS_BESIDE_PRODUCER - pa._wgmma_sums("fwd", 128, 256)[1] < 16
    # dk/dv: 64 keys a block fit, 128 would pass the shared memory
    assert pa._wgmma_sums("dkv", 128, 256)[0] > pa.SMEM_LIMIT
    plan = pa._plan("dkv", 4, 2048, 2048, 8, 8, 256, torch.bfloat16, sms=1)
    assert (plan.route, plan.block, plan.threads) == ("wgmma", 64, 256)
    assert pa._plan("dkv", 4, 2048, 2048, 8, 8, 256, torch.float32).route == "fma"
    for D in (129, 200, 256):
        assert pa._kernel_width(D) == fd._kernel_width(D) == 256
    for D in (257, 320, 384, 512):
        assert pa._kernel_width(D) == fd._kernel_width(D) == 512
    # the sums the refusal states are the width-512 designs' own at the next
    # width: the bf16 layouts and the fp32 kernels' at their width-512 tiles
    # (the three pairs over a block's half of the columns, 320 at 640, with
    # the receive slots: the forward's 64 rows and 32-key tiles, dq's and
    # dk/dv's 32 and 32); at 576 the bf16 forward's fits but a warpgroup's
    # 288 columns pass wgmma's 256, and the pairs' blocks (five slabs a
    # half) pass the shared memory; at 640 none fits
    assert pa._fma_fwd_tiles(640) == (64, 32)
    assert pa._fma_bwd_tiles("dq", 640) == pa._fma_bwd_tiles("dkv", 640) == (32, 32)
    sums = [pa._wgmma_sums(k, 64, 640)[0] for k in ("fwd", "dq", "dkv")] + [
        pa._fma_fwd_bytes(640)] + [pa._fma_bwd_bytes(k, 640) for k in ("dq", "dkv")]
    assert sums == [246_824, 279_864, 274_080, 263_224, 259_128, 263_640]
    assert min(sums) > pa.SMEM_LIMIT
    assert 576 // 2 > pa._WGMMA_N_MAX == 512 // 2
    for D, width, need in ((513, 576, "bf16 forward 222,248; dq 279,864; dk/dv 274,080"),
                           (640, 640, "bf16 forward 246,824; dq 279,864; dk/dv 274,080")):
        with pytest.raises(ValueError, match=f"head_dim up to 512 .*got {D}. At width {width} "
                                             f".*{need}.*232,448.*own {width // 2} columns"):
            pa._kernel_width(D)
        with pytest.raises(ValueError, match=f"flash_decode kernel takes head_dim up to 512 .*got {D}"):
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


@pytest.mark.parametrize("D,window", [(320, None), (512, 40)])
def test_padded_decode_matches_jax_past_256(D, window):
    """Decode at width 512: D 320 padded, 512 as it is."""
    test_padded_decode_matches_jax_at_the_true_head_size(D, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_width_512_plans_at_the_heads_of_512_flagships(dtype):
    """The four kernels' plans at the shapes the heads-of-512 flagships give
    them (training B4 S2048 H2 KV2; the request's prefill B4 S128 H2 KV1,
    its decode steps over a cache of 2,048 slots), taken from meta tensors
    of those shapes; flash-decode's bytes part by part as ``smem_bytes`` in
    ``csrc/flash_decode.cuh`` sums them (K and V rows of a block's keys, the
    chunk's queries, the scores and the combine's weights), its keys a block
    32 in bf16 and 16 in fp32 (64 KB of K and V). The decode wrapper takes
    the meta operands past its head-size check and stops at the device
    check (no card here); D 513 stops at the refusal."""
    elem = 2 if dtype == torch.bfloat16 else 4
    for B, S, H, KV in ((4, 2048, 2, 2), (4, 128, 2, 1)):
        q = torch.empty(B, S, H, 512, dtype=dtype, device="meta")
        k = torch.empty(B, S, KV, 512, dtype=dtype, device="meta")
        for kernel in ("fwd", "dq", "dkv"):
            plan = pa._plan(kernel, *q.shape[:1], q.shape[1], k.shape[1], H, KV, q.shape[-1],
                            q.dtype)
            assert plan.width == 512 and plan.smem_bytes <= pa.SMEM_LIMIT
            assert plan.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
    qd = torch.empty(4, 1, 2, 512, dtype=dtype, device="meta")
    cache = torch.empty(4, 1, 2048, 512, dtype=dtype, device="meta")
    plan = fd._plan(*qd.shape[:3], cache.shape[2], qd.shape[-1], dtype, 132)
    split = 32 if dtype == torch.bfloat16 else 16
    parts = dict(kv=2 * split * 512 * elem, q=8 * 512 * elem, scores=8 * split * 4,
                 weights=8 * (2048 // split) * 4)
    assert (plan.split, plan.splits, plan.cluster, plan.width) == (split, 2048 // split, False, 512)
    assert (plan.kv_bytes, plan.q_bytes, plan.score_bytes, plan.weight_bytes) == tuple(parts.values())
    assert plan.smem_bytes == sum(parts.values()) and plan.kv_bytes == fd._KV_BYTES_MAX
    assert plan.split % fd.SPLIT_UNIT == 0
    pos = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="takes CUDA tensors"):
        fd.flash_decode(qd, cache, cache, pos)
    wide = torch.empty(4, 1, 2048, 513, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="head_dim up to 512 .*got 513"):
        fd.flash_decode(torch.empty(4, 1, 2, 513, dtype=dtype, device="meta"), wide, wide, pos)
