"""The port's input pipeline (``kubeflow_tpu_torch/utils/data.py``) against the
reference's (``kubeflow_tpu/utils/data.py``): the cases of
``tests/test_data.py`` on the port (order, depth in flight, nests and
transforms, a bad depth), with the reference's prefetcher beside it on the
8-device CPU mesh, and the same token draws. The target here is the CPU
(``"cpu"``, or ``batch_sharding(mesh)`` on a gloo world of one); the card's
pinned side-stream copies run on the card (``chip_smoke.py``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.utils import data as jdata
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.utils import data as tdata


def _jax_sharding():
    return jmesh.batch_sharding(jmesh.create_mesh(jmesh.MeshPlan(data=8)))


def test_prefetcher_yields_all_batches_in_order():
    src = [np.full((8, 4), i, np.int32) for i in range(5)]
    got = list(tdata.DevicePrefetcher(src, "cpu"))
    want = list(jdata.DevicePrefetcher(src, _jax_sharding()))
    assert len(got) == len(want) == 5
    for i, (b, ref) in enumerate(zip(got, want)):
        assert int(b[0, 0]) == i and b.dtype == torch.int32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_keeps_depth_in_flight(depth):
    for impl, sharding in ((tdata, "cpu"), (jdata, _jax_sharding())):
        pulled = []

        def src():
            for i in range(6):
                pulled.append(i)
                yield np.full((8, 4), i, np.int32)

        it = impl.DevicePrefetcher(src(), sharding, depth=depth)
        first = next(it)
        # after one next(): the consumed batch + depth in flight were pulled
        assert int(first[0, 0]) == 0
        assert len(pulled) == depth + 1
        assert len(list(it)) == 5


def test_prefetcher_handles_nests_and_transforms():
    src = tdata.synthetic_token_batches(batch=8, seq_len=4, vocab_size=10, steps=3)
    batches = tdata.map_batches(src, lambda t: {"tokens": t, "mask": t > 0,
                                                "pair": (t, [t * 2])})
    got = list(tdata.DevicePrefetcher(batches, torch.device("cpu")))
    assert len(got) == 3
    assert set(got[0]) == {"tokens", "mask", "pair"}
    assert got[0]["mask"].dtype == torch.bool
    assert isinstance(got[0]["pair"], tuple) and isinstance(got[0]["pair"][1], list)
    torch.testing.assert_close(got[0]["pair"][1][0], got[0]["tokens"] * 2)


def test_prefetcher_copies_host_tensors():
    src = torch.arange(6).reshape(2, 3)
    out = next(tdata.DevicePrefetcher([src], "cpu"))
    src.add_(100)
    assert out.tolist() == [[0, 1, 2], [3, 4, 5]]


def test_prefetcher_rejects_bad_depth():
    for impl in (tdata, jdata):
        with pytest.raises(ValueError, match="depth"):
            impl.DevicePrefetcher([], None, depth=0)


def test_prefetcher_rejects_an_unknown_target():
    with pytest.raises(TypeError, match="batch_sharding"):
        tdata.DevicePrefetcher([], 3)


def test_batch_sharding_means_this_ranks_device(tmp_path):
    """``batch_sharding(mesh)`` on a gloo world: this rank's device (the
    CPU), the whole global batch."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = tmesh.create_mesh(tmesh.MeshPlan())
        got = list(tdata.DevicePrefetcher([np.ones((4, 2), np.float32)],
                                          tmesh.batch_sharding(mesh)))
    finally:
        dist.destroy_process_group()
    assert got[0].shape == (4, 2) and got[0].device.type == "cpu"


def test_the_card_target_copies_on_the_card_only():
    """Without a card, the default target (the card) fails at its first
    copy: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    it = tdata.DevicePrefetcher([np.zeros(2, np.int32)], None)
    with pytest.raises((RuntimeError, AssertionError)):
        next(it)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_are_the_references_draws(seed):
    kw = dict(batch=2, seq_len=5, vocab_size=11, seed=seed, steps=3)
    got = list(tdata.synthetic_token_batches(**kw))
    want = list(jdata.synthetic_token_batches(**kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_map_batches_matches_the_reference():
    src = [np.arange(3) + i for i in range(4)]
    got = list(tdata.map_batches(src, lambda b: b * 3))
    want = list(jdata.map_batches(src, lambda b: b * 3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
