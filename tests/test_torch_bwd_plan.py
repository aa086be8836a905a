"""The fused BN + ReLU + 1x1-conv backward's launch plan
(``kubeflow_tpu_torch/benchmarks/pallas_bwd_probe.py`` ``_plan``) and its
refusal past its CO limit, on the CPU.

The plan decides what the card runs: the input-channel slice a block owns
(dr and y are read once per slice), CO padded to a wgmma width, the ring's
depth and each block's shared memory, which the CUDA launcher checks against
its own layout (``Layout`` in ``csrc/fused_bn_relu_conv1x1_bwd.cu``,
recomputed here from its parts)."""
import pytest
import torch

from kubeflow_tpu_torch.benchmarks import pallas_bwd_probe as probe

SMEM_LIMIT = 232_448


def _layout_bytes(ci_slice, co_pad, stages):
    """Layout<ci_slice, co_pad, stages>::bytes, part by part."""
    w = ci_slice * co_pad * 2                          # W^T's slice, bf16
    stage = (2 * co_pad + ci_slice) * 64 * 2           # dr, y and x tiles of 64 rows
    dy = co_pad * 64 * 2
    scal = 7 * co_pad * 4
    barriers = 8 * (1 + 2 * stages)                    # W, full_a, full_x
    return 1024 + w + stages * stage + dy + scal + barriers


def test_plan_at_the_probe_shape_reads_the_activations_once():
    """N 802,816, CI 256, CO 128 on 132 SMs: one block an SM owns all 256
    input channels, so dr, y and x are read once; two ring stages of 64 KB,
    W^T's 64 KB, 217,640 bytes a block."""
    p = probe._plan(probe.N, probe.CI, probe.CO, 132)
    assert (p.ci_slice, p.co_pad, p.slices, p.stages) == (256, 128, 1, 2)
    assert (p.w_bytes, p.stage_bytes, p.dy_bytes, p.scal_bytes) == (65536, 65536, 16384, 3584)
    assert p.smem_bytes == 217_640 and p.grid == (132, 1)
    # dW [256, 128] over two warpgroups of 128 threads: 128 fp32 a thread
    assert p.ci_slice * p.co_pad // 256 == 128


@pytest.mark.parametrize("co", range(16, probe.MAX_CO + 1, 16))
@pytest.mark.parametrize("ci", [16, 48, 128, 192, 256, 512, 2048])
def test_plan_fits_at_every_accepted_co(ci, co):
    p = probe._plan(8192, ci, co, 132)
    assert p.co_pad == min(c for c in (64, 128, 256) if c >= co)     # a wgmma width
    assert p.ci_slice in (128, 256) and p.ci_slice * p.co_pad <= 32768
    assert p.slices == -(-ci // p.ci_slice)
    assert p.smem_bytes == _layout_bytes(p.ci_slice, p.co_pad, p.stages) <= SMEM_LIMIT
    # two stages wherever they fit
    assert p.stages == 2 or _layout_bytes(p.ci_slice, p.co_pad, 2) > SMEM_LIMIT
    assert p.barrier_bytes == 8 * (1 + 2 * p.stages)
    # all of CI in one slice up to 256 channels where CO allows it
    assert p.slices == 1 or (p.ci_slice == 256 or p.co_pad == 256)
    assert p.grid == (min(-(-8192 // 64), 132 // p.slices), p.slices)


def test_plan_of_few_rows():
    assert probe._plan(50, 16, 16, 132).grid == (1, 1)
    assert probe._plan(4133, 48, 80, 132).grid == (65, 1)


def _meta(n, ci, co):
    bf = torch.bfloat16
    return (torch.empty((n, co), dtype=bf, device="meta"), torch.empty((n, co), dtype=bf, device="meta"),
            torch.empty((n, ci), dtype=bf, device="meta"), torch.empty((co, ci), dtype=bf, device="meta"),
            torch.empty((7, co), dtype=torch.float32, device="meta"))


@pytest.mark.parametrize("ci,co", [(256, probe.MAX_CO + 16), (64, 512), (40, 128), (256, 72)])
def test_refusal_past_the_limit_on_meta_tensors(ci, co):
    """Past CO 256 (or CI, CO no multiple of 16) the wrapper raises before any
    device check or launch, on any device but the CPU."""
    before = probe.fused_bn_relu_conv1x1_bwd.launches
    with pytest.raises(ValueError, match=f"CO <= {probe.MAX_CO}"):
        probe.fused_bn_relu_conv1x1_bwd(*_meta(256, ci, co))
    with pytest.raises(ValueError, match="multiples of 16"):
        probe._plan(256, ci, co, 132)
    assert probe.fused_bn_relu_conv1x1_bwd.launches == before


def test_the_limit_itself_is_taken():
    """CO 256 passes the shape check (the meta tensors stop at the device
    check, as no card is present)."""
    with pytest.raises(TypeError, match="takes CUDA tensors"):
        probe.fused_bn_relu_conv1x1_bwd(*_meta(256, 192, probe.MAX_CO))
    p = probe._plan(8192, 192, probe.MAX_CO, 132)
    assert (p.ci_slice, p.co_pad, p.slices, p.stages) == (128, 256, 2, 1)
