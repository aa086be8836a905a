"""Probe: fused (BN + ReLU)-backward + 1x1-conv dgrad/wgrad in one kernel.

Counterpart of the JAX package's ``benchmarks/pallas_bwd_probe.py``. In one
pass over the activations:

    db = dr * relu_mask            (the mask recomputed from the BN output)
    dy = (gamma*inv) * (db - mean_db - xhat * mean_db_xhat), rounded to bf16
    dX = dy @ W.T                  (bf16 out)
    dW = X.T @ dy                  (fp32)

against the same math in plain tensor ops. ``csrc/fused_bn_relu_conv1x1_bwd.cu``
replaces the Pallas ``bwd_kernel`` (``pallas_bwd_probe.py:25``); both matrix
products run in the kernel's body, as they do on the TPU. The probe's own
shape is ResNet-50's stage2_block1/conv1 at batch 256: N = 256·56·56, CI 256,
CO 128.

What bounds the kernel on an H100: bytes (dr, y, x read once, dX written
once: 1.23 GB, 0.37 ms at 3.35 TB/s, against 105 GFLOP, 0.11 ms). The design
is in the source's header: a persistent block an SM owns a slice of input
channels (all 256 at the probe's shape, so the activations are read once),
keeps that slice of dW in registers over its row tiles, which TMA brings
through a ring of shared memory, multiplies on the tensor cores (wgmma) and
writes a partial that a second pass adds in order (the TPU kernel carries dW
across a sequential grid). :func:`_plan` is the launch: the slice, the ring
depth and the shared memory part by part.

The kernel takes any N, CI a multiple of 16, and CO a multiple of 16 up to
256 (a block's dW slice has to fit its registers, and its ring its shared
memory); other shapes raise, on any device but the CPU, before a launch. The
JAX kernel runs at the probe's one bf16 shape only
(``benchmarks/pallas_bwd_probe.py:19-22, 56-75``). CPU tensors take the
plain version.

    python3 -m kubeflow_tpu_torch.benchmarks.pallas_bwd_probe

prints the kernel's and the plain version's device time at the probe's shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import matmul_f32
from kubeflow_tpu_torch.ops import _build

N = 256 * 56 * 56
CI = 256
CO = 128
TILE_ROWS = 64       # rows a tile (csrc/fused_bn_relu_conv1x1_bwd.cu)
MAX_CO = 256
SMEM_LIMIT = 232_448  # bytes of shared memory a block may take on Hopper
_ACC_FP32 = 32_768   # dW accumulators of two consumer warpgroups: 128 fp32 a thread


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the kernel launches. A block owns ``ci_slice`` input channels
    (``slices`` blocks along CI, so dr and y are read ``slices`` times) and
    CO padded to ``co_pad`` (64, 128 or 256) and keeps that [ci_slice,
    co_pad] slice of dW in registers; ``stages`` row tiles in flight. Shared
    memory part by part, from a 1024-byte-aligned base: W^T's slice
    (``w_bytes``), each stage's dr, y and x tiles (``stage_bytes``: a slot
    of the dr/y ring and one of the x ring), dy (``dy_bytes``), scal
    (``scal_bytes``), the mbarriers (``barrier_bytes``: W's and a full
    barrier of each slot); ``csrc/fused_bn_relu_conv1x1_bwd.cu`` (Layout) sums
    the same bytes and the launcher checks them. ``grid`` (row groups,
    slices), at most one block an SM."""

    ci_slice: int
    co_pad: int
    slices: int
    stages: int
    w_bytes: int
    stage_bytes: int
    dy_bytes: int
    scal_bytes: int
    barrier_bytes: int
    smem_bytes: int
    grid: tuple[int, int]


def _kernel_shape(ci: int, co: int) -> None:
    if ci % 16 or co % 16 or ci < 16 or co < 16 or co > MAX_CO:
        raise ValueError(
            f"fused_bn_relu_conv1x1_bwd kernel takes CI and CO that are multiples of 16 and "
            f"CO <= {MAX_CO} (dW's slice of at least 128 input channels x CO must fit 128 fp32 "
            f"registers a thread); got CI {ci}, CO {co}")


def _plan(n: int, ci: int, co: int, sms: int) -> BwdPlan:
    """The kernel's launch: CO padded to 64, 128 or 256; the whole of CI up
    to 256 channels a block where ``ci_slice * co_pad`` fits the two
    warpgroups' 32,768 accumulators (CO <= 128), else 128; two ring stages
    where they fit the 232,448 bytes, else one; ``sms // slices`` blocks
    along N (fewer with fewer row tiles)."""
    _kernel_shape(ci, co)
    co_pad = 64 if co <= 64 else 128 if co <= 128 else 256
    ci_slice = 256 if co_pad <= 128 and ci > 128 else 128
    assert ci_slice * co_pad <= _ACC_FP32
    slices = -(-ci // ci_slice)
    w = ci_slice * co_pad * 2
    stage = (2 * co_pad + ci_slice) * TILE_ROWS * 2
    dy = co_pad * TILE_ROWS * 2
    scal = 7 * co_pad * 4

    def total(stages):
        return 1024 + w + stages * stage + dy + scal + 8 * (1 + 2 * stages)

    stages = 2 if total(2) <= SMEM_LIMIT else 1
    gx = max(1, min(-(-n // TILE_ROWS), sms // slices))
    return BwdPlan(ci_slice, co_pad, slices, stages, w, stage, dy, scal, 8 * (1 + 2 * stages),
                   total(stages), (gx, slices))


def bn_relu_bwd_dy(dr, y, scal):
    """The elementwise chain of the probe, fp32, rounded to bf16: scal rows
    0 gamma*inv, 1 mean, 2 inv, 3 beta, 4 mean_db, 5 mean_db_xhat, 6 gamma."""
    yf = y.float()
    xhat = (yf - scal[1]) * scal[2]
    db = torch.where(xhat * scal[6] + scal[3] > 0, dr.float(), 0.0)
    dy = scal[0] * (db - scal[4] - xhat * scal[5])
    return dy.to(torch.bfloat16)


def fused_bn_relu_conv1x1_bwd_plain(dr, y, x, wt, scal):
    """Plain version (``xla_bwd``, ``pallas_bwd_probe.py:78-89``): (dX bf16
    [N, CI], dW fp32 [CI, CO]), dy rounded to bf16 before both products,
    which sum in fp32."""
    dy16 = bn_relu_bwd_dy(dr, y, scal)
    dx = matmul_f32(dy16, wt.t()).to(torch.bfloat16)
    dw = matmul_f32(x.t(), dy16.t())
    return dx, dw


def _check(dr, y, x, wt, scal):
    n, co = dr.shape if dr.dim() == 2 else (-1, -1)
    ci = x.shape[1] if x.dim() == 2 else -1
    if (dr.dim() != 2 or y.shape != (n, co) or x.shape != (n, ci) or wt.shape != (co, ci)
            or scal.shape != (7, co) or n < 1):
        raise ValueError(
            "expected dr and y [N, CO], x [N, CI], wt [CO, CI], scal [7, CO]; got "
            f"{[tuple(t.shape) for t in (dr, y, x, wt, scal)]}")
    if any(t.dtype != torch.bfloat16 for t in (dr, y, x, wt)) or scal.dtype != torch.float32:
        raise TypeError("dr, y, x and wt must be bfloat16 and scal float32")
    if any(t.device != dr.device for t in (y, x, wt, scal)):
        raise ValueError("all operands must be on one device")
    return n, ci, co


def fused_bn_relu_conv1x1_bwd(dr, y, x, wt, scal):
    """(dX bf16 [N, CI], dW fp32 [CI, CO]) of the fused BN + ReLU + 1x1-conv
    backward: the kernel on CUDA tensors, the plain version on CPU tensors."""
    n, ci, co = _check(dr, y, x, wt, scal)
    if dr.device.type == "cpu":
        return fused_bn_relu_conv1x1_bwd_plain(dr, y, x, wt, scal)
    _kernel_shape(ci, co)
    if dr.device.type != "cuda":
        raise TypeError(f"fused_bn_relu_conv1x1_bwd kernel takes CUDA tensors; dr is on {dr.device}")
    for name, t in (("dr", dr), ("y", y), ("x", x), ("wt", wt), ("scal", scal)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"fused_bn_relu_conv1x1_bwd kernel needs {name} contiguous and 16-byte aligned")
    sms = torch.cuda.get_device_properties(dr.device).multi_processor_count
    plan = _plan(n, ci, co, sms)
    gx = plan.grid[0]
    dx = torch.empty((n, ci), dtype=torch.bfloat16, device=dr.device)
    dw = torch.empty((ci, co), dtype=torch.float32, device=dr.device)
    part = torch.empty((gx, ci, co), dtype=torch.float32, device=dr.device)
    _build.launch(
        "fused_bn_relu_conv1x1_bwd", dr.data_ptr(), y.data_ptr(), x.data_ptr(), wt.data_ptr(),
        scal.data_ptr(), dx.data_ptr(), part.data_ptr(), dw.data_ptr(), n, ci, co, gx,
        plan.ci_slice, plan.co_pad, plan.stages, plan.smem_bytes,
        torch.cuda.current_stream(dr.device).cuda_stream)
    fused_bn_relu_conv1x1_bwd.launches += 1
    return dx, dw


fused_bn_relu_conv1x1_bwd.launches = 0


def probe_operands(n: int = N, ci: int = CI, co: int = CO, seed: int = 0, device="cuda"):
    """The probe's operands (``main``, ``pallas_bwd_probe.py:127-132``):
    standard normal dr, y, x, wt in bf16 and scal in fp32."""
    rng = np.random.default_rng(seed)

    def randn(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)

    bf16 = torch.bfloat16
    return (randn(n, co, dtype=bf16), randn(n, co, dtype=bf16), randn(n, ci, dtype=bf16),
            randn(co, ci, dtype=bf16), randn(7, co, dtype=torch.float32))


def main() -> None:
    from kubeflow_tpu_torch.benchmarks._timing import card, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("pallas_bwd_probe: no CUDA device; the probe times the kernel on the card")
    print(f"card: {card()}")
    args = probe_operands()
    dx_k, dw_k = fused_bn_relu_conv1x1_bwd(*args)
    dx_p, dw_p = fused_bn_relu_conv1x1_bwd_plain(*args)
    err_dx = float((dx_k.float() - dx_p.float()).abs().max())
    err_dw = float((dw_k - dw_p).abs().max()) / float(dw_p.abs().max())
    print(f"max|dX err|={err_dx:.4f}  rel|dW err|={err_dw:.6f}")
    gb = (N * (CO + CO + CI) * 2 + N * CI * 2) / 1e9
    for label, fn in (("fused kernel    ", fused_bn_relu_conv1x1_bwd),
                      ("plain same math ", fused_bn_relu_conv1x1_bwd_plain)):
        ms = device_ms(lambda: fn(*args), iters=10)
        print(f"{label}: {ms:.3f} ms  {gb / ms * 1e3:.0f} GB/s effective")


if __name__ == "__main__":
    main()
