"""ResNet-50, the platform's reference notebook workload; counterpart of ``kubeflow_tpu/models/resnet.py``.

The same model in the same layout at its public surface: images and
activations are NHWC (``[B, H, W, C]`` contiguous), parameters are fp32 and
cast to ``dtype`` (bf16) on every call, BatchNorm statistics are fp32, the
classifier head runs in fp32. Parameter and buffer names follow flax's
(``stage1_block1.bn1.scale``, ``.mean``, ``.var``), so
``interop.resnet_params_from_flax`` is a relabelling plus the conv kernels'
transpose.

Layout inside: the convolutions go through ``F.conv2d`` (cuDNN on the card;
XLA ran them on the TPU, no hand-written kernel on either) on the
``permute(0, 3, 1, 2)`` view of an NHWC tensor, which *is* a
``torch.channels_last`` NCHW tensor, with channels_last weights; the output's
``permute(0, 2, 3, 1)`` is then the contiguous NHWC array again, so the
BatchNorm kernels' ``[rows, C]`` view is free. Nothing here calls
``.contiguous()`` on an activation: ``ops/bn_pallas.py`` raises on an input
whose rows view would need a copy.

``bn_impl`` as in the JAX model: ``'xla'`` writes flax's ``nn.BatchNorm``
arithmetic out in plain tensor ops (fp32 statistics with var = E[x²] − E[x]²
clamped at 0, then ``(x − mean)·(rsqrt(var + eps)·scale) + bias``);
``'pallas'`` and ``'mxu'`` go through ``ops/bn_pallas.batch_norm_train``
(``y = x·a + b`` with the hand-written reduction kernels, or the reductions
as matrix products). Running statistics: biased batch variance, momentum
0.9, ``new = 0.9·old + 0.1·batch``, updated in place.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.transformer import resolve_device
from kubeflow_tpu_torch.ops.bn_pallas import batch_norm_train
from kubeflow_tpu_torch.parallel.collectives import sum_over_group


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high), the odd one
    at the high end (a 3x3 stride-2 conv on an even input gets (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, weight, stride: int = 1, padding="SAME"):
    """``lax.conv_general_dilated`` on NHWC ``x`` with an OIHW ``weight``:
    ``padding`` is 'SAME' or ((top, bottom), (left, right)). Returns the
    contiguous NHWC output."""
    kh, kw = weight.shape[2:]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride))
    (top, bottom), (left, right) = padding
    xc = x.permute(0, 3, 1, 2)               # NCHW view of NHWC: channels_last
    if top == bottom and left == right:
        out = F.conv2d(xc, weight, stride=stride, padding=(top, left))
    else:
        out = F.conv2d(F.pad(xc, (left, right, top, bottom)), weight, stride=stride)
    return out.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: an fp32 OIHW kernel, cast to ``dtype``
    (and to channels_last) on every call; input NHWC."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, padding="SAME",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty((c_out, c_in, kernel, kernel), dtype=torch.float32, device=device))
        # a finite default; seeded weights at flax's scale come from
        # interop.resnet_init_state_dict
        nn.init.normal_(self.weight, std=(c_in * kernel * kernel) ** -0.5)

    def forward(self, x):
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return conv_nhwc(x.to(self.dtype), w, self.stride, self.padding)


class _BatchNormBase(nn.Module):
    """Parameters ``scale``/``bias`` and running statistics ``mean``/``var``
    under flax's names, all fp32."""

    def __init__(self, channels: int, use_running_average: bool = False, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.use_running_average = use_running_average
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(
            torch.zeros(channels, **kw) if zero_scale else torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("mean", torch.zeros(channels, **kw))
        self.register_buffer("var", torch.ones(channels, **kw))

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)

    def _average(self, use_running_average):
        return self.use_running_average if use_running_average is None else use_running_average


class BatchNorm(_BatchNormBase):
    """flax ``nn.BatchNorm`` (``bn_impl='xla'``) in plain tensor ops; the
    gradient flows through the batch statistics by autograd, as in flax.

    ``group`` (set by the train step under a mesh, as ``PallasBatchNorm``'s
    is): the process group over which the batch is sharded in equal shards.
    Train-mode statistics are then the global batch's, as flax's are under
    GSPMD: the fp32 Σx and Σx² are summed over the group with their gradient
    (``sum_over_group``), and the row count is the rank's times the group's
    size."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.group = None

    def forward(self, x, use_running_average: bool | None = None):
        if self._average(use_running_average):
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            if self.group is None:
                mean, sq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            else:
                # equal shards: the global row count is an int, as on one device
                n = (x.numel() // x.shape[-1]) * dist.get_world_size(self.group)
                s, q = sum_over_group(torch.stack([xf.sum(dim=axes), (xf * xf).sum(dim=axes)]),
                                      self.group).unbind(0)
                mean, sq = s / n, q / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            self._update_running(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * mul + self.bias).to(self.dtype)


class PallasBatchNorm(_BatchNormBase):
    """flax ``nn.BatchNorm`` drop-in whose train-mode statistics and gradient
    reductions run in the hand-written kernels (``strategy='pallas'``) or as
    matrix products (``'mxu'``): ``ops/bn_pallas.py``. Inference mode is
    elementwise."""

    def __init__(self, channels: int, strategy: str = "pallas", **kw):
        super().__init__(channels, **kw)
        self.strategy = strategy
        # the process group of the ranks that shard the batch (set by the
        # train step under a mesh): train-mode statistics are the global batch's
        self.group = None

    def forward(self, x, use_running_average: bool | None = None):
        if self._average(use_running_average):
            a = self.scale * torch.rsqrt(self.var + self.epsilon)
            b = self.bias - self.mean * a
            return (x.float() * a + b).to(self.dtype)
        y, (mean, var) = batch_norm_train(
            x.to(self.dtype), self.scale, self.bias, self.epsilon, strategy=self.strategy,
            group=self.group)
        self._update_running(mean, var)
        return y.to(self.dtype)


class SpaceToDepthStem(nn.Module):
    """The 7x7/s2 stem conv, computed in space-to-depth form.

    Reindexing the input into 2x2 pixel cells ([B, H/2, W/2, 12]) and
    zero-padding the kernel to 8x8 turns the stem into an exactly equivalent
    4x4 stride-1 conv with 12 input channels (the MLPerf ResNet trick). The
    parameter stays in the canonical 7x7 layout, so the model is still
    ResNet-50 and the weights are interchangeable with the plain stem's.
    """

    def __init__(self, width: int = 64, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.weight = nn.Parameter(
            torch.empty((width, 3, 7, 7), dtype=torch.float32, device=device))
        nn.init.normal_(self.weight, std=147 ** -0.5)

    def forward(self, x):
        # pad taps at the front: out[i] = sum_k w[k] in[2i-3+k]
        #                              = sum_m w8[m] in[2i-4+m], w8[0] = 0
        w8 = F.pad(self.weight, (1, 0, 1, 0))                  # [O, 3, 8, 8]
        # [O, 3, 4(cell_h), 2(ph), 4(cell_w), 2(pw)] -> [O, (ph, pw, 3), 4, 4]
        w_s2d = (
            w8.reshape(self.width, 3, 4, 2, 4, 2)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(self.width, 12, 4, 4)
        ).to(self.dtype, memory_format=torch.channels_last)
        b, h, wdt, c = x.shape
        x = (
            x.reshape(b, h // 2, 2, wdt // 2, 2, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, wdt // 2, 4 * c)
        )
        return conv_nhwc(x.to(self.dtype), w_s2d, 1, ((2, 1), (2, 1)))


class BottleneckBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, strides: int, conv, norm):
        super().__init__()
        self.conv1 = conv(c_in, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, strides)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        # zero-init gamma on the last BN of each block: residual branch starts
        # as identity, the standard large-batch training recipe
        self.bn3 = norm(filters * 4, zero_scale=True)
        # flax projects where the shapes differ: the channels, or the stride
        if c_in != filters * 4 or strides != 1:
            self.proj_conv = conv(c_in, filters * 4, 1, strides)
            self.proj_bn = norm(filters * 4)
        else:
            self.proj_conv = self.proj_bn = None

    def forward(self, x, average: bool):
        residual = x
        y = F.relu(self.bn1(self.conv1(x), average))
        y = F.relu(self.bn2(self.conv2(y), average))
        y = self.bn3(self.conv3(y), average)
        if self.proj_conv is not None:
            residual = self.proj_bn(self.proj_conv(residual), average)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``model(images, train=True)`` -> fp32 logits ``[B, num_classes]``;
    images NHWC. ``train=True`` normalises with the batch statistics and
    updates the running ones in place. Runs on the card unless the caller
    passes ``device="cpu"``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, s2d_stem: bool = False, bn_impl: str = "xla",
                 device=None):
        super().__init__()
        if bn_impl not in ("xla", "pallas", "mxu"):
            # a typo like 'MXU' would otherwise silently select another path
            raise ValueError(
                f"bn_impl must be one of ('xla', 'pallas', 'mxu'), got {bn_impl!r}")
        device = resolve_device(device)
        self.stage_sizes, self.num_classes, self.width = list(stage_sizes), num_classes, width
        self.dtype, self.s2d_stem, self.bn_impl = dtype, s2d_stem, bn_impl
        conv = partial(Conv, dtype=dtype, device=device)
        if bn_impl == "xla":
            norm = partial(BatchNorm, dtype=dtype, device=device)
        else:
            norm = partial(PallasBatchNorm, strategy=bn_impl, dtype=dtype, device=device)
        if s2d_stem:
            self.stem_conv = SpaceToDepthStem(width, dtype=dtype, device=device)
        else:
            self.stem_conv = conv(3, width, 7, 2, ((3, 3), (3, 3)))
        self.stem_bn = norm(width)
        c_in = width
        for i, block_count in enumerate(self.stage_sizes):
            for j in range(block_count):
                filters = width * 2 ** i
                self.add_module(
                    f"stage{i + 1}_block{j + 1}",
                    BottleneckBlock(c_in, filters, 2 if i > 0 and j == 0 else 1, conv, norm))
                c_in = filters * 4
        # classifier head in fp32 for a numerically stable softmax
        self.head = nn.Linear(c_in, num_classes, dtype=torch.float32, device=device)

    def blocks(self):
        return [m for m in self.children() if isinstance(m, BottleneckBlock)]

    def forward(self, x, train: bool = True):
        average = not train
        x = x.to(self.dtype)
        if self.s2d_stem and (x.shape[1] % 2 or x.shape[2] % 2):
            # an odd image has no 2x2 cells: the plain 7x7 stem on the same weight
            x = conv_nhwc(
                x, self.stem_conv.weight.to(self.dtype, memory_format=torch.channels_last),
                2, ((3, 3), (3, 3)))
        else:
            x = self.stem_conv(x)
        x = F.relu(self.stem_bn(x, average))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for block in self.blocks():
            x = block(x, average)
        x = x.mean(dim=(1, 2))                    # in dtype, as jnp.mean on bf16
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2])   # (basic-block depths reused
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])   # as bottlenecks: test-scale)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])


def flops_per_image(image_size: int = 224) -> float:
    """Approx fwd-pass FLOPs for ResNet-50 (2 * MACs); training ≈ 3x this."""
    # 4.09 GMACs at 224x224 scales quadratically with resolution.
    return 2 * 4.09e9 * (image_size / 224) ** 2
