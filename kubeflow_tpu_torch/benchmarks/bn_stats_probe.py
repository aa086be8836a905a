"""Probe: a plain BN-stats reduction vs the channel-moments kernel.

Counterpart of the JAX package's ``benchmarks/bn_stats_probe.py``. That probe
measures, per ResNet-50 activation shape, XLA's (sum, sumsq) channel
reduction against a Pallas kernel that streams the tensor once, with a scalar
multiplied into the input inside the pass so that its timing loop cannot be
hoisted. The multiplier is part of what the kernel computes, so the port's
kernel has it too: ``csrc/bn_moments.cu`` is one source for the BatchNorm
moments (multiplier 1, ``ops/bn_pallas.channel_moments``) and for this probe's
``_moments_kernel`` (``bn_stats_probe.py:43``).

    python3 -m kubeflow_tpu_torch.benchmarks.bn_stats_probe

prints, for the six batch-16 shapes, the kernel's and the plain reduction's
device time and rate on the card, L2 flushed before every call.
"""
from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.ops import bn_pallas

SHAPES = [  # the ResNet-50 batch-16 activation zoo (NHWC)
    (16, 112, 112, 64),
    (16, 56, 56, 64),
    (16, 56, 56, 256),
    (16, 28, 28, 512),
    (16, 14, 14, 1024),
    (16, 7, 7, 2048),
]


def moments_scaled_plain(x, c: float):
    """Plain version (``xla_moments``, ``bn_stats_probe.py:38-40``):
    (Σ(c·x), Σ(c·x)²) over all but the last dim, fp32 [C] each."""
    return bn_pallas.moments_sums_plain(x, c)


def moments_scaled(x, c: float):
    """(Σ(c·x), Σ(c·x)²) per channel of ``x`` [..., C], fp32 [C] each: the
    moments kernel with multiplier ``c`` on a CUDA tensor, the plain version
    on a CPU tensor."""
    return bn_pallas.moments_sums(x, c, moments_scaled)


moments_scaled.launches = 0


def main() -> None:
    from kubeflow_tpu_torch.benchmarks._timing import card, device_ms

    if not torch.cuda.is_available():
        raise SystemExit("bn_stats_probe: no CUDA device; the probe times the kernel on the card")
    print(f"card: {card()}")
    rng = np.random.default_rng(0)
    c = 1.25
    print(f"{'shape':>22} {'MB':>6} {'plain':>9} {'kernel':>9} {'p GB/s':>7} {'k GB/s':>7}")
    for shape in SHAPES:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", torch.bfloat16)
        nbytes = x.numel() * 2
        t_p = device_ms(lambda: moments_scaled_plain(x, c)) / 1e3
        t_k = device_ms(lambda: moments_scaled(x, c)) / 1e3
        s1, _ = moments_scaled_plain(x, c)
        s2, _ = moments_scaled(x, c)
        rel = float(((s1 - s2).abs() / (s1.abs() + 1.0)).max())
        print(f"{str(shape):>22} {nbytes / 1e6:5.1f}M {t_p * 1e6:8.1f}u {t_k * 1e6:8.1f}u "
              f"{nbytes / t_p / 1e9:7.0f} {nbytes / t_k / 1e9:7.0f}  rel={rel:.1e}")


if __name__ == "__main__":
    main()
