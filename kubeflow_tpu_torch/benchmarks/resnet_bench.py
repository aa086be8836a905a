"""ResNet-50 training benchmark on the card; counterpart of ``bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.resnet_bench
    python3 -m kubeflow_tpu_torch.benchmarks.resnet_bench --mfu [bench_mfu's flags]

The ResNet-50 cell (``_cells.resnet_train``: 1000 classes, bf16, 224x224
standard-normal images, nesterov SGD 0.1/0.9, ``bn_impl="pallas"``, the
configuration that runs the BatchNorm kernels) at batch 256, where
``bench.py`` runs 16 a chip on the TPU: 256 is what fills an 80 GB card.
Prints one JSON line with the reference's keys, less ``vs_baseline``, plus
the card's name and power limit:

    {"metric": "resnet50_train_imgs_per_sec_per_chip", "value": N, "unit":
     "img/s/chip", "value_median_pair": ..., "stalled_windows": ...,
     "windows": ..., "mfu": ..., "per_chip_batch": 256, "n_chips": 1,
     "card": ..., "power_limit_w": ...}

Timing: short and long windows of steps, each closed by a synchronize; the
rate from the difference of each length's minimum over the repeats, the
median pair's rate and the windows more than 5% over their length's
minimum beside it (``bench.py``'s census). ``bench.py`` runs 20 steps in one
dispatch and sleeps between pairs to walk across the TPU runtime's phases;
eager PyTorch needs neither. MFU: 3 x ``flops_per_image(224)`` an image over
989 TFLOP/s.

``--mfu``, as ``bench.py:189-198`` does, hands the rest of the command line
to ``bench_mfu.main`` (the ResNet cell under a placement's derived mesh)
and exits with its code.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.benchmarks import _cells, _timing, bench_mfu

N_SHORT, N_LONG, REPEATS = 5, 25, 5


def main(argv=None, *, cell=None, windows=None) -> dict:
    """Measure and print the line; ``cell`` overrides the cell's fields
    (``device="cpu"``, ``batch``, ``image`` and small widths in the tests),
    ``windows`` the (short, long, repeats) window counts. With ``--mfu``
    it exits with ``bench_mfu.main``'s code on the same device."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    if "--mfu" in argv:
        sys.exit(bench_mfu.main([a for a in argv if a != "--mfu"], device=device))
    argparse.ArgumentParser(prog="resnet_bench", description=__doc__.split("\n")[0]).parse_args(
        argv)
    _timing.require_card(device, "resnet_bench")
    c = _cells.resnet_train(**cell)
    batch = c.batch["image"].shape[0]
    n_short, n_long, repeats = windows or (N_SHORT, N_LONG, REPEATS)
    window = _timing.step_window(c.bundle.step, c.bundle.init(), c.batch, device)
    window(n_short)                              # build, allocate, warm
    sec, shorts, longs = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    pairs = [batch * (n_long - n_short) / (lo - sh) for sh, lo in zip(shorts, longs) if lo > sh]
    img_s = batch / sec
    stalled = sum(t > 1.05 * min(ts) for ts in (shorts, longs) for t in ts)
    line = {
        "metric": "resnet50_train_imgs_per_sec_per_chip",
        "value": round(img_s, 2),
        "unit": "img/s/chip",
        "value_median_pair": round(statistics.median(pairs), 2) if pairs else None,
        "stalled_windows": stalled,
        "windows": 2 * repeats,
        "mfu": _timing.mfu(img_s, 3.0 * kt.flops_per_image(c.batch["image"].shape[1]), device),
        "per_chip_batch": batch,
        "n_chips": 1,
        **_timing.device_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
