"""MoE-transformer training benchmark on the card; counterpart of
``benchmarks/moe_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.moe_bench [--dispatch gather|einsum]
        [--remat] [--fused-head]

The MoE flagship cell (``_cells.moe_train``: 8 layers, 8 experts top-2,
expert hidden 2048, flash attention, gather dispatch, AdamW with bf16
moments) at batch [4, 2048], through the chunked tied head or, with
``--fused-head``, the fused one. ``--dispatch a2a`` (expert parallelism)
raises on one card, as the reference's does on one chip: the a2a dispatch
needs a mesh with an expert axis. Prints one JSON line with the reference's
keys, less ``vs_baseline``, plus the card's name and power limit:

    {"metric": "moe_train_tokens_per_sec_per_chip", "value": N, "unit":
     "tok/s/chip", "mfu": ..., "params_m": ..., "active_params_m": ...,
     "dispatch": ..., "seq_len": ..., "per_chip_batch": ..., "card": ...,
     "power_limit_w": ...}

Timing as ``transformer_bench``: the minimum of each window length over the
repeats, long minus short. MFU: 6 P_active + 12 L E S / 2 FLOPs a token
(P_active counts k of E experts' tables) over 989 TFLOP/s. The reference's
``--ab`` and ``--ab-dispatch`` A/B modes are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from kubeflow_tpu_torch.benchmarks import _cells, _timing

BATCH, SEQ = _cells.MOE_BATCH, _cells.MOE_SEQ
N_SHORT, N_LONG, REPEATS = 3, 13, 5
PEAK_FLOPS = 989e12             # H100 SXM dense bf16


def _args(argv):
    ap = argparse.ArgumentParser(prog="moe_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--dispatch", choices=("gather", "einsum", "a2a"), default="gather")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--fused-head", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, *, cell=None, windows=None) -> dict:
    """Measure and print the line; ``cell`` overrides the cell's fields
    (``device="cpu"`` and small widths in the tests), ``windows`` the
    (short, long, repeats) window counts."""
    args = _args(sys.argv[1:] if argv is None else argv)
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    _timing.require_card(device, "moe_bench")
    head = "fused" if args.fused_head else "chunked"
    c = _cells.moe_train(head=head, dispatch=args.dispatch, remat=args.remat, **cell)
    batch, seq = c.tokens.shape
    n_short, n_long, repeats = windows or (N_SHORT, N_LONG, REPEATS)
    state = c.bundle.init()

    def window(n):
        t = time.perf_counter()
        for _ in range(n):
            c.bundle.step(state, c.tokens)
        _timing.sync(device)
        return time.perf_counter() - t

    window(n_short)                              # build, allocate, warm
    sec, _, _ = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    tok_s = batch * seq / sec
    line = {
        "metric": "moe_train_tokens_per_sec_per_chip",
        "value": round(tok_s, 1),
        "unit": "tok/s/chip",
        "mfu": round(tok_s * c.flops_per_token / PEAK_FLOPS, 4) if str(device) != "cpu" else None,
        "params_m": round(c.n_params / 1e6, 1),
        "active_params_m": round(c.n_active / 1e6, 1),
        "dispatch": args.dispatch,
        "seq_len": seq,
        "per_chip_batch": batch,
        **_timing.device_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
