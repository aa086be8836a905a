"""Transformer-LM training benchmark on the card; counterpart of
``benchmarks/transformer_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.transformer_bench [--long | --seq N]
        [--head chunked|fused] [--remat-policy full|dots|flash]

The dense flagship cell (``_cells.dense_train``: 24 layers, E 1024, 8 heads
of 128, flash attention, AdamW with bf16 moments, the chunked tied head)
at per-chip batch 4 and seq 2048, or with ``--long`` seq 8192 at batch 1
(``--seq`` sets the length; above 2048 the blocks are rematerialised,
``dots`` up to 8192 and ``flash`` beyond, unless ``--remat-policy``
says). Prints one JSON line with the reference's keys, less
``vs_baseline`` (a ratio to a TPU target), plus the card's name and power
limit:

    {"metric": "transformer_train_tokens_per_sec_per_chip", "value": N,
     "unit": "tok/s/chip", "value_best": ..., "mfu": ..., "params_m": ...,
     "seq_len": ..., "per_chip_batch": ..., "head": ..., "card": ...,
     "power_limit_w": ...}

Timing: short and long windows of steps, each closed by a synchronize; the
rate comes from the difference of each length's minimum over the repeats
(``_timing.min_window_step_seconds``), ``value_best`` from the best pair.
MFU: 6 P + 12 L E S / 2 FLOPs a token over the card's 989 TFLOP/s bf16
peak. The reference's ``--ab-head`` A/B mode is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from kubeflow_tpu_torch.benchmarks import _cells, _timing

BATCH, SEQ = _cells.TRAIN_BATCH, _cells.TRAIN_SEQ
N_SHORT, N_LONG, REPEATS = 5, 25, 5
PEAK_FLOPS = 989e12             # H100 SXM dense bf16


def _args(argv):
    ap = argparse.ArgumentParser(prog="transformer_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--long", action="store_true", help="seq 8192 at per-chip batch 1")
    ap.add_argument("--seq", type=int, help="context length (above 2048: long-context mode)")
    ap.add_argument("--head", choices=("chunked", "fused"), default="chunked")
    ap.add_argument("--remat-policy", choices=("full", "dots", "flash"))
    return ap.parse_args(argv)


def main(argv=None, *, cell=None, windows=None) -> dict:
    """Measure and print the line; ``cell`` overrides the cell's fields
    (``device="cpu"`` and small widths in the tests), ``windows`` the
    (short, long, repeats) window counts."""
    args = _args(sys.argv[1:] if argv is None else argv)
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    _timing.require_card(device, "transformer_bench")
    long_ctx = args.long
    seq = 8192 if long_ctx else SEQ
    if args.seq:
        seq, long_ctx = args.seq, args.seq > SEQ
    batch = 1 if long_ctx else BATCH
    policy = args.remat_policy or ("flash" if seq > 8192 else "dots")
    c = _cells.dense_train(seq=seq, batch=batch, head=args.head, remat=seq > SEQ,
                           remat_policy=policy, **cell)
    n_short, n_long, repeats = windows or (N_SHORT, N_LONG, REPEATS)
    state = c.bundle.init()

    def window(n):
        t = time.perf_counter()
        for _ in range(n):
            c.bundle.step(state, c.tokens)
        _timing.sync(device)
        return time.perf_counter() - t

    window(n_short)                              # build, allocate, warm
    sec, shorts, longs = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    tokens = batch * seq
    pairs = [tokens * (n_long - n_short) / (lo - sh) for sh, lo in zip(shorts, longs) if lo > sh]
    per_chip = tokens / sec
    line = {
        "metric": ("transformer_longctx_train_tokens_per_sec_per_chip" if long_ctx
                   else "transformer_train_tokens_per_sec_per_chip"),
        "value": round(per_chip, 1),
        "unit": "tok/s/chip",
        "value_best": round(max(pairs, default=per_chip), 1),
        "mfu": round(per_chip * c.flops_per_token / PEAK_FLOPS, 4) if str(device) != "cpu" else None,
        "params_m": round(c.n_params / 1e6, 1),
        "seq_len": seq,
        "per_chip_batch": batch,
        "head": args.head,
        **_timing.device_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
