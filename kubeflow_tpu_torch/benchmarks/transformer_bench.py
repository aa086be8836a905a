"""Transformer-LM training benchmark on the card; counterpart of
``benchmarks/transformer_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.transformer_bench [--long | --seq N]
        [--head chunked|fused | --ab-head] [--remat-policy full|dots|flash]

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
peak.

``--ab-head`` (the reference's ``:180-185, 237-275``) builds the cell twice
in one process, the fused and the chunked head, from the same seed (so the
same weights), each with its own state; warms each, then times them by
``_timing.ab_palindrome`` (A B B A a repeat). It prints a line of each
side's steps and kernel launches (``{"launches": {side: {"steps": n,
kernel: count}}}``), then the reference's line:

    {"metric": "transformer_head_ab", "unit": "tok/s/chip", "seq_len": ...,
     "per_chip_batch": ..., "fused": N, "fused_mfu": ..., "chunked": N,
     "chunked_mfu": ..., "fused_over_chunked": R, "card": ...,
     "power_limit_w": ...}
"""
from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.benchmarks import _cells, _timing

BATCH, SEQ = _cells.TRAIN_BATCH, _cells.TRAIN_SEQ
N_SHORT, N_LONG, REPEATS = 5, 25, 5


def _args(argv):
    ap = argparse.ArgumentParser(prog="transformer_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--long", action="store_true", help="seq 8192 at per-chip batch 1")
    ap.add_argument("--seq", type=int, help="context length (above 2048: long-context mode)")
    ap.add_argument("--head", choices=("chunked", "fused"), default="chunked")
    ap.add_argument("--ab-head", action="store_true",
                    help="fused against chunked head, palindromic in-process A/B")
    ap.add_argument("--remat-policy", choices=("full", "dots", "flash"))
    return ap.parse_args(argv)


def _shape(args):
    """(seq, batch, long-context) the flags ask for."""
    long_ctx = args.long
    seq = 8192 if long_ctx else SEQ
    if args.seq:
        seq, long_ctx = args.seq, args.seq > SEQ
    return seq, 1 if long_ctx else BATCH, long_ctx


def build(args, head: str, cell: dict) -> _cells.LMCell:
    """The cell the flags ask for, through ``head``: above 2048 the blocks
    are rematerialised (``dots`` to 8192, ``flash`` beyond, or
    ``--remat-policy``)."""
    seq, batch, _ = _shape(args)
    policy = args.remat_policy or ("flash" if seq > 8192 else "dots")
    return _cells.dense_train(seq=seq, batch=batch, head=head, remat=seq > SEQ,
                              remat_policy=policy, **cell)


def ab_sides(args, cell: dict) -> dict:
    """``--ab-head``'s two cells, fused first: one seed, so one set of
    weights; each side then takes its own state."""
    return {head: build(args, head, cell) for head in ("fused", "chunked")}


def _ab_head(args, cell, windows) -> dict:
    device = cell["device"]
    seq, batch, _ = _shape(args)
    sides = ab_sides(args, cell)
    secs, launches = _timing.ab_compare(
        {head: _timing.step_window(c.bundle.step, c.bundle.init(), c.tokens, device)
         for head, c in sides.items()},
        _cells.launch_counters(), *(windows or (N_SHORT, N_LONG, REPEATS)))
    print(json.dumps({"launches": launches}), flush=True)
    line = {"metric": "transformer_head_ab", "unit": "tok/s/chip", "seq_len": seq,
            "per_chip_batch": batch}
    for head, c in sides.items():
        tok_s = batch * seq / secs[head]
        line[head] = round(tok_s, 1)
        line[f"{head}_mfu"] = _timing.mfu(tok_s, c.flops_per_token, device)
    line["fused_over_chunked"] = round(line["fused"] / line["chunked"], 4)
    line.update(_timing.device_fields(device))
    print(json.dumps(line), flush=True)
    return line


def main(argv=None, *, cell=None, windows=None) -> dict:
    """Measure and print the line; ``cell`` overrides the cell's fields
    (``device="cpu"`` and small widths in the tests), ``windows`` the
    (short, long, repeats) window counts."""
    args = _args(sys.argv[1:] if argv is None else argv)
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    _timing.require_card(device, "transformer_bench")
    if args.ab_head:
        return _ab_head(args, cell, windows)
    seq, batch, long_ctx = _shape(args)
    c = build(args, args.head, cell)
    n_short, n_long, repeats = windows or (N_SHORT, N_LONG, REPEATS)
    window = _timing.step_window(c.bundle.step, c.bundle.init(), c.tokens, device)
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
        "mfu": _timing.mfu(per_chip, c.flops_per_token, device),
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
