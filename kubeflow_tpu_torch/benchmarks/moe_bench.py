"""MoE-transformer training benchmark on the card; counterpart of
``benchmarks/moe_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.moe_bench [--dispatch gather|einsum]
        [--remat] [--fused-head] [--ab | --ab-dispatch]

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
(P_active counts k of E experts' tables) over 989 TFLOP/s.

The A/B modes build the cell twice in one process from the same seed, each
side with its own state, warm each, then time them by
``_timing.ab_palindrome`` (A B B A a repeat). Each prints a line of each
side's steps and kernel launches (``{"launches": {side: {"steps": n,
kernel: count}}}``), then the reference's line (``:170-181``):

- ``--ab`` (``:184-195``): the fused head against the chunked one, with
  ``--dispatch`` and ``--remat``; ``{"metric": "moe_head_ab", "unit", "seq_len",
  "per_chip_batch", "dispatch", "fused", "fused_mfu", "chunked",
  "chunked_mfu", "fused_over_chunked", "card", "power_limit_w"}``;
- ``--ab-dispatch`` (``:198-221``): the gather dispatch on the row kernels
  (side ``kernel``) against PyTorch's own gather and scatter (side
  ``library``, ``ops/moe_dispatch.library_route``, entered around each of
  that side's windows), over the whole step, with ``--fused-head`` and
  ``--remat``; ``{"metric": "moe_dispatch_ab", ..., "head", "kernel",
  "kernel_mfu", "library", "library_mfu", "kernel_over_library", ...}``.
  The library side stands where the reference's ``xla`` side stands: XLA's
  ``take_along_axis`` fallback (``_gather_ref``), forced by
  ``VMEM_ROW_BUDGET = 0``.
"""
from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.benchmarks import _cells, _timing
from kubeflow_tpu_torch.ops import moe_dispatch

BATCH, SEQ = _cells.MOE_BATCH, _cells.MOE_SEQ
N_SHORT, N_LONG, REPEATS = 3, 13, 5


def _args(argv):
    ap = argparse.ArgumentParser(prog="moe_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--dispatch", choices=("gather", "einsum", "a2a"), default="gather")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--fused-head", action="store_true")
    ab = ap.add_mutually_exclusive_group()
    ab.add_argument("--ab", action="store_true",
                    help="fused against chunked head, palindromic in-process A/B")
    ab.add_argument("--ab-dispatch", action="store_true",
                    help="the row kernels against PyTorch's gather, palindromic in-process A/B")
    return ap.parse_args(argv)


def ab_sides(args, cell: dict) -> dict:
    """The A/B mode's two cells, side A first, from one seed (one set of
    weights): ``--ab`` the fused and the chunked head; ``--ab-dispatch`` the
    gather dispatch twice (``kernel``, ``library``) through the head the
    flags name."""
    if args.ab_dispatch:
        head = "fused" if args.fused_head else "chunked"
        return {side: _cells.moe_train(head=head, dispatch="gather", remat=args.remat, **cell)
                for side in ("kernel", "library")}
    return {head: _cells.moe_train(head=head, dispatch=args.dispatch, remat=args.remat, **cell)
            for head in ("fused", "chunked")}


def _in_library_route(window):
    def run(n):
        with moe_dispatch.library_route():
            return window(n)

    return run


def _ab(args, cell, windows) -> dict:
    device = cell["device"]
    sides = ab_sides(args, cell)
    runs = {}
    for side, c in sides.items():
        window = _timing.step_window(c.bundle.step, c.bundle.init(), c.tokens, device)
        runs[side] = _in_library_route(window) if side == "library" else window
    secs, launches = _timing.ab_compare(runs, _cells.launch_counters(),
                                        *(windows or (N_SHORT, N_LONG, REPEATS)))
    print(json.dumps({"launches": launches}), flush=True)
    first = next(iter(sides.values()))
    batch, seq = first.tokens.shape
    line = {"metric": "moe_dispatch_ab" if args.ab_dispatch else "moe_head_ab",
            "unit": "tok/s/chip", "seq_len": seq, "per_chip_batch": batch}
    if args.ab_dispatch:
        line["head"] = "fused" if args.fused_head else "chunked"
    else:
        line["dispatch"] = args.dispatch
    for side in sides:
        tok_s = batch * seq / secs[side]
        line[side] = round(tok_s, 1)
        line[f"{side}_mfu"] = _timing.mfu(tok_s, first.flops_per_token, device)
    a, b = sides
    line[f"{a}_over_{b}"] = round(line[a] / line[b], 4)
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
    _timing.require_card(device, "moe_bench")
    if args.ab or args.ab_dispatch:
        return _ab(args, cell, windows)
    head = "fused" if args.fused_head else "chunked"
    c = _cells.moe_train(head=head, dispatch=args.dispatch, remat=args.remat, **cell)
    batch, seq = c.tokens.shape
    n_short, n_long, repeats = windows or (N_SHORT, N_LONG, REPEATS)
    window = _timing.step_window(c.bundle.step, c.bundle.init(), c.tokens, device)
    window(n_short)                              # build, allocate, warm
    sec, _, _ = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    tok_s = batch * seq / sec
    line = {
        "metric": "moe_train_tokens_per_sec_per_chip",
        "value": round(tok_s, 1),
        "unit": "tok/s/chip",
        "mfu": _timing.mfu(tok_s, c.flops_per_token, device),
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
