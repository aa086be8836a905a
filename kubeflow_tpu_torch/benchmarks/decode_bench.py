"""Autoregressive decode benchmark on the card; counterpart of
``benchmarks/decode_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.decode_bench [--long | --cpu-smoke]

Default: ``generate`` on the decode flagship (``_cells.decode_model``: the
dense width with GQA 8/4, bf16, seeded weights), batch 4, prompt 128, 128
new tokens at temperature 0.8 and top-k 40; windows of 1 and 3 requests,
the minimum of each over the repeats, long minus short. One JSON line with
the reference's keys plus the card's name and power limit:

    {"metric": "decode_tokens_per_sec_per_row", "value": N, "unit":
     "tok/s/row", "batch_tok_per_sec": ..., "params_m": ..., "kv_heads": 4,
     "batch": 4, "prompt_len": 128, "new_tokens": 128, "card": ...,
     "power_limit_w": ...}

``--long``: the decode-only table of a fixed 16,640-slot cache: prefill ms
at live context 1k, 4k and 16k through the flash and the einsum (``xla``)
models, and ms a decode step over ``decode_steps`` of 32 steps from there.
A row that runs out of device memory is recorded with its error's name, as
the reference records it. One JSON line a row as it is measured, then the
table.

``--cpu-smoke``: the reference's small fp32 model with einsum attention,
on the CPU (the caller asks for it by this flag): the same window method,
a CPU number, its line naming the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.benchmarks import _cells, _timing

BATCH, PROMPT, NEW = _cells.BATCH, _cells.PROMPT, _cells.NEW
N_SHORT, N_LONG, REPEATS = 1, 3, 3
LONG_CACHE, LONG_POSITIONS, DECODE_N = 16640, (1024, 4096, 16384), 32


def _args(argv):
    ap = argparse.ArgumentParser(prog="decode_bench", description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--long", action="store_true", help="decode-only table of a 16k-class cache")
    mode.add_argument("--cpu-smoke", action="store_true", help="a small fp32 model on the CPU")
    return ap.parse_args(argv)


def _requests(model, prompt, device, new, windows):
    """Seconds a ``generate`` request of ``new`` tokens (temperature 0.8,
    top-k 40), long minus short windows of requests."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def window(n):
        t = time.perf_counter()
        for _ in range(n):
            kt.generate(model, prompt, max_new_tokens=new, temperature=_cells.TEMPERATURE,
                        top_k=_cells.TOP_K, generator=gen)
        _timing.sync(device)
        return time.perf_counter() - t

    n_short, n_long, repeats = windows
    window(n_short)                              # build, allocate, warm
    return _timing.min_window_step_seconds(window, n_short, n_long, repeats)[0]


def main(argv=None, *, cell=None, windows=None) -> dict:
    """Measure and print the line (the table's for ``--long``); ``cell``
    overrides the decode model's fields (``device="cpu"`` and small widths
    in the tests; for ``--long`` also ``cache`` and ``positions``),
    ``windows`` the (short, long, repeats) window counts."""
    args = _args(sys.argv[1:] if argv is None else argv)
    if args.long:
        return long_mode(cell=cell, windows=windows)
    if args.cpu_smoke:
        return cpu_smoke(windows=windows)
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    _timing.require_card(device, "decode_bench")
    cfg, model, prompt = _cells.decode_model(**cell)
    sec = _requests(model, prompt, device, NEW, windows or (N_SHORT, N_LONG, REPEATS))
    per_row = NEW / sec
    line = {
        "metric": "decode_tokens_per_sec_per_row",
        "value": round(per_row, 1),
        "unit": "tok/s/row",
        "batch_tok_per_sec": round(per_row * prompt.shape[0], 1),
        "params_m": round(sum(p.numel() for p in model.parameters()) / 1e6, 1),
        "kv_heads": cfg.kv_heads,
        "batch": prompt.shape[0],
        "prompt_len": prompt.shape[1],
        "new_tokens": NEW,
        **_timing.device_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


def long_mode(*, cell=None, windows=None) -> dict:
    cell = dict(cell or {})
    device = cell.setdefault("device", "cuda")
    _timing.require_card(device, "decode_bench --long")
    cache_len = cell.pop("cache", LONG_CACHE)
    positions = cell.pop("positions", LONG_POSITIONS)
    cfg, flash_model, _ = _cells.decode_model(max_seq_len=cache_len, **cell)
    xla_model = kt.TransformerLM(kt.decode_config(dataclasses.replace(cfg, attention_impl="xla")),
                                 device=device)
    xla_model.load_state_dict(flash_model.state_dict())
    n_short, n_long, repeats = windows or (1, 3, 3)
    rng = torch.Generator(device="cpu")
    rng.manual_seed(0)
    decode_rows, prefill_rows = [], []
    for pos in positions:
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, pos), generator=rng).to(device)
        for name, model in (("flash", flash_model), ("xla", xla_model)):
            row = {"impl": name, "pos": pos}
            try:
                def window(n):
                    t = time.perf_counter()
                    for _ in range(n):
                        kt.prefill(model, prompt)
                    _timing.sync(device)
                    return time.perf_counter() - t

                window(n_short)
                sec = _timing.min_window_step_seconds(window, n_short, n_long, repeats)[0]
                row.update(ms=round(sec * 1e3, 1), tok_per_sec=round(BATCH * pos / sec, 0))
            except torch.OutOfMemoryError as e:
                row.update(ms=None, note=type(e).__name__)
            prefill_rows.append(row)
            print(json.dumps(row), flush=True)
        for name, model in (("flash", flash_model), ("xla", xla_model)):
            row = {"impl": name, "seq": pos}
            try:
                cache, last = kt.prefill(flash_model, prompt)
                tok0 = last.argmax(-1)
                gen = torch.Generator(device=device)
                gen.manual_seed(0)

                def window(n):
                    t = time.perf_counter()
                    for _ in range(n):
                        kt.decode_steps(model, cache, tok0, pos, n=DECODE_N,
                                        temperature=_cells.TEMPERATURE, top_k=_cells.TOP_K,
                                        generator=gen)
                    _timing.sync(device)
                    return time.perf_counter() - t

                window(n_short)
                sec = _timing.min_window_step_seconds(window, n_short, n_long, repeats)[0]
                ms = sec / DECODE_N * 1e3
                row.update(ms=round(ms, 3), tok_per_sec_row=round(1e3 / ms, 1))
                del cache
            except torch.OutOfMemoryError as e:
                row.update(ms=None, note=type(e).__name__)
            decode_rows.append(row)
            print(json.dumps(row), flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    line = {
        "metric": "decode_only_ms_per_step_long_context",
        "cache_len": cache_len,
        "batch": BATCH,
        "decode_n_per_dispatch": DECODE_N,
        "results": decode_rows,
        "prefill": prefill_rows,
        **_timing.device_fields(device),
    }
    print(json.dumps(line), flush=True)
    return line


def cpu_smoke(*, windows=None) -> dict:
    """The reference's CPU-host decode number: a small fp32 model with
    einsum attention on the CPU."""
    batch, prompt_len, new = 2, 32, 32
    cfg = kt.TransformerConfig(vocab_size=1024, num_layers=2, num_heads=4, embed_dim=128,
                               mlp_dim=256, max_seq_len=256, num_kv_heads=2,
                               attention_impl="xla", dtype=torch.float32)
    model = kt.TransformerLM(kt.decode_config(cfg), device="cpu")
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cpu"))
    prompt = _cells._tokens(cfg.vocab_size, batch, prompt_len, "cpu")
    sec = _requests(model, prompt, "cpu", new, windows or (N_SHORT, N_LONG, REPEATS))
    line = {
        "metric": "decode_tokens_per_sec_per_row",
        "value": round(new / sec, 1),
        "unit": "tok/s/row",
        "impl": "cpu-smoke",
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new,
        **_timing.device_fields("cpu"),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
