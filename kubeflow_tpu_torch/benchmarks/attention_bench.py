"""Attention shootout across sequence lengths on the card; counterpart of
``benchmarks/attention_bench.py``.

    python3 -m kubeflow_tpu_torch.benchmarks.attention_bench

The forward and backward time of each attention path at B2 H8 D128, bf16,
causal, S in (2048, 8192, 16384, 32768), block ``min(1024, S // 4)``: the
loss is the sum of the fp32 output, differentiated in q, k and v. The impls:

- ``naive``: ``ops/attention.naive_attention``, the materialised [S, S]
  scores (the reference's ``xla``);
- ``block``: ``blockwise_attention``, streaming over key blocks in fp32,
  each block recomputed in the backward;
- ``flash``: ``ops/pallas_attention.flash_attention``, the forward, dq and
  dk/dv kernels on the card;
- ``library``: ``torch.nn.functional.scaled_dot_product_attention`` on the
  same tensors, the yardstick no path of the port calls.

Every impl is tried at every length, with no skip decided in advance: on the
card an out-of-memory failure is a result (``ms: null, note:
"OutOfMemoryError"``), and any other exception fails the run, as every
exception does on the CPU. Timing: the reference's windows (``windows_for``)
and repeats, the minimum of each window length, long minus short, each
window closed by a synchronize. Prints a line a case, ``{"impl", "seq",
"ms"}``, then ``{"metric": "attention_fwd_bwd_ms", "results": [...],
"card", "power_limit_w"}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.benchmarks import _timing
from kubeflow_tpu_torch.ops import attention
from kubeflow_tpu_torch.ops import pallas_attention

B, H, D = 2, 8, 128
SEQS = (2048, 8192, 16384, 32768)
REPEATS = 8


def windows_for(seq: int) -> tuple[int, int]:
    """Short and long window sizes: short steps need more iterations for
    the difference to rise above the host's noise."""
    if seq <= 2048:
        return 20, 120
    if seq <= 8192:
        return 5, 25
    return 3, 13


def block_for(seq: int) -> int:
    return min(1024, seq // 4)


def _library(q, k, v):
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=True)
    return o.transpose(1, 2)


def impls(block: int) -> dict:
    """Each impl as ``fn(q, k, v)`` on [B, S, H, D], causal."""
    return {
        "naive": lambda q, k, v: attention.naive_attention(q, k, v, causal=True),
        "block": lambda q, k, v: attention.blockwise_attention(q, k, v, causal=True,
                                                               block_size=block),
        "flash": lambda q, k, v: pallas_attention.flash_attention(q, k, v, True, block, block),
        "library": _library,
    }


def inputs(seq: int, device, *, seed: int = 0, dtype=torch.bfloat16):
    """Seeded standard-normal q, k, v [B, seq, H, D] made on ``device``
    (the same for one seed and length, whatever ran before)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn((B, seq, H, D), generator=gen, device=device).to(dtype)
            for _ in range(3)]


def fwd_bwd(fn, q, k, v):
    """(output, (dq, dk, dv)) of the bench's loss, ``sum(fn(q, k, v))`` in fp32."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = fn(q, k, v)
        grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    return o.detach(), grads


def measure(fn, q, k, v, seq, device, windows=None) -> float:
    """Seconds of one forward + backward."""
    n_short, n_long, repeats = windows or (*windows_for(seq), REPEATS)

    def window(n):
        t = time.perf_counter()
        for _ in range(n):
            fwd_bwd(fn, q, k, v)
        _timing.sync(device)
        return time.perf_counter() - t

    window(n_short)                              # build, allocate, warm
    sec, _, _ = _timing.min_window_step_seconds(window, n_short, n_long, repeats)
    return sec


def run_case(name: str, seq: int, timed, device) -> dict:
    """``{"impl", "seq", "ms"}`` of ``timed()``'s seconds; on the card an
    out-of-memory failure gives ``ms`` None and its note, after the failed
    case's tensors are released."""
    catch = (torch.cuda.OutOfMemoryError,) if torch.device(device).type == "cuda" else ()
    note = None
    try:
        ms = round(timed() * 1000, 2)
    except catch as e:
        note = type(e).__name__
    if note is None:
        return {"impl": name, "seq": seq, "ms": ms}
    # the traceback held the failed frames' [S, S] tensors until here
    gc.collect()
    torch.cuda.empty_cache()
    return {"impl": name, "seq": seq, "ms": None, "note": note}


def main(argv=None, *, device="cuda", seqs=SEQS, windows=None) -> dict:
    """Time every impl at every length and print the lines; ``device="cpu"``,
    short ``seqs`` and ``windows`` (short, long, repeats) for the tests."""
    argparse.ArgumentParser(prog="attention_bench", description=__doc__.split("\n")[0]).parse_args(
        sys.argv[1:] if argv is None else argv)
    _timing.require_card(device, "attention_bench")
    results = []
    for seq in seqs:
        q, k, v = inputs(seq, device)
        for name, fn in impls(block_for(seq)).items():
            results.append(run_case(name, seq, lambda: measure(fn, q, k, v, seq, device, windows),
                                    device))
            print(json.dumps(results[-1]), flush=True)
        del q, k, v
    line = {"metric": "attention_fwd_bwd_ms", "results": results, **_timing.device_fields(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
