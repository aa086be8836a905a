"""What flash-decode's combine costs, and flash-decode against another
checkout's kernel, on the card.

    python3 -m kubeflow_tpu_torch.benchmarks.decode_combine [--against NAME=DIR ...]

Builds two copies of ``csrc/flash_decode.cu`` and ``flash_decode_512.cu``
from edited ``csrc/flash_decode.cuh`` (``_patched``): "one level", whose
``FOLD_RUNS`` holds every row, so that the last block of a row combines
all of its live runs' partials alone (the width-512 workspace combine
without groups), and
"without the combine", whose workspace combine returns at once (every
load, score, partial store and ticket stays; the output is never written;
the cluster route's combine stays). Each
``--against NAME=DIR`` adds the kernels and the wrapper
(``ops/flash_decode.py``, its own plan) of another checkout of the port,
``DIR`` its root (a parent unpacked by ``git archive`` into a git-ignored
directory, say).

It runs the heads-of-512 decode flagship's cache (B4 G1 R2 L2048, width
512: 64 bf16 or 128 fp32 runs a row through the workspace) and a 256-slot
one (16 runs, a cluster: its pos 2047 reads the whole cache), heads of 256
(B4 G4 R2 L2048, 32 or 64 runs) and the serving flagship (B4 G4 R2 D128
L2048, a cluster of 16 in bf16), at positions 191 and 2047 and in bf16 and
fp32, through the port's wrapper with each copy's libraries swapped in.
For each case it prints each side's output against ``flash_decode_plain``
(worst err/tol under ``chip_smoke.py``'s bound of the operands' dtype) and
whether it is bitwise equal to this checkout's kernel, then each side's
device ms a launch, the sides in turns and back (a palindrome), with the
L2 flushed before each call and then warm, and the combine's share (the
kernel against "without the combine"). Exits with a message where there is
no card.
"""
from __future__ import annotations

import argparse
import sys

HEADER = "flash_decode.cuh"
NAMES = ("flash_decode", "flash_decode_512")
ONE_LEVEL = ("constexpr int FOLD_RUNS = 32;", "constexpr int FOLD_RUNS = 1 << 30;")
NO_COMBINE = ("                                        int stride, int cnt, bool fold) {",
              "                                        int stride, int cnt, bool fold) {\n  return;")
CASES = (  # (B, G, R, D, L)
    (4, 1, 2, 512, 2048),
    (4, 1, 2, 512, 256),     # width 512 on the cluster route (16 runs)
    (4, 4, 2, 256, 2048),
    (4, 4, 2, 128, 2048),
)
POSITIONS = (191, 2047)
# chip_smoke.py's kernel bounds: rtol, atol as a multiple of the rms
BOUND = {2: (2.0 ** -6, 0.05), 4: (2.0 ** -13, 2.0 ** -13)}


def one_level(src: str) -> str:
    """``csrc/flash_decode.cuh`` whose workspace combine takes every live
    run of a row in one block."""
    return _edited(src, *ONE_LEVEL)


def without_combine(src: str) -> str:
    """``csrc/flash_decode.cuh`` whose workspace combine returns at once."""
    return _edited(src, *NO_COMBINE)


def _edited(src, old, new):
    from kubeflow_tpu_torch.benchmarks import _patched

    return _patched.edited(src, old, new, f"csrc/{HEADER}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="also time the kernels of the checkout rooted at DIR, as NAME")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_combine: no CUDA device; it times the kernel on the card", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.benchmarks import _patched, _timing
    from kubeflow_tpu_torch.ops import flash_decode as fd

    print(_timing.card(), flush=True)
    # (label, libraries swapped in, wrapper module)
    sides = [("kernel", {}, fd),
             ("one level", _patched.build("decode_one_level", NAMES, header=HEADER,
                                          edit=one_level), fd),
             ("without the combine", _patched.build("decode_no_combine", NAMES, header=HEADER,
                                                    edit=without_combine), fd)]
    for i, spec in enumerate(args.against):
        name, root = spec.split("=", 1)
        libs = _patched.build(f"decode_against_{i}", NAMES,
                              csrc=f"{root}/kubeflow_tpu_torch/csrc")
        sides.append((name, libs, _patched.wrapper_module(
            root, "kubeflow_tpu_torch/ops/flash_decode.py", f"_decode_against_{i}")))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    for B, G, R, D, L in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, G, R, D), generator=gen, device="cuda").to(dtype)
            kc, vc = (torch.randn((B, G, L, D), generator=gen, device="cuda").to(dtype)
                      for _ in range(2))
            plan = fd._plan(B, G, R, L, D, dtype, torch.cuda.get_device_properties(0)
                            .multi_processor_count)
            rtol, atol = BOUND[dtype.itemsize]
            for p in POSITIONS:
                pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
                tag = (f"[decode combine] D{D} B{B} G{G} R{R} L{L} {str(dtype)[6:]} pos {p} "
                       f"(split {plan.split} x {plan.splits}, "
                       f"{'cluster' if plan.cluster else 'workspace'} combine)")
                ref = fd.flash_decode_plain(q, kc, vc, pos).float()
                rms = ref.pow(2).mean().sqrt()
                mine = None
                for label, libs, mod in sides:
                    with _patched.swapped(libs):
                        o = mod.flash_decode(q, kc, vc, pos)
                    if label == "without the combine":
                        continue
                    mine = o if mine is None else mine
                    ratio = ((o.float() - ref).abs() / (rtol * ref.abs() + atol * rms)).max()
                    print(f"{tag} {label}: vs flash_decode_plain worst err/tol "
                          f"{ratio.item():.3f} (rtol {rtol}, atol {atol}*rms); bitwise equal to "
                          f"the kernel: {torch.equal(o, mine)}", flush=True)
                for flush in (True, False):
                    ms = {}
                    for label, libs, mod in sides + sides[::-1]:
                        with _patched.swapped(libs):
                            ms.setdefault(label, []).append(_timing.device_ms(
                                lambda: mod.flash_decode(q, kc, vc, pos), flush_l2=flush))
                    whole, cut = (sum(ms[k]) / 2 for k in ("kernel", "without the combine"))
                    print(f"{tag}, L2 {'flushed' if flush else 'warm'}, ms a launch: "
                          + "; ".join(f"{label} " + ", ".join(f"{t:.4f}" for t in ts)
                                      for label, ts in ms.items())
                          + f"; the combine {whole - cut:.4f} ms, {(whole - cut) / whole:.1%} "
                          f"of the kernel", flush=True)
            del q, kc, vc
    return 0


if __name__ == "__main__":
    sys.exit(main())
