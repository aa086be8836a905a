"""What the width-512 flash dq and dk/dv pairs pay for their swap, on the card.

    python3 -m kubeflow_tpu_torch.benchmarks.pair_swap

At head width 512 the dq and dk/dv kernels of both routes (bf16 on the
tensor cores, fp32 on FMAs) run as clusters of two blocks, each holding
half of the head's columns, which swap their partial score products
through distributed shared memory every tile (``csrc/flash_common.cuh``,
the pair pieces). This builds copies of
``csrc/flash_attention_bwd_{dq,dkv}.cu`` whose ``pair_send``,
``pair_send_one``, ``pair_add`` and ``pair_release`` return at once: each
block keeps its own partials, so the gradients are wrong, but every
product, load, barrier and the cluster launch stay. It times the built
kernels and the copies in turns (kernel, copy, copy, kernel) at the
heads-of-512 training shape (B4 S2048 H2 KV2 D512 causal, L2 warm), in
bf16 and then fp32, through the port's own wrappers, the copies'
libraries swapped in, and prints each ms: the difference is what the
swap costs, its traffic and each block's wait for the other. Exits with
a message where there is no card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

NAMES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the pair pieces' signature lines, each given a return ahead of its body
SKIPPED = ("int bytes, int at = 0) {", "uint32_t peer_at, float v) {",
           "int tid, int at = 0) {", "void pair_release(const Pair& pr) {")
B, S, H, D = 4, 2048, 2, 512


def skipped_swap_header(src: str) -> str:
    for line in SKIPPED:
        if src.count(line) != 1:
            raise RuntimeError(f"csrc/flash_common.cuh has no single line {line!r}")
        src = src.replace(line, line + "\n  return;")
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pair_swap: no CUDA device; it times the kernels on the card", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.benchmarks import _timing
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    print(_timing.card(), flush=True)
    build = _build.BUILD_DIR / "pair_swap"
    build.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        text = f.read_text()
        (build / f.name).write_text(skipped_swap_header(text) if f.name == "flash_common.cuh"
                                    else text)
    procs = {}
    for name in NAMES:
        (build / f"{name}.cu").write_text((_build.CSRC / f"{name}.cu").read_text())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(build / f"lib{name}.so"),
             str(build / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    copies = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} without the swap did not build:\n{out[-3000:]}")
        lib = ctypes.CDLL(str(build / f"lib{name}.so"))
        symbol, argtypes = _build.SIGNATURES[name]
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        copies[name] = lib
    kernels = {name: _build.load(name) for name in NAMES}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    for tag in ("bf16", "fp32"):
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = pa.flash_attention(q, k, v, True, S, S, return_lse=True)
        print(f"[pair swap] B{B} S{S} H{H} KV{H} D{D} causal {tag}, L2 warm, ms a launch:",
              flush=True)
        for side in ("kernel", "without swap", "without swap", "kernel"):
            for name in NAMES:
                _build._LIBS[name] = kernels[name] if side == "kernel" else copies[name]
            dq = _timing.device_ms(lambda: pa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                                   flush_l2=False)
            dkv = _timing.device_ms(lambda: pa.flash_attention_bwd_dkv(q, k, v, o, lse, do),
                                    flush_l2=False)
            print(f"[pair swap] {tag} {side}: dq {dq:.4f} dk/dv {dkv:.4f}", flush=True)
        for name in NAMES:
            _build._LIBS[name] = kernels[name]
        del q, k, v, do, o, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
