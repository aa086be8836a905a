"""What the width-512 flash pairs pay for their swap, on the card.

    python3 -m kubeflow_tpu_torch.benchmarks.pair_swap

At head width 512 the dq and dk/dv kernels of both routes (bf16 on the
tensor cores, fp32 on FMAs) and the fp32 forward run as clusters of two
blocks, each holding half of the head's columns, which swap their partial
score products through distributed shared memory every tile
(``csrc/flash_common.cuh``, the pair pieces). This builds copies of
``csrc/flash_attention_{fwd,bwd_dq,bwd_dkv}.cu`` whose ``pair_send``,
``pair_send_one``, ``pair_add`` and ``pair_release`` return at once: each
block keeps its own partials, so the outputs are wrong, but every product,
load, barrier and the cluster launch stay. It times the built kernels and
the copies in turns (kernel, copy, copy, kernel) at the heads-of-512
training shape (B4 S2048 H2 KV2 D512 causal, L2 warm), in bf16 (dq and
dk/dv; the bf16 forward is one block) and then fp32 (the forward too),
through the port's own wrappers, the copies' libraries swapped in, and
prints each ms: the difference is what the swap costs, its traffic and
each block's wait for the other. Exits with a message where there is no
card.
"""
from __future__ import annotations

import sys

NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the pair pieces' signature lines, each given a return ahead of its body
SKIPPED = ("int bytes, int at = 0) {", "uint32_t peer_at, float v) {",
           "int tid, int at = 0) {", "void pair_release(const Pair& pr) {")
B, S, H, D = 4, 2048, 2, 512


def skipped_swap_header(src: str) -> str:
    from kubeflow_tpu_torch.benchmarks import _patched

    for line in SKIPPED:
        src = _patched.edited(src, line, line + "\n  return;", "csrc/flash_common.cuh")
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pair_swap: no CUDA device; it times the kernels on the card", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.benchmarks import _patched, _timing
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    print(_timing.card(), flush=True)
    copies = _patched.build("pair_swap", NAMES, header="flash_common.cuh",
                            edit=skipped_swap_header)

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
            with _patched.swapped(copies if side == "without swap" else {}):
                dq = _timing.device_ms(lambda: pa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                                       flush_l2=False)
                dkv = _timing.device_ms(
                    lambda: pa.flash_attention_bwd_dkv(q, k, v, o, lse, do), flush_l2=False)
                fwd = ("" if tag == "bf16" else " forward " + format(_timing.device_ms(
                    lambda: pa.flash_attention(q, k, v, True, S, S), flush_l2=False), ".4f"))
            print(f"[pair swap] {tag} {side}: dq {dq:.4f} dk/dv {dkv:.4f}{fwd}", flush=True)
        del q, k, v, do, o, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
