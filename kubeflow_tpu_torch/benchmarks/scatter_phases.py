"""Where the accumulating MoE scatter's time goes, on the card.

    python3 -m kubeflow_tpu_torch.benchmarks.scatter_phases

Builds a copy of ``csrc/moe_scatter.cu`` in which thread 0 of every block
stamps ``%globaltimer`` at the kernel's phase boundaries into a
``__device__`` array, launches it on the MoE training flagship's dispatch
backward (B 4, J 5120 slots, R 2049 rows, M 1024, bf16; indices from the
port's own routing with expert 0 favoured, as ``chip_smoke.py`` builds
them), checks it bit for bit against ``scatter_replay``, and prints, for
each stamp, the microseconds after the first block's start (min, median,
max over the blocks that reached it) after an L2 flush, as
``chip_smoke.py``'s ``device_ms`` runs the kernel cold. A stamp costs one
global store a block.

Stamps: start; index pass done (a tile's sources sorted and published);
tiles done (a block's tiles written); segment start (a heavy row's segment
taken; the last one a block took); combine start and end (a heavy row's
column slice). Exits with a message where there is no card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

MARKS = [  # (text the stamp goes before, stamp)
    ("  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {", 0),
    ("    // rows with no source: zeros", 1),
    ("  // heavy rows' work items, as they are published", 2),
    ("      // a segment: its sources summed in j order", 3),
    ("      // a combine slice: the row's partials", 4),
]
AFTER = [  # (text the stamp goes after, stamp)
    ("      if (c < M) out[((size_t)hb * R + hr) * M + c] = acc;", 5),
]
NAMES = ["start", "index pass done", "tiles done", "segment start", "combine start",
         "combine end"]
STAMP = """
__device__ unsigned long long g_stamp[6][8192];
#define STAMP(e) if (threadIdx.x == 0 && blockIdx.x < 8192) \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_stamp[e][blockIdx.x]));
"""
READ = """
extern "C" int stamp_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
extern "C" int stamp_clear() {
  static unsigned long long z[6][8192];
  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
}
"""


def instrumented_source(src: str) -> str:
    for text, e in MARKS:
        if text not in src:
            raise RuntimeError(f"csrc/moe_scatter.cu has no line {text!r} to stamp")
        src = src.replace(text, f"  STAMP({e});\n" + text, 1)
    for text, e in AFTER:
        if text not in src:
            raise RuntimeError(f"csrc/moe_scatter.cu has no line {text!r} to stamp")
        src = src.replace(text, text + f"\n      STAMP({e});", 1)
    return src.replace("namespace {\n", "namespace {\n" + STAMP, 1) + READ


# the MoE training flagship's dispatch backward (benchmarks/moe_bench.py:54-56,
# 74-94: batch 4 of 2048 tokens, 8 experts, top-2, capacity factor 1.25, E 1024)
B, S, M, E, K, CAPACITY_FACTOR = 4, 2048, 1024, 8, 2, 1.25


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scatter_phases: no CUDA device; it times the kernel on the card", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.models import moe
    from kubeflow_tpu_torch.ops import _build, _workspace
    from kubeflow_tpu_torch.ops import moe_dispatch as md

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else torch.cuda.get_device_name(0), flush=True)
    build = _build.BUILD_DIR / "scatter_phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "moe_scatter_stamped.cu"
    src.write_text(instrumented_source((_build.CSRC / "moe_scatter.cu").read_text()))
    lib_path = build / "libmoe_scatter_stamped.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    symbol, argtypes = _build.SIGNATURES["moe_scatter"]
    launch = getattr(lib, symbol)
    launch.argtypes, launch.restype = argtypes, ctypes.c_int

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    C = int(CAPACITY_FACTOR * S * K / E)
    logits = torch.randn((B, S, E), generator=gen, device="cuda")
    logits[..., 0] += 1.0
    slot_token, _ = moe.slot_indices(moe.route_top_k(logits, K, C), E, C, S)
    idx = slot_token.int().contiguous()
    R, J = S + 1, E * C
    dy = torch.randn((B, J, M), generator=gen, device="cuda").to(torch.bfloat16)
    item_max, n_ws, n_tickets = md._scatter_sizes(B, J, M)
    stream = torch.cuda.current_stream().cuda_stream
    ws, tickets = _workspace.workspace(dy.device, stream, n_ws, n_tickets)
    out = torch.empty((B, R, M), device="cuda")

    def call():
        rc = launch(dy.data_ptr(), idx.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    tickets.data_ptr(), B, J, R, M, 1, 1, item_max, stream)
        if rc:
            raise RuntimeError(f"stamped moe_scatter launch failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    if not torch.equal(out, md.scatter_replay(idx, dy, R)):
        raise AssertionError("the stamped kernel disagrees with scatter_replay")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    print(f"[scatter phases] moe_scatter accumulate B{B} J{J} R{R} M{M} bf16 (bit-equal to "
          f"scatter_replay), L2 flushed before each of 3 launches, us after the first "
          f"block's start:")
    for run in range(3):
        flush.zero_()
        torch.cuda.synchronize()
        lib.stamp_clear()
        call()
        torch.cuda.synchronize()
        host = np.zeros((6, 8192), np.uint64)
        lib.stamp_read(host.ctypes.data_as(ctypes.c_void_p))
        t0 = host[0][host[0] > 0].min()
        for e, name in enumerate(NAMES):
            v = host[e][host[e] > 0]
            if len(v):
                d = (v - t0) / 1e3
                print(f"[scatter phases] launch {run} {name:16s} blocks {len(v):4d}: min "
                      f"{d.min():7.2f} median {np.median(d):7.2f} max {d.max():7.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
