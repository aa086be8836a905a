#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run with a non-zero exit:

1. build    compile every kernel in kubeflow_tpu_torch/csrc with nvcc for
            sm_90a, one nvcc per source, all started together;
2. kernels  hold each kernel against its plain PyTorch version on the card
            in bf16, at the serving path's shapes and at edge cases, and time
            kernel, plain version, one PyTorch library call as a yardstick,
            and the least time the card could take (bound);
3. generate run ``generate`` at the full flagship decode config (24 layers,
            GQA 8/4 heads, 410.3M parameters, seeded weights): batch 4, prompt 128, 128 new
            tokens, temperature 0.8, top_k 40, with every kernel launch
            counter set to 0 just before and read just after;
4. parity   the card's prefill logits against the same module on the CPU
            (plain versions, fp32 weights) at 2 layers of the same width.

The last lines are the card's name and power limit, one ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak

FLAGSHIP = dict(
    vocab_size=32_000, num_layers=24, num_heads=8, num_kv_heads=4,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, attention_impl="flash",
)
BATCH, PROMPT, NEW = 4, 128, 128
TEMPERATURE, TOP_K = 0.8, 40

# kernel checks, per element of the bf16 output:
#   |out - plain| <= OUT_RTOL * |plain| + OUT_ATOL_RMS * rms(plain)
# One bf16 step is at most 2^-7 of a value, and the kernel rounds its
# unnormalized probabilities to bf16 at the running row max where the plain
# version uses the final one; OUT_RTOL allows two steps. The absolute part
# follows each case's own output scale (rms ~0.036 at decode pos 2047), so it
# covers values near zero and still fails a kernel that drops part of the
# live range, which moves outputs by a sizeable fraction of their rms.
OUT_RTOL = 2.0 ** -6
OUT_ATOL_RMS = 0.05
LSE_ATOL = 1e-3               # fp32 throughout; differs only in summation order
# card (bf16 weights and activations) vs CPU (fp32) on the last prefill
# logits of a 2-layer model, logits std ~1: the card measured 0.0699 on an
# H100 in every run recorded in PERF.md; the limit is twice that.
PARITY_ATOL = 0.14


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(torch, fn, *, cold: bool, iters=30, warmup=3):
    """Mean device ms of one call of ``fn``, between CUDA events around it.

    The stream first runs a ~50 ms spin kernel while the host enqueues every
    timed call, so the events measure the device's work and not the host's
    launch rate. ``cold`` writes 128 MB before each call, flushing the 50 MB
    L2, as a decode step finds its layer's cache after the other layers ran;
    otherwise the inputs stay in L2 from the call before, as prefill's q, k, v
    come straight from the projections."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda") if cold else None
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def check_out(o, ref):
    """(ok, max abs error, worst |error| / tolerance, rms of ref) of a bf16
    kernel output against its plain version; ``ok`` also needs finite output."""
    o, ref = o.float(), ref.float()
    rms = ref.pow(2).mean().sqrt().item()
    err = (o - ref).abs()
    ratio = (err / (OUT_RTOL * ref.abs() + OUT_ATOL_RMS * rms)).max().item()
    ok = bool(o.isfinite().all()) and ratio <= 1.0
    return ok, err.max().item(), ratio, rms


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernels built in {time.perf_counter() - t0:.2f} s "
        f"with {_build.nvcc()}")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return libs


def phase_kernels(torch):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from kubeflow_tpu_torch.ops.pallas_attention import (
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(bf16)

    results = {}

    # ---- flash_attention_fwd: prefill
    worst = 0.0
    cases = [
        # name, B, S, H, KV, D, causal, window, block
        ("prefill_flagship", BATCH, PROMPT, 8, 4, 128, True, None, 128),
        ("windowed", BATCH, PROMPT, 8, 4, 128, True, 48, 128),
        ("gqa_group_1", BATCH, PROMPT, 8, 8, 128, True, None, 128),
        ("ragged_s96_d64", 2, 96, 4, 2, 64, True, None, 96),
        ("noncausal_s96", 2, 96, 4, 2, 128, False, None, 96),
    ]
    for name, B, S, H, KV, D, causal, window, blk in cases:
        q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
        o, lse = flash_attention(q, k, v, causal, blk, blk, window, return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, err, ratio, rms = check_out(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        ok = ok and lse_err <= LSE_ATOL
        log(f"[kernels] flash_attention_fwd {name}: max_abs_err {err:.3e} "
            f"(rms {rms:.3e}, worst err/tol {ratio:.3f}; rtol {OUT_RTOL}, atol "
            f"{OUT_ATOL_RMS}*rms) lse_err {lse_err:.3e} (atol {LSE_ATOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version ({name})")
        worst = max(worst, err)

    B, S, H, KV, D = BATCH, PROMPT, 8, 4, 128
    q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = device_ms(torch, lambda: flash_attention(q, k, v, True, S, S), cold=False)
    plain_ms = device_ms(torch, lambda: flash_attention_plain(q, k, v, causal=True), cold=False)
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), cold=False)
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)
    flops = 4 * D * B * H * S * (S + 1) // 2
    bms, by = bound_ms(n_bytes, flops)
    results["flash_attention_fwd"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by,
    )
    log(f"[kernels] flash_attention_fwd B{B} S{S} H{H} KV{KV} D{D} causal, L2 warm: "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
        f"(scaled_dot_product_attention) bound_ms {bms:.5f} ({by}: "
        f"{n_bytes} B, {flops} FLOP)")

    # ---- flash_decode: every decode step
    B, G, R, D, L = BATCH, 4, 2, 128, FLAGSHIP["max_seq_len"]
    flagship = (B, G, R, D, L)
    worst = 0.0
    dec_cases = [(f"pos={p}", flagship, [p] * B, None) for p in (0, 127, 255, 256, 2047)]
    dec_cases += [("per_row_pos", flagship, [0, 255, 1024, 2047], None),
                  ("window_100", flagship, [5, 300, 1500, 2047], 100),
                  ("d64_r4", (2, 2, 4, 64, 512), [63, 500], None)]
    for name, (B, G, R, D, L), pos_list, window in dec_cases:
        kc, vc, qd = randn(B, G, L, D), randn(B, G, L, D), randn(B, G, R, D)
        kpos = torch.arange(L, device="cuda")
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        live = kpos[None, :] <= pos[:, None].long()
        if window is not None:
            live = live & (kpos[None, :] > pos[:, None].long() - window)
        live = live[:, None, :, None]
        # NaN in every dead slot: the kernel must never read one
        kg = torch.where(live, kc, torch.nan)
        vg = torch.where(live, vc, torch.nan)
        o = flash_decode(qd, kg, vg, pos, window=window)
        torch.cuda.synchronize()
        o_ref = flash_decode_plain(qd, kg, vg, pos, window=window)
        torch.cuda.synchronize()
        ok, err, ratio, rms = check_out(o, o_ref)
        log(f"[kernels] flash_decode {name} window={window}: max_abs_err {err:.3e} "
            f"(rms {rms:.3e}, worst err/tol {ratio:.3f}; rtol {OUT_RTOL}, atol "
            f"{OUT_ATOL_RMS}*rms) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_decode disagrees with its plain version ({name})")
        worst = max(worst, err)

    # timed at the request's mean decode position: steps run at 128 .. 254
    B, G, R, D, L = flagship
    p_mean = PROMPT + (NEW - 2) // 2
    kc, vc, qd = randn(B, G, L, D), randn(B, G, L, D), randn(B, G, R, D)
    pos = torch.full((B,), p_mean, dtype=torch.int32, device="cuda")
    ms = device_ms(torch, lambda: flash_decode(qd, kc, vc, pos), cold=True)
    plain_ms = device_ms(torch, lambda: flash_decode_plain(qd, kc, vc, pos), cold=True)
    k_live, v_live = kc[:, :, :p_mean + 1], vc[:, :, :p_mean + 1]
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qd.view(B, G * R, 1, D), k_live, v_live, enable_gqa=True), cold=True)
    n_bytes = 2 * (2 * B * G * R * D) + 2 * (2 * B * G * (p_mean + 1) * D) + 4 * B
    flops = 4 * B * G * R * (p_mean + 1) * D
    bms, by = bound_ms(n_bytes, flops)
    results["flash_decode"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by,
    )
    log(f"[kernels] flash_decode B{B} G{G} R{R} D{D} L{L} pos {p_mean}, L2 flushed: "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
        f"(scaled_dot_product_attention) bound_ms {bms:.5f} ({by}: "
        f"{n_bytes} B, {flops} FLOP)")
    return results


def _profile(torch, fn, reps: int):
    """Device time of ``fn`` from a torch.profiler trace, per repetition:
    (busy ms, device events, [(kernel, ms), ...] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (sum(by_name.values()) / 1e3 / reps, n / reps,
            [(name[:80], us / 1e3 / reps) for name, us in top])


def phase_generate(torch, np):
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode
    from kubeflow_tpu_torch.ops.pallas_attention import flash_attention

    cfg = kt.TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    model = kt.TransformerLM(kt.decode_config(cfg), device="cuda")
    t0 = time.perf_counter()
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[generate] flagship: {cfg.num_layers} layers, {n_params / 1e6:.1f}M parameters "
        f"(bf16), seeded init in {time.perf_counter() - t0:.2f} s")
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    ).to("cuda")

    def gen(seed, n=NEW):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return kt.generate(model, prompt, max_new_tokens=n, temperature=TEMPERATURE,
                           top_k=TOP_K, generator=g)

    gen(1, 8)                                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    flash_attention.launches = 0
    flash_decode.launches = 0
    t0 = time.perf_counter()
    out = gen(0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (NEW - 1)}
    log(f"[generate] launches in one request: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    if tuple(out.shape) != (BATCH, PROMPT + NEW):
        raise AssertionError(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generate emitted an id outside the vocabulary")
    if not torch.equal(gen(0), out):
        raise AssertionError("generate is not reproducible under one generator seed")

    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, last = kt.prefill(model, prompt)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(last).all():
        raise AssertionError("prefill logits are not finite")
    prefill_ms = sorted(prefill_ms)[2]

    cache, last = kt.prefill(model, prompt)
    tok0 = last.argmax(-1)
    n_steps = 64
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kt.decode_steps(model, cache, tok0, PROMPT, n=n_steps, temperature=TEMPERATURE,
                    top_k=TOP_K, generator=g)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps

    # device idle share: profiled device time vs the unprofiled wall time
    # of the same work
    busy_dec, ev_dec, top_dec = _profile(torch, lambda: kt.decode_steps(
        model, cache, tok0, PROMPT, n=1, temperature=TEMPERATURE, top_k=TOP_K,
        generator=g), reps=16)
    busy_pf, ev_pf, top_pf = _profile(torch, lambda: kt.prefill(model, prompt), reps=3)

    def idle(busy, wall):
        return 1.0 - busy / wall if busy > 0 else None

    res = dict(
        params_m=n_params / 1e6, generate_s=gen_s, prefill_ms=prefill_ms,
        decode_ms_per_step=step_ms, tok_s=BATCH * NEW / gen_s,
        tok_s_per_row=NEW / gen_s,
        decode_device_busy_ms=busy_dec, decode_device_events=ev_dec,
        decode_idle_share=idle(busy_dec, step_ms), decode_top_kernels=top_dec,
        prefill_device_busy_ms=busy_pf, prefill_device_events=ev_pf,
        prefill_idle_share=idle(busy_pf, prefill_ms), prefill_top_kernels=top_pf,
        launches=launches,
    )
    log(f"[generate] request B{BATCH} P{PROMPT} +{NEW} (T={TEMPERATURE}, top_k={TOP_K}): "
        f"{gen_s * 1e3:.1f} ms, {res['tok_s']:.1f} tok/s ({res['tok_s_per_row']:.1f} "
        f"tok/s/row); prefill {prefill_ms:.2f} ms; decode {step_ms:.3f} ms/step")
    for what, busy, ev, wall, top in (("decode step", busy_dec, ev_dec, step_ms, top_dec),
                                      ("prefill", busy_pf, ev_pf, prefill_ms, top_pf)):
        share = idle(busy, wall)
        log(f"[generate] {what}: device busy {busy:.3f} ms of {wall:.3f} ms, "
            f"{ev:.0f} device events, idle share "
            + (f"{share:.3f}" if share is not None else "not measured (no device time in the trace)"))
        for name, ms in top:
            log(f"[generate]   {ms:8.4f} ms  {name}")
    return res


def phase_parity(torch, np):
    import kubeflow_tpu_torch as kt

    cfg = kt.TransformerConfig(**dict(FLAGSHIP, num_layers=2), dtype=torch.bfloat16)
    sd = kt.init_state_dict(cfg, seed=1, device="cpu")
    card = kt.TransformerLM(kt.decode_config(cfg), device="cuda")
    card.load_state_dict(sd)
    cpu = kt.TransformerLM(
        kt.decode_config(dataclasses.replace(cfg, dtype=torch.float32)), device="cpu")
    cpu.load_state_dict(sd)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT)))
    _, got = kt.prefill(card, prompt)
    _, want = kt.prefill(cpu, prompt)
    got = got.cpu()
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[parity] 2-layer flagship width, last prefill logits card(bf16) vs "
        f"cpu(fp32): max_abs_err {err:.4f} (atol {PARITY_ATOL}; logits std "
        f"{want.std().item():.3f}), argmax agreement {agree:.2f}")
    if not torch.isfinite(got).all() or err > PARITY_ATOL:
        raise AssertionError(f"card prefill disagrees with the CPU: {err}")
    return dict(max_abs_err=err, argmax_agreement=agree)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kubeflow_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False

    report = {"card": smi}
    t_all = time.perf_counter()
    phase_build()
    kernels = phase_kernels(torch)
    gen = phase_generate(torch, np)
    report["parity"] = phase_parity(torch, np)
    report.update(kernels=kernels, generate=gen, seconds=time.perf_counter() - t_all)

    replaces = {
        "flash_attention_fwd": "kubeflow_tpu/ops/pallas_attention.py:160",
        "flash_decode": "kubeflow_tpu/ops/flash_decode.py:53",
    }
    line = {"kernels": [
        dict(name=name, route="cuda", source=f"kubeflow_tpu_torch/csrc/{name}.cu",
             replaces=replaces[name], launches=gen["launches"][name], **kernels[name])
        for name in replaces
    ]}
    for k in line["kernels"]:
        log(f"[kernel] {k['name']}: max_abs_err {k['max_abs_err']:.3e} kernel_ms "
            f"{k['ms']:.4f} plain_ms {k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
            f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']}) launches/request {k['launches']}")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
