#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run with a non-zero exit:

1. build    compile every kernel in kubeflow_tpu_torch/csrc with nvcc for
            sm_90a, one nvcc per source, all started together;
2. kernels  hold each kernel against its plain PyTorch version on the card
            in bf16, at the main paths' shapes and at edge cases, and time
            kernel, plain version, one PyTorch library call as a yardstick,
            and the least time the card could take (bound); the forward and
            the two backward kernels also at the training shape;
3. generate run ``generate`` at the full flagship decode config (24 layers,
            GQA 8/4 heads, 410.3M parameters, seeded weights): batch 4, prompt 128, 128 new
            tokens, temperature 0.8, top_k 40, with every kernel launch
            counter set to 0 just before and read just after;
4. parity   the card's prefill logits against the same module on the CPU
            (plain versions, fp32 weights) at 2 layers of the same width;
5. train    ``make_lm_train_step`` on the full flagship training config (24
            layers, 8 heads, 435.5M fp32 parameters, seeded weights) with
            ``adamw_lowmem`` and the chunked loss: one warm-up step, then 5
            steps on one batch [4, 2048] with the launch counters set to 0
            just before and read just after;
6. train parity  one step's loss and global gradient norm on the card (bf16)
            against the CPU (fp32) at 2 layers of the flagship width.

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

# the training flagship: benchmarks/transformer_bench.py:85-118 (no GQA,
# attention block 1024, no remat at seq 2048), AdamW as there (:118), the
# chunked loss with chunk 1024 (:58)
TRAIN = dict(
    vocab_size=32_000, num_layers=24, num_heads=8, embed_dim=1024, mlp_dim=4096,
    max_seq_len=2048, attention_impl="flash", attention_block_size=1024,
)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK, TRAIN_STEPS = 4, 2048, 1024, 5

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
# one train step at 2 layers of the training width, B2 S256, card (bf16
# activations) vs CPU (fp32): on an H100 the loss (~10.95) differed by
# 0.00083 and the global gradient norm by 6.75e-5 of itself, the inputs and
# the kernels being deterministic; the limits are about 2.5x and 3x those.
TRAIN_LOSS_ATOL = 0.002
TRAIN_GNORM_RTOL = 2e-4


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


def causal_pairs(B, H, Sq, Sk):
    """(query, key) pairs a causal mask keeps: the work of one causal matmul
    is 2 * D FLOP per pair."""
    return B * H * sum(min(q + 1, Sk) for q in range(Sq))


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
        # the training path's shape: 32 key tiles of online-softmax rescale
        ("train_flagship", TRAIN_BATCH, TRAIN_SEQ, 8, 8, 128, True, None, 1024),
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


def phase_kernels_bwd(torch):
    """The backward kernels against the plain backward, and the forward and
    both backward kernels timed at the training shape."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import pallas_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(bf16)

    S_T, H_T, D_T = TRAIN_SEQ, TRAIN["num_heads"], TRAIN["embed_dim"] // TRAIN["num_heads"]
    worst = {"dq": 0.0, "dkv": 0.0}
    cases = [
        # name, B, S, H, KV, D, causal, window, grad_dtype
        ("train_flagship", TRAIN_BATCH, S_T, H_T, H_T, D_T, True, None, None),
        ("gqa_8_4", BATCH, 256, 8, 4, 128, True, None, None),
        ("window_48", BATCH, 256, 8, 4, 128, True, 48, None),
        ("window_100", BATCH, 256, 8, 4, 128, True, 100, None),
        ("ragged_s96_d64", 2, 96, 4, 2, 64, True, None, None),
        ("noncausal_s96", 2, 96, 4, 2, 128, False, None, None),
        ("gqa_8_4_fp32_grads", BATCH, 256, 8, 4, 128, True, 100, torch.float32),
    ]
    for name, B, S, H, KV, D, causal, window, gd in cases:
        q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
        o, lse = pa.flash_attention(q, k, v, causal, S, S, window, return_lse=True)
        kw = dict(causal=causal, window=window, grad_dtype=gd)
        got = (pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
               *pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))
        torch.cuda.synchronize()
        want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            ok, err, ratio, rms = check_out(g, w)
            ok = ok and g.dtype == w.dtype
            log(f"[kernels] flash_attention_bwd {name} {grad} ({g.dtype}): max_abs_err "
                f"{err:.3e} (rms {rms:.3e}, worst err/tol {ratio:.3f}; rtol {OUT_RTOL}, "
                f"atol {OUT_ATOL_RMS}*rms) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd {grad} disagrees with the plain backward ({name})")
            key = "dq" if grad == "dq" else "dkv"
            worst[key] = max(worst[key], err)

    # timed at the training shape, L2 warm (q, k, v, o and do come straight
    # from the layer's forward and the backward of its output projection)
    B, S, H, D = TRAIN_BATCH, S_T, H_T, D_T
    q, k, v, do = randn(B, S, H, D), randn(B, S, H, D), randn(B, S, H, D), randn(B, S, H, D)
    o, lse = pa.flash_attention(q, k, v, True, S, S, return_lse=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_lib = do.transpose(1, 2).contiguous()
    times = dict(
        fwd=device_ms(torch, lambda: pa.flash_attention(q, k, v, True, S, S), cold=False),
        fwd_plain=device_ms(torch, lambda: pa.flash_attention_plain(q, k, v), cold=False),
        fwd_lib=device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=True), cold=False),
        dq=device_ms(torch, lambda: pa.flash_attention_bwd_dq(q, k, v, o, lse, do), cold=False),
        dkv=device_ms(torch, lambda: pa.flash_attention_bwd_dkv(q, k, v, o, lse, do), cold=False),
        bwd_plain=device_ms(torch, lambda: pa.flash_attention_backward_plain(
            q, k, v, o, lse, do), cold=False, iters=10),
        bwd_lib=device_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do_lib, retain_graph=True), cold=False),
    )
    pairs = causal_pairs(B, H, S, S)
    operand = 2 * B * S * H * D                      # one bf16 [B, S, H, D] tensor
    lse_bytes = 4 * B * H * S
    fwd_b, fwd_f = bound_ms(3 * operand + operand + lse_bytes, 2 * 2 * D * pairs)
    dq_b, dq_f = bound_ms(5 * operand + lse_bytes + operand, 3 * 2 * D * pairs)
    dkv_b, dkv_f = bound_ms(5 * operand + lse_bytes + 2 * operand, 4 * 2 * D * pairs)
    log(f"[kernels] training shape B{B} S{S} H{H} KV{H} D{D} causal, L2 warm "
        f"({pairs} causal (q, k) pairs per matmul):")
    log(f"[kernels]   flash_attention_fwd kernel_ms {times['fwd']:.4f} plain_ms "
        f"{times['fwd_plain']:.4f} library_ms {times['fwd_lib']:.4f} bound_ms {fwd_b:.5f} ({fwd_f})")
    log(f"[kernels]   flash_attention_bwd_dq kernel_ms {times['dq']:.4f} bound_ms {dq_b:.5f} ({dq_f})")
    log(f"[kernels]   flash_attention_bwd_dkv kernel_ms {times['dkv']:.4f} bound_ms {dkv_b:.5f} ({dkv_f})")
    log(f"[kernels]   plain backward (dq, dk, dv together) {times['bwd_plain']:.4f} ms; "
        f"library: scaled_dot_product_attention backward (dq, dk, dv together) "
        f"{times['bwd_lib']:.4f} ms")
    results = {
        "flash_attention_bwd_dq": dict(
            max_abs_err=worst["dq"], ms=times["dq"], plain_ms=times["bwd_plain"],
            library_ms=times["bwd_lib"], bound_ms=dq_b, bound_by=dq_f),
        "flash_attention_bwd_dkv": dict(
            max_abs_err=worst["dkv"], ms=times["dkv"], plain_ms=times["bwd_plain"],
            library_ms=times["bwd_lib"], bound_ms=dkv_b, bound_by=dkv_f),
    }
    fwd_train = dict(ms=times["fwd"], plain_ms=times["fwd_plain"], library_ms=times["fwd_lib"],
                     bound_ms=fwd_b, bound_by=fwd_f)
    return results, fwd_train


def _profile(torch, fn, reps: int, top: int = 8):
    """Device time of ``fn`` from a torch.profiler trace, per repetition:
    (busy ms, device events, [(kernel, ms), ...] largest first, the first
    ``top`` of them with their names cut to 80 characters)."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (sum(by_name.values()) / 1e3 / reps, n / reps,
            [(name if i >= top else name[:80], us / 1e3 / reps)
             for i, (name, us) in enumerate(ranked)])


def phase_generate(torch, np):
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode
    from kubeflow_tpu_torch.ops.pallas_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

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

    counters = {"flash_attention_fwd": flash_attention, "flash_decode": flash_decode,
                "flash_attention_bwd_dq": flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": flash_attention_bwd_dkv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = gen(0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    # serving runs under inference_mode: the forward kernel alone, never
    # the autograd Function, so no backward kernel launches
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (NEW - 1),
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
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
    top_dec, top_pf = top_dec[:8], top_pf[:8]

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


def phase_train(torch, np):
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    cfg = kt.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = kt.TransformerLM(cfg, device="cuda")
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("a training model must hold fp32 parameters")
    log(f"[train] flagship: {cfg.num_layers} layers, {n_params / 1e6:.1f}M fp32 parameters, "
        f"seeded init in {time.perf_counter() - t0:.2f} s")
    bundle = kt.make_lm_train_step(
        model, kt.adamw_lowmem(3e-4, b2=0.99, weight_decay=0.1), chunk=TRAIN_CHUNK)
    state = bundle.init()
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ).to("cuda")

    loss_log = []

    def step():
        _, metrics = bundle.step(state, tokens)
        loss_log.append(metrics["loss"])

    step()                                     # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (pa.flash_attention, pa.flash_attention_bwd_dq, pa.flash_attention_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    step_ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_attention_fwd": pa.flash_attention.launches,
                "flash_attention_bwd_dq": pa.flash_attention_bwd_dq.launches,
                "flash_attention_bwd_dkv": pa.flash_attention_bwd_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {name: cfg.num_layers * TRAIN_STEPS for name in launches}
    log(f"[train] launches in {TRAIN_STEPS} steps: {launches} (expected {want}: "
        f"{cfg.num_layers} of each a step)")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    losses = [x.item() for x in loss_log]
    log(f"[train] losses (warm-up, then the timed steps): {[round(x, 4) for x in losses]} "
        f"(ln V = {np.log(cfg.vocab_size):.4f})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    # tied head at flax's init scale: logits ~ N(0, 1), so ~ln V + 1/2
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln V")
    if not losses[-1] < losses[1] < losses[0]:
        raise AssertionError(f"the loss does not fall over the steps: {losses}")

    busy, events, ranked = _profile(torch, step, reps=1, top=12)
    top = ranked[:12]
    # device time by class of kernel: the hand-written kernels, cuBLAS and
    # CUTLASS GEMMs (bf16 projections and head; the loss backward's fp32
    # products), and PyTorch's elementwise, copy and reduction kernels
    classes: dict[str, float] = {}
    for name, ms in ranked:
        cls = ("flash kernels" if "flash_" in name else
               "GEMM" if any(t in name for t in ("gemm", "nvjet", "xmma")) else "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    med = float(np.median(step_ms))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    # transformer_bench.py:208-212: 6 P for the matmuls + 12 L E S / 2 for
    # the causal attention, fwd + bwd, per token
    flops_tok = 6 * n_params + 12 * cfg.num_layers * cfg.embed_dim * TRAIN_SEQ * 0.5
    mfu = tok_s * flops_tok / BF16_FLOPS_PER_S
    idle = 1.0 - busy / med if busy > 0 else None
    log(f"[train] step {med:.2f} ms median of {[round(x, 2) for x in step_ms]}; {tok_s:.1f} tok/s; "
        f"MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s ({flops_tok / 1e9:.3f} GFLOP/token); "
        f"peak memory {peak_gb:.2f} GB")
    log(f"[train] one step: device busy {busy:.2f} ms, {events:.0f} device events, idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured (no device time in the trace)"))
    log("[train]   by class: " + ", ".join(f"{cls} {ms:.3f} ms" for cls, ms in classes.items()))
    for name, ms in top:
        log(f"[train]   {ms:9.3f} ms  {name}")
    return dict(params_m=n_params / 1e6, losses=losses, step_ms=step_ms, step_ms_median=med,
                tok_s=tok_s, mfu=mfu, flops_per_token=flops_tok, peak_memory_gb=peak_gb,
                device_busy_ms=busy, device_events=events, idle_share=idle, top_kernels=top,
                device_ms_by_class=classes, launches=launches)


def phase_train_parity(torch, np):
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import optimizers as opt

    cfg = kt.TransformerConfig(**dict(TRAIN, num_layers=2), dtype=torch.bfloat16)
    sd = kt.init_state_dict(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)))
    got = {}
    for where, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = kt.TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where)
        model.load_state_dict(sd)
        norms = []
        sgd = opt.sgd(1e-3)

        def update(grads, state, params):
            norms.append(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)).item())
            return sgd.update(grads, state, params)

        bundle = kt.make_lm_train_step(
            model, opt.GradientTransformation(sgd.init, update), chunk=TRAIN_CHUNK)
        _, metrics = bundle.step(bundle.init(), tokens.to(where))
        got[where] = (metrics["loss"].item(), norms[0])
    (loss_c, norm_c), (loss_h, norm_h) = got["cuda"], got["cpu"]
    d_loss, d_norm = abs(loss_c - loss_h), abs(norm_c - norm_h) / norm_h
    log(f"[train parity] 2-layer training width, B2 S256, one step card(bf16) vs cpu(fp32): "
        f"loss {loss_c:.5f} vs {loss_h:.5f} (|diff| {d_loss:.5f}, atol {TRAIN_LOSS_ATOL}); "
        f"grad norm {norm_c:.5f} vs {norm_h:.5f} (rel diff {d_norm:.2e}, rtol {TRAIN_GNORM_RTOL})")
    if not np.isfinite([loss_c, norm_c]).all() or d_loss > TRAIN_LOSS_ATOL or d_norm > TRAIN_GNORM_RTOL:
        raise AssertionError(f"card train step disagrees with the CPU: {got}")
    return dict(loss_card=loss_c, loss_cpu=loss_h, grad_norm_card=norm_c,
                grad_norm_cpu=norm_h, loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm)


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
    bwd, fwd_train = phase_kernels_bwd(torch)
    kernels.update(bwd)
    gen = phase_generate(torch, np)
    report["parity"] = phase_parity(torch, np)
    train = phase_train(torch, np)
    report["train_parity"] = phase_train_parity(torch, np)
    report.update(kernels=kernels, fwd_at_train_shape=fwd_train, generate=gen, train=train,
                  seconds=time.perf_counter() - t_all)

    # each kernel's launches come from the main path that drives it: the
    # forward and flash-decode from one generate request, the backward
    # kernels from the timed train steps
    replaces = {
        "flash_attention_fwd": ("kubeflow_tpu/ops/pallas_attention.py:160", gen),
        "flash_decode": ("kubeflow_tpu/ops/flash_decode.py:53", gen),
        "flash_attention_bwd_dq": ("kubeflow_tpu/ops/pallas_attention.py:290", train),
        "flash_attention_bwd_dkv": ("kubeflow_tpu/ops/pallas_attention.py:336", train),
    }
    line = {"kernels": [
        dict(name=name, route="cuda", source=f"kubeflow_tpu_torch/csrc/{name}.cu",
             replaces=where, launches=phase["launches"][name], **kernels[name])
        for name, (where, phase) in replaces.items()
    ]}
    for k in line["kernels"]:
        log(f"[kernel] {k['name']}: max_abs_err {k['max_abs_err']:.3e} kernel_ms "
            f"{k['ms']:.4f} plain_ms {k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
            f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']}) launches {k['launches']}")
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
