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
            the two backward kernels also at the training shape, with their
            TFLOP/s of the bound's work, and on their fp32 route (fp32 cases
            against the plain versions, TF32 off); every case under the bound
            of its operands' dtype (``out_bound``: bf16 operands, fp32
            gradients of bf16 operands among them, ``OUT_RTOL`` and
            ``OUT_ATOL_RMS``; fp32 operands the tighter ``OUT_RTOL_F32`` and
            ``OUT_ATOL_RMS_F32``); flash-decode also in fp32,
            at 12 and 16 query heads a group, at positions on and around the
            edges of its per-row runs and a window across one, each against
            its own order of operations (``_split_reference``) too, two
            launches bitwise equal, timed at the request's mean position
            (191) and at the full 2,048-token cache; the forward, dq and
            dk/dv also at head sizes 16, 32 and 96 and flash-decode at 16,
            32, 96 and 100 (bf16 and fp32, run padded to 64 or 128), and
            head sizes of 513 and 640 refused with their limits; the build phase counts
            the tensor-core instructions (HGMMA) of the flash libraries, the
            fused head's forward, dh and dE libraries and the fused BN +
            ReLU + 1x1-conv backward, which the bf16 flash forward, dq and
            dk/dv, the head's three kernels and that backward must have (the
            width-256 forward, dq and dk/dv in their own entry functions),
            and prints those three's registers and spills (none allowed) and
            any wgmma serialisation note, and the fp32 FMA kernels'
            (``flash_fwd_fma``, ``flash_dq_fma`` and ``flash_dkv_fma`` at
            every width, ``head_fwd_fma``; no spills allowed); the fp32
            routes are timed beside the library on fp32 operands (TF32 off,
            its kernels named) and their bound at the fp32 peak, the flash
            forward beside its plain version, each of the three beside the
            first scalar kernel's time, two launches of each bitwise equal;
            more fp32 cases of the forward and of dq and dk/dv (the training
            shape among them) after the timings;
2b. wide heads  the flash forward, dq and dk/dv at head sizes 160, 192 and
            256 (run at width 256: bf16 on the tensor-core route, dk/dv on
            its two-warpgroup kernel, fp32 on the FMA forward, dq and
            dk/dv, any other
            route failing the run; causal, windowed, non-causal, GQA, MQA
            8/1, ragged, rows that see no key, the shapes of phase 5b's
            train step and prefill) and flash-decode at 160, 192 and 256
            (positions 191 and 2047, a window, R 16), each against its plain
            version under the bounds above; each timed at D 256 with its
            bound, TFLOP/s, plain version and scaled_dot_product_attention,
            the timed inputs' outputs held against the plain versions too,
            the profile naming the width-256 kernels (dk/dv's at 160 and
            192 too); the fp32 forward, dq and dk/dv timed likewise at the
            heads-of-256 training shape (B4 S2048 H4), flash-decode in bf16
            and fp32; a ``generate`` request
            of a 2-layer model of heads of 256 (launches counted), and one
            train step of that model at each of 8 seeds against the CPU
            (loss, and the relative error of the whole gradient and of each
            parameter's);
2c. heads 512  the flash forward, dq and dk/dv and flash-decode at head
            width 512, in bf16 (the tensor-core kernels, two warpgroups each
            owning half of an accumulator's columns) and fp32 (the FMA
            kernels), dq and dk/dv on both routes and the fp32 forward a
            cluster of two blocks each owning a column half, each route and
            cluster required, the backward held against ``_pair_reference``
            and the fp32 forward against ``_pair_forward_reference`` too;
            each fp32 route's TF32 control (the plain version on operands
            rounded to TF32's mantissa) must fail the fp32 bound, at widths
            64, 128, 256 and 512 (``CONTROL_FLASH``, ``CONTROL_DECODE``): the heads-of-512
            training shape (B4 S2048 H2), the request's prefill (GQA 2/1), MQA 8/1, a
            window, ragged S with fp32 gradients, rows that see no key, D
            300 padded; decode at positions 191 and 2047, a window, R 16, a
            row with no live key on both combines, D 300. Each against its plain version
            under the bounds above, a second launch bitwise equal, decode
            against ``_split_reference`` too, the profile naming the
            width-512 kernels; each timed with its bound, plain version and
            scaled_dot_product_attention, whose backend is named (its flash
            backend stops at 256); the build phase prints each width-512
            instantiation's registers and spills and counts its tensor-core
            instructions (HGMMA in the bf16 kernels, HMMA in flash-decode's);
3. generate run ``generate`` at the full flagship decode config (24 layers,
            GQA 8/4 heads, 410.3M parameters, seeded weights): batch 4, prompt 128, 128 new
            tokens, temperature 0.8, top_k 40, with every kernel launch
            counter set to 0 just before and read just after;
4. parity   the card's prefill logits against the same module on the CPU
            (plain versions, fp32 weights) at 2 layers of the same width;
            then ``generate`` on a 2-layer fp32 flash model of that width
            (the fp32 prefill and flash-decode kernels, launches counted) and
            one decode step's logits against the CPU; then ``generate`` on a
            2-layer bf16 model of 4 heads of D 32 (launches counted) and an
            fp32 copy's decode step against the CPU;
5. train    ``make_lm_train_step`` on the full flagship training config (24
            layers, 8 heads, 435.5M fp32 parameters, seeded weights) with
            ``adamw_lowmem`` and the chunked loss: one warm-up step, then 5
            steps on one batch [4, 2048] with the launch counters set to 0
            just before and read just after;
5b. wide flagships  the training flagship at 4 heads of 256 (the same 24
            layers and 435.5M parameters) through one warm-up and 3 timed
            steps (flash 24/24/24 a step) and the decode flagship at GQA 4/2
            heads of 256 through one request (24 + 3,048 launches), each
            printed beside the flagship at 8 heads of 128 of phases 3 and 5:
            step ms, device busy, the flash kernels' share, peak memory,
            prefill and decode ms;
5c. heads-of-512 flagships  the training flagship at 2 heads of 512 (the
            same 24 layers and 435.5M parameters) through one warm-up and 3
            timed steps (flash 24/24/24 a step) and the decode flagship at
            GQA 2/1 heads of 512 through one request (24 + 3,048 launches),
            printed beside the flagships at heads of 128 and 256; then one
            train step of a 2-layer model of 2 heads of 512 over one KV head
            at E 1024 at seeds 8-15, card against CPU, under phase 2b's
            heads-of-256 bounds;
6. train parity  one step's loss and global gradient norm on the card (bf16,
            then fp32 through the flash kernels' fp32 route) against the CPU
            (fp32) at 2 layers of the flagship width; then the bf16 step at
            seeds 8-15, held by the relative L2 error of the whole gradient
            and of each parameter's (and the loss);
7. moe kernels  hold the MoE row gather and both modes of its scatter
            backward against their plain versions at the MoE flagship's four
            launch shapes (indices from the port's own routing) and at edge
            cases (all 4,096 sources on one row, R 1, J 5120 with 1,600 on
            one row among them), the accumulating scatter also bit for bit
            against its own order of operations (``scatter_replay``) and a
            second launch; show from profiles that a scatter call is one
            device kernel in each mode; time kernel, plain version, library
            call and bound, each launch apart;
8. moe train    ``make_lm_train_step`` on the full MoE training config (8
            layers, 8 experts, top-2, gather dispatch, 334.8M fp32 parameters,
            133.5M active a token) with ``adamw_lowmem`` and
            ``moe_lm_loss_chunked``: one warm-up step, then 5 steps on one batch
            [4, 2048] with every launch counter set to 0 just before and read
            just after;
9. moe train parity  one MoE step's loss, gradient norm and routing choices
            on the card (bf16) against the CPU (fp32) at 2 layers of the MoE
            flagship width; then at seeds 8-15 as phase 6, each step's
            routing choices held too;
10. head kernels  hold the fused tied head's forward, dh and dE kernels
            against their plain versions in bf16 at the MoE flagship's head
            shape (T 8192, V 32000, E 1024) and at edge cases (ragged T, V
            97, 40 and 50257, E 128 and 100, E 256 and 200 in two E chunks a
            forward tile over ranges of three tiles, targets outside [0, V) and in
            the last vocabulary tile, logits near +-80 (dh and dE there
            held to the exact sums of the route's own dlogits), each
            cotangent alone, E 768 and 2048 on clusters of 3 and 8 blocks,
            E 4096 in two passes), and on their fp32 route (E 1024, V 97, E
            100 and 99, E 768 on a cluster of 6, E 2048, 4096 and 8200 in
            2, 4 and 9 passes, T 300 with V 97 and targets outside [0, V),
            and the flagship shape); check that two forward, two dh and two
            dE launches agree bit for bit in bf16 and fp32, dh and dE also
            when launched while another stream's kernel (the fp32 dE at E
            128, one block on every SM) holds the card; print the forward's
            plan and ptxas lines and the fp32 dh and dE's; time kernel, plain
            version, library, bound and the fp32 route (with its plain
            versions, the forward beside the first scalar kernel's time),
            and the whole head forward + backward fused against chunked;
11. moe train fused  the MoE flagship of phase 8 through
            ``moe_lm_loss_fused`` (``moe_bench.py --fused-head``), with the
            head's three launch counters added;
12. moe train fused parity  phase 9 through ``moe_lm_loss_fused``, then
            the same step with fp32 activations and fp32 head operands on
            the card (the head's fp32 route) against the CPU's fp32 step,
            then the bf16 step at seeds 8-15 as phase 9;
13. bn kernels  hold the BatchNorm moments and grad-sums kernels against
            their plain versions at ResNet-50's 12 distinct activation shapes at batch
            256 and at edge cases (ragged row counts, C 3, 11, 100, fp32, a
            channel whose variance must clamp at 0), and the stats probe's
            scaled moments at its six batch-16 shapes with a multiplier of
            1.25; show from a profile that a moments call is one device
            kernel, and that two of its launches agree bit for bit; time
            kernel, plain version, library reductions and bound
            (L2 flushed), one train step's 53 launches summed, and the whole
            ``batch_norm_train`` forward + backward a shape; then run the
            stats probe's ``main()``;
14. bwd probe   hold the fused BN + ReLU + 1x1-conv backward kernel against
            its plain version at the probe's shape (N 802,816, CI 256, CO
            128; the activations read once) and four smaller ones (CO 256,
            the limit; two input-channel slices), check that CO 272 is
            refused before any launch and that two launches agree bit for
            bit, time kernel, plain version, the two library products and
            bound, and run the probe's ``main()``;
15. resnet train  ``make_classifier_train_step`` on ResNet-50 (1000 classes,
            bf16, 224x224, ``bn_impl="pallas"``, nesterov SGD 0.1/0.9, seeded
            weights): one warm-up step, then 5 steps on one batch of 256 with
            the launch counters set to 0 just before and read just after (53
            moments and 53 grad-sums launches a step); then, without the
            launch check, batch 16 and ``bn_impl`` ``"xla"`` and ``"mxu"`` at
            batch 256 (2 warm-up steps, 3 timed);
16. resnet train parity  one SGD step of a small ResNet on the card (bf16,
            through the kernels) against the CPU (fp32): loss, gradient norm
            and the running statistics after the step; then at seeds 8-15 as
            phase 6, the running statistics held too;
17. sharded  the sharded train steps (``parallel/train.py`` under a mesh)
            in a world of one rank (nccl, an in-memory store,
            ``MeshPlan()``): the dense flagship, the MoE flagship and
            ResNet-50 at batch 256 (BatchNorm statistics through the batch
            group), each against its ``mesh=None`` step on the same weights
            (every step's loss, the parameters and buffers after the last
            step, within ``SHARDED_ATOL``),
            the launch counts of the unsharded steps, both steps' ms; then
            the dense flagship's step with ``attention_impl="ring"`` on that
            mesh (one seq rank) against its flash step on the same weights:
            the first step's loss and gradient norm within the train parity
            bounds, flash launches 24/24/24 a step, a falling loss;
18. ring    ring attention (``parallel/ring_attention.py``) at the
            long-context shape (B1 S8192 H8 D128, bf16): the dq and dk/dv
            kernels on one 2048-row chunk with the global o and lse and
            fp32 gradients against the plain backward with the same lse;
            then the ring walked in one process over 4 and 2 virtual
            ranks, causal and non-causal (the module's own schedule, chunk
            functions and merge; at step r rank i holds chunk (i - r) mod
            n), its o, lse, dq, dk and dv held against the one-shot flash
            kernels on the whole sequence, its launches counted (n(n+1)/2 a
            kernel causal, n² non-causal), its device ms beside the
            one-shot kernels';
19. expert walk  one MoE flagship layer through the ``a2a`` path over two
            virtual expert ranks (each all-to-all the permutation it
            performs over the ranks' slabs) against the gather dispatch:
            output and gradients, gather and scatter launches;
19b. seq moe walk  the same MoE layer on the span route (``seq`` > 1 with
            ring attention: each rank one span of every row) over 4 and 2
            virtual seq ranks, each span routed with the scan over the
            ranks' choice counts and the whole row's capacity: the spans'
            plans bit-equal to the whole row's ``route_top_k``, output and
            gradients against the whole-row layer, gather and scatter
            launches per span, device ms of both;
20. tensor walk  one dense flagship block over two virtual tensor ranks
            (the tensor rule's parts, flash at 4 heads a rank, partials
            summed) against the unsplit block: output, every gradient,
            flash launches;
21. two ranks  the sharded train steps on tensor=2 (also with one KV head,
            which the rule leaves whole: the layer half split) and expert=2 (the a2a
            dispatch's real all-to-alls) and the pipeline on stage=2 (2
            microbatches, the hand-overs by all_to_all_single) in two
            processes on the card joined by gloo, at the flagship widths cut
            to 2 layers, fp32, against the one-device step (the pipeline's:
            unpipelined, the same full-logits loss): losses, the global
            gradient norm, each rank's launches;
22. pipeline  the dense training flagship through
            ``make_pipeline_train_step`` walked over 4 virtual stages with 4
            microbatches and over 2 with 2 (every stage in this process, the
            same tick loop as on ranks), against the unpipelined
            ``TransformerLM`` + ``lm_loss`` step on the same weights: the
            first step's loss and gradient norm within the dense card-vs-CPU
            bounds, flash launches a step 2·24·n_micro forward (the stage
            steps run again in the backward) and 24·n_micro dq and dk/dv, a
            falling loss, step ms, device busy ms, tok/s and peak memory of
            both, and the bubble real ranks would add (arithmetic);
23. dry run  ``python -m kubeflow_tpu_torch.graft_entry 1``: the reference
            dry run's sections at one rank on the card (nccl), the ResNet
            parities with one device included (the reference's ``train=False``
            forward, then the train step's), then ``entry()``'s ResNet-50
            forward;
24. session  the notebook's suspend and resume on the dense flagship of
            phase 5: six steps fed by ``DevicePrefetcher`` (synthetic tokens,
            the card, depth 2), each in ``step_annotation(n)``, flash
            launches 24/24/24 a step; ``CheckpointManager`` (2 kept, every
            2nd step) saves after steps 1-3, ``snapshot_for_suspend`` at
            step 4 returns 4; a cell from another seed resumes through
            ``resume_or_init``, bit-equal to the suspended state, and steps
            5 and 6 replayed on the same batches give the uninterrupted
            losses bit for bit; ``TorchDeviceBackend``'s bytes against the
            allocator's; ``TorchCompileMonitor``'s count of the build phase;
            in a fresh process (``session_traces_main``: after the earlier
            phases' many profiler sessions, a trace in this process lost
            every kernel its main thread launched), ``trace_n_steps`` (3
            steps: 72 device events of each flash kernel, the step regions)
            and a ``TorchTraceProfiler`` capture asked for from another
            thread while the main thread steps: it must run on the stepping
            thread (route "loop") and hold the flash kernels of its whole
            steps (24 each a step) and their step regions; the same through
            a ``TelemetryAgent``: a loop stepping only through
            ``agent.step()``, ``agent.capture(2)`` from another thread, route
            "loop", the trace's ``train#n`` regions a run of the agent's step
            numbers, the scrape's step total and ended steps the agent's; a world of one
            joined with ``"cpu:gloo,cuda:nccl"``,
            its mesh from ``spmd.build_mesh``, a sharded 2-layer step saved
            as DTensors and restored onto ``mesh=None`` bit-equal. Prints the
            bytes of a step on disk, the free disk, each step's and save's
            ms, the suspend's and the resume's;
25. bench entries  each of ``kubeflow_tpu_torch/benchmarks/{transformer,
            moe,decode,resnet}_bench.py`` once, in a subprocess, with few
            windows (decode with its own three repeats, the host-bound
            request's spread): its line's metric, a positive value, this card's name
            and power limit; then, each in a subprocess with the fewest
            windows, the A/B modes ``transformer_bench --ab-head``,
            ``moe_bench --ab`` and ``moe_bench --ab-dispatch`` (the
            reference's keys, positive rates and MFU, and each side's launches
            a step from the line before: flash 24/24/24 or 8/8/8, 24 gathers
            and 24 scatters a MoE step on the kernel sides, the fused head's
            1/1/1 on the fused sides, 24 + 24 library calls and no row
            kernel on the library side); ``resnet_bench --mfu --accelerator
            v5e --topology 1x1`` (the ``MFU_BENCH`` line on the card, a world
            of one); and the attention shootout, ``attention_bench``, at S
            2048 to 32768 (started as ``python3 -c`` through
            ``shootout_main``): flash, block and SDPA give a time at every
            length, naive at 2048 and 8192 (a time or the OOM note beyond),
            flash's launches equal its windows' iterations, and flash's
            output, lse and three gradients are held against their plain
            versions at every length (two (b, h) slices) under
            ``OUT_RTOL`` / ``OUT_ATOL_RMS``, with flash's and the plain
            versions' distance from block's printed beside them.

The last lines are the card's name and power limit, one ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores

# the flagship cells (decode, dense train, MoE train, ResNet-50 train) are
# built by the package's benchmarks/_cells.py, which the bench entry points
# build theirs from too
from kubeflow_tpu_torch.benchmarks import _cells as cells  # noqa: E402
from kubeflow_tpu_torch.benchmarks._cells import (  # noqa: E402
    BATCH, FLAGSHIP, MOE, MOE_BATCH, MOE_SEQ, NEW, PROMPT, RESNET, RESNET_BATCH, RESNET_IMAGE,
    TEMPERATURE, TOP_K, TRAIN, TRAIN_BATCH, TRAIN_CHUNK, TRAIN_SEQ,
)

TRAIN_STEPS, MOE_STEPS = 5, 5

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
# fp32 operands (the flash kernels' and flash-decode's fp32 routes): the
# kernel and the plain version both compute in fp32 and differ in summation
# order only. On an H100 80GB HBM3 (700 W) every fp32 case's largest error
# stayed under 2.5e-5 of its output's rms (err/tol below 0.0005 under the
# bf16 bound above); against 2^-14 of the value plus 2^-14 of the rms the
# worst case read 0.59 (dq at the heads-of-512 training shape, B4 S2048 D512
# causal) and the TF32 controls 20.6 to 79.2 (``fp32_bound_controls``: the
# plain versions on operands rounded to TF32's 10-bit mantissa). The bound
# is twice that, 2^-13 and 2^-13: about 3.4 times the worst sound reading,
# and every control above it about 10 times over, so a kernel whose products
# ran at TF32 or bf16 precision fails it.
OUT_RTOL_F32 = 2.0 ** -13
OUT_ATOL_RMS_F32 = 2.0 ** -13
LSE_ATOL = 1e-3               # fp32 throughout; differs only in summation order
# the first port's scalar flash kernels on this card (PERF.md's kernel table:
# H100 80GB HBM3, 700 W), printed beside this run's times
SCALAR_FLASH_MS = {"fwd_serving": 0.0428, "fwd_train": 3.1914, "dq_train": 3.5763,
                   "dkv_train": 3.2523}
# the fp32 routes' first scalar forwards on this card (PERF.md's kernel table,
# rows 1 and 5: H100 80GB HBM3, 700 W), printed beside the FMA kernels' times:
# the flash forward at the training shape, the fused head's at the MoE
# flagship's head shape
SCALAR_FP32_FWD_MS = {"flash_attention_fwd": 3.2493, "fused_head_fwd": 51.99}
# the fp32 route's first scalar dq and dk/dv at the training shape (PERF.md's
# kernel table, rows 2 and 3: H100 80GB HBM3, 700 W), printed beside the FMA
# kernels' times
SCALAR_FP32_BWD_MS = {"dq": 3.6041, "dkv": 3.2928}
# the first port's fp32 kernels at head width 512 (one block over all 512
# columns: the forward's 32-row, 16-key tiles, dq's and dk/dv's 16 and 16) at
# the heads-of-512 training shape (PERF.md's kernel table, rows 1-3: H100
# 80GB HBM3, 700 W), printed beside the pairs' times
FIRST_FP32_512_MS = {"fwd": 2.0368, "dq": 4.8490, "dkv": 3.9495}
# card (bf16 weights and activations) vs CPU (fp32) on the last prefill
# logits of a 2-layer model, logits std ~1: the card measured 0.0699 on an
# H100 in every run recorded in PERF.md; the limit is twice that.
PARITY_ATOL = 0.14
# generate() on a 2-layer fp32 flash model at the decode flagship's width
# (the fp32 prefill and flash-decode kernels), card vs CPU (plain versions):
# fp32 on both sides and TF32 off, so the logits of one decode step differ
# by summation order only (~1e-5 at logits std ~1); a wrong or missing
# attention row moves them by a sizeable fraction of their std
GEN_FP32_LAYERS, GEN_FP32_NEW = 2, 16
GEN_FP32_LOGITS_ATOL = 1e-3
# a small model of 4 heads of D 32 (the reference's own test width,
# tests/test_attention.py:16), which the kernels run padded to 64
SMALL_HEADS = dict(vocab_size=4096, num_layers=2, num_heads=4, embed_dim=128, mlp_dim=512,
                   max_seq_len=256, attention_impl="flash")
SMALL_HEADS_PROMPT, SMALL_HEADS_NEW = 64, 32
# one train step at 2 layers of the training width, B2 S256, card (bf16
# activations) vs CPU (fp32): on an H100 the loss (~10.95) differed by
# 0.00083 and the global gradient norm by 6.75e-5 of itself, the inputs and
# the kernels being deterministic; the limits are about 2.5x and 3x those.
TRAIN_LOSS_ATOL = 0.002
TRAIN_GNORM_RTOL = 2e-4
# the same step at heads of 256 (phase 2b's 2-layer E 512 model, 2 heads of
# 256) at seeds 8-15, PARITY_SEEDS: there the bf16 gradient norm's distance
# from fp32 is the noise of one bf16 step (0.3-5.1e-4 over these seeds on an
# H100, with the scalar flash kernels as with the tensor-core ones), so the
# bf16 step is held by the relative L2 error of the whole gradient and of
# each parameter's, which measured 1.66-1.72e-2 and at most 2.48e-2 (the
# second layer's query and key projections) with either route; the fp32 route
# measured 5.2-7.4e-5 and at most 8.35e-5, and is held to TRAIN_GNORM_RTOL
# too. The limits are about 1.2x those: an error of 2% of a projection's
# gradient, added to its bf16 noise, passes the per-parameter limit.
PARITY_SEEDS = range(8, 16)
WIDE_GRAD_RTOL = 2e-2
WIDE_PARAM_GRAD_RTOL = 3e-2
WIDE_FP32_GRAD_RTOL = 1e-4
# the seed-1 train steps' gradient norms (TRAIN_GNORM_RTOL, MOE_GNORM_RTOL,
# MOE_FUSED_GNORM_RTOL, RESNET_GNORM_RTOL) sit at the noise of one bf16
# step, so each of those models is also held at seeds 8-15 (PARITY_SEEDS),
# as the heads-of-256 step above: the relative L2 error, card (bf16) vs CPU
# (fp32), of the whole gradient and of each parameter's, each limit about
# 1.2x the worst of those seeds on an H100 80GB HBM3 (700 W), with the loss
# and the steps' other checks (MoE routing, ResNet statistics) at their
# seed-1 limits:
# phase 6's 2-layer training width: whole gradient 1.690-1.723e-2, worst
# parameter 2.530-2.577e-2 (the second layer's k or q projection), loss
# |diff| at most 1.31e-3
TRAIN_GRAD_RTOL = 2.1e-2
TRAIN_PARAM_GRAD_RTOL = 3.1e-2
# the 2-layer MoE width, chunked and fused head alike: whole gradient
# 2.497-4.615e-2, worst parameter 1.162-3.290e-1 (a router: the choices a
# bf16 step flips, 0.6-1.8%, move its gradient most), loss |diff| at most
# 6.14e-4
MOE_GRAD_RTOL = 5.6e-2
MOE_PARAM_GRAD_RTOL = 0.4
# the small ResNet (noise-limited in bf16, as its seed-1 check says): whole
# gradient 0.0983-0.1532, worst parameter 0.171-0.635 (a BatchNorm bias or
# the stem), running statistics at most 1.53e-3; its loss |diff| reached
# 3.54e-3, past the seed-1 limit, so the seeds hold it to RESNET_SEED_LOSS_ATOL
RESNET_GRAD_RTOL = 0.19
RESNET_PARAM_GRAD_RTOL = 0.77
RESNET_SEED_LOSS_ATOL = 4.3e-3
# MoE kernel checks: the gathers and the direct-store scatter copy rows, so
# they are bit-equal to their plain versions (the direct-store scatter on
# every row that one index hits; a row several hit is unspecified). The
# accumulating scatter sums a row's n sources in fp32, the kernel in its
# atomics' order and the plain version in its own: each is within
# (n - 1) * 2^-24 * sum|sources| of the exact sum (recursive summation), so
# they differ by at most n * 2^-23 * sum|sources|; a row of at most two
# sources is exact (0 + a + b).
MOE_ACC_EPS = 2.0 ** -23
# one MoE train step at 2 layers of the MoE width, B2 S256, card (bf16) vs CPU
# (fp32): on an H100 the loss (~10.875) differed by 0.00143, the global
# gradient norm by 1.27e-4 of itself, and 33 of the 2,048 routing choices
# (1.6%; bf16 activations flip near-ties); the limits are about 2.8x, 3x and
# 2.5x those
MOE_LOSS_ATOL = 0.004
MOE_GNORM_RTOL = 4e-4
MOE_FLIP_SHARE = 0.04         # routing choices that differ, of all choices
# fused head kernel checks: fp32 unit roundoff, and the one bf16 step
# (2^-8 of itself) a dlogit may land apart where p differs in its last fp32
# bits; the limits are the summation bounds of _check_head_case
HEAD_EPS = 2.0 ** -24
HEAD_DL_STEP = 2.0 ** -8
# one MoE train step through the fused head at 2 layers of the MoE width, B2
# S256, card (bf16) vs CPU (fp32): on an H100 the loss differed by 0.00143
# and the global gradient norm by 8.06e-5 of itself, with the same 33 routing
# flips as the chunked head; the limits are about 2.8x and 3x those
MOE_FUSED_LOSS_ATOL = 0.004
MOE_FUSED_GNORM_RTOL = 2.5e-4
# the same step with fp32 activations and fp32 head operands on the card
# (the head's fp32 route) against the CPU's fp32 step: on an H100 the
# loss and the global gradient norm came out equal at fp32 resolution (the
# dense fp32 step differs by 1.9e-6 and 6.2e-8 of itself); the limits leave
# room for summation order and stay far under the bf16 step's differences
MOE_FUSED_F32_LOSS_ATOL = 1e-4
MOE_FUSED_F32_GNORM_RTOL = 1e-5

# beside the ResNet-50 cell (batch 256, bn_impl="pallas"): bench.py's own
# batch of 16 a chip, without the launch check
RESNET_SMALL_BATCH, RESNET_STEPS = 16, 5
# reduction kernels (BatchNorm sums, the bwd probe's dW) against their plain
# versions: a sum taken as a tree or in blocks is within depth * 2^-24 *
# sum|terms| of the exact sum. Both versions sum in blocks (the kernels: a
# thread's run of rows, then fixed-order trees over lanes and blocks; PyTorch:
# its cascaded reductions and split GEMMs); 64 roundings between the two is
# several times what either needs at these sizes and far under what a dropped
# tile or row shows at the edge-case sizes.
SUM_DEPTH = 64
SUM_EPS = 2.0 ** -24
BF16_STEP = 2.0 ** -7         # the largest relative spacing of bf16 values
# one SGD step of ResNet [1, 1, 1, 1], width 16, 100 classes, batch 8 of 64x64,
# card (bf16 activations, the kernels) vs CPU (fp32, the plain versions): on
# an H100 the loss (~4.82) differed by 0.00056, the global gradient norm by
# 2.56e-3 of itself and the running means and variances after the step by at
# most 1.02e-3; the limits are about 3x those
RESNET_LOSS_ATOL = 0.002
RESNET_GNORM_RTOL = 8e-3
RESNET_STATS_ATOL = 3e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms(torch, fn, *, cold: bool, iters=30, warmup=3):
    """Mean device ms of one call of ``fn``, between CUDA events around it.

    This is the timer behind every number of the ``kernels`` line, and it
    lives in this script, outside the package it measures (the probes'
    ``main()`` have a timer of their own for what they print).

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


def out_bound(operands):
    """(rtol, atol as a multiple of the rms) of a kernel check, chosen by
    the dtype of the kernel's operands, never by its output's: fp32
    gradients of bf16 operands keep the bf16 bound."""
    return (OUT_RTOL_F32, OUT_ATOL_RMS_F32) if operands.itemsize == 4 else (OUT_RTOL, OUT_ATOL_RMS)


def bound_note(operands) -> str:
    rtol, atol = out_bound(operands)
    return f"rtol {rtol}, atol {atol}*rms"


def check_out(o, ref, operands):
    """(ok, max abs error, worst |error| / tolerance, rms of ref) of a
    kernel output against its plain version under the bound of its
    ``operands``' dtype (:func:`out_bound`); ``ok`` also needs finite
    output."""
    rtol, atol = out_bound(operands)
    o, ref = o.float(), ref.float()
    rms = ref.pow(2).mean().sqrt().item()
    err = (o - ref).abs()
    ratio = (err / (rtol * ref.abs() + atol * rms)).max().item()
    ok = bool(o.isfinite().all()) and ratio <= 1.0
    return ok, err.max().item(), ratio, rms


def check_lse(lse, ref):
    """(ok, max abs error over finite entries) of an lse against its plain
    version: +inf (a row that sees no key) exactly where the plain one is."""
    fin = ref.isfinite()
    same = bool(((lse == float("inf")) == ~fin).all())
    err = (lse[fin] - ref[fin]).abs().max().item() if bool(fin.any()) else 0.0
    return same and err <= LSE_ATOL, err


def check_dead_rows(o, lse_ref):
    """A row that sees no key gives exactly 0 (the port's contract)."""
    dead = ~lse_ref.isfinite()                       # [B, H, Sq]
    return bool((o.float().permute(0, 2, 1, 3)[dead] == 0).all())


def causal_pairs(B, H, Sq, Sk):
    """(query, key) pairs a causal mask keeps: the work of one causal matmul
    is 2 * D FLOP per pair."""
    return B * H * sum(min(q + 1, Sk) for q in range(Sq))


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build():
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = {}
    listener = seconds.__setitem__
    _build.add_listener(listener)
    try:
        libs = _build.build_all()
    finally:
        _build.remove_listener(listener)
    log(f"[build] {len(libs)} libraries built in {time.perf_counter() - t0:.2f} s "
        f"with {_build.nvcc()} (13 kernels: bn_moments.cu serves the BatchNorm moments and "
        f"the stats probe's scaled moments, flash_decode_512.cu flash-decode at width 512); "
        f"nvcc seconds a source, all started together: "
        + ", ".join(f"{name} {sec:.1f}" for name, sec in sorted(
            seconds.items(), key=lambda kv: -(kv[1] or 0)) if sec is not None))
    registers = {}
    for name in libs:
        entry = None
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split(chr(39))[1]
                log(f"[build] {name}: {entry[:90]}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")
                registers.setdefault(name, {}).setdefault(entry, []).append(line.strip())
    for name, kernel in (*WIDE_WGMMA.items(), *WGMMA_512.items()):
        lines = [ln for entry, got in registers.get(name, {}).items() if kernel[1] in entry
                 for ln in got]
        regs = re.search(r"Used (\d+) registers", " ".join(lines))
        spill = re.search(r"(\d+) bytes spill stores", " ".join(lines))
        if regs is None or spill is None:
            raise AssertionError(f"{name}: no ptxas report of {kernel[0]}")
        registers[kernel[0]] = dict(registers=int(regs[1]), spill_store_bytes=int(spill[1]))
        log(f"[build] {kernel[0]}: {regs[1]} registers, {spill[1]} bytes spill stores")
        for ln in _build.build_log(name).splitlines():
            if "C75" in ln:
                log(f"[build] {name}: {ln.strip()}")
        if int(spill[1]):
            raise AssertionError(f"{kernel[0]} spills {spill[1]} bytes")
    for name, fragment in FMA_KERNELS.items():
        lines = _entry_ptxas(_build.build_log(name), fragment)
        spills = [int(m[1]) for ln in lines for m in [re.search(r"(\d+) bytes spill stores", ln)]
                  if m]
        if not lines or not spills:
            raise AssertionError(f"{name}: no ptxas report of {fragment}")
        for ln in lines:
            log(f"[build] {fragment}: {ln[:160]}")
        registers[fragment] = lines
        if any(spills):
            raise AssertionError(f"{fragment} spills: {lines}")
    # the width-512 fp32 pairs by name (their spills are FMA_KERNELS' check)
    for name, (kernel, fragment) in FMA_512.items():
        lines = [ln for entry, got in registers.get(name, {}).items() if fragment in entry
                 for ln in got]
        regs = re.search(r"Used (\d+) registers", " ".join(lines))
        if regs is None:
            raise AssertionError(f"{name}: no ptxas report of {kernel}")
        log(f"[build] {kernel}: {regs[1]} registers")
    # every width-512 instantiation's registers and spill bytes (flash-decode's
    # fp32 FMA route holds 128 accumulators a thread there: its spills, if
    # any, are stated here, not refused)
    for name in WIDTH_512_ENTRIES:
        lines = _entry_ptxas(_build.build_log(name), "ILi512E")
        if not lines:
            raise AssertionError(f"{name}: no ptxas report of a width-512 instantiation")
        spill = sum(int(m[1]) for ln in lines for m in [re.search(r"(\d+) bytes spill stores", ln)]
                    if m)
        registers[f"{name} (width 512)"] = lines
        log(f"[build] {name} at width 512: {len(lines) // 2} instantiations, spill store bytes "
            f"{spill} in all")
    return libs, registers


# the fp32 kernels of register-tiled FMAs (every width's instantiation):
# library -> the fragment of their mangled names
FMA_KERNELS = {"flash_attention_fwd": "flash_fwd_fma", "flash_attention_bwd_dq": "flash_dq_fma",
               "flash_attention_bwd_dkv": "flash_dkv_fma", "fused_head_fwd": "head_fwd_fma"}


# the width-256 instantiations of the bf16 forward, dq and dk/dv: (name,
# the fragment of its mangled name)
WIDE_WGMMA = {"flash_attention_fwd": ("flash_fwd_wgmma<256, 1>", "flash_fwd_wgmmaILi256ELi1E"),
              "flash_attention_bwd_dq": ("flash_dq_wgmma<256, 1, 1>",
                                         "flash_dq_wgmmaILi256ELi1ELi1E"),
              "flash_attention_bwd_dkv": ("flash_dkv_wgmma_pair<256, 1>",
                                          "flash_dkv_wgmma_pairILi256ELi1E")}
DKV_PAIR = WIDE_WGMMA["flash_attention_bwd_dkv"][0]
# the width-512 bf16 kernels (name, the fragment of its mangled name): the
# forward's two warpgroups each owning half of O's columns; dq and dk/dv the
# width-256 kernels on each column half, a cluster of two blocks
WGMMA_512 = {
    "flash_attention_fwd": ("flash_fwd_wgmma_halves<512>", "flash_fwd_wgmma_halvesILi512E"),
    "flash_attention_bwd_dq": ("flash_dq_wgmma<512, 1, 2>", "flash_dq_wgmmaILi512ELi1ELi2E"),
    "flash_attention_bwd_dkv": ("flash_dkv_wgmma_pair<512, 2>",
                                "flash_dkv_wgmma_pairILi512ELi2E")}
# the width-512 fp32 forward, dq and dk/dv: the width-256 FMA kernels on each
# column half, a cluster of two blocks (name, the fragment of its mangled
# name)
FMA_512 = {"flash_attention_fwd": ("flash_fwd_fma<512, 64, 32, 2>",
                                   "flash_fwd_fmaILi512ELi64ELi32ELi2E"),
           "flash_attention_bwd_dq": ("flash_dq_fma<512, 32, 32, 2>",
                                      "flash_dq_fmaILi512ELi32ELi32ELi2E"),
           "flash_attention_bwd_dkv": ("flash_dkv_fma<512, 32, 32, 2>",
                                       "flash_dkv_fmaILi512ELi32ELi32ELi2E")}
# the libraries of the width-512 instantiations (their mangled names hold
# "ILi512E"): library -> the fragment of the entries whose tensor-core
# instructions are counted apart (the bf16 flash kernels' are WGMMA_512's)
WIDTH_512_ENTRIES = {"flash_attention_fwd": "flash_fwd_fmaILi512E",
                     "flash_attention_bwd_dq": "flash_dq_fmaILi512E",
                     "flash_attention_bwd_dkv": "flash_dkv_fmaILi512E",
                     "flash_decode_512": "flash_decode_splitILi512E"}


WGMMA_LIBS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "fused_head_fwd", "fused_head_bwd_dh", "fused_head_bwd_de",
              "fused_bn_relu_conv1x1_bwd")


def tensor_core_counts(libs):
    """Tensor-core instructions in each library whose bf16 route is a wgmma
    kernel: HGMMA (wgmma) and HMMA (mma.sync) in the SASS that ``cuobjdump``
    shows, or, without it, ``wgmma.mma_async`` and ``mma.sync`` in ``nvcc
    -ptx`` output. The bf16 route of the flash forward, dq and dk/dv, of
    the fused head's forward, dh and dE and the fused BN + ReLU + 1x1-conv
    backward must issue wgmma; the fp32 routes (the FMA kernels) none.
    The width-256 and width-512 forward, dq and dk/dv (``WIDE_WGMMA``,
    ``WGMMA_512``) must hold it in their own entry functions; with
    ``cuobjdump``, the fp32 kernels' width-512 entries must hold none and
    flash-decode's width-512 entries HMMA (its bf16 ``mma.sync`` route)."""
    from kubeflow_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")

    def sass(name):
        return subprocess.run([str(tool), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    counts, texts = {}, {}
    for name in WGMMA_LIBS:
        if tool.is_file():
            text = texts[name] = sass(name)
            counts[name] = {"HGMMA": text.count("HGMMA"), "HMMA": text.count("HMMA")}
        else:
            text = subprocess.run(
                [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-ptx",
                 "-o", "-", str(_build.CSRC / f"{name}.cu")],
                capture_output=True, text=True, check=True, timeout=300).stdout
            counts[name] = {"wgmma": text.count("wgmma.mma_async"), "mma": text.count("mma.sync")}
        log(f"[build] {name}: tensor-core instructions {counts[name]} "
            f"({'cuobjdump -sass' if tool.is_file() else 'nvcc -ptx'})")
        for table in (WIDE_WGMMA, WGMMA_512):
            if name not in table:
                continue
            # one section a function: SASS "Function : <name>", PTX ".entry <name>("
            kernel, mangled = table[name]
            body = "".join(part for part in re.split(r"Function : |\.entry ", text)[1:]
                           if mangled in part.split(None, 1)[0])
            counts[kernel] = {"HGMMA" if tool.is_file() else "wgmma":
                              body.count("HGMMA" if tool.is_file() else "wgmma.mma_async")}
            # by shape (SASS "HGMMA.64x64x16", PTX "m64n64k16"): the FLOPs a
            # block issues a tile, against its bound's, for the PR's notes
            shapes = re.findall(r"HGMMA\.(\d+x\d+x\d+)" if tool.is_file() else
                                r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)", body)
            counts[kernel]["shapes"] = {sh: shapes.count(sh) for sh in sorted(set(shapes))}
            log(f"[build] {kernel}: tensor-core instructions in its entry function {counts[kernel]}")
    if tool.is_file():
        # the width-512 variants' own entry functions: the bf16 kernels above
        # (HGMMA), the fp32 FMA kernels (none) and flash-decode's (HMMA on its
        # bf16 mma.sync route)
        for name, fragment in WIDTH_512_ENTRIES.items():
            text = texts.get(name) or sass(name)
            parts = [part for part in re.split(r"Function : ", text)[1:]
                     if fragment in part.split(None, 1)[0]]
            got = {"entries": len(parts), "HGMMA": sum(p.count("HGMMA") for p in parts),
                   "HMMA": sum(p.count("HMMA") for p in parts)}
            counts[f"{fragment} (width 512)"] = got
            log(f"[build] {fragment}: tensor-core instructions in its width-512 entries {got}")
            if not parts or (name == "flash_decode_512" and not got["HMMA"]) or (
                    name != "flash_decode_512" and got["HGMMA"]):
                raise AssertionError(f"{fragment}: width-512 entries {got}")
    for name in (*WGMMA_LIBS, *(k for k, _ in WIDE_WGMMA.values()),
                 *(k for k, _ in WGMMA_512.values())):
        if not counts[name].get("HGMMA", counts[name].get("wgmma")):
            raise AssertionError(f"{name} has no wgmma instruction: its bf16 route must use wgmma")
    return counts


def check_forward(torch, cases, randn, sms):
    """Each flash forward case (name, B, Sq, Sk, H, KV, D, causal, window,
    dtype) against the plain version: output, lse, and o = 0 where a row sees
    no key. Returns the worst bf16 max abs error."""
    from kubeflow_tpu_torch.ops.pallas_attention import _plan, flash_attention, flash_attention_plain

    worst = 0.0
    for name, B, Sq, Sk, H, KV, D, causal, window, dt in cases:
        q, k, v = (randn(*shape).to(dt) for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
        o, lse = flash_attention(q, k, v, causal, Sq, Sk, window, return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, err, ratio, rms = check_out(o, o_ref, dt)
        lse_ok, lse_err = check_lse(lse, lse_ref)
        dead_ok = check_dead_rows(o, lse_ref)
        ok = ok and lse_ok and dead_ok and o.dtype == dt
        plan = _plan("fwd", B, Sq, Sk, H, KV, D, dt, sms)
        log(f"[kernels] flash_attention_fwd {name} ({dt}; {plan.route}, {plan.block}-row tiles, "
            f"D {D} at width {plan.width}): "
            f"max_abs_err {err:.3e} "
            f"(rms {rms:.3e}, worst err/tol {ratio:.3f}; {bound_note(dt)}) lse_err "
            f"{lse_err:.3e} (atol {LSE_ATOL}; +inf rows "
            f"{int((~lse_ref.isfinite()).sum())}, o = 0 there: {dead_ok}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version ({name})")
        if dt == torch.bfloat16:
            worst = max(worst, err)
    return worst


def phase_kernels(torch):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.flash_decode import (
        _launch as _decode_launch,
        _plan as _decode_plan,
        _split_reference,
        flash_decode,
        flash_decode_plain,
    )
    from kubeflow_tpu_torch.ops.pallas_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(bf16)

    results = {}

    # ---- flash_attention_fwd: prefill
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        # name, B, Sq, Sk, H, KV, D, causal, window, dtype
        ("prefill_flagship", BATCH, PROMPT, PROMPT, 8, 4, 128, True, None, bf16),
        # the training path's shape: 32 key tiles of online-softmax rescale
        ("train_flagship", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 8, 8, 128, True, None, bf16),
        ("windowed", BATCH, PROMPT, PROMPT, 8, 4, 128, True, 48, bf16),
        ("gqa_group_1", BATCH, PROMPT, PROMPT, 8, 8, 128, True, None, bf16),
        ("ragged_s96_d64", 2, 96, 96, 4, 2, 64, True, None, bf16),
        ("noncausal_s96", 2, 96, 96, 4, 2, 128, False, None, bf16),
        # rows 9-15 see no key: o = 0 and lse = +inf
        ("causal_sq16_sk8_window2", 2, 16, 8, 4, 2, 128, True, 2, bf16),
        ("noncausal_sq64_sk192", 2, 64, 192, 4, 2, 128, False, None, bf16),
        # 9 x 8 x 2 = 144 blocks take 128-row tiles; the second is 72 rows
        ("s200_ragged_128_row_tile", 9, 200, 200, 8, 4, 128, True, None, bf16),
        ("mqa_8_1", 2, 256, 256, 8, 1, 128, True, None, bf16),
        ("b1_h16_kv8_window100", 1, 2048, 2048, 16, 8, 128, True, 100, bf16),
        ("window_1000_over_s256", 2, 256, 256, 8, 4, 128, True, 1000, bf16),
        # the fp32 route (flash_fwd_fma: 128-row tiles, 64-key tiles); more
        # fp32 cases after this phase's timings (``late``)
        ("fp32_prefill", BATCH, PROMPT, PROMPT, 8, 4, 128, True, None, f32),
        ("fp32_ragged_s96_d64_window", 2, 96, 96, 4, 2, 64, True, 48, f32),
        # rows 9-15 see no key: o = 0 and lse = +inf
        ("fp32_causal_sq16_sk8_window2", 2, 16, 8, 4, 2, 128, True, 2, f32),
        ("fp32_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 128, False, None, f32),
        # head sizes the kernels run zero-padded to 64 or 128
        ("d16_gqa_4_2", 2, 256, 256, 4, 2, 16, True, None, bf16),
        ("d32_window_48", 2, 256, 256, 4, 4, 32, True, 48, bf16),
        ("d96_train_tiles", 4, 1024, 1024, 8, 8, 96, True, None, bf16),
        ("d96_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 96, False, None, bf16),
        ("fp32_d16", 2, 128, 128, 4, 2, 16, True, None, f32),
        ("fp32_d32_window_48", 2, 256, 256, 4, 4, 32, True, 48, f32),
        ("fp32_d96", 2, 128, 128, 4, 2, 96, True, None, f32),
    ]
    # fp32 cases at larger shapes, held after the prefill and decode timings:
    # made before them, their allocations moved those latency-bound timings
    # (same kernels) by 2-4% on an H100
    late = [
        ("fp32_train_flagship", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 8, 8, 128, True, None, f32),
        ("fp32_s200_ragged_128_row_tile", 9, 200, 200, 8, 4, 128, True, None, f32),
        ("fp32_mqa_8_1", 2, 256, 256, 8, 1, 128, True, None, f32),
        ("fp32_b1_h16_kv8_window100", 1, 2048, 2048, 16, 8, 128, True, 100, f32),
    ]
    worst = check_forward(torch, cases, randn, sms)

    # a head size past 512 is a stated refusal on the card, never the plain
    # version: the forward at 513, dq and dk/dv at 640
    from kubeflow_tpu_torch.ops.pallas_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    for D, what, call in (
            (513, "flash_attention_fwd", lambda t, lse: flash_attention(t, t, t, True, 64, 64)),
            (640, "flash_attention_bwd_dq", lambda t, lse: flash_attention_bwd_dq(
                t, t, t, t, lse, t)),
            (640, "flash_attention_bwd_dkv", lambda t, lse: flash_attention_bwd_dkv(
                t, t, t, t, lse, t))):
        t = randn(1, 64, 2, D)
        try:
            call(t, torch.zeros(1, 2, 64, device="cuda"))
        except ValueError as e:
            if "head_dim up to 512" not in str(e) or "232,448" not in str(e):
                raise
            log(f"[kernels] {what} D {D} (bf16): refused: {e}")
        else:
            raise AssertionError(f"{what} ran at head_dim {D}")

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
        f"kernel_ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s of the bound's work; the first "
        f"scalar kernel {SCALAR_FLASH_MS['fwd_serving']}) plain_ms {plain_ms:.4f} library_ms "
        f"{lib_ms:.4f} (scaled_dot_product_attention) bound_ms {bms:.5f} ({by}: "
        f"{n_bytes} B, {flops} FLOP)")

    # ---- flash_decode: every decode step
    B, G, R, D, L = BATCH, 4, 2, 128, FLAGSHIP["max_seq_len"]
    flagship = (B, G, R, D, L)
    worst, worst_witness = 0.0, 0.0
    dec_cases = [(f"pos={p}", flagship, [p] * B, None, bf16)
                 for p in (0, 63, 64, 65, 127, 128, 129, 255, 256, 2047)]
    dec_cases += [("per_row_pos", flagship, [0, 255, 1024, 2047], None, bf16),
                  ("window_100", flagship, [5, 300, 1500, 2047], 100, bf16),
                  # the window's first key and pos in different splits of 128
                  ("window_across_split_edge", flagship, [130, 200, 1100, 2047], 100, bf16),
                  ("d64_r4", (2, 2, 4, 64, 512), [63, 500], None, bf16),
                  # more than 8 query heads a group: chunks of 8 on a grid axis
                  ("mqa_r16", (2, 1, 16, 128, 512), [100, 511], None, bf16),
                  ("r12_g2_d64_window_48", (2, 2, 12, 64, 512), [63, 500], 48, bf16),
                  ("pos_below_zero_l100", (2, 2, 2, 64, 100), [-1, 99], None, bf16),
                  # fp32 operands: probabilities kept in fp32, as the TPU kernel's astype
                  ("fp32_per_row_pos", flagship, [0, 255, 1024, 2047], None, f32),
                  ("fp32_window_100", flagship, [5, 300, 1500, 2047], 100, f32),
                  ("fp32_pos_63_64_65", flagship, [63, 64, 65, 2047], None, f32),
                  ("fp32_mqa_r16_window_48", (2, 1, 16, 128, 512), [100, 511], 48, f32),
                  ("fp32_r12_g2_d64", (2, 2, 12, 64, 512), [63, 500], None, f32),
                  # head sizes read in place and zero-filled up to 64 or 128 in
                  # shared memory: 16-byte pieces, and element loads at D 100
                  ("d16_r4", (2, 2, 4, 16, 512), [63, 500], None, bf16),
                  ("d32_window_100", (2, 4, 2, 32, 2048), [130, 2047], 100, bf16),
                  ("d96_per_row_pos", (4, 4, 2, 96, 2048), [0, 255, 1024, 2047], None, bf16),
                  ("d100_r16", (2, 1, 16, 100, 512), [100, 511], None, bf16),
                  ("fp32_d32", (2, 2, 4, 32, 512), [63, 500], None, f32),
                  ("fp32_d100_window_48", (2, 2, 2, 100, 512), [63, 500], 48, f32)]
    for name, (B, G, R, D, L), pos_list, window, dt in dec_cases:
        kc, vc, qd = (randn(*shape).to(dt) for shape in ((B, G, L, D), (B, G, L, D), (B, G, R, D)))
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
        plan = _decode_plan(B, G, R, L, D, dt, sms)
        o_split = _split_reference(qd, kg, vg, pos, window, plan)
        torch.cuda.synchronize()
        ok, err, ratio, rms = check_out(o, o_ref, dt)
        w_ratio = _decode_witness(torch, o, o_split, dt)
        ok = ok and o.dtype == dt and w_ratio <= 1.0
        log(f"[kernels] flash_decode {name} ({dt}, R {R}, D {D} at width {plan.width}) "
            f"window={window}: max_abs_err {err:.3e} "
            f"(rms {rms:.3e}, worst err/tol {ratio:.3f}; {bound_note(dt)}); vs "
            f"_split_reference (split {plan.split} x {plan.splits}) "
            f"worst err/tol {w_ratio:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_decode disagrees with its plain version ({name})")
        worst_witness = max(worst_witness, w_ratio)
        if dt == bf16:
            worst = max(worst, err)

    q640 = randn(1, 1, 2, 640)
    k640 = randn(1, 1, 64, 640)
    try:
        flash_decode(q640, k640, k640, torch.zeros(1, dtype=torch.int32, device="cuda"), block_k=64)
    except ValueError as e:
        if "head_dim up to 512" not in str(e):
            raise
        log(f"[kernels] flash_decode D 640 (bf16): refused: {e}")
    else:
        raise AssertionError("flash_decode ran at head_dim 640")

    # two launches on the same inputs give the same bits (the combine's order is fixed)
    B, G, R, D, L = flagship
    kc, vc, qd = randn(B, G, L, D), randn(B, G, L, D), randn(B, G, R, D)
    for pos_list in ([191] * B, [0, 700, 1500, 2047]):
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        o1, o2 = flash_decode(qd, kc, vc, pos), flash_decode(qd, kc, vc, pos)
        torch.cuda.synchronize()
        if not torch.equal(o1, o2):
            raise AssertionError(f"two flash_decode launches differ (pos {pos_list})")
    log("[kernels] flash_decode: two launches bitwise equal at pos 191 and at per-row pos")

    # the flagship's 16 splits combine through a cluster; the workspace and
    # ticket combine (batch 1, longer caches, fp32) on the same inputs
    plan = _decode_plan(B, G, R, L, D, bf16, sms)
    plan_ws = dataclasses.replace(plan, cluster=False)
    for pos_list in ([191] * B, [0, 700, 1500, 2047]):
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        o_cl = flash_decode(qd, kc, vc, pos)
        o_ws = _decode_launch(qd, kc, vc, pos, None, plan_ws)
        torch.cuda.synchronize()
        ok, err, ratio, _ = check_out(o_ws, flash_decode_plain(qd, kc, vc, pos), bf16)
        log(f"[kernels] flash_decode workspace combine at the flagship, pos {pos_list}: worst "
            f"err/tol {ratio:.3f}; bitwise equal to the cluster combine: "
            f"{torch.equal(o_cl, o_ws)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_decode's workspace combine disagrees (pos {pos_list})")

    # timed at the request's mean decode position (steps run at 128 .. 254)
    # and at the full 2,048-token cache
    p_mean = PROMPT + (NEW - 2) // 2
    timed = {}
    for p in (p_mean, L - 1):
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        ms = device_ms(torch, lambda: flash_decode(qd, kc, vc, pos), cold=True)
        # the two combines alternated: cluster (above), workspace, workspace, cluster
        ws_ms = [device_ms(torch, lambda: _decode_launch(qd, kc, vc, pos, None, plan_ws),
                           cold=True) for _ in range(2)]
        cl_ms = device_ms(torch, lambda: flash_decode(qd, kc, vc, pos), cold=True)
        plain_ms = device_ms(torch, lambda: flash_decode_plain(qd, kc, vc, pos), cold=True)
        k_live, v_live = kc[:, :, :p + 1], vc[:, :, :p + 1]
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qd.view(B, G * R, 1, D), k_live, v_live, enable_gqa=True), cold=True)
        n_bytes = 2 * (2 * B * G * R * D) + 2 * (2 * B * G * (p + 1) * D) + 4 * B
        flops = 4 * B * G * R * (p + 1) * D
        bms, by = bound_ms(n_bytes, flops)
        timed[p] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        workspace_combine_ms=sum(ws_ms) / 2)
        log(f"[kernels] flash_decode pos {p}, L2 flushed, combine through the cluster "
            f"{ms:.4f}, {cl_ms:.4f} ms; through the workspace {ws_ms[0]:.4f}, {ws_ms[1]:.4f} ms")
        log(f"[kernels] flash_decode B{B} G{G} R{R} D{D} L{L} pos {p}, L2 flushed (split "
            f"{plan.split} x {plan.splits}, grid {plan.grid}, {plan.smem_bytes} B shared memory a "
            f"block): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"(scaled_dot_product_attention) bound_ms {bms:.5f} ({by}: {n_bytes} B, {flops} FLOP)")
    # the fp32 route at the mean position (an fp32 decode_config model's step),
    # beside the library on the same fp32 operands and its bound (fp32 bytes)
    kf, vf, qf = kc.float(), vc.float(), qd.float()
    pos = torch.full((B,), p_mean, dtype=torch.int32, device="cuda")
    f32_ms = device_ms(torch, lambda: flash_decode(qf, kf, vf, pos), cold=True)
    kf_live, vf_live = kf[:, :, :p_mean + 1], vf[:, :, :p_mean + 1]
    f32_lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qf.view(B, G * R, 1, D), kf_live, vf_live, enable_gqa=True), cold=True)
    f32_bound = bound_ms(4 * (2 * B * G * R * D) + 4 * (2 * B * G * (p_mean + 1) * D) + 4 * B,
                         4 * B * G * R * (p_mean + 1) * D, FP32_FLOPS_PER_S)
    results["flash_decode"] = dict(
        max_abs_err=worst, **timed[p_mean], fp32_ms=f32_ms, fp32_library_ms=f32_lib_ms,
        fp32_bound_ms=f32_bound[0], fp32_bound_by=f32_bound[1], pos2047=timed[L - 1],
        split_witness_worst=worst_witness,
    )
    log(f"[kernels] flash_decode fp32 operands pos {p_mean}: kernel_ms {f32_ms:.4f} (split "
        f"{_decode_plan(B, G, R, L, D, f32, sms).split}) library_ms {f32_lib_ms:.4f} "
        f"(scaled_dot_product_attention on the fp32 operands) bound_ms {f32_bound[0]:.5f} "
        f"({f32_bound[1]}); worst err/tol against _split_reference over every case "
        f"{worst_witness:.3f}")
    check_forward(torch, late, randn, sms)
    return results


def _decode_witness(torch, o, o_split, operands):
    """Worst |error| / tolerance of the kernel against ``_split_reference``,
    its own order of operations in plain PyTorch: the two round the same
    probabilities against the same per-split maxima, so they differ only in
    fp32 summation order (a probability near a bf16 rounding edge may land
    one step apart) and in the final cast: bf16 operands within 2^-7·|ref| +
    2^-8·rms, fp32 operands within 2^-14·|ref| + 2^-14·rms."""
    rtol, atol = (2.0 ** -14, 2.0 ** -14) if operands == torch.float32 else (2.0 ** -7, 2.0 ** -8)
    o, ref = o.float(), o_split.float()
    rms = ref.pow(2).mean().sqrt().item()
    return ((o - ref).abs() / (rtol * ref.abs() + atol * rms + 1e-30)).max().item()


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
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"dq": 0.0, "dkv": 0.0}
    cases = [
        # name, B, Sq, Sk, H, KV, D, causal, window, grad_dtype, operand dtype
        ("train_flagship", TRAIN_BATCH, S_T, S_T, H_T, H_T, D_T, True, None, None, bf16),
        ("gqa_8_4", BATCH, 256, 256, 8, 4, 128, True, None, None, bf16),
        ("window_48", BATCH, 256, 256, 8, 4, 128, True, 48, None, bf16),
        ("window_100", BATCH, 256, 256, 8, 4, 128, True, 100, None, bf16),
        ("ragged_s96_d64", 2, 96, 96, 4, 2, 64, True, None, None, bf16),
        ("noncausal_s96", 2, 96, 96, 4, 2, 128, False, None, None, bf16),
        ("gqa_8_4_fp32_grads", BATCH, 256, 256, 8, 4, 128, True, 100, f32, bf16),
        # rows 9-15 see no key (lse +inf): their dq is 0
        ("causal_sq16_sk8_window2", 2, 16, 8, 4, 2, 128, True, 2, None, bf16),
        ("noncausal_sq64_sk192", 2, 64, 192, 4, 2, 128, False, None, None, bf16),
        # 144 blocks of 128-row tiles, the second 72 rows
        ("s200_ragged_128_row_tile", 9, 200, 200, 8, 4, 128, True, None, None, bf16),
        ("mqa_8_1", 2, 256, 256, 8, 1, 128, True, None, None, bf16),
        ("b1_h16_kv8_window100_d64", 1, 2048, 2048, 16, 8, 64, True, 100, f32, bf16),
        ("window_1000_over_s256", 2, 256, 256, 8, 4, 128, True, 1000, None, bf16),
        # dk/dv's 2-warpgroup variant at D 64 walking a group of 4 query heads
        ("gqa_8_2_s2048_d64", 8, 2048, 2048, 8, 2, 64, True, None, None, bf16),
        # the fp32 route (the FMA kernels, dq, dk and dv in fp32); more fp32
        # cases after this phase's timings (``late``)
        ("fp32_gqa_8_4_window100", BATCH, 256, 256, 8, 4, 128, True, 100, None, f32),
        ("fp32_ragged_s96_d64", 2, 96, 96, 4, 2, 64, True, None, None, f32),
        ("fp32_causal_sq16_sk8_window2", 2, 16, 8, 4, 2, 128, True, 2, None, f32),
        ("fp32_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 128, False, None, None, f32),
        # head sizes the kernels run zero-padded to 64 or 128
        ("d16_gqa_4_2", 2, 256, 256, 4, 2, 16, True, None, None, bf16),
        ("d32_window_48_fp32_grads", 2, 256, 256, 4, 4, 32, True, 48, f32, bf16),
        ("d96_train_tiles", 4, 1024, 1024, 8, 8, 96, True, None, None, bf16),
        ("d96_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 96, False, None, None, bf16),
        ("fp32_d16", 2, 128, 128, 4, 2, 16, True, None, None, f32),
        ("fp32_d32_window_48", 2, 256, 256, 4, 4, 32, True, 48, None, f32),
        ("fp32_d96", 2, 128, 128, 4, 2, 96, True, None, None, f32),
    ]
    # fp32 cases at larger shapes, held after the timings (as the forward's
    # ``late`` cases of phase 2)
    late = [
        ("fp32_train_flagship", TRAIN_BATCH, S_T, S_T, H_T, H_T, D_T, True, None, None, f32),
        ("fp32_mqa_8_1", 2, 256, 256, 8, 1, 128, True, None, None, f32),
        ("fp32_s200_ragged", 9, 200, 200, 8, 4, 128, True, None, None, f32),
        ("fp32_b1_h16_kv8_window100_d64", 1, 2048, 2048, 16, 8, 64, True, 100, None, f32),
    ]

    def check(cases):
        """Each case's dq, dk and dv against the plain backward; on the fp32
        route also a second launch of each kernel, bit for bit."""
        for name, B, Sq, Sk, H, KV, D, causal, window, gd, dt in cases:
            q, k, v, do = (randn(*shape).to(dt) for shape in (
                (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))
            o, lse = pa.flash_attention(q, k, v, causal, Sq, Sk, window, return_lse=True)
            kw = dict(causal=causal, window=window, grad_dtype=gd)
            got = (pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                   *pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))
            again = True
            if dt == f32:
                again = bool(torch.equal(got[0], pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw))
                             and all(torch.equal(a, b) for a, b in zip(
                                 got[1:], pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))))
            torch.cuda.synchronize()
            want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            route = pa._plan("dq", B, Sq, Sk, H, KV, D, dt, sms)
            route_kv = pa._plan("dkv", B, Sq, Sk, H, KV, D, dt, sms)
            for grad, g, w in zip(("dq", "dk", "dv"), got, want):
                ok, err, ratio, rms = check_out(g, w, dt)
                ok = ok and g.dtype == w.dtype and again
                where = (f"dq: {route.route}, {route.block}-row tiles; " if grad == "dq" else
                         f"dk/dv: {route_kv.route}, {route_kv.block} keys a block; ") + (
                    f"D {D} at width {route.width}; ")
                log(f"[kernels] flash_attention_bwd {name} {grad} ({where}operands {dt}, {g.dtype}): "
                    f"max_abs_err {err:.3e} (rms {rms:.3e}, worst err/tol {ratio:.3f}; "
                    f"{bound_note(dt)})"
                    + (f"; a second launch bitwise equal: {again}" if dt == f32 else "")
                    + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention_bwd {grad} disagrees with the plain "
                                         f"backward or with its second launch ({name})")
                key = "dq" if grad == "dq" else "dkv"
                if dt == bf16:
                    worst[key] = max(worst[key], err)

    check(cases)

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
    # the fp32 route at the same shape (the FMA forward, dq and dk/dv),
    # beside the plain versions and the library on the same fp32 operands
    # (TF32 off for matmuls and cuDNN alike); two forward launches agree bit
    # for bit (no atomics, fixed-order sums), as two dq and two dk/dv
    # launches do in ``late``
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    of, lsef = pa.flash_attention(qf, kf, vf, True, S, S, return_lse=True)
    again = pa.flash_attention(qf, kf, vf, True, S, S, return_lse=True)
    fwd_f32_same = bool(torch.equal(of, again[0]) and torch.equal(lsef, again[1]))
    del again
    log(f"[kernels] flash_fwd_fma at the training shape, two launches bitwise equal: "
        f"{fwd_f32_same}")
    if not fwd_f32_same:
        raise AssertionError("the fp32 flash forward differs between two launches")
    qft, kft, vft = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qf, kf, vf))
    o_lib32 = F.scaled_dot_product_attention(qft, kft, vft, is_causal=True)
    do_lib32 = dof.transpose(1, 2).contiguous()
    times.update(
        fwd_f32=device_ms(torch, lambda: pa.flash_attention(qf, kf, vf, True, S, S), cold=False, iters=5),
        dq_f32=device_ms(torch, lambda: pa.flash_attention_bwd_dq(qf, kf, vf, of, lsef, dof),
                         cold=False, iters=5),
        dkv_f32=device_ms(torch, lambda: pa.flash_attention_bwd_dkv(qf, kf, vf, of, lsef, dof),
                          cold=False, iters=5),
        fwd_f32_plain=device_ms(torch, lambda: pa.flash_attention_plain(qf, kf, vf), cold=False,
                                iters=5),
        bwd_f32_plain=device_ms(torch, lambda: pa.flash_attention_backward_plain(
            qf, kf, vf, of, lsef, dof), cold=False, iters=3),
        fwd_f32_lib=device_ms(torch, lambda: F.scaled_dot_product_attention(
            qft.detach(), kft.detach(), vft.detach(), is_causal=True), cold=False, iters=5),
        bwd_f32_lib=device_ms(torch, lambda: torch.autograd.grad(
            o_lib32, (qft, kft, vft), do_lib32, retain_graph=True), cold=False, iters=5),
    )
    # the yardstick by name: the device kernels of SDPA's forward on fp32 operands
    lib_f32_kernels = sorted({n.split("(")[0][:120] for run in _device_kernels(
        torch, lambda: F.scaled_dot_product_attention(qft.detach(), kft.detach(), vft.detach(),
                                                      is_causal=True), reps=2) for n in run})
    log(f"[kernels]   library on fp32 operands, forward: device kernels {lib_f32_kernels}")
    del qf, kf, vf, dof, of, lsef, qft, kft, vft, o_lib32, do_lib32
    pairs = causal_pairs(B, H, S, S)
    operand = 2 * B * S * H * D                      # one bf16 [B, S, H, D] tensor
    lse_bytes = 4 * B * H * S
    fwd_b, fwd_f = bound_ms(3 * operand + operand + lse_bytes, 2 * 2 * D * pairs)
    dq_b, dq_f = bound_ms(5 * operand + lse_bytes + operand, 3 * 2 * D * pairs)
    dkv_b, dkv_f = bound_ms(5 * operand + lse_bytes + 2 * operand, 4 * 2 * D * pairs)
    # the fp32 route's bounds: twice the bytes, the FLOPs at the fp32 peak
    bounds_f32 = {"fwd": bound_ms(2 * (4 * operand) + lse_bytes, 2 * 2 * D * pairs, FP32_FLOPS_PER_S),
                  "dq": bound_ms(2 * (6 * operand) + lse_bytes, 3 * 2 * D * pairs, FP32_FLOPS_PER_S),
                  "dkv": bound_ms(2 * (7 * operand) + lse_bytes, 4 * 2 * D * pairs,
                                  FP32_FLOPS_PER_S)}
    log(f"[kernels] training shape B{B} S{S} H{H} KV{H} D{D} causal, L2 warm "
        f"({pairs} causal (q, k) pairs per matmul):")
    tflops = {name: n * 2 * D * pairs / times[name] / 1e9 for name, n in (("fwd", 2), ("dq", 3), ("dkv", 4))}
    log(f"[kernels]   flash_attention_fwd kernel_ms {times['fwd']:.4f} ({tflops['fwd']:.1f} TFLOP/s "
        f"of the bound's work; the first scalar kernel {SCALAR_FLASH_MS['fwd_train']}) plain_ms "
        f"{times['fwd_plain']:.4f} library_ms {times['fwd_lib']:.4f} bound_ms {fwd_b:.5f} ({fwd_f})")
    log(f"[kernels]   flash_attention_bwd_dq kernel_ms {times['dq']:.4f} ({tflops['dq']:.1f} TFLOP/s; "
        f"the first scalar kernel {SCALAR_FLASH_MS['dq_train']}) bound_ms {dq_b:.5f} ({dq_f})")
    log(f"[kernels]   flash_attention_bwd_dkv kernel_ms {times['dkv']:.4f} ({tflops['dkv']:.1f} TFLOP/s; "
        f"the first scalar kernel {SCALAR_FLASH_MS['dkv_train']}) bound_ms {dkv_b:.5f} ({dkv_f})")
    tflops_f32 = {name: n * 2 * D * pairs / times[f"{name}_f32"] / 1e9
                  for name, n in (("fwd", 2), ("dq", 3), ("dkv", 4))}
    bwd_f32 = times["dq_f32"] + times["dkv_f32"]
    log(f"[kernels]   fp32 route (fp32 operands; flash_fwd_fma, flash_dq_fma, flash_dkv_fma): "
        f"forward {times['fwd_f32']:.4f} ms ({tflops_f32['fwd']:.1f} TFLOP/s of the bound's work; "
        f"the first scalar kernel {SCALAR_FP32_FWD_MS['flash_attention_fwd']}; plain "
        f"{times['fwd_f32_plain']:.4f}), dq {times['dq_f32']:.4f} ms ({tflops_f32['dq']:.1f} "
        f"TFLOP/s; the first scalar kernel {SCALAR_FP32_BWD_MS['dq']}), dk/dv "
        f"{times['dkv_f32']:.4f} ms ({tflops_f32['dkv']:.1f} TFLOP/s; the first scalar kernel "
        f"{SCALAR_FP32_BWD_MS['dkv']}), dq + dk/dv {bwd_f32:.4f} ms (the first scalar kernels "
        f"{sum(SCALAR_FP32_BWD_MS.values()):.4f}; plain backward {times['bwd_f32_plain']:.4f}); "
        f"bounds at {FP32_FLOPS_PER_S / 1e12:.0f} TF/s "
        + ", ".join(f"{k} {b:.5f} ({by})" for k, (b, by) in bounds_f32.items())
        + f"; library on fp32 operands (scaled_dot_product_attention, TF32 off): forward "
        f"{times['fwd_f32_lib']:.4f} ms, backward (dq, dk, dv together) {times['bwd_f32_lib']:.4f} "
        f"ms (dq + dk/dv {bwd_f32 / times['bwd_f32_lib']:.3f}x of it)")
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
                     bound_ms=fwd_b, bound_by=fwd_f, tflops=tflops,
                     fp32_route_ms={k: times[f"{k}_f32"] for k in ("fwd", "dq", "dkv")},
                     fp32_route_plain_ms={"fwd": times["fwd_f32_plain"],
                                          "bwd": times["bwd_f32_plain"]},
                     fp32_route_tflops=tflops_f32,
                     fp32_fwd_bitwise_equal_relaunch=fwd_f32_same,
                     fp32_route_library_kernels=lib_f32_kernels,
                     fp32_route_bound_ms={k: b for k, (b, _) in bounds_f32.items()},
                     fp32_route_library_ms={"fwd": times["fwd_f32_lib"],
                                            "bwd": times["bwd_f32_lib"]})
    check(late)
    return results, fwd_train


# heads of 256 at a small width (Gemma-class heads): a generate request and
# an fp32 decode step against the CPU, through the width-256 forward and
# flash-decode
WIDE_HEADS = dict(vocab_size=4096, num_layers=2, num_heads=2, embed_dim=512, mlp_dim=1024,
                  max_seq_len=256, attention_impl="flash")
WIDE_HEADS_PROMPT, WIDE_HEADS_NEW = 64, 16


def flash_times(torch, F, pa, q, k, v, do, *, kernel_iters, lib_iters):
    """The flash forward, dq and dk/dv on causal [B, S, H, D] operands (L2
    warm), their plain versions and scaled_dot_product_attention's forward
    and whole backward on the same operands, in device ms, with each
    kernel's bound at its dtype's peak and the TFLOP/s of the bound's work:
    (times, bounds, tflops, o, lse)."""
    B, S, H, D = q.shape
    o, lse = pa.flash_attention(q, k, v, True, S, S, return_lse=True)
    qt, kt_, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt_, vt, is_causal=True)
    do_lib = do.transpose(1, 2).contiguous()
    times = dict(
        fwd=device_ms(torch, lambda: pa.flash_attention(q, k, v, True, S, S), cold=False,
                      iters=kernel_iters),
        fwd_plain=device_ms(torch, lambda: pa.flash_attention_plain(q, k, v), cold=False, iters=3),
        fwd_lib=device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt.detach(), kt_.detach(), vt.detach(), is_causal=True), cold=False, iters=lib_iters),
        dq=device_ms(torch, lambda: pa.flash_attention_bwd_dq(q, k, v, o, lse, do), cold=False,
                     iters=kernel_iters),
        dkv=device_ms(torch, lambda: pa.flash_attention_bwd_dkv(q, k, v, o, lse, do),
                      cold=False, iters=kernel_iters),
        bwd_plain=device_ms(torch, lambda: pa.flash_attention_backward_plain(
            q, k, v, o, lse, do), cold=False, iters=3),
        bwd_lib=device_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt_, vt), do_lib, retain_graph=True), cold=False, iters=lib_iters),
    )
    pairs = causal_pairs(B, H, S, S)
    operand = q.element_size() * B * S * H * D
    lse_bytes = 4 * B * H * S
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    bounds = {"fwd": bound_ms(4 * operand + lse_bytes, 2 * 2 * D * pairs, rate),
              "dq": bound_ms(6 * operand + lse_bytes, 3 * 2 * D * pairs, rate),
              "dkv": bound_ms(7 * operand + lse_bytes, 4 * 2 * D * pairs, rate)}
    tflops = {kn: n * 2 * D * pairs / times[kn] / 1e9 for kn, n in (("fwd", 2), ("dq", 3), ("dkv", 4))}
    return times, bounds, tflops, o, lse


def phase_wide_heads(torch, np):
    """The flash forward, dq and dk/dv at head sizes 160, 192 and 256 (run at
    width 256: bf16 on the tensor-core route, dk/dv on the two-warpgroup
    kernel, fp32 on the FMA forward, dq and dk/dv, each route required)
    and flash-decode
    at 160, 192 and 256, each against its plain version under the bounds of
    the kernels phases; each kernel timed at D 256 beside its bound, its
    plain version and scaled_dot_product_attention on the same inputs, whose
    outputs are held against the plain versions too, the profile's kernel
    names showing the route (for dk/dv at 160 and 192 too), the fp32 route
    at the heads-of-256 training shape and flash-decode in both dtypes;
    then a generate request, and the train steps of :func:`wide_train_steps`, of heads of
    256 against the CPU."""
    import torch.nn.functional as F

    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import pallas_attention as pa
    from kubeflow_tpu_torch.ops.flash_decode import _plan as decode_plan
    from kubeflow_tpu_torch.ops.flash_decode import (
        _split_reference,
        flash_decode,
        flash_decode_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    def wide_routes(dt):
        """bf16 on the tensor cores; fp32 on the FMA kernels."""
        return dict.fromkeys(("fwd", "dq", "dkv"), "wgmma" if dt == bf16 else "fma")

    def dkv_kernels(*args, **kw):
        """The flash kernels' names in a profile of two dk/dv calls (beside
        them the padding's copies)."""
        runs = _device_kernels(torch, lambda: pa.flash_attention_bwd_dkv(*args, **kw), reps=2)
        return sorted({n.split(">(")[0] + ">" for run in runs for n in run if "flash_" in n})

    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "decode": 0.0}
    cases = [
        # name, B, Sq, Sk, H, KV, D, causal, window, grad_dtype, dtype
        ("d256_causal_gqa_8_2", 2, 256, 256, 8, 2, 256, True, None, None, bf16),
        # Gemma 2B's layout: 8 query heads of 256 over one KV head
        ("d256_mqa_8_1", 2, 256, 256, 8, 1, 256, True, None, None, bf16),
        ("d256_window_48", 2, 256, 256, 4, 4, 256, True, 48, None, bf16),
        ("d256_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 256, False, None, None, bf16),
        ("d256_causal_sq16_sk8_window2", 2, 16, 8, 4, 2, 256, True, 2, None, bf16),
        ("d256_fp32_grads_s200", 3, 200, 200, 4, 2, 256, True, None, f32, bf16),
        # the shapes phase 5b's flagships give the kernels: the training
        # step's (4 heads of 256) and the request's prefill (GQA 4/2 of 256)
        ("d256_wide_flagship_train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
         WIDE_FLAGSHIP_TRAIN["num_heads"], WIDE_FLAGSHIP_TRAIN["num_heads"], 256, True, None,
         None, bf16),
        ("d256_wide_flagship_prefill", BATCH, PROMPT, PROMPT, WIDE_FLAGSHIP_SERVE["num_heads"],
         WIDE_FLAGSHIP_SERVE["num_kv_heads"], 256, True, None, None, bf16),
        ("d160_gqa_4_2_window_100", 2, 256, 256, 4, 2, 160, True, 100, None, bf16),
        ("d192_noncausal", 2, 128, 128, 4, 4, 192, False, None, None, bf16),
        ("fp32_d256_gqa_8_2", 2, 256, 256, 8, 2, 256, True, None, None, f32),
        ("fp32_d256_window_48_ragged", 2, 200, 200, 4, 4, 256, True, 48, None, f32),
        ("fp32_d256_noncausal_sq64_sk192", 2, 64, 192, 4, 2, 256, False, None, None, f32),
        ("fp32_d160", 2, 128, 128, 4, 2, 160, True, None, None, f32),
        ("fp32_d192_window_48", 2, 128, 128, 4, 4, 192, True, 48, None, f32),
    ]
    # fp32 dq and dk/dv at 160 and 192 on more shapes, held after the timings
    late = [
        ("fp32_d160_gqa_8_2_s200_ragged", 3, 200, 200, 8, 2, 160, True, None, None, f32),
        ("fp32_d192_mqa_8_1_window_100", 2, 256, 256, 8, 1, 192, True, 100, None, f32),
    ]

    def check(cases):
        """Each case's forward, dq, dk and dv against the plain versions and
        its routes against ``wide_routes``; on the fp32 route a second dq
        and dk/dv launch bit for bit too."""
        for name, B, Sq, Sk, H, KV, D, causal, window, gd, dt in cases:
            q, k, v, do = (randn(*shape, dtype=dt) for shape in (
                (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))
            o, lse = pa.flash_attention(q, k, v, causal, Sq, Sk, window, return_lse=True)
            kw = dict(causal=causal, window=window, grad_dtype=gd)
            grads = (pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                     *pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))
            again = dt == bf16 or bool(
                torch.equal(grads[0], pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw))
                and all(torch.equal(a, b) for a, b in zip(
                    grads[1:], pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))))
            torch.cuda.synchronize()
            o_ref, lse_ref = pa.flash_attention_plain(q, k, v, causal=causal, window=window)
            want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            ok, err, ratio, rms = check_out(o, o_ref, dt)
            lse_ok, lse_err = check_lse(lse, lse_ref)
            ok = ok and lse_ok and check_dead_rows(o, lse_ref) and o.dtype == dt and again
            plans = {kn: pa._plan(kn, B, Sq, Sk, H, KV, D, dt, sms) for kn in ("fwd", "dq", "dkv")}
            routes = {kn: p.route for kn, p in plans.items()}
            if routes != wide_routes(dt):
                raise AssertionError(f"D {D} ({name}, {dt}) took the routes {routes}, not "
                                     f"{wide_routes(dt)}")
            line = [f"fwd err/tol {ratio:.3f} lse_err {lse_err:.2e}"] + (
                [f"a second dq and dk/dv launch bitwise equal: {again}"] if dt == f32 else [])
            if dt == bf16:
                worst["fwd"] = max(worst["fwd"], err)
            for grad, g, w in zip(("dq", "dk", "dv"), grads, want):
                g_ok, g_err, g_ratio, _ = check_out(g, w, dt)
                ok = ok and g_ok and g.dtype == w.dtype
                line.append(f"{grad} err/tol {g_ratio:.3f}")
                key = "dq" if grad == "dq" else "dkv"
                if dt == bf16:
                    worst[key] = max(worst[key], g_err)
            if dt == bf16 and D in (160, 192):
                # the padded widths launch the width-256 kernel too
                names = dkv_kernels(q, k, v, o, lse, do, **kw)
                ok = ok and len(names) == 1 and DKV_PAIR in names[0]
                line.append(f"dk/dv kernel {names}")
            log(f"[wide heads] flash {name} ({dt}; D {D} at width {plans['fwd'].width}; "
                + ", ".join(f"{kn} {p.route} {p.block}-row tiles {p.smem_bytes} B"
                            for kn, p in plans.items())
                + f"): {'; '.join(line)} ({bound_note(dt)}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"a flash kernel disagrees with its plain version at D {D} ({name})")

    check(cases)

    dec_cases = [
        # name, (B, G, R, D, L), positions, window, dtype
        ("d256_pos191", (4, 4, 2, 256, 2048), [191] * 4, None, bf16),
        ("d256_pos2047", (4, 4, 2, 256, 2048), [2047] * 4, None, bf16),
        ("d256_per_row_pos_window_100", (4, 4, 2, 256, 2048), [0, 255, 1024, 2047], 100, bf16),
        ("d256_r16_cluster", (2, 1, 16, 256, 256), [100, 255], None, bf16),
        ("d160_pos191", (2, 4, 2, 160, 512), [191, 511], None, bf16),
        ("d192_r4", (2, 2, 4, 192, 512), [63, 500], None, bf16),
        ("fp32_d256_pos191", (4, 4, 2, 256, 2048), [191] * 4, None, f32),
        ("fp32_d256_pos2047", (4, 4, 2, 256, 2048), [2047] * 4, None, f32),
        ("fp32_d256_r4_window_48", (2, 2, 4, 256, 256), [63, 200], 48, f32),
    ]
    for name, (B, G, R, D, L), pos_list, window, dt in dec_cases:
        kc, vc, qd = (randn(*shape, dtype=dt) for shape in ((B, G, L, D), (B, G, L, D), (B, G, R, D)))
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        kpos = torch.arange(L, device="cuda")
        live = kpos[None, :] <= pos[:, None].long()
        if window is not None:
            live = live & (kpos[None, :] > pos[:, None].long() - window)
        live = live[:, None, :, None]
        kg, vg = torch.where(live, kc, torch.nan), torch.where(live, vc, torch.nan)
        o = flash_decode(qd, kg, vg, pos, window=window)
        torch.cuda.synchronize()
        o_ref = flash_decode_plain(qd, kg, vg, pos, window=window)
        plan = decode_plan(B, G, R, L, D, dt, sms)
        w_ratio = _decode_witness(torch, o, _split_reference(qd, kg, vg, pos, window, plan), dt)
        ok, err, ratio, rms = check_out(o, o_ref, dt)
        ok = ok and o.dtype == dt and w_ratio <= 1.0
        log(f"[wide heads] flash_decode {name} ({dt}, R {R}, D {D} at width {plan.width}, split "
            f"{plan.split} x {plan.splits}, {'cluster' if plan.cluster else 'workspace'} combine) "
            f"window={window}: max_abs_err {err:.3e} (worst err/tol {ratio:.3f}; "
            f"{bound_note(dt)}); vs _split_reference worst err/tol {w_ratio:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_decode disagrees with its plain version at D {D} ({name})")
        if dt == bf16:
            worst["decode"] = max(worst["decode"], err)

    # timed at D 256: the training flagship's shape with heads of 256
    # (B4 S2048 H8, causal), and flash-decode at the serving flagship's
    # cache with heads of 256 (B4 G4 R2 L2048, pos 191 and 2047)
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, TRAIN["num_heads"], 256
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    times, bounds, tflops, o, lse = flash_times(torch, F, pa, q, k, v, do, kernel_iters=5,
                                                lib_iters=30)
    # the timed inputs' o, lse, dq, dk and dv against the plain versions
    grads = (pa.flash_attention_bwd_dq(q, k, v, o, lse, do),
             *pa.flash_attention_bwd_dkv(q, k, v, o, lse, do))
    torch.cuda.synchronize()
    o_ref, lse_ref = pa.flash_attention_plain(q, k, v)
    ok, err, ratio, _ = check_out(o, o_ref, bf16)
    lse_ok, lse_err = check_lse(lse, lse_ref)
    ok = ok and lse_ok
    worst["fwd"] = max(worst["fwd"], err)
    line = [f"fwd err/tol {ratio:.3f} lse_err {lse_err:.2e}"]
    del o_ref, lse_ref
    for grad, g, w in zip(("dq", "dk", "dv"), grads,
                          pa.flash_attention_backward_plain(q, k, v, o, lse, do)):
        g_ok, g_err, g_ratio, _ = check_out(g, w, bf16)
        ok = ok and g_ok
        worst["dq" if grad == "dq" else "dkv"] = max(worst["dq" if grad == "dq" else "dkv"], g_err)
        line.append(f"{grad} err/tol {g_ratio:.3f}")
    log(f"[wide heads] flash d256_timed_inputs (B{B} S{S} H{H} KV{H} causal, the inputs timed "
        f"above): {'; '.join(line)} ({bound_note(bf16)}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a flash kernel disagrees with its plain version on the timed D 256 inputs")
    del grads
    torch.cuda.empty_cache()
    plans = {kn: pa._plan(kn, B, S, S, H, H, D, bf16, sms) for kn in ("fwd", "dq", "dkv")}
    # the kernels the forward, dq and dk/dv launched, by the profiler's names
    seen = _device_kernels(torch, lambda: (pa.flash_attention(q, k, v, True, S, S),
                                           pa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                                           pa.flash_attention_bwd_dkv(q, k, v, o, lse, do)),
                           reps=2)
    names = {n for run in seen for n in run}
    launched = {kn: [n.split(">(")[0] + ">" for n in names if kernel in n]
                for kn, kernel in zip(("fwd", "dq", "dkv"), (k for k, _ in WIDE_WGMMA.values()))}
    res = {"worst_bf16_err": worst, "times_d256_train_shape": times, "bounds": bounds,
           "tflops": tflops, "routes": {kn: p.route for kn, p in plans.items()},
           "kernels_seen": sorted(names)}
    for kn, label, plain, lib in (("fwd", "forward", "fwd_plain", "fwd_lib"),
                                  ("dq", "dq", "bwd_plain", "bwd_lib"),
                                  ("dkv", "dk/dv", "bwd_plain", "bwd_lib")):
        log(f"[wide heads] D 256 {label} at the training shape B{B} S{S} H{H} KV{H} causal, L2 "
            f"warm ({plans[kn].route}, {plans[kn].block}-row tiles, {plans[kn].threads} threads, "
            f"{plans[kn].smem_bytes} B): kernel_ms {times[kn]:.4f} ({tflops[kn]:.1f} TFLOP/s of "
            f"the bound's work) bound_ms {bounds[kn][0]:.5f} ({bounds[kn][1]}) plain_ms "
            f"{times[plain]:.4f} library_ms {times[lib]:.4f} ({times[kn] / times[lib]:.2f}x; "
            f"scaled_dot_product_attention{' backward, dq dk dv together' if kn != 'fwd' else ''})")
    log(f"[wide heads] D 256 kernels in the profile of a forward, a dq and a dk/dv: {launched}")
    if res["routes"] != wide_routes(bf16) or not all(launched.values()):
        raise AssertionError(f"D 256 forward, dq and dk/dv did not take the tensor-core route: "
                             f"{res['routes']}, {sorted(names)}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    # the fp32 route at D 256, timed at the heads-of-256 flagship's training
    # shape (B4 S2048 H4: the H * D of the heads-of-512 shape, so the work of
    # the fp32 width-512 pairs without their swap), SDPA on the fp32 operands
    H = WIDE_FLAGSHIP_TRAIN["num_heads"]
    q, k, v, do = (randn(B, S, H, D, dtype=f32) for _ in range(4))
    times, bounds, tflops, o, lse = flash_times(torch, F, pa, q, k, v, do, kernel_iters=3,
                                                lib_iters=3)
    plans = {kn: pa._plan(kn, B, S, S, H, H, D, f32, sms) for kn in ("fwd", "dq", "dkv")}
    if {p.route for p in plans.values()} != {"fma"}:
        raise AssertionError(f"D 256 fp32 did not take the FMA route: {plans}")
    res["fp32_d256"] = dict(times=times, bounds=bounds, tflops=tflops)
    for kn, label, plain, lib in (("fwd", "forward", "fwd_plain", "fwd_lib"),
                                  ("dq", "dq", "bwd_plain", "bwd_lib"),
                                  ("dkv", "dk/dv", "bwd_plain", "bwd_lib")):
        log(f"[wide heads] D 256 fp32 {label} at the heads-of-256 training shape B{B} S{S} H{H} "
            f"KV{H} causal, L2 warm ({plans[kn].route}, {plans[kn].block}, {plans[kn].threads} "
            f"threads, {plans[kn].smem_bytes} B): kernel_ms {times[kn]:.4f} ({tflops[kn]:.1f} "
            f"TFLOP/s of the bound's work) bound_ms {bounds[kn][0]:.5f} ({bounds[kn][1]}) "
            f"plain_ms {times[plain]:.4f} library_ms {times[lib]:.4f} ({times[kn] / times[lib]:.2f}x"
            f"; scaled_dot_product_attention on the fp32 operands"
            f"{' backward, dq dk dv together' if kn != 'fwd' else ''})")
    log(f"[wide heads] D 256 fp32 dq + dk/dv {times['dq'] + times['dkv']:.4f} ms against "
        f"scaled_dot_product_attention's fp32 backward {times['bwd_lib']:.4f} "
        f"({(times['dq'] + times['dkv']) / times['bwd_lib']:.3f}x)")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    B, G, R, D, L = BATCH, 4, 2, 256, FLAGSHIP["max_seq_len"]
    for dt in (bf16, f32):
        tag, elem = ("", 2) if dt == bf16 else ("_fp32", 4)
        kc, vc, qd = (randn(*shape, dtype=dt) for shape in ((B, G, L, D), (B, G, L, D),
                                                            (B, G, R, D)))
        for p in (PROMPT + (NEW - 2) // 2, L - 1):
            pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
            ms = device_ms(torch, lambda: flash_decode(qd, kc, vc, pos), cold=True)
            plain_ms = device_ms(torch, lambda: flash_decode_plain(qd, kc, vc, pos), cold=True)
            k_live, v_live = kc[:, :, :p + 1], vc[:, :, :p + 1]
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qd.view(B, G * R, 1, D), k_live, v_live, enable_gqa=True), cold=True)
            n_bytes = 2 * (elem * B * G * R * D) + 2 * (elem * B * G * (p + 1) * D) + 4 * B
            bms, by = bound_ms(n_bytes, 4 * B * G * R * (p + 1) * D,
                               BF16_FLOPS_PER_S if dt == bf16 else FP32_FLOPS_PER_S)
            res[f"decode_d256{tag}_pos{p}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                   bound_ms=bms, bound_by=by)
            log(f"[wide heads] flash_decode D 256 ({dt}) B{B} G{G} R{R} L{L} pos {p}, L2 "
                f"flushed: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                f"bound_ms {bms:.5f} ({by})")
        del kc, vc, qd

    check(late)

    # a generate request of heads of 256 (launches counted), an fp32 copy's
    # decode step against the CPU, and one train step against the CPU
    cfg = kt.TransformerConfig(**WIDE_HEADS, dtype=bf16)
    prompt = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (BATCH, WIDE_HEADS_PROMPT)))
    model = kt.TransformerLM(kt.decode_config(cfg), device="cuda")
    model.load_state_dict(kt.init_state_dict(cfg, seed=6, device="cuda"))
    counters = {"flash_attention_fwd": pa.flash_attention, "flash_decode": flash_decode}
    for fn in counters.values():
        fn.launches = 0
    out = kt.generate(model, prompt.to("cuda"), max_new_tokens=WIDE_HEADS_NEW)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (WIDE_HEADS_NEW - 1)}
    log(f"[wide heads] generate, {cfg.num_layers}-layer bf16 model of {cfg.num_heads} heads of D "
        f"{cfg.head_dim}, B{BATCH} P{WIDE_HEADS_PROMPT} +{WIDE_HEADS_NEW}: launches {launches} "
        f"(expected {want})")
    if launches != want or tuple(out.shape) != (BATCH, WIDE_HEADS_PROMPT + WIDE_HEADS_NEW):
        raise AssertionError(f"D 256 generate: launches {launches}, shape {tuple(out.shape)}")
    cfg32 = dataclasses.replace(cfg, dtype=f32)
    sd = kt.init_state_dict(cfg32, seed=7, device="cpu")
    steps = {}
    with torch.inference_mode():
        for where in ("cuda", "cpu"):
            m = kt.TransformerLM(kt.decode_config(cfg32), device=where)
            m.load_state_dict(sd)
            cache, last = kt.prefill(m, prompt)
            tok = last.argmax(-1).to("cpu")
            steps[where] = m(tok[:, None].to(m.device), start=WIDE_HEADS_PROMPT,
                             cache=cache)[:, -1].float().cpu()
    err = (steps["cuda"] - steps["cpu"]).abs().max().item()
    log(f"[wide heads] fp32 model, one decode step's logits card vs cpu: max_abs_err {err:.3e} "
        f"(atol {GEN_FP32_LOGITS_ATOL})")
    if not torch.isfinite(steps["cuda"]).all() or err > GEN_FP32_LOGITS_ATOL:
        raise AssertionError(f"D 256 fp32 decode step disagrees with the CPU: {err}")
    diffs = wide_train_steps(torch, np, kt, cfg)
    res.update(generate_launches=launches, decode_step_err=err, train_step_diffs=diffs)
    return res


def wide_train_steps(torch, np, kt, cfg, tag="wide heads"):
    """One SGD step of ``cfg``'s model at each of ``PARITY_SEEDS``, on the
    card (bf16, then fp32) against the CPU (fp32): the bf16 step through
    :func:`_seeded_grad_check` (``WIDE_GRAD_RTOL``, ``WIDE_PARAM_GRAD_RTOL``),
    and with it the fp32 route's loss within ``TRAIN_LOSS_ATOL``, its whole
    gradient's and each parameter's relative L2 error within
    ``WIDE_FP32_GRAD_RTOL``, its gradient norm within ``TRAIN_GNORM_RTOL``,
    and one launch of each flash kernel a layer in each of the two steps."""
    def make(dtype, where):
        return kt.TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where)

    def one_seed(seed):
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 256)))
        sd = kt.init_state_dict(cfg, seed=seed, device="cpu")
        grads = {}
        before = [c.launches for c in _flash_counters().values()]
        got = _one_step_vs_cpu(torch, kt, make, sd, tokens, chunk=TRAIN_CHUNK, grads_out=grads)
        launched = [c.launches - b for c, b in zip(_flash_counters().values(), before)]
        before = [c.launches for c in _flash_counters().values()]
        got32 = _one_step_vs_cpu(torch, kt, make, sd, tokens, card_dtype=torch.float32,
                                 chunk=TRAIN_CHUNK, grads_out=grads, cpu_from=got)
        launched32 = [c.launches - b for c, b in zip(_flash_counters().values(), before)]
        (loss_f, norm_f), (loss_h, norm_h) = got32["cuda"], got["cpu"]
        whole, per = _grad_errors(torch, grads["cuda_fp32"], grads["cpu"])
        worst_p = max(per.values())
        d_loss, d_norm = abs(loss_f - loss_h), abs(norm_f - norm_h) / norm_h
        ok = (bool(np.isfinite([loss_f, norm_f]).all()) and d_loss <= TRAIN_LOSS_ATOL
              and whole <= WIDE_FP32_GRAD_RTOL and worst_p <= WIDE_FP32_GRAD_RTOL
              and d_norm <= TRAIN_GNORM_RTOL
              and launched == launched32 == [cfg.num_layers] * 3)
        note = (f"; fp32: loss |diff| {d_loss:.2e}, grad norm rel diff {d_norm:.2e} (rtol "
                f"{TRAIN_GNORM_RTOL}), gradient rel L2 err {whole:.3e}, worst parameter "
                f"{worst_p:.3e} (rtol {WIDE_FP32_GRAD_RTOL}); flash launches in the bf16 step "
                f"{launched}, in the fp32 step {launched32}")
        return got, grads["cuda"], grads["cpu"], note, ok

    return _seeded_grad_check(torch, np, tag, one_seed, TRAIN_LOSS_ATOL, WIDE_GRAD_RTOL,
                              WIDE_PARAM_GRAD_RTOL)


# heads of 512: a 2-layer model of two heads of 512 over one KV head at the
# flagships' width E 1024 (phase 5c's train step held against the CPU), and
# the flagships at heads of 512 (the training cell at 2 heads, the decode
# cell at GQA 2/1: the same widths, parameters and attention FLOPs as the
# 8-heads-of-128 ones)
HEADS_512 = dict(vocab_size=4096, num_layers=2, num_heads=2, num_kv_heads=1, embed_dim=1024,
                 mlp_dim=2048, max_seq_len=256, attention_impl="flash")
HEADS_512_TRAIN = dict(num_heads=2)
HEADS_512_SERVE = dict(num_heads=2, num_kv_heads=1)
HEADS_512_STEPS = 3


def _sdpa_backends(torch, F, q, k, v, **kw):
    """(the SDPA backends that take these operands, the device kernels one
    default call launched): SDPA's flash backend stops at head width 256, so
    at 512 the library yardstick is another backend, named here."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            took.append(backend.name)
        except RuntimeError:
            pass
    runs = _device_kernels(torch, lambda: F.scaled_dot_product_attention(q, k, v, **kw), reps=1)
    names = sorted({n[:60] for run in runs for n in run})
    return took, names


def _tf32(torch, x):
    """fp32 ``x`` rounded to nearest (ties to even) at TF32's 10 explicit
    mantissa bits: what a product at TF32 precision reads of its operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


# the TF32 controls' shapes: the flash kernels' (B, S, H, KV, D, causal) and
# flash-decode's (B, G, R, D, L, positions), at every width the fp32 bound holds
CONTROL_FLASH = ((3, 200, 2, 1, 512, True),            # phase 2c's case
                 (4, 2048, 4, 4, 256, True),            # heads of 256, the training shape
                 (4, 2048, 8, 8, 128, True),            # the training flagship
                 (2, 512, 4, 2, 64, False))
CONTROL_DECODE = ((4, 1, 2, 512, 2048, [191, 700, 1500, 2047]),  # the heads-of-512 request
                  (4, 4, 2, 256, 2048, [191, 191, 191, 191]),
                  (4, 4, 2, 128, 2048, [191, 191, 191, 191]),    # the serving flagship
                  (2, 2, 4, 64, 512, [63, 500]))


def fp32_bound_controls(torch, randn):
    """The lower-precision controls of the fp32 routes (the flash forward,
    dq, dk/dv and flash-decode) at every width the fp32 bound holds (the
    shapes of ``CONTROL_FLASH`` and ``CONTROL_DECODE``), each on its own
    line: the plain version on operands rounded to TF32's 10-bit mantissa
    (:func:`_tf32`), held against the plain version on the fp32 operands
    under the fp32 bound (:func:`out_bound`). Each must read err/tol above
    1, so that a kernel whose products ran at TF32 or bf16 precision fails
    the bound; one that does not means the bound is too loose, and the
    phase fails."""
    from kubeflow_tpu_torch.ops import pallas_attention as pa
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode_plain

    f32 = torch.float32
    ratios = {}
    for B, S, H, KV, D, causal in CONTROL_FLASH:
        q, k, v, do = (randn(*shape, dtype=f32) for shape in (
            (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
        o, lse = pa.flash_attention_plain(q, k, v, causal=causal)
        o_t, _ = pa.flash_attention_plain(*(_tf32(torch, x) for x in (q, k, v)), causal=causal)
        want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal)
        got = pa.flash_attention_backward_plain(*(_tf32(torch, x) for x in (q, k, v, o)), lse,
                                                _tf32(torch, do), causal=causal)
        shape = f"B{B} S{S} H{H} KV{KV} D{D}{' causal' if causal else ''}"
        ratios[f"forward, {shape}"] = check_out(o_t, o, f32)[2]
        ratios[f"dq, {shape}"] = check_out(got[0], want[0], f32)[2]
        ratios[f"dk/dv, {shape}"] = max(check_out(g, w, f32)[2] for g, w in zip(got[1:], want[1:]))
        del q, k, v, do, o, lse, o_t, want, got
    for B, G, R, D, L, pos_list in CONTROL_DECODE:
        kc, vc, qd = (randn(*shape, dtype=f32) for shape in ((B, G, L, D), (B, G, L, D),
                                                             (B, G, R, D)))
        pos = torch.tensor(pos_list, dtype=torch.int32, device=qd.device)
        ratios[f"flash-decode, B{B} G{G} R{R} D{D} L{L} pos {pos_list}"] = check_out(
            flash_decode_plain(*(_tf32(torch, x) for x in (qd, kc, vc)), pos),
            flash_decode_plain(qd, kc, vc, pos), f32)[2]
    for route, ratio in ratios.items():
        log(f"[fp32 bound] control, {route}: the plain version on operands rounded to TF32's "
            f"10-bit mantissa against it on the fp32 operands: worst err/tol {ratio:.2f} under "
            f"the fp32 bound ({bound_note(f32)}), must be above 1: "
            f"{'ok' if ratio > 1.0 else 'FAIL'}")
    if min(ratios.values()) <= 1.0:
        raise AssertionError(f"a TF32 control passes the fp32 bound: {ratios}")
    return ratios


def phase_heads_512(torch, np):
    """The flash forward, dq and dk/dv and flash-decode at head width 512,
    in bf16 (the tensor-core kernels: the forward's two warpgroups each
    owning half of O's columns, dq and dk/dv a cluster of two blocks each
    owning a column half) and fp32 (the FMA kernels, the forward, dq and
    dk/dv a cluster of two blocks each), each route and cluster required:
    the heads-of-512 training shape (B4 S2048 H2), the request's prefill
    (GQA 2/1), MQA 8/1, a window, ragged S (with fp32 gradients of bf16
    operands), rows that see no key, D 300 padded, and two cases only the
    pair can get wrong (Sk not a multiple of the 64-key block, so both
    blocks of a pair mask keys; key blocks no query sees); decode at
    positions 191 and 2047 of a 2,048-slot cache, a window, R 16, a row
    with no live key (on both combines) and D 300 padded. Each against its
    plain version under the bound of its operands' dtype (:func:`out_bound`),
    a second launch bitwise equal, the backward of both routes against
    ``_pair_reference`` (the pairs' order of operations), the fp32 forward
    against ``_pair_forward_reference`` and decode against
    ``_split_reference`` too; each fp32 route's TF32 control
    (:func:`fp32_bound_controls`); the training shape's
    profile names the width-512 kernels. Each kernel is timed at the training shape (decode at
    positions 191 and 2047, L2 flushed) with its bound, plain version and
    scaled_dot_product_attention, whose backend is named; the fp32 dq and
    dk/dv beside the first port's 16-row, 16-key kernels (``FIRST_FP32_512_MS``)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import pallas_attention as pa
    from kubeflow_tpu_torch.ops.flash_decode import _plan as decode_plan
    from kubeflow_tpu_torch.ops.flash_decode import (
        _split_reference,
        flash_decode,
        flash_decode_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    B, S, H = TRAIN_BATCH, TRAIN_SEQ, HEADS_512_TRAIN["num_heads"]
    shapes = [
        # name, B, Sq, Sk, H, KV, D, causal, window, fp32 gradients of bf16 operands
        ("train_b4_s2048_h2", B, S, S, H, H, 512, True, None, False),
        ("prefill_b4_s128_gqa_2_1", BATCH, PROMPT, PROMPT, HEADS_512_SERVE["num_heads"],
         HEADS_512_SERVE["num_kv_heads"], 512, True, None, False),
        ("mqa_8_1", 2, 256, 256, 8, 1, 512, True, None, False),
        ("window_48", 2, 256, 256, 2, 2, 512, True, 48, False),
        ("ragged_s200_fp32_grads", 3, 200, 200, 2, 1, 512, True, None, True),
        ("dead_rows_sq16_sk8_window2", 2, 16, 8, 2, 1, 512, True, 2, False),
        ("d300_noncausal_sq64_sk192", 2, 64, 192, 2, 1, 300, False, None, False),
        # the pair's edges: Sk 200 leaves both blocks of the last key block
        # 8 keys of 64 (dk/dv) and dq's last key tile 8 too; causal Sq 64 <
        # Sk 256 leaves three key blocks that no query sees
        ("pair_noncausal_sq40_sk200_gqa_4_2", 2, 40, 200, 4, 2, 512, False, None, False),
        ("pair_unseen_keys_sq64_sk256", 2, 64, 256, 2, 1, 512, True, None, False),
    ]
    res = {"cases": {}, "decode_cases": {}}
    for dt in (bf16, f32):
        route = "wgmma" if dt == bf16 else "fma"
        for name, b_, sq, sk, h_, kv, D, causal, window, f32_grads in shapes:
            q, k, v, do = (randn(*shape, dtype=dt) for shape in (
                (b_, sq, h_, D), (b_, sk, kv, D), (b_, sk, kv, D), (b_, sq, h_, D)))
            kw = dict(causal=causal, window=window, grad_dtype=f32 if f32_grads else None)

            def run():
                o, lse = pa.flash_attention(q, k, v, causal, sq, sk, window, return_lse=True)
                return (o, lse, pa.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw),
                        *pa.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw))

            got, again = run(), run()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            o, lse, *grads = got
            torch.cuda.synchronize()
            o_ref, lse_ref = pa.flash_attention_plain(q, k, v, causal=causal, window=window)
            want = pa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            ok, err, ratio, _ = check_out(o, o_ref, dt)
            lse_ok, lse_err = check_lse(lse, lse_ref)
            ok = ok and lse_ok and check_dead_rows(o, lse_ref) and o.dtype == dt and same
            plans = {kn: pa._plan(kn, b_, sq, sk, h_, kv, D, dt, sms) for kn in ("fwd", "dq", "dkv")}
            # both routes: dq and dk/dv a pair of two blocks; the forward a
            # pair on the fp32 route, one block of two halves on the bf16 one
            if {p.route for p in plans.values()} != {route} or any(
                    p.width != 512 or p.cluster != (1 if kn == "fwd" and dt == bf16 else 2)
                    for kn, p in plans.items()):
                raise AssertionError(f"D {D} ({name}, {dt}) took {plans}, not {route} at width "
                                     f"512 with the pairs' cluster 2")
            line = [f"fwd err/tol {ratio:.3f} lse_err {lse_err:.2e}"]
            errs = {"fwd": err}
            if dt == f32:
                # the fp32 forward pair's witness: its own order of operations
                o_w, lse_w = pa._pair_forward_reference(q, k, v, causal=causal, window=window)
                w_ok, _, w_ratio, _ = check_out(o, o_w, dt)
                wl_ok, wl_err = check_lse(lse, lse_w)
                ok = ok and w_ok and wl_ok
                line[0] += f" (vs _pair_forward_reference {w_ratio:.3f}, lse_err {wl_err:.2e})"
                errs["fwd_vs_pair_forward_reference_ratio"] = w_ratio
                del o_w, lse_w
            # the pair's witness: its own order of operations, the same bounds
            wit = pa._pair_reference(q, k, v, o, lse, do, **kw)
            for grad, g, w, r in zip(("dq", "dk", "dv"), grads, want, wit):
                g_ok, g_err, g_ratio, _ = check_out(g, w, dt)
                w_ok, _, w_ratio, _ = check_out(g, r, dt)
                ok = ok and g_ok and w_ok and g.dtype == w.dtype
                line.append(f"{grad} err/tol {g_ratio:.3f} (vs _pair_reference {w_ratio:.3f})")
                errs[f"{grad}_vs_pair_reference_ratio"] = w_ratio
                errs[grad] = g_err
            del wit
            res["cases"][f"{'bf16' if dt == bf16 else 'fp32'}_{name}"] = errs
            log(f"[heads 512] flash {name} ({dt}; D {D} at width 512; "
                + ", ".join(f"{kn} {p.route} {p.block} {p.threads} threads grid {p.grid} "
                            f"cluster {p.cluster} {p.smem_bytes} B" for kn, p in plans.items())
                + f"): {'; '.join(line)}; a second launch of all three bitwise equal: {same} "
                f"({bound_note(dt)}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"a width-512 flash kernel disagrees with its plain version "
                                     f"({name}, {dt})")
            del q, k, v, do, got, again, o, lse, grads, o_ref, lse_ref, want
        torch.cuda.empty_cache()
    res["fp32_bound_controls"] = fp32_bound_controls(torch, randn)

    dec_cases = [
        # name, (B, G, R, D, L), positions, window
        ("pos191", (BATCH, 1, 2, 512, 2048), [191] * BATCH, None),
        ("pos2047", (BATCH, 1, 2, 512, 2048), [2047] * BATCH, None),
        # rows of 1, 8, 33 and 64 live runs (bf16; fp32 1, 16, 65, 128): one
        # block's combine, and groups of 16 with a ragged last one
        ("per_row_pos", (BATCH, 1, 2, 512, 2048), [0, 255, 1024, 2047], None),
        ("per_row_pos_window_100", (BATCH, 1, 2, 512, 2048), [0, 255, 1024, 2047], 100),
        ("r16_cluster", (2, 1, 16, 512, 256), [100, 255], None),
        ("no_live_key_row", (2, 2, 4, 512, 256), [-1, 130], None),
        # the workspace combine (64 or 128 splits a row) with a row that has
        # no live key, and rows whose live keys fill one run or part of one
        ("no_live_key_row_workspace", (BATCH, 1, 2, 512, 2048), [-1, 0, 15, 16], None),
        ("d300_pos191", (2, 1, 2, 300, 512), [191, 511], None),
    ]
    for dt in (bf16, f32):
        for name, (b_, G, R, D, L), pos_list, window in dec_cases:
            kc, vc, qd = (randn(*shape, dtype=dt) for shape in ((b_, G, L, D), (b_, G, L, D),
                                                                 (b_, G, R, D)))
            pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
            kpos = torch.arange(L, device="cuda")
            live = kpos[None, :] <= pos[:, None].long()
            if window is not None:
                live = live & (kpos[None, :] > pos[:, None].long() - window)
            live = live[:, None, :, None]
            kg, vg = torch.where(live, kc, torch.nan), torch.where(live, vc, torch.nan)
            o = flash_decode(qd, kg, vg, pos, window=window)
            same = torch.equal(o, flash_decode(qd, kg, vg, pos, window=window))
            torch.cuda.synchronize()
            o_ref = flash_decode_plain(qd, kg, vg, pos, window=window)
            plan = decode_plan(b_, G, R, L, D, dt, sms)
            w_ratio = _decode_witness(torch, o, _split_reference(qd, kg, vg, pos, window, plan),
                                      dt)
            ok, err, ratio, _ = check_out(o, o_ref, dt)
            ok = ok and o.dtype == dt and w_ratio <= 1.0 and same and plan.width == 512
            res["decode_cases"][f"{'bf16' if dt == bf16 else 'fp32'}_{name}"] = err
            log(f"[heads 512] flash_decode {name} ({dt}, B{b_} G{G} R{R}, D {D} at width "
                f"{plan.width}, split {plan.split} x {plan.splits}, "
                f"{'cluster' if plan.cluster else 'workspace'} combine) window={window}: "
                f"max_abs_err {err:.3e} (worst err/tol {ratio:.3f}; {bound_note(dt)}); vs "
                f"_split_reference worst err/tol {w_ratio:.3f}; a second launch bitwise equal: "
                f"{same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_decode disagrees with its plain version at width "
                                     f"512 ({name}, {dt})")

    # timed at the heads-of-512 training shape (B4 S2048 H2, causal), each
    # route on its own operands, and flash-decode at the heads-of-512 decode
    # flagship's cache (B4 G1 R2 L2048) at positions 191 and 2047, L2 flushed
    res["timed"] = {}
    D = 512
    for dt in (bf16, f32):
        tag = "bf16" if dt == bf16 else "fp32"
        rate = BF16_FLOPS_PER_S if dt == bf16 else FP32_FLOPS_PER_S
        elem = 2 if dt == bf16 else 4
        q, k, v, do = (randn(B, S, H, D, dtype=dt) for _ in range(4))
        took, lib_kernels = _sdpa_backends(torch, F, *(x.transpose(1, 2).contiguous()
                                                       for x in (q, k, v)), is_causal=True)
        times, bounds, tflops, o, lse = flash_times(
            torch, F, pa, q, k, v, do, kernel_iters=3 if dt == f32 else 5,
            lib_iters=3 if dt == f32 else 10)
        plans = {kn: pa._plan(kn, B, S, S, H, H, D, dt, sms) for kn in ("fwd", "dq", "dkv")}
        seen = _device_kernels(torch, lambda: (pa.flash_attention(q, k, v, True, S, S),
                                               pa.flash_attention_bwd_dq(q, k, v, o, lse, do),
                                               pa.flash_attention_bwd_dkv(q, k, v, o, lse, do)),
                               reps=2)
        names = sorted({n.split(">(")[0] + ">" for run in seen for n in run if "flash_" in n})
        want_names = [k for k, _ in (WGMMA_512 if dt == bf16 else FMA_512).values()]
        launched = {w: any(w in n for n in names) for w in want_names}
        for kn, label, plain, lib in (("fwd", "forward", "fwd_plain", "fwd_lib"),
                                      ("dq", "dq", "bwd_plain", "bwd_lib"),
                                      ("dkv", "dk/dv", "bwd_plain", "bwd_lib")):
            log(f"[heads 512] D 512 {label} ({tag}) at the training shape B{B} S{S} H{H} KV{H} "
                f"causal, L2 warm ({plans[kn].route}, {plans[kn].block}, {plans[kn].threads} "
                f"threads, cluster {plans[kn].cluster}, {plans[kn].smem_bytes} B): kernel_ms "
                f"{times[kn]:.4f} ({tflops[kn]:.1f} TFLOP/s of the bound's work) bound_ms "
                f"{bounds[kn][0]:.5f} "
                f"({bounds[kn][1]}) plain_ms {times[plain]:.4f} library_ms {times[lib]:.4f} "
                f"({times[kn] / times[lib]:.2f}x; scaled_dot_product_attention"
                f"{' backward, dq dk dv together' if kn != 'fwd' else ''})"
                + (f"; the first port's one-block kernel {FIRST_FP32_512_MS[kn]}"
                   if dt == f32 else ""))
        if dt == f32:
            log(f"[heads 512] D 512 fp32 dq + dk/dv {times['dq'] + times['dkv']:.4f} ms (the "
                f"first port's {FIRST_FP32_512_MS['dq'] + FIRST_FP32_512_MS['dkv']:.4f}) against "
                f"scaled_dot_product_attention's fp32 backward {times['bwd_lib']:.4f} "
                f"({(times['dq'] + times['dkv']) / times['bwd_lib']:.3f}x)")
        log(f"[heads 512] D 512 ({tag}) scaled_dot_product_attention: backends that take it "
            f"{took}; a default call's kernels {lib_kernels}")
        log(f"[heads 512] D 512 ({tag}) kernels in the profile of a forward, a dq and a dk/dv: "
            f"{names}")
        if not all(launched.values()):
            raise AssertionError(f"D 512 ({tag}) did not launch {want_names}: {names}")
        res["timed"][tag] = dict(times=times, bounds=bounds, tflops=tflops, sdpa_backends=took,
                                 sdpa_kernels=lib_kernels, kernels_seen=names)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

        G, R, L = HEADS_512_SERVE["num_kv_heads"], 2, FLAGSHIP["max_seq_len"]
        kc, vc, qd = randn(B, G, L, D, dtype=dt), randn(B, G, L, D, dtype=dt), randn(B, G, R, D,
                                                                                     dtype=dt)
        for p in (PROMPT + (NEW - 2) // 2, L - 1):
            pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
            ms = device_ms(torch, lambda: flash_decode(qd, kc, vc, pos), cold=True)
            plain_ms = device_ms(torch, lambda: flash_decode_plain(qd, kc, vc, pos), cold=True)
            k_live, v_live = kc[:, :, :p + 1], vc[:, :, :p + 1]
            q_lib = qd.view(B, G * R, 1, D)
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q_lib, k_live, v_live, enable_gqa=True), cold=True)
            took, lib_kernels = _sdpa_backends(torch, F, q_lib, k_live, v_live, enable_gqa=True)
            n_bytes = 2 * (elem * B * G * R * D) + 2 * (elem * B * G * (p + 1) * D) + 4 * B
            bms, by = bound_ms(n_bytes, 4 * B * G * R * (p + 1) * D, rate)
            res["timed"][f"decode_{tag}_pos{p}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                       bound_ms=bms, bound_by=by,
                                                       sdpa_backends=took)
            log(f"[heads 512] flash_decode D 512 ({tag}) B{B} G{G} R{R} L{L} pos {p}, L2 flushed: "
                f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{bms:.5f} ({by}); scaled_dot_product_attention backends that take it {took}, a "
                f"default call's kernels {lib_kernels}")
        del kc, vc, qd
    return res


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


PROFILE_PRIMERS = 8


def _device_kernels(torch, fn, reps: int, tries: int = 10):
    """The names of the device operations (kernels, copies, memsets) that
    ``reps`` calls of ``fn`` ran, one list a profile, from the profiler's
    raw activity records (launches made outside any PyTorch op, as the
    port's ctypes launchers make them, are not always attached to
    ``prof.events()``). A profile may drop records but invents none: on an
    H100 its first one or two device records went missing once earlier
    phases had run (4 or 3 records for 5 one-kernel calls, every profile
    alike), so each profile first runs ``PROFILE_PRIMERS`` spin kernels,
    which ``fn`` never launches, and their records are left out; a whole
    profile may still come back empty (on an H100, two of three in a row).
    Up to ``tries`` profiles are taken, until one holds a record for each of
    its ``reps`` calls or more. A first profile of the same calls is discarded:
    it warms the tracer up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for t in range(tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if t:
            seen.append([e.name() for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA and "spin_kernel" not in e.name()])
            if len(seen[-1]) >= reps:
                break
    return seen


def _serve_cell(torch, np, tag, cfg, model, prompt):
    """One ``generate`` request of ``model`` on ``prompt`` (batch 4, 128 new
    tokens, temperature 0.8, top_k 40) with the launch counters set to 0
    just before and read just after: ``num_layers`` forward launches,
    ``num_layers * 127`` flash-decode launches and no backward; then
    prefill ms (median of 5), decode ms a step over 64 steps, one profile
    each of a decode step and a prefill (device busy, idle share, the flash
    kernels' device ms) and the request's peak memory. Returns (the
    measurements, the request's tokens, the request as a function of its
    seed)."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode
    from kubeflow_tpu_torch.ops.pallas_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    B, P = prompt.shape

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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = gen(0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in counters.items()}
    # serving runs under inference_mode: the forward kernel alone, never
    # the autograd Function, so no backward kernel launches
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (NEW - 1),
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    log(f"[{tag}] launches in one request: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    if tuple(out.shape) != (B, P + NEW):
        raise AssertionError(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :P], prompt):
        raise AssertionError("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generate emitted an id outside the vocabulary")

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
    kt.decode_steps(model, cache, tok0, P, n=n_steps, temperature=TEMPERATURE,
                    top_k=TOP_K, generator=g)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps

    # device idle share: profiled device time vs the unprofiled wall time
    # of the same work
    busy_dec, ev_dec, ranked_dec = _profile(torch, lambda: kt.decode_steps(
        model, cache, tok0, P, n=1, temperature=TEMPERATURE, top_k=TOP_K,
        generator=g), reps=16)
    busy_pf, ev_pf, ranked_pf = _profile(torch, lambda: kt.prefill(model, prompt), reps=3)
    flash_dec = sum(ms for name, ms in ranked_dec if "flash_" in name)
    flash_pf = sum(ms for name, ms in ranked_pf if "flash_" in name)
    top_dec, top_pf = ranked_dec[:8], ranked_pf[:8]

    def idle(busy, wall):
        return 1.0 - busy / wall if busy > 0 else None

    res = dict(
        generate_s=gen_s, prefill_ms=prefill_ms,
        decode_ms_per_step=step_ms, tok_s=B * NEW / gen_s,
        tok_s_per_row=NEW / gen_s, peak_memory_gb=peak_gb,
        decode_device_busy_ms=busy_dec, decode_device_events=ev_dec,
        decode_idle_share=idle(busy_dec, step_ms), decode_top_kernels=top_dec,
        decode_flash_ms=flash_dec,
        prefill_device_busy_ms=busy_pf, prefill_device_events=ev_pf,
        prefill_idle_share=idle(busy_pf, prefill_ms), prefill_top_kernels=top_pf,
        prefill_flash_ms=flash_pf,
        launches=launches,
    )
    log(f"[{tag}] request B{B} P{P} +{NEW} (T={TEMPERATURE}, top_k={TOP_K}): "
        f"{gen_s * 1e3:.1f} ms, {res['tok_s']:.1f} tok/s ({res['tok_s_per_row']:.1f} "
        f"tok/s/row); prefill {prefill_ms:.2f} ms; decode {step_ms:.3f} ms/step; peak memory "
        f"{peak_gb:.2f} GB")
    for what, busy, ev, wall, top, flash in (
            ("decode step", busy_dec, ev_dec, step_ms, top_dec, flash_dec),
            ("prefill", busy_pf, ev_pf, prefill_ms, top_pf, flash_pf)):
        share = idle(busy, wall)
        log(f"[{tag}] {what}: device busy {busy:.3f} ms of {wall:.3f} ms, "
            f"{ev:.0f} device events, flash kernels {flash:.4f} ms, idle share "
            + (f"{share:.3f}" if share is not None else "not measured (no device time in the trace)"))
        for name, ms in top:
            log(f"[{tag}]   {ms:8.4f} ms  {name}")
    return res, out, gen


def phase_generate(torch, np):
    t0 = time.perf_counter()
    cfg, model, prompt = cells.decode_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[generate] flagship: {cfg.num_layers} layers, {n_params / 1e6:.1f}M parameters "
        f"(bf16), seeded init in {time.perf_counter() - t0:.2f} s")
    res, out, gen = _serve_cell(torch, np, "generate", cfg, model, prompt)
    if not torch.equal(gen(0), out):
        raise AssertionError("generate is not reproducible under one generator seed")
    return dict(params_m=n_params / 1e6, **res)


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


def phase_generate_fp32(torch, np):
    """``generate`` on a 2-layer fp32 flash model: the prefill and every
    decode step go through the fp32 kernels (launches counted), and one
    decode step's logits match the same model on the CPU."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode
    from kubeflow_tpu_torch.ops.pallas_attention import flash_attention

    cfg = kt.TransformerConfig(**dict(FLAGSHIP, num_layers=GEN_FP32_LAYERS), dtype=torch.float32)
    sd = kt.init_state_dict(cfg, seed=2, device="cpu")
    models = {}
    for where in ("cuda", "cpu"):
        models[where] = kt.TransformerLM(kt.decode_config(cfg), device=where)
        models[where].load_state_dict(sd)
    prompt = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, PROMPT)))
    flash_attention.launches = flash_decode.launches = 0
    out = kt.generate(models["cuda"], prompt, max_new_tokens=GEN_FP32_NEW)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (GEN_FP32_NEW - 1)}
    log(f"[generate fp32] {cfg.num_layers}-layer fp32 flash model, greedy B{BATCH} P{PROMPT} "
        f"+{GEN_FP32_NEW}: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"fp32 generate launch counts {launches} != {want}")
    ref = kt.generate(models["cpu"], prompt, max_new_tokens=GEN_FP32_NEW)
    agree = (out.cpu()[:, PROMPT:] == ref[:, PROMPT:]).float().mean().item()
    steps = {}
    with torch.inference_mode():
        for where, model in models.items():
            cache, last = kt.prefill(model, prompt)
            tok = ref[:, PROMPT].to(model.device, torch.int64)
            steps[where] = model(tok[:, None], start=PROMPT, cache=cache)[:, -1].float().cpu()
    err = (steps["cuda"] - steps["cpu"]).abs().max().item()
    log(f"[generate fp32] one decode step's logits card vs cpu (fp32 both): max_abs_err "
        f"{err:.3e} (atol {GEN_FP32_LOGITS_ATOL}; logits std {steps['cpu'].std().item():.3f}); "
        f"greedy tokens agree {agree:.3f}")
    if not torch.isfinite(steps["cuda"]).all() or err > GEN_FP32_LOGITS_ATOL:
        raise AssertionError(f"fp32 decode step disagrees with the CPU: {err}")
    return dict(launches=launches, step_logits_max_abs_err=err, token_agreement=agree)


def phase_generate_small_heads(torch, np):
    """``generate`` on a 2-layer flash model of 4 heads of D 32 (bf16): the
    prefill and every decode step run the kernels at D 32, padded to 64
    (launches counted); then the same model in fp32 (the FMA forward and
    flash-decode's fp32 route at D 32), one decode step's logits against
    the CPU."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops.flash_decode import flash_decode
    from kubeflow_tpu_torch.ops.pallas_attention import flash_attention

    cfg = kt.TransformerConfig(**SMALL_HEADS, dtype=torch.bfloat16)
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (BATCH, SMALL_HEADS_PROMPT)))
    model = kt.TransformerLM(kt.decode_config(cfg), device="cuda")
    model.load_state_dict(kt.init_state_dict(cfg, seed=3, device="cuda"))
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    flash_attention.launches = flash_decode.launches = 0
    out = kt.generate(model, prompt.to("cuda"), max_new_tokens=SMALL_HEADS_NEW,
                      temperature=TEMPERATURE, top_k=TOP_K, generator=g)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    want = {"flash_attention_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (SMALL_HEADS_NEW - 1)}
    log(f"[generate D 32] {cfg.num_layers}-layer bf16 flash model, {cfg.num_heads} heads of "
        f"D {cfg.head_dim}, B{BATCH} P{SMALL_HEADS_PROMPT} +{SMALL_HEADS_NEW}: launches "
        f"{launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"D 32 generate launch counts {launches} != {want}")
    if (tuple(out.shape) != (BATCH, SMALL_HEADS_PROMPT + SMALL_HEADS_NEW)
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
        raise AssertionError(f"D 32 generate returned {tuple(out.shape)} or ids outside the vocabulary")

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    sd = kt.init_state_dict(cfg32, seed=4, device="cpu")
    steps = {}
    with torch.inference_mode():
        for where in ("cuda", "cpu"):
            m = kt.TransformerLM(kt.decode_config(cfg32), device=where)
            m.load_state_dict(sd)
            cache, last = kt.prefill(m, prompt)
            tok = last.argmax(-1).to("cpu")
            steps[where] = m(tok[:, None].to(m.device), start=SMALL_HEADS_PROMPT,
                             cache=cache)[:, -1].float().cpu()
    err = (steps["cuda"] - steps["cpu"]).abs().max().item()
    log(f"[generate D 32] fp32 model, one decode step's logits card vs cpu: max_abs_err "
        f"{err:.3e} (atol {GEN_FP32_LOGITS_ATOL}; logits std {steps['cpu'].std().item():.3f})")
    if not torch.isfinite(steps["cuda"]).all() or err > GEN_FP32_LOGITS_ATOL:
        raise AssertionError(f"D 32 fp32 decode step disagrees with the CPU: {err}")
    return dict(launches=launches, fp32_step_logits_max_abs_err=err)


def _train_cell(torch, np, tag, bundle, tokens, counters, per_step, flops_tok, steps, vocab):
    """One warm-up step of ``bundle``, then ``steps`` timed steps with the
    launch counters (name -> wrapper) set to 0 just before and read just
    after, held to ``per_step`` launches a step; a finite loss near ln V
    that falls; then one profiled step. Returns the cell's measurements."""
    state = bundle.init()
    loss_log = []

    def step():
        _, metrics = bundle.step(state, tokens)
        loss_log.append(metrics["loss"])

    step()                                     # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {name: n * steps for name, n in per_step.items()}
    log(f"[{tag}] launches in {steps} steps: {launches} (expected {want}: {per_step} a step)")
    if launches != want:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    losses = [x.item() for x in loss_log]
    log(f"[{tag}] losses (warm-up, then the timed steps): {[round(x, 4) for x in losses]} "
        f"(ln V = {np.log(vocab):.4f})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    # tied head at flax's init scale: logits ~ N(0, 1), so ~ln V + 1/2
    if abs(losses[0] - np.log(vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln V")
    if not losses[-1] < losses[1] < losses[0]:
        raise AssertionError(f"the loss does not fall over the steps: {losses}")

    busy, events, ranked = _profile(torch, step, reps=1, top=12)
    top = ranked[:12]
    # device time by class of kernel: the hand-written kernels, cuBLAS and
    # CUTLASS GEMMs (bf16 projections, experts and head; the loss backward's
    # fp32 products), and PyTorch's elementwise, copy, scan and reduction kernels
    classes: dict[str, float] = {}
    for name, ms in ranked:
        cls = ("flash kernels" if "flash_" in name else "moe kernels" if "moe_" in name else
               "head kernels" if "fused_head" in name else
               "GEMM" if any(t in name for t in ("gemm", "nvjet", "xmma")) else "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    # each flash kernel's device ms, by its name without the argument list
    flash = {}
    for name, ms in ranked:
        if "flash_" in name:
            key = name.split(">(")[0] + ">" if ">(" in name else name[:80]
            flash[key] = flash.get(key, 0.0) + ms
    med = float(np.median(step_ms))
    tok_s = tokens.numel() / (med / 1e3)
    mfu = tok_s * flops_tok / BF16_FLOPS_PER_S
    idle = 1.0 - busy / med if busy > 0 else None
    log(f"[{tag}] step {med:.2f} ms median of {[round(x, 2) for x in step_ms]}; {tok_s:.1f} tok/s; "
        f"MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s ({flops_tok / 1e9:.3f} GFLOP/token); "
        f"peak memory {peak_gb:.2f} GB")
    log(f"[{tag}] one step: device busy {busy:.2f} ms, {events:.0f} device events, idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured (no device time in the trace)"))
    log(f"[{tag}]   by class: " + ", ".join(f"{cls} {ms:.3f} ms" for cls, ms in classes.items()))
    for name, ms in top:
        log(f"[{tag}]   {ms:9.3f} ms  {name}")
    return dict(losses=losses, step_ms=step_ms, step_ms_median=med, tok_s=tok_s, mfu=mfu,
                flops_per_token=flops_tok, peak_memory_gb=peak_gb, device_busy_ms=busy,
                device_events=events, idle_share=idle, top_kernels=top,
                device_ms_by_class=classes, flash_ms_by_kernel=flash, launches=launches)


def _flash_counters():
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    return {"flash_attention_fwd": pa.flash_attention,
            "flash_attention_bwd_dq": pa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": pa.flash_attention_bwd_dkv}


def phase_train(torch, np):
    t0 = time.perf_counter()
    cell = cells.dense_train()
    cfg, n_params = cell.cfg, cell.n_params
    torch.cuda.synchronize()
    if any(p.dtype != torch.float32 for p in cell.model.parameters()):
        raise AssertionError("a training model must hold fp32 parameters")
    log(f"[train] flagship: {cfg.num_layers} layers, {n_params / 1e6:.1f}M fp32 parameters, "
        f"seeded init in {time.perf_counter() - t0:.2f} s")
    counters = _flash_counters()
    res = _train_cell(torch, np, "train", cell.bundle, cell.tokens, counters,
                      {name: cfg.num_layers for name in counters}, cell.flops_per_token,
                      TRAIN_STEPS, cfg.vocab_size)
    return dict(params_m=n_params / 1e6, **res)


# the flagships with heads of 256 (Gemma's head width): the same widths and
# depths with half the heads, so the same parameters and attention FLOPs
WIDE_FLAGSHIP_TRAIN = dict(num_heads=4)
WIDE_FLAGSHIP_SERVE = dict(num_heads=4, num_kv_heads=2)
WIDE_FLAGSHIP_STEPS = 3


def phase_wide_flagships(torch, np, gen, train):
    """The flagships at heads of 256, through the width-256 kernels: the
    dense training flagship at 4 heads of 256 (``_cells.dense_train(
    num_heads=4)``: 24 layers, E 1024, 435.5M fp32 parameters, B4 S2048),
    one warm-up and three timed steps with flash launches 24/24/24 a step;
    the decode flagship at GQA 4/2 heads of 256 (``_cells.decode_model(
    num_heads=4, num_kv_heads=2)``, 410.3M parameters), one request with 24
    forward and 3,048 flash-decode launches. Each is printed beside the same
    numbers of the flagship at 8 heads of 128 from this run's train and
    generate phases: step ms, device busy, the flash kernels' share and each
    flash kernel's ms, peak memory; prefill and decode ms."""
    t0 = time.perf_counter()
    cell = cells.dense_train(**WIDE_FLAGSHIP_TRAIN)
    cfg = cell.cfg
    torch.cuda.synchronize()
    log(f"[wide flagship] train: {cfg.num_layers} layers, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, {cell.n_params / 1e6:.1f}M fp32 parameters, seeded init in "
        f"{time.perf_counter() - t0:.2f} s")
    if cfg.head_dim != 256:
        raise AssertionError(f"the wide flagship has heads of {cfg.head_dim}")
    counters = _flash_counters()
    wide_train = _train_cell(torch, np, "wide flagship train", cell.bundle, cell.tokens,
                             counters, {name: cfg.num_layers for name in counters},
                             cell.flops_per_token, WIDE_FLAGSHIP_STEPS, cfg.vocab_size)
    wide_train["params_m"] = cell.n_params / 1e6
    del cell
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scfg, model, prompt = cells.decode_model(**WIDE_FLAGSHIP_SERVE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[wide flagship] serve: {scfg.num_layers} layers, GQA {scfg.num_heads}/"
        f"{scfg.num_kv_heads} heads of {scfg.head_dim}, {n_params / 1e6:.1f}M parameters "
        f"(bf16), seeded init in {time.perf_counter() - t0:.2f} s")
    wide_gen, _, _ = _serve_cell(torch, np, "wide flagship generate", scfg, model, prompt)
    wide_gen["params_m"] = n_params / 1e6
    del model
    torch.cuda.empty_cache()

    for name, r, steps in (("8 heads of 128", train, TRAIN_STEPS),
                           ("4 heads of 256", wide_train, WIDE_FLAGSHIP_STEPS)):
        flash = r["device_ms_by_class"].get("flash kernels", 0.0)
        log(f"[wide flagship] train step, {name}: {r['step_ms_median']:.2f} ms median, "
            f"{r['tok_s']:.1f} tok/s, device busy {r['device_busy_ms']:.2f} ms, flash kernels "
            f"{flash:.2f} ms ({flash / r['device_busy_ms']:.3f} of busy), peak memory "
            f"{r['peak_memory_gb']:.2f} GB, flash launches a step "
            f"{[n // steps for n in r['launches'].values()]}")
        for kernel, ms in r["flash_ms_by_kernel"].items():
            log(f"[wide flagship]   {ms:9.3f} ms  {kernel}")
    for name, r in (("GQA 8/4 of 128", gen), ("GQA 4/2 of 256", wide_gen)):
        log(f"[wide flagship] request, {name}: {r['generate_s'] * 1e3:.1f} ms, prefill "
            f"{r['prefill_ms']:.2f} ms (busy {r['prefill_device_busy_ms']:.3f}, flash "
            f"{r['prefill_flash_ms']:.4f}), decode {r['decode_ms_per_step']:.3f} ms/step (busy "
            f"{r['decode_device_busy_ms']:.3f}, flash {r['decode_flash_ms']:.4f}), peak memory "
            f"{r['peak_memory_gb']:.2f} GB, launches {r['launches']}")
    return dict(train=wide_train, generate=wide_gen)


def phase_heads_512_flagships(torch, np, gen, train, wide):
    """The flagships at heads of 512, through the width-512 kernels: the
    dense training flagship at 2 heads of 512 (``_cells.dense_train(
    num_heads=2)``: 24 layers, E 1024, 435.5M fp32 parameters, B4 S2048),
    one warm-up and three timed steps with flash launches 24/24/24 a step
    and a finite, falling loss; the decode flagship at GQA 2/1 heads of 512
    (``_cells.decode_model(num_heads=2, num_kv_heads=1)``, 410.3M
    parameters), one request with 24 forward and 3,048 flash-decode
    launches. Each is printed beside the flagships at heads of 128 (phases
    3 and 5) and of 256 (phase 5b). Then one train step of ``HEADS_512``'s
    2-layer model (2 heads of 512 over one KV head at E 1024) at each of
    ``PARITY_SEEDS``, card against CPU, under phase 2b's heads-of-256
    bounds (:func:`wide_train_steps`)."""
    import kubeflow_tpu_torch as kt

    t0 = time.perf_counter()
    cell = cells.dense_train(**HEADS_512_TRAIN)
    cfg = cell.cfg
    torch.cuda.synchronize()
    log(f"[heads 512 flagship] train: {cfg.num_layers} layers, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, {cell.n_params / 1e6:.1f}M fp32 parameters, seeded init in "
        f"{time.perf_counter() - t0:.2f} s")
    if cfg.head_dim != 512:
        raise AssertionError(f"the heads-of-512 flagship has heads of {cfg.head_dim}")
    counters = _flash_counters()
    train512 = _train_cell(torch, np, "heads 512 flagship train", cell.bundle, cell.tokens,
                           counters, {name: cfg.num_layers for name in counters},
                           cell.flops_per_token, HEADS_512_STEPS, cfg.vocab_size)
    train512["params_m"] = cell.n_params / 1e6
    del cell
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scfg, model, prompt = cells.decode_model(**HEADS_512_SERVE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[heads 512 flagship] serve: {scfg.num_layers} layers, GQA {scfg.num_heads}/"
        f"{scfg.num_kv_heads} heads of {scfg.head_dim}, {n_params / 1e6:.1f}M parameters "
        f"(bf16), seeded init in {time.perf_counter() - t0:.2f} s")
    gen512, _, _ = _serve_cell(torch, np, "heads 512 flagship generate", scfg, model, prompt)
    gen512["params_m"] = n_params / 1e6
    del model
    torch.cuda.empty_cache()

    for name, r, steps in (("8 heads of 128", train, TRAIN_STEPS),
                           ("4 heads of 256", wide["train"], WIDE_FLAGSHIP_STEPS),
                           ("2 heads of 512", train512, HEADS_512_STEPS)):
        flash = r["device_ms_by_class"].get("flash kernels", 0.0)
        log(f"[heads 512 flagship] train step, {name}: {r['step_ms_median']:.2f} ms median, "
            f"{r['tok_s']:.1f} tok/s, device busy {r['device_busy_ms']:.2f} ms, flash kernels "
            f"{flash:.2f} ms ({flash / r['device_busy_ms']:.3f} of busy), peak memory "
            f"{r['peak_memory_gb']:.2f} GB, flash launches a step "
            f"{[n // steps for n in r['launches'].values()]}")
        for kernel, ms in r["flash_ms_by_kernel"].items():
            log(f"[heads 512 flagship]   {ms:9.3f} ms  {kernel}")
    for name, r in (("GQA 8/4 of 128", gen), ("GQA 4/2 of 256", wide["generate"]),
                    ("GQA 2/1 of 512", gen512)):
        log(f"[heads 512 flagship] request, {name}: {r['generate_s'] * 1e3:.1f} ms, prefill "
            f"{r['prefill_ms']:.2f} ms (busy {r['prefill_device_busy_ms']:.3f}, flash "
            f"{r['prefill_flash_ms']:.4f}), decode {r['decode_ms_per_step']:.3f} ms/step (busy "
            f"{r['decode_device_busy_ms']:.3f}, flash {r['decode_flash_ms']:.4f}), peak memory "
            f"{r['peak_memory_gb']:.2f} GB, launches {r['launches']}")
    diffs = wide_train_steps(torch, np, kt, kt.TransformerConfig(**HEADS_512,
                                                                 dtype=torch.bfloat16),
                             tag="heads 512 parity")
    return dict(train=train512, generate=gen512, train_step_diffs=diffs)


def _one_step_vs_cpu(torch, kt, make_model, sd, tokens, card_dtype=None, grads_out=None,
                     cpu_from=None, **step_kw):
    """One SGD step of the model on the card (bf16, or ``card_dtype``) and on
    the CPU (fp32) from one state dict: {where: (loss, global gradient norm)}.
    ``grads_out`` gets each side's gradients by parameter name (fp32, on the
    CPU) under "cuda" (bf16), "cuda_fp32" and "cpu"; ``cpu_from``, an earlier
    result of the same state and tokens, stands in for the CPU's step."""
    from kubeflow_tpu_torch.ops import optimizers as opt

    got = {"cpu": cpu_from["cpu"]} if cpu_from else {}
    card = "cuda" if card_dtype in (None, torch.bfloat16) else "cuda_fp32"
    for where, dtype in (("cuda", card_dtype or torch.bfloat16), ("cpu", torch.float32)):
        if where in got:
            continue
        model = make_model(dtype, where)
        model.load_state_dict(sd)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        norms = []
        sgd = opt.sgd(1e-3)

        def update(grads, state, params, where=where, names=names):
            norms.append(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)).item())
            if grads_out is not None:
                grads_out[card if where == "cuda" else "cpu"] = {
                    n: g.detach().float().cpu() for n, g in zip(names, grads)}
            return sgd.update(grads, state, params)

        bundle = kt.make_lm_train_step(model, opt.GradientTransformation(sgd.init, update),
                                       **step_kw)
        _, metrics = bundle.step(bundle.init(), tokens.to(where))
        got[where] = (metrics["loss"].item(), norms[0])
    return got


def _grad_errors(torch, got: dict, want: dict):
    """(relative L2 error of the whole gradient, {parameter: its relative L2
    error}) of ``got`` against ``want``, both by parameter name; parameters
    whose wanted gradient is zero are left out of the second."""
    diff = sum((got[n] - w).pow(2).sum().item() for n, w in want.items())
    whole = (diff / sum(w.pow(2).sum().item() for w in want.values())) ** 0.5
    per = {n: ((got[n] - w).norm() / w.norm()).item() for n, w in want.items() if w.norm() > 0}
    return whole, per


def _seeded_grad_check(torch, np, tag, one_seed, loss_atol, grad_rtol, param_rtol):
    """Hold a card-vs-CPU train step at each of ``PARITY_SEEDS``:
    ``one_seed(seed)`` gives ({where: (loss, grad norm)}, the card's
    gradients, the CPU's, a note for the line, its own check); the loss
    within ``loss_atol``, the relative L2 error of the whole gradient within
    ``grad_rtol`` and of each parameter's within ``param_rtol``. Returns
    {"seed<n>": distances}."""
    diffs, worst, ok = {}, (0.0, 0.0, 0.0), True
    t0 = time.perf_counter()
    for seed in PARITY_SEEDS:
        got, card, cpu, note, seed_ok = one_seed(seed)
        (loss_c, norm_c), (loss_h, norm_h) = got["cuda"], got["cpu"]
        whole, per = _grad_errors(torch, card, cpu)
        name, worst_p = max(per.items(), key=lambda kv: kv[1])
        d_loss, d_norm = abs(loss_c - loss_h), abs(norm_c - norm_h) / norm_h
        seed_ok = (seed_ok and bool(np.isfinite([loss_c, norm_c]).all()) and d_loss <= loss_atol
                   and whole <= grad_rtol and worst_p <= param_rtol)
        ok = ok and seed_ok
        diffs[f"seed{seed}"] = dict(loss=d_loss, grad_norm=d_norm, grad=whole, param=worst_p,
                                    param_name=name)
        worst = (max(worst[0], d_loss), max(worst[1], whole), max(worst[2], worst_p))
        log(f"[{tag}] seed {seed}, one step card(bf16) vs cpu(fp32): loss |diff| {d_loss:.2e}, "
            f"grad norm rel diff {d_norm:.2e}, gradient rel L2 err {whole:.3e} (rtol "
            f"{grad_rtol}), worst parameter {worst_p:.3e} ({name}; rtol {param_rtol}){note} "
            f"{'ok' if seed_ok else 'FAIL'}")
    log(f"[{tag}] seeds {PARITY_SEEDS[0]}-{PARITY_SEEDS[-1]}: worst loss |diff| {worst[0]:.2e} "
        f"(atol {loss_atol}), gradient rel L2 err {worst[1]:.3e}, parameter {worst[2]:.3e} "
        f"{'ok' if ok else 'FAIL'} in {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError(f"{tag}: a card train step disagrees with the CPU at a seed: {diffs}")
    return diffs


def phase_train_parity(torch, np):
    import kubeflow_tpu_torch as kt

    cfg = kt.TransformerConfig(**dict(TRAIN, num_layers=2), dtype=torch.bfloat16)
    sd = kt.init_state_dict(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)))
    got = _one_step_vs_cpu(
        torch, kt,
        lambda dtype, where: kt.TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where),
        sd, tokens, chunk=TRAIN_CHUNK)
    (loss_c, norm_c), (loss_h, norm_h) = got["cuda"], got["cpu"]
    d_loss, d_norm = abs(loss_c - loss_h), abs(norm_c - norm_h) / norm_h
    log(f"[train parity] 2-layer training width, B2 S256, one step card(bf16) vs cpu(fp32): "
        f"loss {loss_c:.5f} vs {loss_h:.5f} (|diff| {d_loss:.5f}, atol {TRAIN_LOSS_ATOL}); "
        f"grad norm {norm_c:.5f} vs {norm_h:.5f} (rel diff {d_norm:.2e}, rtol {TRAIN_GNORM_RTOL})")
    if not np.isfinite([loss_c, norm_c]).all() or d_loss > TRAIN_LOSS_ATOL or d_norm > TRAIN_GNORM_RTOL:
        raise AssertionError(f"card train step disagrees with the CPU: {got}")
    # the same step with fp32 activations on the card: the flash kernels'
    # fp32 route (TF32 off), held to the same limits
    got32 = _one_step_vs_cpu(
        torch, kt,
        lambda dtype, where: kt.TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where),
        sd, tokens, card_dtype=torch.float32, chunk=TRAIN_CHUNK)
    loss_f, norm_f = got32["cuda"]
    d_loss32, d_norm32 = abs(loss_f - loss_h), abs(norm_f - norm_h) / norm_h
    log(f"[train parity] the same step card(fp32, flash fp32 route) vs cpu(fp32): loss {loss_f:.5f} "
        f"(|diff| {d_loss32:.2e}, atol {TRAIN_LOSS_ATOL}); grad norm {norm_f:.5f} (rel diff "
        f"{d_norm32:.2e}, rtol {TRAIN_GNORM_RTOL})")
    if (not np.isfinite([loss_f, norm_f]).all() or d_loss32 > TRAIN_LOSS_ATOL
            or d_norm32 > TRAIN_GNORM_RTOL):
        raise AssertionError(f"card fp32 train step disagrees with the CPU: {got32}")
    return dict(loss_card=loss_c, loss_cpu=loss_h, grad_norm_card=norm_c,
                grad_norm_cpu=norm_h, loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm,
                fp32_card_loss_abs_diff=d_loss32, fp32_card_grad_norm_rel_diff=d_norm32,
                seeds=train_parity_seeds(torch, np, kt, cfg))


def train_parity_seeds(torch, np, kt, cfg):
    """Phase 6's bf16 step at ``PARITY_SEEDS`` (:func:`_seeded_grad_check`)."""
    def make(dtype, where):
        return kt.TransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where)

    def one_seed(seed):
        sd = kt.init_state_dict(cfg, seed=seed, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 256)))
        grads = {}
        got = _one_step_vs_cpu(torch, kt, make, sd, tokens, grads_out=grads, chunk=TRAIN_CHUNK)
        return got, grads["cuda"], grads["cpu"], "", True

    return _seeded_grad_check(torch, np, "train parity", one_seed, TRAIN_LOSS_ATOL,
                              TRAIN_GRAD_RTOL, TRAIN_PARAM_GRAD_RTOL)


def _index_stats(torch, idx, R):
    """(in-range indices, distinct rows they hit, sources per row [B, R, 1])."""
    valid = (idx >= 0) & (idx < R)
    spill = torch.where(valid, idx.long(), R)
    n = torch.zeros((idx.shape[0], R + 1), device=idx.device).scatter_add_(
        1, spill, torch.ones(idx.shape, device=idx.device))[:, :R]
    return int(valid.sum()), int((n > 0).sum()), n[..., None]


def _check_moe_case(torch, md, name, x, idx, gen):
    """The gather and both scatter modes on (x, idx) against the plain
    versions; the accumulating scatter also against its own order of
    operations (``scatter_replay``, bit for bit) and against a second
    launch (bit for bit); returns (gather max abs err, accumulate max abs
    err)."""
    B, R, M = x.shape
    J = idx.shape[1]
    dy = torch.randn((B, J, M), generator=gen, device="cuda").to(x.dtype)
    out = md.gather(x, idx)
    dx_acc = md.scatter(idx, dy, R, accumulate=True)
    dx_acc2 = md.scatter(idx, dy, R, accumulate=True)
    dx_uni = md.scatter(idx, dy, R, accumulate=False)
    torch.cuda.synchronize()
    out_ref = md.gather_rows_plain(x, idx)
    acc_ref = md.scatter_rows_plain(idx, dy, R, accumulate=True)
    uni_ref = md.scatter_rows_plain(idx, dy, R, accumulate=False)
    replay = md.scatter_replay(idx, dy, R)
    torch.cuda.synchronize()
    _, _, n = _index_stats(torch, idx, R)
    abs_sum = md.scatter_rows_plain(idx, dy.float().abs(), R, accumulate=True)
    g_err = (out.float() - out_ref.float()).abs().max().item() if out.numel() else 0.0
    single = (n <= 1).expand(B, R, M)
    uni_ok = dx_uni.dtype == x.dtype and torch.equal(dx_uni[single], uni_ref[single])
    err = (dx_acc - acc_ref).abs()
    bound = n * MOE_ACC_EPS * abs_sum
    few = (n <= 2).expand(B, R, M)
    ratio = (err / bound.clamp_min(1e-30)).max().item() if err.numel() else 0.0
    a_err = err.max().item() if err.numel() else 0.0
    same = torch.equal(dx_acc, dx_acc2)
    own = torch.equal(dx_acc, replay)
    acc_ok = (dx_acc.dtype == torch.float32 and bool(torch.isfinite(dx_acc).all())
              and bool((err <= bound).all()) and torch.equal(dx_acc[few], acc_ref[few])
              and same and own)
    ok = torch.equal(out, out_ref) and uni_ok and acc_ok
    log(f"[moe kernels] {name} B{B} R{R} M{M} J{J} {str(x.dtype)[6:]}: gather bit-equal "
        f"{torch.equal(out, out_ref)}; unique scatter bit-equal on {int(single[..., 0].sum())} "
        f"single-source rows {uni_ok}; accumulate max_abs_err {a_err:.3e}, worst "
        f"err/bound {ratio:.3f} (bound n*2^-23*sum|src|, rows of <= 2 sources exact: "
        f"{torch.equal(dx_acc[few], acc_ref[few])}; max sources a row {int(n.max().item()) if n.numel() else 0}; "
        f"rows of > {md.SEG} sources {int((n > md.SEG).sum())}), bit-equal to scatter_replay "
        f"{own}, two launches bit-equal {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"MoE gather/scatter kernels disagree with their plain versions ({name})")
    return g_err, a_err


def phase_moe_kernels(torch):
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.models import moe
    from kubeflow_tpu_torch.ops import moe_dispatch as md

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    bf16 = torch.bfloat16
    B, S, M = MOE_BATCH, MOE_SEQ, MOE["embed_dim"]
    E, k, C = MOE["num_experts"], MOE["experts_per_token"], kt.MoEConfig(**MOE).capacity(S)
    EC = E * C

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    # the flagship's indices from the port's own routing: router logits of
    # unit scale with expert 0 favoured, so it overflows and choices drop
    # (the combine's dropped choices all index the padding row E*C)
    logits = torch.randn((B, S, E), generator=gen, device="cuda")
    logits[..., 0] += 1.0
    plan = moe.route_top_k(logits, k, C)
    slot_token, combine_idx = moe.slot_indices(plan, E, C, S)
    dropped = int((plan.keep == 0).sum())
    empty = int((slot_token == S).sum())
    log(f"[moe kernels] flagship indices: C {C}, {EC} slots a row, {empty} empty slots "
        f"(index S = {S}), {dropped} of {k * B * S} choices dropped (index E*C = {EC})")
    if dropped == 0 or empty == 0:
        raise AssertionError("the flagship indices must have dropped choices and empty slots")

    x_pad = torch.cat([randn(B, S, M), torch.zeros((B, 1, M), dtype=bf16, device="cuda")], 1)
    out_pad = torch.cat([randn(B, EC, M), torch.zeros((B, 1, M), dtype=bf16, device="cuda")], 1)
    sentinels = slot_token.clone()
    sentinels[:, ::97] = S + 1 + 3
    sentinels[:, 5::101] = -1
    unique = torch.stack([torch.randperm(1000, generator=gen, device="cuda")[:64]
                          for _ in range(2)]).int()
    one_row_heavy = randint(0, 2048, 4, 5120)
    for b in range(4):
        one_row_heavy[b, torch.randperm(5120, generator=gen, device="cuda")[:1600]] = 2048
    cases = [
        ("dispatch_flagship", x_pad, slot_token),
        ("combine_flagship_0", out_pad, combine_idx[0]),
        ("combine_flagship_1", out_pad, combine_idx[1]),
        ("dispatch_sentinels", x_pad, sentinels),
        ("b1", randn(1, 300, 256), randint(0, 300, 1, 512)),
        ("j_lt_r_unique", randn(2, 1000, 128), unique),
        ("j_gt_r", randn(2, 50, 128), randint(0, 50, 2, 4096)),
        ("all_sentinels", randn(2, 64, 128), torch.full((2, 256), 64, dtype=torch.int32, device="cuda")),
        ("m100_fp32", randn(2, 77, 100, dtype=torch.float32), randint(-3, 80, 2, 300)),
        ("m100_bf16", randn(2, 77, 100), randint(-3, 80, 2, 300)),
        ("m7_bf16", randn(3, 20, 7), randint(0, 22, 3, 33)),
        ("m3_fp32", randn(3, 20, 3, dtype=torch.float32), randint(0, 22, 3, 33)),
        # every source on one row: 128 segments of 32 combined in order
        ("one_row_4096_sources", randn(2, 300, 1024), torch.full((2, 4096), 7, dtype=torch.int32,
                                                                  device="cuda")),
        ("r1", randn(2, 1, 256), randint(-1, 3, 2, 512)),
        ("m1024_j5120_1600_on_one_row", randn(4, 2049, 1024), one_row_heavy),
    ]
    worst_g = worst_a = 0.0
    for name, x, idx in cases:
        g_err, a_err = _check_moe_case(torch, md, name, x, idx, gen)
        worst_g, worst_a = max(worst_g, g_err), max(worst_a, a_err)

    # one device kernel a call in each mode (the index pass, the rows and
    # the heavy rows' combine are one cooperative launch): every record of
    # every profile names the mode's kernel alone, and no profile holds more
    # records than calls (a profile may drop records: on an H100 every one
    # of five profiles of this kernel held 3 or 4 for 5 calls)
    dy_disp, dy_comb = randn(B, EC, M), randn(B, S, M)
    for mode, kernel, fn in (
            ("accumulate", "scatter_add_kernel",
             lambda: md.scatter(slot_token, dy_disp, S + 1, accumulate=True)),
            ("direct store", "scatter_store_kernel",
             lambda: md.scatter(combine_idx[0], dy_comb, EC + 1, accumulate=False))):
        seen = _device_kernels(torch, fn, reps=5)
        kinds = sorted({n for names in seen for n in names})
        counts = [len(names) for names in seen]
        log(f"[moe kernels] moe_scatter {mode} at the flagship: device kernels "
            f"{[n[:60] for n in kinds]}; records a profile of 5 calls: {counts}")
        if len(kinds) != 1 or kernel not in kinds[0] or not 0 < max(counts) <= 5:
            raise AssertionError(f"moe_scatter {mode} must be one device kernel a call")

    # timed at the flagship's four launch shapes, L2 flushed before each call
    # (bound: HBM bytes, counted from this run's indices)
    def idx_exp(idx):
        return idx.long()[..., None].expand(-1, -1, M)

    launches = []
    for name, x, idx in (("dispatch", x_pad, slot_token), ("combine_0", out_pad, combine_idx[0]),
                         ("combine_1", out_pad, combine_idx[1])):
        R, J = x.shape[1], idx.shape[1]
        _, distinct, _ = _index_stats(torch, idx, R)
        n_bytes = distinct * M * 2 + B * J * M * 2 + B * J * 4
        ie = idx_exp(idx)
        launches.append(dict(
            kernel="moe_gather", launch=name, B=B, R=R, J=J, M=M,
            ms=device_ms(torch, lambda: md.gather(x, idx), cold=True),
            plain_ms=device_ms(torch, lambda: md.gather_rows_plain(x, idx), cold=True),
            library_ms=device_ms(torch, lambda: torch.gather(x, 1, ie), cold=True),
            bytes=n_bytes, flops=0, **dict(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, 0)))))
    for name, idx, dy, R, acc in (("dispatch_accumulate", slot_token, dy_disp, S + 1, True),
                                  ("combine_0_store", combine_idx[0], dy_comb, EC + 1, False),
                                  ("combine_1_store", combine_idx[1], dy_comb, EC + 1, False)):
        J = idx.shape[1]
        valid, distinct, _ = _index_stats(torch, idx, R)
        # accumulate needs every in-range source row; a direct store needs one
        # source a destination row (which of the colliding rows lands is
        # unspecified), as the gather's bound counts distinct rows
        n_bytes = (valid if acc else distinct) * M * 2 + B * R * M * (4 if acc else 2) + B * J * 4
        flops = valid * M if acc else 0
        ie = idx_exp(idx)
        if acc:
            def lib():
                return torch.zeros((B, R, M), device="cuda").scatter_add_(1, ie, dy.float())
        else:
            def lib():
                return torch.zeros((B, R, M), dtype=bf16, device="cuda").scatter_(1, ie, dy)
        launches.append(dict(
            kernel="moe_scatter", launch=name, B=B, R=R, J=J, M=M,
            ms=device_ms(torch, lambda: md.scatter(idx, dy, R, accumulate=acc), cold=True),
            plain_ms=device_ms(torch, lambda: md.scatter_rows_plain(idx, dy, R, accumulate=acc),
                               cold=True),
            library_ms=device_ms(torch, lib, cold=True), bytes=n_bytes, flops=flops,
            **dict(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, flops, FP32_FLOPS_PER_S)))))
    for t in launches:
        log(f"[moe kernels] {t['kernel']} {t['launch']} B{t['B']} R{t['R']} J{t['J']} M{t['M']} "
            f"bf16, L2 flushed: kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
            f"{t['library_ms']:.4f} bound_ms {t['bound_ms']:.5f} ({t['bound_by']}: {t['bytes']} B)")
    # the kernels line carries one layer's launches of each kernel: the
    # dispatch gather and the two combine gathers of the forward, the
    # accumulating and the two direct-store scatters of the backward
    results = {}
    for kernel, err in (("moe_gather", worst_g), ("moe_scatter", worst_a)):
        mine = [t for t in launches if t["kernel"] == kernel]
        results[kernel] = dict(
            max_abs_err=err, per=f"one layer's {len(mine)} launches, summed",
            **{key: sum(t[key] for t in mine)
                                for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by="bytes" if all(t["bound_by"] == "bytes" for t in mine) else "operations")
        log(f"[moe kernels] {kernel}, one layer's 3 launches: kernel_ms {results[kernel]['ms']:.4f} "
            f"plain_ms {results[kernel]['plain_ms']:.4f} library_ms {results[kernel]['library_ms']:.4f} "
            f"bound_ms {results[kernel]['bound_ms']:.5f}")
    return results, launches


def _mm_f32(torch, a, b):
    """a @ b in fp32 from operands of one dtype, on the card."""
    return torch.mm(a, b) if a.dtype == torch.float32 else torch.mm(a, b, out_dtype=torch.float32)


def _head_abs_products(torch, h, emb, tgt, lse, dlse, dgold):
    """(|dl| @ |emb|, |dl|^T @ |h|) in fp32, dl the plain version's dlogits
    in h's dtype: the sums of absolute products that bound the backward
    kernels' rounding and summation differences."""
    from kubeflow_tpu_torch.ops import fused_head_loss as fh

    T, E = h.shape
    V = emb.shape[0]
    cols = torch.arange(V, device=h.device)
    ah, ae = h.abs(), emb.abs()
    a_dh = torch.empty((T, E), dtype=torch.float32, device=h.device)
    a_de = torch.zeros((V, E), dtype=torch.float32, device=h.device)
    for s in range(0, T, fh.PLAIN_CHUNK):
        sl = slice(s, s + fh.PLAIN_CHUNK)
        logits = _mm_f32(torch, h[sl], emb.t())
        y = (cols[None, :] == tgt[sl, None]).float()
        dl = (dlse[sl, None] * torch.exp(logits - lse[sl, None]) + dgold[sl, None] * y)
        dl = dl.to(h.dtype).abs()
        a_dh[sl] = _mm_f32(torch, dl, ae)
        a_de += _mm_f32(torch, dl.t(), ah[sl])
    return a_dh, a_de


def _route_dlogits(torch, fh, h, emb, tgt, lse, dlse, dgold):
    """(route, plain): the bf16 dlogits [T, V] that the tensor-core route
    forms, and the plain version's. The route's logits are the partial
    logits of each cluster block over its own E slice (one fp32 tensor-core
    product of the slice), summed in block order; then dlse * exp(logit -
    lse) + dgold * [v == tgt] in fp32 without FMA, rounded to bf16. dh and
    dE form the same dlogits. One pass, E a multiple of 8."""
    T, E = h.shape
    V = emb.shape[0]
    plan = fh._plan(T, V, E, h.dtype)
    assert plan.route == "wgmma" and plan.passes == 1 and plan.e_pad == E, plan
    w = plan.slice
    logits = torch.zeros((T, V), dtype=torch.float32, device=h.device)
    for c in range(plan.cluster):
        logits += _mm_f32(torch, h[:, c * w:(c + 1) * w], emb[:, c * w:(c + 1) * w].t())
    cols = torch.arange(V, device=h.device)
    gold = torch.where(cols[None, :] == tgt[:, None], dgold[:, None], 0.0)
    route = (dlse[:, None] * torch.exp(logits - lse[:, None]) + gold).to(h.dtype)
    logits = _mm_f32(torch, h, emb.t())
    y = (cols[None, :] == tgt[:, None]).float()
    plain = (dlse[:, None] * torch.exp(logits - lse[:, None]) + dgold[:, None] * y).to(h.dtype)
    return route, plain


def _bf16_steps(torch, a, b):
    """How many bf16 values lie between a and b, elementwise, plus one
    (0 where equal, 1 where neighbours; +0 and -0 are one value)."""
    def key(x):
        k = x.view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return (key(a) - key(b)).abs()


def _head_witness(torch, fh, h, emb, tgt, lse_p, dlse, dgold, dh, de):
    """The bf16 backward kernels held to the exact sums of the route's own
    dlogits: no route dlogit lies more than one bf16 step from the plain
    version's, and dh and dE are within 2 V (2 T) 2^-24 sum|products| of the
    float64 products of the route's dlogits, the summation term of
    _check_head_case without its one-step term. Returns the ratios and the
    dlogit counts."""
    T, E = h.shape
    V = emb.shape[0]
    route, plain = _route_dlogits(torch, fh, h, emb, tgt, lse_p, dlse, dgold)
    steps = _bf16_steps(torch, route, plain)
    d, hd, ed = route.double(), h.double(), emb.double()
    a_dh, a_de = d.abs() @ ed.abs(), d.abs().t() @ hd.abs()
    out = {
        "dh": ((dh.double() - d @ ed).abs() / (2 * V * HEAD_EPS * a_dh).clamp_min(1e-30))
        .max().item(),
        "de": ((de.double() - d.t() @ hd).abs() / (2 * T * HEAD_EPS * a_de).clamp_min(1e-30))
        .max().item(),
        "dlogits": int(route.numel()),
        "one_step_from_plain": int((steps == 1).sum().item()),
        "further_from_plain": int((steps > 1).sum().item()),
    }
    out["ok"] = bool(out["dh"] <= 1.0 and out["de"] <= 1.0 and out["further_from_plain"] == 0)
    return out


def _entry_ptxas(log_text, fragment):
    """ptxas's register and spill lines for the entry functions of a build
    log whose mangled names hold ``fragment``, each led by its entry."""
    entry, lines = None, []
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split(chr(39))[1]
        elif entry and fragment in entry and ("registers" in ln or "spill" in ln):
            lines.append(f"{entry[:64]}: {ln.strip()}")
    return lines


def _check_head_case(torch, fh, name, h, emb, tgt, dlse, dgold, witness=False):
    """The three head kernels on one case against their plain versions; the
    backward kernels take the plain forward's lse. Returns the worst
    absolute errors (lse and gold, dh, dE) and the ratios of error to bound.
    bf16 operands take the tensor-core route, fp32 the fp32 route (the
    FMA forward, dh and dE; unrounded dlogits: the one-step term
    is fp32's unit roundoff).

    ``witness``: a case whose logits are so large that the route's and the
    plain version's fp32 logits differ in enough bits to round many dlogits
    to neighbouring bf16 values, where one step of bf16 may be up to 2^-7 of
    the dlogit (twice the one-step term). dh and dE are then held to the
    exact sums of the route's own dlogits (_head_witness), and their ratios
    to the one-step bound are reported."""
    T, E = h.shape
    V = emb.shape[0]
    lse, gold = fh.fused_head_fwd(h, emb, tgt)
    torch.cuda.synchronize()
    lse_p, gold_p = fh.lse_gold_plain(h, emb, tgt)
    dh = fh.fused_head_bwd_dh(h, emb, tgt, lse_p, dlse, dgold)
    de = fh.fused_head_bwd_de(h, emb, tgt, lse_p, dlse, dgold)
    torch.cuda.synchronize()
    dh_p, de_p = fh.head_grads_plain(h, emb, tgt, lse_p, dlse, dgold)
    a_dh, a_de = _head_abs_products(torch, h, emb, tgt, lse_p, dlse, dgold)
    torch.cuda.synchronize()
    # a logit is a sum of E products: each order within E 2^-24 sum|products|
    # of the exact sum, and sum|products| <= |h_t| max_v |emb_v|
    logit_tol = (2 * E * HEAD_EPS * h.float().norm(dim=1)
                 * emb.float().norm(dim=1).max())
    # lse: the logits' error, plus the V-term sum of exponentials in two
    # orders (relative 2 V 2^-24 of the sum, so absolute in its log), plus
    # the rounding of exp and log
    lse_tol = logit_tol + 2 * V * HEAD_EPS + 4 * HEAD_EPS * lse_p.abs()
    # a dlogit may land one step (bf16: 2^-8 of itself; fp32 dlogits are not
    # rounded: 2^-24) apart where p differs in its last fp32 bits; then V
    # (dh) or T (dE) products summed in two orders
    step = HEAD_DL_STEP if h.dtype == torch.bfloat16 else HEAD_EPS
    ratios = {
        "lse": ((lse - lse_p).abs() / lse_tol).max().item(),
        "gold": ((gold - gold_p).abs() / logit_tol).max().item(),
        "dh": ((dh - dh_p).abs() / ((step + 2 * V * HEAD_EPS) * a_dh)
               .clamp_min(1e-30)).max().item(),
        "de": ((de - de_p).abs() / ((step + 2 * T * HEAD_EPS) * a_de)
               .clamp_min(1e-30)).max().item(),
    }
    errs = {"lse": max((lse - lse_p).abs().max().item(), (gold - gold_p).abs().max().item()),
            "dh": (dh - dh_p).abs().max().item(), "de": (de - de_p).abs().max().item()}
    finite = all(bool(x.isfinite().all()) for x in (lse, gold, dh, de))
    held = ("lse", "gold") if witness else tuple(ratios)
    ok = finite and all(ratios[k] <= 1.0 for k in held)
    log(f"[head kernels] {name} T{T} V{V} E{E} {str(h.dtype)[6:]}: worst err/tol " + ", ".join(
        f"{k} {v:.3f}" for k, v in ratios.items()) + f"; max_abs_err lse/gold {errs['lse']:.3e} "
        f"dh {errs['dh']:.3e} dE {errs['de']:.3e} (|dh| max {dh_p.abs().max().item():.3e}, "
        f"|dE| max {de_p.abs().max().item():.3e}) "
        f"{'held to the witness below' if witness else 'ok' if ok else 'FAIL'}")
    if witness:
        w = _head_witness(torch, fh, h, emb, tgt, lse_p, dlse, dgold, dh, de)
        ratios["witness"] = w
        ok = ok and w["ok"]
        log(f"[head kernels] {name} witness: of {w['dlogits']} route dlogits "
            f"{w['one_step_from_plain']} lie one bf16 step from the plain version's, "
            f"{w['further_from_plain']} further (limit 0); dh, dE against the float64 sums of "
            f"the route's dlogits: worst err/tol {w['dh']:.3f}, {w['de']:.3f} (tol 2 V (T) "
            f"2^-24 sum|products|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused head kernels disagree with their plain versions ({name})")
    return errs, ratios


def _check_head_contention(torch, fh, side_ops, solo):
    """dh and dE at the MoE flagship, bf16 and fp32 (more row tiles than
    clusters fit at once, so clusters wait on each other's flags), each
    launched while another stream's kernel holds every SM: the fp32 dE at E
    128 over the flagship's tokens and vocabulary (``side_ops``; 250 row
    tiles of 128 on clusters of one block, one block an SM, so the launch
    takes as many as the card holds). Each must launch, finish and equal its
    solo launch (``solo``: key -> (wrapper, operands, output)) bit for bit."""
    side = torch.cuda.Stream()
    T, V = side_ops[0].shape[0], side_ops[1].shape[0]
    plan = fh._plan(T, V, side_ops[0].shape[1], torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = min(-(-V // plan.rows), sms // plan.cluster)
    log(f"[head kernels] contender: fp32 dE at T{T} V{V} E{side_ops[0].shape[1]}, "
        f"{plan.cluster}-block clusters, {-(-V // plan.rows)} row tiles on at most {clusters} "
        f"clusters ({clusters * plan.cluster} of {sms} SMs, one block an SM)")
    ev = {k: torch.cuda.Event(enable_timing=True) for k in ("side0", "side1", "main0", "main1")}
    out = {}
    for key, (fn, args, want) in solo.items():
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            ev["side0"].record()
            fh.fused_head_bwd_de(*side_ops)
            ev["side1"].record()
        ev["main0"].record()
        got = fn(*args)
        ev["main1"].record()
        torch.cuda.synchronize()
        out[key] = dict(bitwise_equal_solo=bool(torch.equal(got, want)),
                        side_ms=ev["side0"].elapsed_time(ev["side1"]),
                        launched_at_ms=ev["side0"].elapsed_time(ev["main0"]),
                        finished_at_ms=ev["side0"].elapsed_time(ev["main1"]))
        log(f"[head kernels] {key} under contention: launched {out[key]['launched_at_ms']:.3f} "
            f"ms into the other stream's {out[key]['side_ms']:.3f} ms kernel, finished at "
            f"{out[key]['finished_at_ms']:.3f} ms; bitwise equal to its solo launch: "
            f"{out[key]['bitwise_equal_solo']}")
    if not all(v["bitwise_equal_solo"] for v in out.values()):
        raise AssertionError(f"fused head backward differs under contention: {out}")
    return out


def phase_head_kernels(torch, np):
    """The fused head's three kernels against their plain versions on the
    card in bf16, at the MoE flagship's head shape and at edge cases, then
    timed with the plain versions, the library yardstick and the bound; and
    the whole head, forward and backward, fused against chunked."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import fused_head_loss as fh

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf16 = torch.bfloat16
    T, V, E = MOE_BATCH * MOE_SEQ, MOE["vocab_size"], MOE["embed_dim"]

    def operands(T, V, E, tgt=None, dtype=bf16):
        """h ~ N(0, 1) (a final norm's output) and the table at flax's init
        scale, std 1/sqrt(E), so logits ~ N(0, 1); targets uniform."""
        h = torch.randn((T, E), generator=gen, device="cuda").to(dtype)
        emb = (torch.randn((V, E), generator=gen, device="cuda") / E ** 0.5).to(dtype)
        if tgt is None:
            tgt = torch.randint(0, V, (T,), generator=gen, device="cuda")
        return h, emb, tgt

    def nll_cot(T):
        """The mean NLL's cotangents: dlse = 1/n, dgold = -1/n on every
        position but the last of each row."""
        mask = torch.ones((MOE_BATCH, T // MOE_BATCH), device="cuda")
        mask[:, -1] = 0
        mask = mask.reshape(T) / mask.sum()
        return mask, -mask

    def randn_rows(T):
        return torch.randn((T,), generator=gen, device="cuda")

    # the flagship: the MoE train phase's tokens, targets roll(tokens, -1)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, V, (MOE_BATCH, MOE_SEQ))).to("cuda")
    tgt_flag = torch.roll(tokens, -1, dims=1).reshape(T)
    h, emb, _ = operands(T, V, E, tgt_flag)
    dlse, dgold = nll_cot(T)
    worst = {"lse": 0.0, "dh": 0.0, "de": 0.0}
    detail = {"cases": {}}

    def run(name, h, emb, tgt, dlse, dgold, witness=False):
        errs, ratios = _check_head_case(torch, fh, name, h, emb, tgt, dlse, dgold, witness)
        detail["cases"][name] = dict(shape=[h.shape[0], emb.shape[0], h.shape[1]],
                                     dtype=str(h.dtype)[6:], worst_err_over_tol=ratios,
                                     max_abs_err=errs)
        if h.dtype == bf16:     # the kernels line holds the bf16 route
            for k, v in errs.items():
                worst[k] = max(worst[k], v)

    run("flagship_nll", h, emb, tgt_flag, dlse, dgold)
    # cotangents: dlse only, dgold only, both at random (T 1024 of the flagship)
    hs, ts = h[:1024].contiguous(), tgt_flag[:1024].contiguous()
    zero = torch.zeros(1024, device="cuda")
    run("dlse_only", hs, emb, ts, randn_rows(1024), zero)
    run("dgold_only", hs, emb, ts, zero, randn_rows(1024))
    run("mixed_random", hs, emb, ts, randn_rows(1024), randn_rows(1024))
    # T not a multiple of the 64-token tile
    run("t300", *operands(300, 5000, E), randn_rows(300), randn_rows(300))
    # V with no 128-multiple divisor; GPT-2's vocabulary with targets in the
    # last, partial vocabulary tile, and targets outside [0, V)
    run("v97", *operands(512, 97, E), randn_rows(512), randn_rows(512))
    h2, e2, t2 = operands(1024, 50_257, E)
    t2[::3] = 50_257 - 1 - torch.arange(0, 1024, 3, device="cuda") % 17
    t2[1::50], t2[2::50] = 50_257, -1
    run("v50257_last_tile", h2, e2, t2, randn_rows(1024), randn_rows(1024))
    # V smaller than one tile; E = 128; E not a multiple of 8 (element loads)
    run("v40", *operands(256, 40, 256), randn_rows(256), randn_rows(256))
    run("e128", *operands(1024, 4096, 128), randn_rows(1024), randn_rows(1024))
    run("e100", *operands(200, 300, 100), randn_rows(200), randn_rows(200))
    # two E chunks a forward tile (E 256 and 200), blocks walking ranges of
    # two and three vocabulary tiles
    run("e256_two_chunks", *operands(1024, 5000, 256), randn_rows(1024), randn_rows(1024))
    run("e200_two_chunks", *operands(2048, 3000, 200), randn_rows(2048), randn_rows(2048))
    # rows whose logits are all large: a shared column of the table and an
    # h entry of +-80 there put every logit of the row near +80 or -80
    h3, e3, t3 = operands(256, 5000, E)
    e3[:, 0] = 1.0
    h3[5, 0], h3[6, 0] = 80.0, -80.0
    run("large_logits", h3, e3, t3, randn_rows(256), randn_rows(256), witness=True)
    # E split across clusters of 3 and 8 blocks (GPT-2's 768, 2048), and
    # above E 2048 in two passes over each block's 512 columns
    run("e768_cluster3", *operands(512, 3000, 768), randn_rows(512), randn_rows(512))
    run("e2048_cluster8", *operands(384, 2000, 2048), randn_rows(384), randn_rows(384))
    run("e4096_passes2", *operands(256, 1500, 4096), randn_rows(256), randn_rows(256))
    # the fp32 route (the FMA forward, dh and dE; no TF32): the
    # flagship E, V with no 128-multiple divisor, E not a multiple of 8 and
    # not of 4 (padded to 100), a cluster of 6 (GPT-2's 768), passes over E
    # 2048, 4096 and past the bf16 route's 8192 (nine passes), ragged T with
    # V 97 and targets outside [0, V), and the flagship shape itself
    f32 = torch.float32
    run("f32_e1024", *operands(1024, 4096, E, dtype=f32), randn_rows(1024), randn_rows(1024))
    run("f32_v97", *operands(512, 97, E, dtype=f32), randn_rows(512), randn_rows(512))
    run("f32_e100", *operands(200, 300, 100, dtype=f32), randn_rows(200), randn_rows(200))
    run("f32_e99", *operands(200, 300, 99, dtype=f32), randn_rows(200), randn_rows(200))
    run("f32_e768_cluster6", *operands(512, 3000, 768, dtype=f32), randn_rows(512),
        randn_rows(512))
    run("f32_e2048_passes2", *operands(384, 2000, 2048, dtype=f32), randn_rows(384),
        randn_rows(384))
    run("f32_e4096_passes4", *operands(256, 1500, 4096, dtype=f32), randn_rows(256),
        randn_rows(256))
    run("f32_e8200_passes9", *operands(256, 500, 8200, dtype=f32), randn_rows(256),
        randn_rows(256))
    h4, e4, t4 = operands(300, 97, E, dtype=f32)
    t4[1::7], t4[2::11] = 97, -1
    run("f32_t300_v97_outside", h4, e4, t4, randn_rows(300), randn_rows(300))
    h32, emb32, _ = operands(T, V, E, tgt_flag, dtype=f32)
    run("f32_flagship_nll", h32, emb32, tgt_flag, dlse, dgold)

    # no atomics on the sums: two launches of each kernel agree bit for bit
    # (the forward's ranges combine in range order whichever block is last),
    # bf16 and fp32
    same, solo = {}, {}
    for tag, hh, ee in (("", h, emb), ("_f32", h32, emb32)):
        lse_d, _ = fh.lse_gold_plain(hh, ee, tgt_flag)
        first, again = fh.fused_head_fwd(hh, ee, tgt_flag), fh.fused_head_fwd(hh, ee, tgt_flag)
        same["fwd" + tag] = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
        del first, again
        for key, fn in (("dh", fh.fused_head_bwd_dh), ("dE", fh.fused_head_bwd_de)):
            args = (hh, ee, tgt_flag, lse_d, dlse, dgold)
            solo[key + tag] = (fn, args, fn(*args))
            same[key + tag] = bool(torch.equal(solo[key + tag][2], fn(*args)))
    detail["bitwise_equal_relaunch"] = same
    log(f"[head kernels] determinism at the flagship, two launches bitwise equal: {same}")
    if not all(same.values()):
        raise AssertionError(f"fused head kernels differ between two launches: {same}")
    side_ops = (h32[:, :128].contiguous(), emb32[:, :128].contiguous(), tgt_flag,
                *solo["dh_f32"][1][3:])
    detail["contention"] = _check_head_contention(torch, fh, side_ops, solo)
    del solo, side_ops, h32, emb32

    # timed at the flagship head shape, L2 warm (h and the table come
    # straight from the final norm and the optimizer; neither fits in L2)
    lse, _ = fh.lse_gold_plain(h, emb, tgt_flag)
    tg = tgt_flag.long()[:, None]

    def lib_fwd():
        logits = torch.mm(h, emb.t(), out_dtype=torch.float32)
        return torch.logsumexp(logits, -1), logits.gather(1, tg)

    def lib_dl():
        logits = torch.mm(h, emb.t(), out_dtype=torch.float32)
        p = torch.exp(logits - lse[:, None])
        return p.mul_(dlse[:, None]).scatter_add_(1, tg, dgold[:, None]).to(bf16)

    times = dict(
        fwd=device_ms(torch, lambda: fh.fused_head_fwd(h, emb, tgt_flag), cold=False, iters=10),
        fwd_plain=device_ms(torch, lambda: fh.lse_gold_plain(h, emb, tgt_flag), cold=False, iters=10),
        fwd_lib=device_ms(torch, lib_fwd, cold=False, iters=10),
        dh=device_ms(torch, lambda: fh.fused_head_bwd_dh(h, emb, tgt_flag, lse, dlse, dgold),
                     cold=False, iters=5),
        dh_plain=device_ms(torch, lambda: fh.head_grads_plain(h, emb, tgt_flag, lse, dlse, dgold,
                                                              de=False), cold=False, iters=5),
        dh_lib=device_ms(torch, lambda: torch.mm(lib_dl(), emb, out_dtype=torch.float32),
                         cold=False, iters=5),
        de=device_ms(torch, lambda: fh.fused_head_bwd_de(h, emb, tgt_flag, lse, dlse, dgold),
                     cold=False, iters=5),
        de_plain=device_ms(torch, lambda: fh.head_grads_plain(h, emb, tgt_flag, lse, dlse, dgold,
                                                              dh=False), cold=False, iters=5),
        de_lib=device_ms(torch, lambda: torch.mm(lib_dl().t(), h, out_dtype=torch.float32),
                         cold=False, iters=5),
    )
    # the fp32 route at the same shape (the FMA forward, dh and dE), beside
    # its plain versions and the library on fp32 operands:
    # torch.mm on materialised fp32 logits, TF32 off
    h32, emb32 = h.float(), emb.float()

    def lib_fwd32():
        logits = torch.mm(h32, emb32.t())
        return torch.logsumexp(logits, -1), logits.gather(1, tg)

    def lib_dl32():
        p = torch.exp(torch.mm(h32, emb32.t()) - lse[:, None])
        return p.mul_(dlse[:, None]).scatter_add_(1, tg, dgold[:, None])

    times.update(
        fwd_f32=device_ms(torch, lambda: fh.fused_head_fwd(h32, emb32, tgt_flag), cold=False,
                          iters=2, warmup=1),
        dh_f32=device_ms(torch, lambda: fh.fused_head_bwd_dh(h32, emb32, tgt_flag, lse, dlse,
                                                             dgold), cold=False, iters=2, warmup=1),
        de_f32=device_ms(torch, lambda: fh.fused_head_bwd_de(h32, emb32, tgt_flag, lse, dlse,
                                                             dgold), cold=False, iters=2, warmup=1),
        fwd_f32_plain=device_ms(torch, lambda: fh.lse_gold_plain(h32, emb32, tgt_flag),
                                cold=False, iters=2, warmup=1),
        dh_f32_plain=device_ms(torch, lambda: fh.head_grads_plain(h32, emb32, tgt_flag, lse, dlse,
                                                                  dgold, de=False),
                               cold=False, iters=2, warmup=1),
        de_f32_plain=device_ms(torch, lambda: fh.head_grads_plain(h32, emb32, tgt_flag, lse, dlse,
                                                                  dgold, dh=False),
                               cold=False, iters=2, warmup=1),
        fwd_f32_lib=device_ms(torch, lib_fwd32, cold=False, iters=2, warmup=1),
        dh_f32_lib=device_ms(torch, lambda: torch.mm(lib_dl32(), emb32), cold=False, iters=2,
                             warmup=1),
        de_f32_lib=device_ms(torch, lambda: torch.mm(lib_dl32().t(), h32), cold=False, iters=2,
                             warmup=1),
    )
    del h32, emb32
    rows = 16 * T                                    # tgt, lse, dlse, dgold
    operand = 2 * T * E + 2 * V * E
    tve = T * V * E
    bounds = {"fwd": bound_ms(operand + 4 * T + 8 * T, 2 * tve),
              "dh": bound_ms(operand + rows + 4 * T * E, 4 * tve),
              "de": bound_ms(operand + rows + 4 * V * E, 4 * tve)}
    # the fp32 route's: fp32 operands, the FLOPs at the fp32 peak
    bounds_f32 = {"fwd": bound_ms(2 * operand + 4 * T + 8 * T, 2 * tve, FP32_FLOPS_PER_S),
                  "dh": bound_ms(2 * operand + rows + 4 * T * E, 4 * tve, FP32_FLOPS_PER_S),
                  "de": bound_ms(2 * operand + rows + 4 * V * E, 4 * tve, FP32_FLOPS_PER_S)}
    names = {"fwd": "fused_head_fwd", "dh": "fused_head_bwd_dh", "de": "fused_head_bwd_de"}
    errs = {"fwd": worst["lse"], "dh": worst["dh"], "de": worst["de"]}
    results = {}
    plan = fh._plan(T, V, E, bf16)
    fwd_plan = fh._fwd_plan(T, V, E, bf16, torch.cuda.get_device_properties(0).multi_processor_count)
    detail["plan"] = dataclasses.asdict(plan)
    detail["fwd_plan"] = dataclasses.asdict(fwd_plan)
    detail["fwd_registers"] = [ln.strip() for ln in _build.build_log("fused_head_fwd").splitlines()
                               if "registers" in ln or "spill" in ln or "C75" in ln]
    detail["bwd_fp32_registers"] = {name: _entry_ptxas(_build.build_log(name), "head_bwd_fma")
                                    for name in ("fused_head_bwd_dh", "fused_head_bwd_de")}
    detail["fp32_route_ms"] = {k: times[k + "_f32"] for k in ("fwd", "dh", "de")}
    detail["fp32_route_plain_ms"] = {k: times[k + "_f32_plain"] for k in ("fwd", "dh", "de")}
    detail["fp32_route_library_ms"] = {k: times[k + "_f32_lib"] for k in ("fwd", "dh", "de")}
    detail["fp32_route_bound_ms"] = {k: b for k, (b, _) in bounds_f32.items()}
    log(f"[head kernels] forward plan: {fwd_plan}")
    for ln in detail["fwd_registers"]:
        log(f"[head kernels] forward ptxas: {ln[:160]}")
    for name, lines in detail["bwd_fp32_registers"].items():
        for ln in lines:
            log(f"[head kernels] {name} fp32 route ptxas: {ln[:160]}")
    log(f"[head kernels] timed at T{T} V{V} E{E} bf16, L2 warm; library = torch.mm(out_dtype="
        f"fp32) + logsumexp + gather (forward), + exp, bf16 dlogits, torch.mm (dh, dE); "
        f"backward plan: {plan}:")
    for key, name in names.items():
        (bms, by) = bounds[key]
        results[name] = dict(max_abs_err=errs[key], ms=times[key], plain_ms=times[key + "_plain"],
                             library_ms=times[key + "_lib"], bound_ms=bms, bound_by=by)
        log(f"[head kernels]   {name} kernel_ms {times[key]:.4f} plain_ms "
            f"{times[key + '_plain']:.4f} library_ms {times[key + '_lib']:.4f} bound_ms "
            f"{bms:.5f} ({by}; {2 * tve * (1 if key == 'fwd' else 2) / times[key] / 1e9:.1f} "
            f"TFLOP/s of the bound's work); fp32 route {times[key + '_f32']:.4f} ms ("
            f"{2 * tve * (1 if key == 'fwd' else 2) / times[key + '_f32'] / 1e9:.1f} TFLOP/s; bound "
            f"{bounds_f32[key][0]:.5f} at {FP32_FLOPS_PER_S / 1e12:.0f} TF/s, {bounds_f32[key][1]}; "
            + f"plain {times[key + '_f32_plain']:.4f} ms; "
            + (f"the first scalar kernel {SCALAR_FP32_FWD_MS[name]} ms; " if key == "fwd" else "")
            + f"library on fp32 operands, TF32 off, {times[key + '_f32_lib']:.4f} ms)")

    # the whole head, forward + backward, fused against the chunked head
    # (chunk 1024): the choice moe_bench.py --ab measured on the TPU
    hidden = h.reshape(MOE_BATCH, MOE_SEQ, E).detach().requires_grad_()
    table = emb.float().requires_grad_()

    def head(fn):
        def step():
            loss = fn(hidden, table, tokens)
            return torch.autograd.grad(loss, (hidden, table))
        return step

    fused = head(lambda hd, tb, tk: kt.fused_head_nll(hd, tb, tk))
    chunked = head(lambda hd, tb, tk: kt.lm_loss_chunked(hd, tb, tk, chunk=cells.MOE_CHUNK))
    whole = {}
    for name, fn in (("fused", fused), ("chunked", chunked)):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        whole[name] = dict(ms=device_ms(torch, fn, cold=False, iters=5), peak_gb_above_inputs=peak)
        log(f"[head kernels] whole head fwd+bwd, {name}: {whole[name]['ms']:.3f} device ms, peak "
            f"{peak:.3f} GB above its inputs")
    return results, whole, detail


def _head_counters():
    from kubeflow_tpu_torch.ops import fused_head_loss as fh

    return {"fused_head_fwd": fh.fused_head_fwd, "fused_head_bwd_dh": fh.fused_head_bwd_dh,
            "fused_head_bwd_de": fh.fused_head_bwd_de}


def phase_moe_train(torch, np, fused: bool = False):
    from kubeflow_tpu_torch.ops import moe_dispatch as md

    tag = "moe train fused" if fused else "moe train"

    t0 = time.perf_counter()
    cell = cells.moe_train(head="fused" if fused else "chunked")
    cfg, model, bundle, tokens = cell.cfg, cell.model, cell.bundle, cell.tokens
    n_params, n_active = cell.n_params, cell.n_active
    E, k, L, C = cfg.num_experts, cfg.experts_per_token, cfg.num_layers, cfg.capacity(MOE_SEQ)
    torch.cuda.synchronize()
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("a training model must hold fp32 parameters")
    log(f"[{tag}] flagship: {L} layers, {E} experts top-{k}, capacity {C}, "
        f"{n_params / 1e6:.1f}M fp32 parameters ({n_active / 1e6:.1f}M active a token), "
        f"seeded init in {time.perf_counter() - t0:.2f} s; "
        + ("fused tied head" if fused else f"chunked tied head, chunk {cells.MOE_CHUNK}"))

    def routing():
        """(mean aux loss, share of routed choices dropped) of the batch,
        from each layer's MoE input in one forward."""
        plans = []
        hooks = [layer.moe.register_forward_hook(lambda m, inp, out: plans.append(m.route(inp[0])))
                 for layer in model.layers]
        with torch.no_grad():
            model(tokens, return_hidden=True)
        for h in hooks:
            h.remove()
        return (float(np.mean([p.aux_loss.item() for p in plans])),
                float(np.mean([(p.keep == 0).float().mean().item() for p in plans])))

    routing_init = routing()
    counters = dict(_flash_counters(), moe_gather=md.gather, moe_scatter=md.scatter)
    per_step = {name: L for name in _flash_counters()}
    per_step.update(moe_gather=3 * L, moe_scatter=3 * L)
    if fused:
        # one forward, one dh and one dE launch a step
        counters.update(_head_counters())
        per_step.update({name: 1 for name in _head_counters()})
    res = _train_cell(torch, np, tag, bundle, tokens, counters, per_step, cell.flops_per_token,
                      MOE_STEPS, cfg.vocab_size)
    # the routing after the steps (its forward runs after the counters were read)
    aux, dropped = routing()
    log(f"[{tag}] mean aux loss (1.0 = balanced) and share of routed choices dropped: "
        f"{routing_init[0]:.4f}, {routing_init[1]:.4f} at init; {aux:.4f}, {dropped:.4f} after "
        f"{MOE_STEPS + 2} steps")
    return dict(params_m=n_params / 1e6, active_params_m=n_active / 1e6, **res,
                mean_aux_loss_init=routing_init[0], dropped_share_init=routing_init[1],
                mean_aux_loss=aux, dropped_share=dropped)


def phase_moe_train_parity(torch, np, fused: bool = False):
    import kubeflow_tpu_torch as kt

    tag = "moe train fused parity" if fused else "moe train parity"
    loss_atol, gnorm_rtol, flip_share = (
        (MOE_FUSED_LOSS_ATOL, MOE_FUSED_GNORM_RTOL, MOE_FLIP_SHARE) if fused
        else (MOE_LOSS_ATOL, MOE_GNORM_RTOL, MOE_FLIP_SHARE))
    cfg = kt.MoEConfig(**dict(MOE, num_layers=2), dtype=torch.bfloat16)
    seq = 256
    plans = {"cuda": [], "cpu": []}

    def make_model(dtype, where):
        model = kt.MoETransformerLM(dataclasses.replace(cfg, dtype=dtype), device=where)
        def hook(m, inp, out):
            with torch.no_grad():
                plans[where].append(m.route(inp[0]))

        # each layer's routing as the step's forward computes it, before the update
        for layer in model.layers:
            layer.moe.register_forward_hook(hook)
        return model

    def run(seed, grads_out=None):
        """One step from ``seed``'s init and tokens: (state dict, tokens,
        {where: (loss, grad norm)}, routing choices that differ, keep flags
        that differ, routing choices)."""
        for got_plans in plans.values():
            got_plans.clear()
        sd = kt.moe_init_state_dict(cfg, seed=seed, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, seq)))
        got = _one_step_vs_cpu(torch, kt, make_model, sd, tokens, grads_out=grads_out,
                               loss_fn=cells.moe_loss_fn("fused" if fused else "chunked"))
        exp_c, exp_h, keep_c, keep_h = (torch.stack([getattr(p, name) for p in plans[where]]).cpu()
                                        for name in ("experts", "keep") for where in ("cuda", "cpu"))
        return (sd, tokens, got, int((exp_c != exp_h).sum()), int((keep_c != keep_h).sum()),
                exp_c.numel())

    sd, tokens, got, flips, keep_flips, choices = run(1)
    (loss_c, norm_c), (loss_h, norm_h) = got["cuda"], got["cpu"]
    d_loss, d_norm = abs(loss_c - loss_h), abs(norm_c - norm_h) / norm_h
    share = flips / choices
    log(f"[{tag}] 2-layer MoE width, B2 S{seq}, one step card(bf16) vs cpu(fp32): "
        f"loss {loss_c:.5f} vs {loss_h:.5f} (|diff| {d_loss:.5f}, atol {loss_atol}); grad norm "
        f"{norm_c:.5f} vs {norm_h:.5f} (rel diff {d_norm:.2e}, rtol {gnorm_rtol}); routing "
        f"choices that differ {flips} of {choices} ({share:.4f}, limit {flip_share}), "
        f"keep flags that differ {keep_flips}")
    if (not np.isfinite([loss_c, norm_c]).all() or d_loss > loss_atol
            or d_norm > gnorm_rtol or share > flip_share):
        raise AssertionError(f"card MoE train step disagrees with the CPU: {got}")
    res = dict(loss_card=loss_c, loss_cpu=loss_h, grad_norm_card=norm_c, grad_norm_cpu=norm_h,
               loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm, routing_choices=choices,
               routing_flips=flips, keep_flips=keep_flips)
    if fused:
        res.update(_moe_fused_fp32_step(torch, np, kt, make_model, sd, tokens, loss_h, norm_h))

    def one_seed(seed):
        grads = {}
        _, _, got, flips, _, choices = run(seed, grads)
        note = (f", routing choices that differ {flips} of {choices} ({flips / choices:.4f}, "
                f"limit {flip_share})")
        return got, grads["cuda"], grads["cpu"], note, flips / choices <= flip_share

    res["seeds"] = _seeded_grad_check(torch, np, tag, one_seed, loss_atol, MOE_GRAD_RTOL,
                                      MOE_PARAM_GRAD_RTOL)
    return res


def _moe_fused_fp32_step(torch, np, kt, make_model, sd, tokens, loss_h, norm_h):
    """The fused MoE step of phase 12 with fp32 activations and fp32 head
    operands on the card (the head's fp32 route: the FMA forward, dh and
    dE; the flash kernels' fp32 route, TF32 off) against the CPU's
    fp32 step through the same loss."""
    import functools

    loss_fn = functools.partial(kt.moe_lm_loss_fused, compute_dtype=torch.float32)
    before = [c.launches for c in _head_counters().values()]
    got = _one_step_vs_cpu(torch, kt, make_model, sd, tokens, card_dtype=torch.float32,
                           loss_fn=loss_fn)
    launched = [c.launches - b for c, b in zip(_head_counters().values(), before)]
    (loss_f, norm_f), (loss_c32, norm_c32) = got["cuda"], got["cpu"]
    d_loss, d_norm = abs(loss_f - loss_c32), abs(norm_f - norm_c32) / norm_c32
    log(f"[moe train fused parity] the same step card(fp32, head fp32 route) vs cpu(fp32, fp32 "
        f"head): loss {loss_f:.6f} vs {loss_c32:.6f} (|diff| {d_loss:.2e}, atol "
        f"{MOE_FUSED_F32_LOSS_ATOL}); grad norm {norm_f:.6f} vs {norm_c32:.6f} (rel diff "
        f"{d_norm:.2e}, rtol {MOE_FUSED_F32_GNORM_RTOL}); head launches {launched}; cpu bf16-head "
        f"step above: loss {loss_h:.5f}, grad norm {norm_h:.5f}")
    if (not np.isfinite([loss_f, norm_f]).all() or d_loss > MOE_FUSED_F32_LOSS_ATOL
            or d_norm > MOE_FUSED_F32_GNORM_RTOL or launched != [1, 1, 1]):
        raise AssertionError(f"card fp32 fused MoE step disagrees with the CPU: {got}, {launched}")
    return dict(fp32_loss_card=loss_f, fp32_loss_cpu=loss_c32, fp32_grad_norm_card=norm_f,
                fp32_grad_norm_cpu=norm_c32, fp32_loss_abs_diff=d_loss,
                fp32_grad_norm_rel_diff=d_norm)


def resnet_bn_shapes(batch: int, image: int = RESNET_IMAGE, stage_sizes=None, width: int = 64):
    """The BatchNorm inputs of one ResNet train step as {(rows, channels):
    count}: the stem's, three a block, and a fourth where the block projects
    its residual (the first block of every stage)."""
    stage_sizes = stage_sizes or RESNET["stage_sizes"]
    shapes: dict[tuple[int, int], int] = {}

    def add(side, ch):
        key = (batch * side * side, ch)
        shapes[key] = shapes.get(key, 0) + 1

    side = -(-image // 2)                 # the 7x7 stride-2 stem
    add(side, width)
    side = -(-side // 2)                  # the 3x3 stride-2 max-pool
    for i, count in enumerate(stage_sizes):
        filters = width * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            add(side, filters)            # bn1, before conv2's stride
            side = -(-side // stride)
            add(side, filters)            # bn2
            add(side, filters * 4)        # bn3
            if j == 0:
                add(side, filters * 4)    # proj_bn
    return shapes


def _sum_tol(abs_terms):
    """The reduction tolerance of SUM_DEPTH on a sum whose terms' absolute
    values add up to ``abs_terms``."""
    return SUM_DEPTH * SUM_EPS * abs_terms + 1e-30


def _check_bn_case(torch, bn, probe, name, x, dy, c):
    """Kernels 8, 9 and 13 on one activation against their plain versions;
    returns the worst absolute errors (moments, grad sums, scaled moments)."""
    ch = x.shape[-1]
    m = x.numel() // ch
    xf = x.float().reshape(m, ch)
    abs_x, abs_x2 = xf.abs().sum(0), (xf * xf).sum(0)
    ratios, errs = {}, {}

    # kernel 8 through channel_moments: the sums' tolerance over m on the
    # mean; on the variance the same for sum x^2 plus what the mean's
    # difference moves mean^2 by
    mean_k, var_k = bn.channel_moments(x)
    torch.cuda.synchronize()
    mean_p, var_p = bn.channel_moments_plain(x)
    tol_mean = _sum_tol(abs_x) / m
    tol_var = _sum_tol(abs_x2) / m + 2 * (mean_p.abs() + tol_mean) * tol_mean + 4 * SUM_EPS * mean_p ** 2
    ratios["mean"] = ((mean_k - mean_p).abs() / tol_mean).max().item()
    ratios["var"] = ((var_k - var_p).abs() / tol_var).max().item()
    errs["moments"] = max((mean_k - mean_p).abs().max().item(), (var_k - var_p).abs().max().item())
    clamped = bool((var_k >= 0).all()) and bool(torch.isfinite(torch.rsqrt(var_k + 1e-5)).all())

    # kernel 9 at the plain statistics
    rinv = torch.rsqrt(var_p + 1e-5)
    db_k, dg_k = bn.bn_grad_sums(dy, x, mean_p, rinv)
    torch.cuda.synchronize()
    db_p, dg_p = bn.bn_grad_sums_plain(dy, x, mean_p, rinv)
    dyf = dy.float().reshape(m, ch)
    abs_dy, abs_dg = dyf.abs().sum(0), (dyf * ((xf - mean_p) * rinv)).abs().sum(0)
    ratios["dbeta"] = ((db_k - db_p).abs() / _sum_tol(abs_dy)).max().item()
    ratios["dgamma"] = ((dg_k - dg_p).abs() / _sum_tol(abs_dg)).max().item()
    errs["grad_sums"] = max((db_k - db_p).abs().max().item(), (dg_k - dg_p).abs().max().item())

    # kernel 13: the same sums of c * x
    s_k, q_k = probe.moments_scaled(x, c)
    torch.cuda.synchronize()
    s_p, q_p = probe.moments_scaled_plain(x, c)
    ratios["scaled_sum"] = ((s_k - s_p).abs() / _sum_tol(abs(c) * abs_x)).max().item()
    ratios["scaled_sq"] = ((q_k - q_p).abs() / _sum_tol(c * c * abs_x2)).max().item()
    errs["scaled"] = max((s_k - s_p).abs().max().item(), (q_k - q_p).abs().max().item())

    finite = all(bool(t.isfinite().all()) for t in (mean_k, var_k, db_k, dg_k, s_k, q_k))
    ok = finite and clamped and all(r <= 1.0 for r in ratios.values())
    log(f"[bn kernels] {name} {tuple(x.shape)} {str(x.dtype)[6:]} c={c}: worst err/tol "
        + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
        + f" (tol {SUM_DEPTH}*2^-24*sum|terms|); min var {var_k.min().item():.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"BatchNorm kernels disagree with their plain versions ({name})")
    return errs


def phase_bn_kernels(torch, np):
    """Kernels 8, 9 and 13 against their plain versions, then timed."""
    from kubeflow_tpu_torch.benchmarks import bn_stats_probe as probe
    from kubeflow_tpu_torch.ops import bn_pallas as bn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, mean=0.0, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    zoo = resnet_bn_shapes(RESNET_BATCH)
    if sum(zoo.values()) != 53:
        raise AssertionError(f"ResNet-50 has 53 BatchNorms, the shape list {sum(zoo.values())}")
    worst = {"moments": 0.0, "grad_sums": 0.0, "scaled": 0.0}

    def run(name, x, dy, c=1.25, reported=True):
        for k, v in _check_bn_case(torch, bn, probe, name, x, dy, c).items():
            if reported:
                worst[k] = max(worst[k], v)

    # the train step's shapes: conv outputs of mean ~0.3 and unit scale
    for (m, ch) in zoo:
        run(f"resnet50_b{RESNET_BATCH}", randn(m, ch, mean=0.3), randn(m, ch))
    # the stats probe's own shapes (NHWC, batch 16)
    for shape in probe.SHAPES:
        run("probe_b16", randn(*shape), randn(*shape))
    # edge cases: rows no multiple of any tile, channels that allow no
    # 16-byte vector, fp32 input, a negative multiplier
    run("ragged_rows", randn(12347, 64), randn(12347, 64))
    run("one_row", randn(1, 256), randn(1, 256))
    run("c3", randn(5001, 3), randn(5001, 3), c=-0.5)
    run("c11", randn(3, 5, 7, 11), randn(3, 5, 7, 11))
    run("c100_bf16", randn(3001, 100), randn(3001, 100))
    run("c100_fp32", randn(3001, 100, dtype=torch.float32), randn(3001, 100, dtype=torch.float32))
    run("c2048_fp32", randn(777, 2048, dtype=torch.float32), randn(777, 2048, dtype=torch.float32))
    run("c1_fp32", randn(100_000, 1, dtype=torch.float32), randn(100_000, 1, dtype=torch.float32))
    # channels of large mean and low variance: E[x^2] - mean^2 cancels to
    # below zero in some of them and must clamp at 0
    x = randn(200_000, 64, dtype=torch.float32, mean=1000.0, std=1e-3)
    raw_s, raw_q = probe.moments_scaled(x, 1.0)
    raw_var = raw_q / x.shape[0] - (raw_s / x.shape[0]) ** 2
    log(f"[bn kernels] large_mean: unclamped var min {raw_var.min().item():.3e}, "
        f"{int((raw_var < 0).sum())} of 64 channels below 0")
    if not bool((raw_var < 0).any()):
        raise AssertionError("the large-mean case must drive some unclamped variance below 0")
    # held to its bound like every case, but left out of the reported
    # max_abs_err: its sums are of order 1e11, so their absolute error says
    # nothing of the activations' scale
    run("large_mean_fp32", x, randn(200_000, 64, dtype=torch.float32), reported=False)

    # one device kernel a moments call (its finish in the same launch), and
    # two launches bitwise equal (a fixed order whichever block finishes last)
    # (every profile's records must name the moments kernel alone, and the
    # last, whose records are complete, hold one a call)
    x = randn(802_816, 64, mean=0.3)
    counted = bn.channel_moments.launches
    seen = _device_kernels(torch, lambda: bn.moments_sums(x, 1.0, bn.channel_moments), reps=5)
    launched = bn.channel_moments.launches - counted
    kinds = sorted({n for names in seen for n in names})
    per_call = len(seen[-1]) / 5
    first = bn.moments_sums(x, 1.0, bn.channel_moments)
    again = bn.moments_sums(x, 1.0, bn.channel_moments)
    bitwise = all(bool(torch.equal(p, q)) for p, q in zip(first, again))
    log(f"[bn kernels] bn_moments at [802816, 64]: {per_call:.1f} device kernels a call "
        f"({[n[:40] for n in kinds]}; records a profile of 5 calls: "
        f"{[len(names) for names in seen]}), {launched} launches counted for "
        f"{5 * (len(seen) + 1)} profiled calls; two launches bitwise equal: {bitwise}")
    if (per_call != 1.0 or len(kinds) != 1 or "column_sums_once" not in kinds[0]
            or launched != 5 * (len(seen) + 1) or not bitwise):
        raise AssertionError("bn_moments must be one device kernel a call, counted once, and "
                             "repeat bit for bit")
    one_launch = dict(kernels_a_call=per_call, bitwise_equal_relaunch=bitwise)

    # a rows view that needs a copy raises, as does a CPU mean for a CUDA x
    xt = randn(64, 4096).t()
    for what, call in (("channel_moments", lambda: bn.channel_moments(xt)),
                       ("bn_grad_sums", lambda: bn.bn_grad_sums(xt, xt, xt[0].float(), xt[0].float()))):
        try:
            call()
        except ValueError as e:
            log(f"[bn kernels] {what} on a transposed view raises: {str(e)[:60]}...")
        else:
            raise AssertionError(f"{what} took a non-contiguous input")

    # timed per distinct shape of the ResNet-50 step at batch 256, L2 flushed;
    # library: torch.var_mean (moments), three torch.sum reductions (grad sums)
    per_shape = []
    for (m, ch), count in zoo.items():
        x, dy = randn(m, ch, mean=0.3), randn(m, ch)
        scale, bias = torch.ones(ch, device="cuda"), torch.zeros(ch, device="cuda")
        mean, var = bn.channel_moments_plain(x)
        rinv = torch.rsqrt(var + 1e-5)
        xg = x.clone().requires_grad_()
        it = 10

        def whole():
            y, _ = bn.batch_norm_train(xg, scale, bias)
            return torch.autograd.grad(y, xg, dy)

        t = dict(
            m=m, ch=ch, count=count, bytes=2 * m * ch,
            mom_ms=device_ms(torch, lambda: bn.channel_moments(x), cold=True, iters=it),
            # the kernel's launch alone, without channel_moments' mean and
            # variance (four small elementwise launches)
            mom_alone_ms=device_ms(torch, lambda: bn.moments_sums(x, 1.0, bn.channel_moments),
                                   cold=True, iters=it),
            mom_plain_ms=device_ms(torch, lambda: bn.channel_moments_plain(x), cold=True, iters=it),
            mom_lib_ms=device_ms(torch, lambda: torch.var_mean(x, dim=0, correction=0),
                                 cold=True, iters=it),
            gs_ms=device_ms(torch, lambda: bn.bn_grad_sums(dy, x, mean, rinv), cold=True, iters=it),
            gs_plain_ms=device_ms(torch, lambda: bn.bn_grad_sums_plain(dy, x, mean, rinv),
                                  cold=True, iters=it),
            gs_lib_ms=device_ms(torch, lambda: (dy.sum(0, dtype=torch.float32),
                                                x.sum(0, dtype=torch.float32),
                                                (dy * x).sum(0, dtype=torch.float32)),
                                cold=True, iters=it),
            whole_ms=device_ms(torch, whole, cold=True, iters=it),
        )
        # fp32 adds outside the tensor cores: 3 (moments) and 5 (grad sums) an element
        t["mom_bound_ms"], t["mom_bound_by"] = bound_ms(
            t["bytes"] + 8 * ch, 3 * m * ch, FP32_FLOPS_PER_S)
        t["gs_bound_ms"], t["gs_bound_by"] = bound_ms(
            2 * t["bytes"] + 16 * ch, 5 * m * ch, FP32_FLOPS_PER_S)
        per_shape.append(t)
        log(f"[bn kernels] [{m}, {ch}] bf16 x{count} a step, L2 flushed: moments kernel_ms "
            f"{t['mom_ms']:.4f} (launch alone {t['mom_alone_ms']:.4f}) plain_ms "
            f"{t['mom_plain_ms']:.4f} library_ms {t['mom_lib_ms']:.4f} "
            f"bound_ms {t['mom_bound_ms']:.5f} ({t['mom_bound_by']}) | grad sums kernel_ms "
            f"{t['gs_ms']:.4f} plain_ms {t['gs_plain_ms']:.4f} library_ms {t['gs_lib_ms']:.4f} "
            f"bound_ms {t['gs_bound_ms']:.5f} ({t['gs_bound_by']}) "
            f"| batch_norm_train fwd+bwd {t['whole_ms']:.4f} ms")

    def step_sum(key):
        return sum(t[key] * t["count"] for t in per_shape)

    def row(prefix, err):
        """One kernel's row of the ``kernels`` line. Like every other row its
        times are those of one launch: here the mean over the 53 launches of
        one ResNet-50 step (each distinct shape timed, weighted by how often
        the step has it); ``step_ms`` and ``step_bound_ms`` are the 53 summed."""
        keys = dict(ms="ms", plain_ms="plain_ms", library_ms="lib_ms", bound_ms="bound_ms")
        launches = sum(t["count"] for t in per_shape)
        r = {out: step_sum(f"{prefix}_{key}") / launches for out, key in keys.items()}
        r.update(
            max_abs_err=err, per=f"launch, mean of the {launches} of one step",
            bound_by=("bytes" if all(t[f"{prefix}_bound_by"] == "bytes" for t in per_shape)
                      else "operations"),
            step_ms=step_sum(f"{prefix}_ms"), step_bound_ms=step_sum(f"{prefix}_bound_ms"))
        return r

    results = {"bn_moments": row("mom", worst["moments"]),
               "bn_grad_sums": row("gs", worst["grad_sums"])}
    bn_whole = step_sum("whole_ms")
    for name, r in results.items():
        log(f"[bn kernels] {name}, one ResNet-50 step's 53 launches at batch {RESNET_BATCH}: "
            f"kernel_ms {r['step_ms']:.4f} bound_ms {r['step_bound_ms']:.5f} "
            f"({step_sum('bytes') / 1e9:.3f} GB an activation sweep); a launch on average: kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']})")
    log(f"[bn kernels] bn_moments' launches alone (channel_moments without its mean and variance), "
        f"the 53 of a step: {step_sum('mom_alone_ms'):.4f} ms")
    results["bn_moments"]["step_alone_ms"] = step_sum("mom_alone_ms")
    log(f"[bn kernels] batch_norm_train forward + backward, the 53 of a step one by one: "
        f"{bn_whole:.3f} ms, of which the two kernels "
        f"{results['bn_moments']['step_ms'] + results['bn_grad_sums']['step_ms']:.3f} ms and the "
        f"elementwise passes the rest")

    # kernel 13 at the probe's six shapes, c = 1.25, and the probe's main()
    c = 1.25
    timed = []
    for shape in probe.SHAPES:
        x = randn(*shape)
        n_bytes = 2 * x.numel() + 8 * shape[-1]
        timed.append(dict(
            shape=shape,
            ms=device_ms(torch, lambda: probe.moments_scaled(x, c), cold=True, iters=10),
            plain_ms=device_ms(torch, lambda: probe.moments_scaled_plain(x, c), cold=True, iters=10),
            library_ms=device_ms(torch, lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0),
                                 cold=True, iters=10),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(n_bytes, 4 * x.numel(), FP32_FLOPS_PER_S)))))
        t = timed[-1]
        log(f"[bn kernels] moments_scaled {shape} bf16 c={c}, L2 flushed: kernel_ms {t['ms']:.4f} "
            f"plain_ms {t['plain_ms']:.4f} library_ms {t['library_ms']:.4f} bound_ms "
            f"{t['bound_ms']:.5f} ({t['bound_by']})")
    # one launch, the mean over the probe's six shapes
    results["bn_moments_scaled"] = dict(
        max_abs_err=worst["scaled"], per=f"launch, mean of the probe's {len(timed)} shapes",
        bound_by="bytes" if all(t["bound_by"] == "bytes" for t in timed) else "operations",
        **{key: sum(t[key] for t in timed) / len(timed)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    probe.moments_scaled.launches = 0
    probe.main()
    probe_launches = probe.moments_scaled.launches
    log(f"[bn kernels] bn_stats_probe.main(): {probe_launches} launches of the scaled moments kernel")
    if probe_launches < len(probe.SHAPES):
        raise AssertionError("the stats probe did not launch its kernel at every shape")
    return results, dict(per_shape=per_shape, batch_norm_train_ms=bn_whole,
                         scaled=timed, moments_one_launch=one_launch), probe_launches


def _check_bwd_case(torch, probe, name, n, ci, co, seed):
    args = probe.probe_operands(n, ci, co, seed=seed)
    dr, y, x, wt, scal = args
    dx_k, dw_k = probe.fused_bn_relu_conv1x1_bwd(*args)
    torch.cuda.synchronize()
    dx_p, dw_p = probe.fused_bn_relu_conv1x1_bwd_plain(*args)
    dy16 = probe.bn_relu_bwd_dy(dr, y, scal)
    abs_dx = torch.mm(dy16.abs(), wt.abs(), out_dtype=torch.float32)
    abs_dw = torch.mm(x.abs().t(), dy16.abs(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    # dX: CO products summed in fp32 in two orders, then one rounding to bf16
    # each: the values may land one bf16 step apart
    tol_dx = BF16_STEP * dx_p.float().abs() + _sum_tol(abs_dx)
    err_dx, err_dw = (dx_k.float() - dx_p.float()).abs(), (dw_k - dw_p).abs()
    r_dx = (err_dx / tol_dx).max().item()
    r_dw = (err_dw / _sum_tol(abs_dw)).max().item()
    ok = (dx_k.dtype == torch.bfloat16 and dw_k.dtype == torch.float32
          and bool(dx_k.isfinite().all()) and bool(dw_k.isfinite().all())
          and r_dx <= 1.0 and r_dw <= 1.0)
    log(f"[bwd probe] {name} N{n} CI{ci} CO{co}: worst err/tol dX {r_dx:.4f} (one bf16 step + "
        f"{SUM_DEPTH}*2^-24*sum|terms|), dW {r_dw:.4f} ({SUM_DEPTH}*2^-24*sum|terms|); max_abs_err "
        f"dX {err_dx.max().item():.3e} (|dX| max {dx_p.float().abs().max().item():.3e}, "
        f"{int((err_dx > 0).sum())} of {dx_p.numel()} elements differ) dW {err_dw.max().item():.3e} "
        f"(|dW| max {dw_p.abs().max().item():.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused BN+ReLU+conv1x1 backward disagrees with its plain version ({name})")
    return max(err_dx.max().item(), err_dw.max().item())


def phase_bwd_probe(torch, np):
    """Kernel 12 against its plain version, then timed at the probe's shape."""
    from kubeflow_tpu_torch.benchmarks import pallas_bwd_probe as probe

    from kubeflow_tpu_torch.ops import _build

    n, ci, co = probe.N, probe.CI, probe.CO
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entry = None     # ptxas' registers and spills of each instantiation
    for line in _build.build_log("fused_bn_relu_conv1x1_bwd").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"fused_bwd_wgmmaILi(\d+)ELi(\d+)ELi(\d+)E", line)
            entry = f"fused_bwd_wgmma<{', '.join(m.groups())}>" if m else None
        elif entry and ("registers" in line or "spill" in line):
            log(f"[bwd probe] {entry}: {line.strip()}")
    worst = 0.0
    for i, (name, shape) in enumerate((
            ("probe_shape", (n, ci, co)),
            ("ragged_n", (4133, 48, 80)),           # N no multiple of 64; one partial slice
            ("co256_at_the_limit", (8192, 192, 256)),   # 128-channel slices, one ring stage
            ("co64_ci512", (9000, 512, 64)),        # two 256-channel slices
            ("ci320_partial_slice", (4133, 320, 128)),  # 256-channel slices, the second partial
            ("one_tile", (50, 16, 16)))):
        plan = probe._plan(*shape, sms)
        log(f"[bwd probe] {name}: plan ci_slice {plan.ci_slice} co_pad {plan.co_pad} slices "
            f"{plan.slices} (dr and y read {plan.slices}x) stages {plan.stages} grid {plan.grid} "
            f"{plan.smem_bytes} B shared memory a block")
        worst = max(worst, _check_bwd_case(torch, probe, name, *shape, seed=10 + i))

    # past the CO limit: a stated refusal before any launch, never the plain version
    before = probe.fused_bn_relu_conv1x1_bwd.launches
    try:
        probe.fused_bn_relu_conv1x1_bwd(*probe.probe_operands(256, 64, probe.MAX_CO + 16, seed=3))
    except ValueError as e:
        log(f"[bwd probe] CO {probe.MAX_CO + 16}: refused: {e}")
    else:
        raise AssertionError(f"the fused backward took CO {probe.MAX_CO + 16}")
    if probe.fused_bn_relu_conv1x1_bwd.launches != before:
        raise AssertionError("a refused shape launched the fused backward")

    args = probe.probe_operands(n, ci, co, seed=0)
    dr, y, x, wt, scal = args
    dx1, dw1 = probe.fused_bn_relu_conv1x1_bwd(*args)
    dx2, dw2 = probe.fused_bn_relu_conv1x1_bwd(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx1, dx2) and torch.equal(dw1, dw2)):
        raise AssertionError("two launches of the fused backward differ")
    log("[bwd probe] two launches at the probe's shape bitwise equal (dX and dW)")
    del dx1, dw1, dx2, dw2
    dy16 = probe.bn_relu_bwd_dy(dr, y, scal)
    ms = device_ms(torch, lambda: probe.fused_bn_relu_conv1x1_bwd(*args), cold=True, iters=10)
    plain_ms = device_ms(torch, lambda: probe.fused_bn_relu_conv1x1_bwd_plain(*args),
                         cold=True, iters=10)
    lib_ms = device_ms(torch, lambda: (torch.mm(dy16, wt),
                                       torch.mm(x.t(), dy16, out_dtype=torch.float32)),
                       cold=True, iters=10)
    n_bytes = 2 * n * (2 * co + ci) + 2 * co * ci + 28 * co + 2 * n * ci + 4 * ci * co
    flops = 4 * n * ci * co
    bms, by = bound_ms(n_bytes, flops)
    log(f"[bwd probe] N{n} CI{ci} CO{co} bf16, L2 flushed: kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {lib_ms:.4f} (the two torch.mm on a ready bf16 dy) bound_ms "
        f"{bms:.5f} ({by}: {n_bytes} B, {flops} FLOP); {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{n_bytes / ms / 1e6:.0f} GB/s of the bound's work")
    probe.fused_bn_relu_conv1x1_bwd.launches = 0
    probe.main()
    launches = probe.fused_bn_relu_conv1x1_bwd.launches
    log(f"[bwd probe] pallas_bwd_probe.main(): {launches} launches of the fused kernel")
    if launches < 1:
        raise AssertionError("the backward probe did not launch its kernel")
    return {"fused_bn_relu_conv1x1_bwd": dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by)}, launches


def _resnet_kernel_class(name: str) -> str:
    """The class a device event of the ResNet step counts under, by its
    name. A name that matches nothing is 'unclassified' and is logged, so
    that a renamed kernel or library engine does not pass for elementwise
    work."""
    low = name.lower()
    if "bn::column_sums" in low:
        return "bn kernels"
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nhwc")) and "pool" not in low:
        return "convolutions"
    if any(t in low for t in ("gemm", "nvjet", "cublas")):
        return "GEMM"
    if "pool" in low:
        return "pooling"
    if "at::native" in low or "softmax" in low or low.startswith(("memcpy", "memset")):
        return "elementwise, reductions, copies"
    return "unclassified"


def _resnet_cell(torch, np, tag, bn_impl, batch_size, warmup, steps, per_step=None):
    """ResNet-50 through ``make_classifier_train_step``: ``warmup`` steps,
    then ``steps`` timed ones on one batch, with the BatchNorm launch
    counters set to 0 just before and read just after and, where ``per_step``
    is given, held to it; then one profiled step."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import bn_pallas as bn

    t0 = time.perf_counter()
    cell = cells.resnet_train(bn_impl=bn_impl, batch=batch_size)
    model, tx, bundle, batch, n_params = cell.model, cell.tx, cell.bundle, cell.batch, cell.n_params
    torch.cuda.synchronize()
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("a training model must hold fp32 parameters")
    log(f"[{tag}] ResNet-50, bn_impl={bn_impl}: {n_params / 1e6:.2f}M fp32 parameters, "
        f"{len(model.blocks())} blocks, batch {batch_size} of {RESNET_IMAGE}x{RESNET_IMAGE} bf16, "
        f"seeded init in {time.perf_counter() - t0:.2f} s")
    state = bundle.init()
    log_metrics = []

    def step():
        _, metrics = bundle.step(state, batch)
        log_metrics.append(metrics)

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"bn_moments": bn.channel_moments, "bn_grad_sums": bn.bn_grad_sums}
    for fn in counters.values():
        fn.launches = 0
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if per_step is not None:
        want = {name: n * steps for name, n in per_step.items()}
        log(f"[{tag}] launches in {steps} steps: {launches} (expected {want}: {per_step} a step)")
        if launches != want:
            raise AssertionError(f"kernel launch counts {launches} != {want}")
    losses = [m["loss"].item() for m in log_metrics]
    accs = [m["accuracy"].item() for m in log_metrics]
    classes = RESNET["num_classes"]
    log(f"[{tag}] losses (warm-up, then the timed steps): {[round(x, 4) for x in losses]} "
        f"(ln {classes} = {np.log(classes):.4f}); accuracy {[round(a, 3) for a in accs]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - np.log(classes)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln {classes}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss does not fall over the steps: {losses}")
    stats = torch.cat([b.flatten() for b in model.buffers()])
    if not bool(torch.isfinite(stats).all()):
        raise AssertionError("non-finite BatchNorm running statistics")

    busy, events, ranked = _profile(torch, step, reps=1, top=14)
    by_class: dict[str, float] = {}
    unclassified = []
    for name, ms in ranked:
        cls = _resnet_kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        if cls == "unclassified":
            unclassified.append((name, ms))
    if per_step is not None and not by_class.get("bn kernels", 0.0) > 0.0:
        raise AssertionError(f"the profiled step shows no time in the BatchNorm kernels: {by_class}")
    med = float(np.median(step_ms))
    img_s = batch_size / (med / 1e3)
    # bench.py:162-163: training ~ 3x the forward pass's FLOPs
    mfu = img_s * 3 * kt.flops_per_image(RESNET_IMAGE) / BF16_FLOPS_PER_S
    idle = 1.0 - busy / med if busy > 0 else None
    log(f"[{tag}] step {med:.2f} ms median of {[round(x, 2) for x in step_ms]}; {img_s:.1f} img/s; "
        f"MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s "
        f"({3 * kt.flops_per_image(RESNET_IMAGE) / 1e9:.2f} GFLOP an image); peak memory {peak_gb:.2f} GB")
    log(f"[{tag}] one step: device busy {busy:.2f} ms, {events:.0f} device events, idle share "
        + (f"{idle:.4f}" if idle is not None else "not measured (no device time in the trace)"))
    log(f"[{tag}]   by class: " + ", ".join(f"{cls} {ms:.3f} ms" for cls, ms in by_class.items()))
    for name, ms in ranked[:14]:
        log(f"[{tag}]   {ms:9.3f} ms  {name}")
    for name, ms in unclassified[:10]:
        log(f"[{tag}]   unclassified: {ms:9.3f} ms  {name[:120]}")

    # the optimizer alone: tx.update + apply_updates on zero gradients and a
    # fresh state (every update is zero, so the parameters stay as they are)
    from kubeflow_tpu_torch.ops.optimizers import apply_updates
    params = [p for p in model.parameters()]
    zeros = [torch.zeros_like(p) for p in params]
    opt_state = tx.init(params)
    opt_ms = device_ms(torch, lambda: apply_updates(params, tx.update(zeros, opt_state, params)),
                       cold=False, iters=5)
    log(f"[{tag}] optimizer alone (nesterov SGD update + apply over {len(params)} tensors): "
        f"{opt_ms:.3f} device ms")
    return dict(bn_impl=bn_impl, batch=batch_size, params_m=n_params / 1e6, losses=losses,
                accuracy=accs, step_ms=step_ms, step_ms_median=med, img_s=img_s, mfu=mfu,
                peak_memory_gb=peak_gb, device_busy_ms=busy, device_events=events, idle_share=idle,
                top_kernels=ranked[:14], device_ms_by_class=by_class, optimizer_ms=opt_ms,
                launches=launches)


def phase_resnet_train(torch, np):
    main_cell = _resnet_cell(torch, np, "resnet train", "pallas", RESNET_BATCH, 1, RESNET_STEPS,
                             per_step={"bn_moments": 53, "bn_grad_sums": 53})
    others = {}
    for tag, impl, batch in (("resnet train b16", "pallas", RESNET_SMALL_BATCH),
                             ("resnet train xla", "xla", RESNET_BATCH),
                             ("resnet train mxu", "mxu", RESNET_BATCH)):
        torch.cuda.empty_cache()
        others[tag] = _resnet_cell(torch, np, tag, impl, batch, 2, 3)
    return main_cell, others


def _resnet_step_vs_cpu(torch, np, kt, small, seed):
    """One SGD step of the small ResNet from ``seed``'s init and batch, on
    the card (bf16, the kernels) and on the CPU (fp32, the plain versions):
    {where: (loss, grad norm, buffers, gradients by parameter name)}."""
    from kubeflow_tpu_torch.ops import optimizers as opt

    sd = kt.resnet_init_state_dict(**small, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, small["num_classes"], 8))
    got = {}
    for where, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = kt.ResNet(**small, dtype=dtype, bn_impl="pallas", device=where)
        model.load_state_dict(sd)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        norms, grads = [], {}
        sgd = opt.sgd(0.1)

        def update(g, state, params, names=names, norms=norms, grads=grads):
            norms.append(torch.sqrt(sum(x.float().pow(2).sum() for x in g)).item())
            grads.update({n: x.detach().float().cpu() for n, x in zip(names, g)})
            return sgd.update(g, state, params)

        bundle = kt.make_classifier_train_step(model, opt.GradientTransformation(sgd.init, update))
        _, metrics = bundle.step(bundle.init(), {"image": image.to(where), "label": label.to(where)})
        got[where] = (metrics["loss"].item(), norms[0],
                      {name: b.detach().float().cpu() for name, b in model.named_buffers()}, grads)
    return got


def phase_resnet_train_parity(torch, np):
    """One SGD step of a small ResNet, card (bf16, the kernels) vs CPU (fp32,
    the plain versions), from one state dict and one batch; then the same at
    ``PARITY_SEEDS``, held by the gradients' relative L2 errors."""
    import kubeflow_tpu_torch as kt

    small = dict(stage_sizes=[1, 1, 1, 1], num_classes=100, width=16)
    got = _resnet_step_vs_cpu(torch, np, kt, small, 1)
    (loss_c, norm_c, stats_c, _), (loss_h, norm_h, stats_h, _) = got["cuda"], got["cpu"]
    d_loss, d_norm = abs(loss_c - loss_h), abs(norm_c - norm_h) / norm_h
    d_stats = max((stats_c[name] - stats_h[name]).abs().max().item() for name in stats_h)
    log(f"[resnet train parity] ResNet [1, 1, 1, 1] width 16, batch 8 of 64x64, one step card(bf16) "
        f"vs cpu(fp32): loss {loss_c:.5f} vs {loss_h:.5f} (|diff| {d_loss:.5f}, atol "
        f"{RESNET_LOSS_ATOL}); grad norm {norm_c:.5f} vs {norm_h:.5f} (rel diff {d_norm:.2e}, rtol "
        f"{RESNET_GNORM_RTOL}); running mean/var of {len(stats_h)} buffers max abs diff "
        f"{d_stats:.2e} (atol {RESNET_STATS_ATOL})")
    if (not np.isfinite([loss_c, norm_c, d_stats]).all() or d_loss > RESNET_LOSS_ATOL
            or d_norm > RESNET_GNORM_RTOL or d_stats > RESNET_STATS_ATOL):
        raise AssertionError("card ResNet train step disagrees with the CPU")

    def one_seed(seed):
        got = _resnet_step_vs_cpu(torch, np, kt, small, seed)
        (loss_c, norm_c, stats_c, grads_c), (loss_h, norm_h, stats_h, grads_h) = (
            got["cuda"], got["cpu"])
        d = max((stats_c[name] - stats_h[name]).abs().max().item() for name in stats_h)
        return ({"cuda": (loss_c, norm_c), "cpu": (loss_h, norm_h)}, grads_c, grads_h,
                f", running mean/var max abs diff {d:.2e} (atol {RESNET_STATS_ATOL})",
                bool(np.isfinite(d)) and d <= RESNET_STATS_ATOL)

    seeds = _seeded_grad_check(torch, np, "resnet train parity", one_seed,
                               RESNET_SEED_LOSS_ATOL, RESNET_GRAD_RTOL, RESNET_PARAM_GRAD_RTOL)
    return dict(loss_card=loss_c, loss_cpu=loss_h, grad_norm_card=norm_c, grad_norm_cpu=norm_h,
                loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm, running_stats_max_abs_diff=d_stats,
                seeds=seeds)


SHARDED_STEPS = 5
# the sharded steps in a world of one against the mesh=None steps: every
# collective is an identity and BatchNorm divides by the same int row count,
# so both runs do the same arithmetic (on an H100 all three cells came out
# bit-equal after 7 steps); the limit, on every loss and on every parameter
# and buffer after all the steps, leaves room only for a library kernel
# (cuDNN's) that may sum in another order from one call to the next
SHARDED_ATOL = 1e-6


def _sharded_vs_unsharded(torch, np, tag, build, mesh, counters, per_step):
    """One cell built twice from the same seed, once with ``mesh=None`` and
    once on ``mesh``: a first step, then ``SHARDED_STEPS`` timed steps, the
    sharded run's launch counts held to ``per_step`` a step, then one
    profiled step (device busy ms: wall times follow the host). Every
    step's loss, and the parameters (gathered from their shards) and
    buffers after the last step, are held to the unsharded run's within
    ``SHARDED_ATOL``."""
    runs = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        cell = build(m)
        batch = cell.tokens if hasattr(cell, "tokens") else cell.batch
        state = cell.bundle.init()
        losses = [cell.bundle.step(state, batch)[1]["loss"].item()]
        for fn in counters.values():
            fn.launches = 0
        ms = []
        for _ in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = cell.bundle.step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: n * SHARDED_STEPS for k, n in per_step.items()}
        if launches != want:
            raise AssertionError(f"[sharded {tag}] {name} launches {launches} != {want}")
        losses_last = []
        busy = _profile(torch, lambda: losses_last.append(cell.bundle.step(state, batch)[1]["loss"]),
                        reps=1)[0]
        losses.append(losses_last[-1].item())
        params = (cell.bundle.gather(state["params"]) if m is not None else
                  {n: p.detach() for n, p in cell.model.named_parameters()})
        params = {n: t.to("cpu", torch.float32, copy=True) for n, t in params.items()}
        buffers = {n: b.to("cpu", torch.float32, copy=True) for n, b in cell.model.named_buffers()}
        runs[name] = dict(losses=losses, ms=ms, launches=launches, busy=busy, params=params,
                          buffers=buffers)
        del cell, state
        torch.cuda.empty_cache()
    a, b = runs["unsharded"], runs["sharded"]
    d_loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    d_params = max(float((a["params"][n] - b["params"][n]).abs().max()) for n in a["params"])
    d_buffers = max((float((a["buffers"][n] - b["buffers"][n]).abs().max()) for n in a["buffers"]),
                    default=0.0)
    med = {k: float(np.median(r["ms"])) for k, r in runs.items()}
    log(f"[sharded {tag}] world of one (nccl), MeshPlan() (every rule's fsdp split of 1): "
        f"losses {[round(x, 5) for x in b['losses']]} vs mesh=None {[round(x, 5) for x in a['losses']]}; "
        f"after {SHARDED_STEPS + 2} steps max |diff| losses {d_loss:.2e}, parameters "
        f"{d_params:.2e}, buffers {d_buffers:.2e} (atol {SHARDED_ATOL}; bit-equal: "
        f"{d_loss == d_params == d_buffers == 0.0}); launches a step "
        f"{ {k: v // SHARDED_STEPS for k, v in b['launches'].items()} }; step ms median "
        f"{med['sharded']:.2f} sharded vs {med['unsharded']:.2f} mesh=None "
        f"({[round(x, 2) for x in b['ms']]} vs {[round(x, 2) for x in a['ms']]}); device busy "
        f"{b['busy']:.2f} vs {a['busy']:.2f} ms a step; full depth")
    if (not np.isfinite(b["losses"]).all() or set(a["params"]) != set(b["params"])
            or max(d_loss, d_params, d_buffers) > SHARDED_ATOL):
        raise AssertionError(f"the sharded {tag} step disagrees with the mesh=None step")
    return dict(losses=b["losses"], losses_unsharded=a["losses"], loss_max_abs_diff=d_loss,
                params_max_abs_diff=d_params, buffers_max_abs_diff=d_buffers,
                step_ms=b["ms"], step_ms_unsharded=a["ms"], step_ms_median=med["sharded"],
                step_ms_median_unsharded=med["unsharded"], device_busy_ms=b["busy"],
                device_busy_ms_unsharded=a["busy"], launches=b["launches"])


def phase_sharded(torch, np):
    """The sharded train steps (``parallel/train.py`` under a mesh) in a
    world of one rank (nccl, an in-memory store, ``MeshPlan()``): the dense
    flagship, the MoE flagship and ResNet-50 at batch 256 (global-batch
    BatchNorm through the batch group), each against its ``mesh=None`` step
    on the same weights, with the launch counts of the unsharded steps and
    both steps' ms (the difference is the machinery's cost)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.ops import bn_pallas as bn
    from kubeflow_tpu_torch.ops import moe_dispatch as md
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.create_mesh(tmesh.MeshPlan())
        flash = _flash_counters()
        moe = dict(flash, moe_gather=md.gather, moe_scatter=md.scatter)
        bn_counters = {"bn_moments": bn.channel_moments, "bn_grad_sums": bn.bn_grad_sums}
        L, Lm = TRAIN["num_layers"], MOE["num_layers"]
        moe_steps = dict({k: Lm for k in flash}, moe_gather=3 * Lm, moe_scatter=3 * Lm)
        out = {}
        for tag, build, counters, per_step in (
                ("dense", lambda m: cells.dense_train(mesh=m), flash, {k: L for k in flash}),
                ("moe", lambda m: cells.moe_train(mesh=m), moe, moe_steps),
                ("resnet50", lambda m: cells.resnet_train(mesh=m), bn_counters,
                 {"bn_moments": 53, "bn_grad_sums": 53})):
            out[tag] = _sharded_vs_unsharded(torch, np, tag, build, mesh, counters, per_step)
        out["dense_ring"] = _ring_train_step(torch, np, mesh)
    finally:
        dist.destroy_process_group()
    return out


def _ring_train_step(torch, np, mesh):
    """The dense flagship's train step with ``attention_impl="ring"`` on
    ``mesh`` (a world of one: one seq rank, the diagonal chunk a layer, the
    backward with the global lse and fp32 gradients) against the flash step
    on the same weights: the first step's loss and global gradient norm
    within the train parity bounds, each step's flash launches 24/24/24,
    and both steps' ms."""
    from kubeflow_tpu_torch.ops import optimizers as opt

    import kubeflow_tpu_torch as kt

    counters = _flash_counters()
    L = TRAIN["num_layers"]
    got = {}
    for impl, m in (("flash", None), ("ring", mesh)):
        cell = cells.dense_train(mesh=m, attention_impl=impl)
        norms = []
        adamw = cells.adamw()

        def update(grads, state, params, adamw=adamw, norms=norms):
            norms.append(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)).item())
            return adamw.update(grads, state, params)

        bundle = kt.make_lm_train_step(cell.model, opt.GradientTransformation(adamw.init, update),
                                       m, chunk=TRAIN_CHUNK)
        state = bundle.init()
        for fn in counters.values():
            fn.launches = 0
        losses = [bundle.step(state, cell.tokens)[1]["loss"].item()]
        launches = {k: fn.launches for k, fn in counters.items()}
        if launches != {k: L for k in counters}:
            raise AssertionError(f"[ring train] {impl} step launches {launches}, not {L} each")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(bundle.step(state, cell.tokens)[1]["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        got[impl] = dict(losses=losses, grad_norm=norms[0], step_ms=ms, launches=launches)
        del cell, bundle, state
        torch.cuda.empty_cache()
    a, b = got["flash"], got["ring"]
    d_loss = abs(a["losses"][0] - b["losses"][0])
    d_norm = abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
    log(f"[ring train] dense flagship, attention_impl='ring' on MeshPlan() (world of one, nccl) vs "
        f"'flash' (mesh=None), same weights: first-step loss {b['losses'][0]:.5f} vs "
        f"{a['losses'][0]:.5f} (|diff| {d_loss:.2e}, atol {TRAIN_LOSS_ATOL}); grad norm "
        f"{b['grad_norm']:.5f} vs {a['grad_norm']:.5f} (rel diff {d_norm:.2e}, rtol "
        f"{TRAIN_GNORM_RTOL}); flash launches a step {b['launches']} (flash step {a['launches']}); "
        f"losses {[round(x, 4) for x in b['losses']]}; step ms {[round(x, 2) for x in b['step_ms']]} "
        f"vs {[round(x, 2) for x in a['step_ms']]}; {card()}")
    if (not np.isfinite(b["losses"]).all() or d_loss > TRAIN_LOSS_ATOL
            or d_norm > TRAIN_GNORM_RTOL or not b["losses"][-1] < b["losses"][0]):
        raise AssertionError(f"the ring train step disagrees with the flash step: {got}")
    return dict(got, loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm)


# ring attention (parallel/ring_attention.py) walked in one process at the
# long-context dense configuration's attention (benchmarks/transformer_bench.py
# :73-81: seq 8192, batch 1; 8 heads of 128), cut into n chunks a virtual rank
RING_B, RING_S, RING_H, RING_D = 1, 8192, 8, 128
RING_SPLITS = (4, 2)
RING_BLOCK = TRAIN["attention_block_size"]


def _chunks(x, n, dim=1):
    return [c.contiguous() for c in x.chunk(n, dim=dim)]


def ring_walk_fwd(torch, q, k, v, n, causal, block):
    """The forward ring of ``parallel/ring_attention.py`` over n virtual
    ranks in one process, through the module's own ``_schedule``,
    ``_chunk_fwd`` and ``_merge``: at step r virtual rank i holds chunk
    (i - r) mod n, and there are no transfers. Returns (o, lse) of the whole
    sequence ([B, S, H, D] in q's dtype, [B, H, S] fp32)."""
    from kubeflow_tpu_torch.parallel import ring_attention as ra

    qs, ks, vs = _chunks(q, n), _chunks(k, n), _chunks(v, n)
    plans = [ra._schedule(i, n, causal) for i in range(n)]
    state = [None] * n
    for r in range(n):
        for i in range(n):
            src, kind = plans[i][r]
            if kind is not None:
                part = ra._chunk_fwd(qs[i], ks[src], vs[src], kind == ra.DIAG, block)
                state[i] = part if r == 0 else ra._merge(*state[i], *part)
    return (torch.cat([o.to(q.dtype) for o, _ in state], dim=1),
            torch.cat([lse for _, lse in state], dim=2))


def ring_walk_bwd(torch, q, k, v, o, lse, do, n, causal):
    """The backward ring over the same virtual ranks: each chunk's dq and
    dk/dv kernels against the merged o and the global lse, in fp32; chunk
    src's dk/dv accumulators take virtual rank (src + r)'s partial at step
    r, the order in which they rotate through the ring. Returns (dq, dk,
    dv) in the operands' dtypes."""
    from kubeflow_tpu_torch.parallel import ring_attention as ra

    qs, ks, vs, os, dos = (_chunks(x, n) for x in (q, k, v, o, do))
    lses = _chunks(ra._backward_lse(lse), n, dim=2)
    plans = [ra._schedule(i, n, causal) for i in range(n)]
    acc = [[None] * n for _ in range(3)]
    for r in range(n):
        for i in range(n):
            src, kind = plans[i][r]
            if kind is not None:
                parts = ra._chunk_bwd(qs[i], ks[src], vs[src], os[i], lses[i], dos[i],
                                      kind == ra.DIAG)
                for a, j, part in zip(acc, (i, src, src), parts):
                    a[j] = part if r == 0 else a[j] + part
    return tuple(torch.cat(a, dim=1).to(x.dtype) for a, x in zip(acc, (q, k, v)))


def phase_ring(torch):
    """Ring attention at the long-context shape, walked in one process: the
    backward kernels on one chunk against the global o and lse (larger than
    the chunk's own) with fp32 gradients, held against the plain backward
    with the same lse; then the walk at n = 4 and 2, causal and non-causal,
    its o, lse, dq, dk and dv held against the one-shot flash kernels on the
    whole sequence, its launches counted (n(n+1)/2 a kernel causal, n²
    non-causal) and its device ms timed beside the one-shot kernels'."""
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, D = RING_B, RING_S, RING_H, RING_D
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(bf16)
                   for _ in range(4))
    counters = _flash_counters()
    out = {}
    ref = {}
    for causal in (True, False):
        o1, lse1 = pa.flash_attention(q, k, v, causal, S, S, return_lse=True)
        ref[causal] = (o1, lse1, pa.flash_attention_bwd_dq(q, k, v, o1, lse1, do, causal=causal),
                       *pa.flash_attention_bwd_dkv(q, k, v, o1, lse1, do, causal=causal))
    torch.cuda.synchronize()

    # the backward kernels on one chunk of 2048 rows with the global o and lse
    c = S // RING_SPLITS[0]
    o1, lse1 = ref[True][:2]
    for name, qi, ki, causal in (("noncausal_q3_k0", 3, 0, False), ("diagonal_q3_k3", 3, 3, True),
                                 ("noncausal_q1_k0", 1, 0, False)):
        rows, keys = slice(qi * c, (qi + 1) * c), slice(ki * c, (ki + 1) * c)
        qc, oc, doc = (x[:, rows].contiguous() for x in (q, o1, do))
        kc, vc = k[:, keys].contiguous(), v[:, keys].contiguous()
        lc = lse1[:, :, rows].contiguous()
        own = pa.flash_attention(qc, kc, vc, causal, c, c, return_lse=True)[1]
        kw = dict(causal=causal, grad_dtype=f32)
        got = (pa.flash_attention_bwd_dq(qc, kc, vc, oc, lc, doc, **kw),
               *pa.flash_attention_bwd_dkv(qc, kc, vc, oc, lc, doc, **kw))
        want = pa.flash_attention_backward_plain(qc, kc, vc, oc, lc, doc, **kw)
        torch.cuda.synchronize()
        rise = (lc - own).mean().item()
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            ok, err, ratio, rms = check_out(g, w, bf16)
            ok = ok and g.dtype == f32
            log(f"[ring] global-lse backward {name} {grad} (chunk {c} rows, causal {causal}, fp32 "
                f"gradients, global lse above the chunk's own by {rise:.3f} on average): max_abs_err "
                f"{err:.3e} (rms {rms:.3e}, worst err/tol {ratio:.3f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash backward with the global lse disagrees with the plain "
                                     f"backward ({name} {grad})")
            out[f"global_lse_{name}_{grad}_err"] = err
        if not rise > 0:
            raise AssertionError(f"{name}: the global lse is not above the chunk's own")

    smi = card()
    for causal in (True, False):
        o1, lse1, dq1, dk1, dv1 = ref[causal]
        for n in RING_SPLITS:
            tag = f"n{n}_{'causal' if causal else 'noncausal'}"
            for fn in counters.values():
                fn.launches = 0
            o, lse = ring_walk_fwd(torch, q, k, v, n, causal, RING_BLOCK)
            grads = ring_walk_bwd(torch, q, k, v, o, lse, do, n, causal)
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            want = n * (n + 1) // 2 if causal else n * n
            checks = [("o", *check_out(o, o1, bf16)[:3])]
            lse_ok, lse_err = check_lse(lse, lse1)
            checks.append(("lse", lse_ok, lse_err, lse_err / LSE_ATOL))
            checks += [(g, *check_out(x, y, bf16)[:3]) for g, x, y in zip(("dq", "dk", "dv"), grads,
                                                                    (dq1, dk1, dv1))]
            # few calls a timing: the host enqueues a walk's ~100-200 operations
            # more slowly than the card runs them, and all of them must be queued
            # behind device_ms's spin kernel for the events to time the card
            ms = dict(walk_fwd=device_ms(torch, lambda: ring_walk_fwd(
                          torch, q, k, v, n, causal, RING_BLOCK), cold=False, iters=3, warmup=2),
                      walk_bwd=device_ms(torch, lambda: ring_walk_bwd(
                          torch, q, k, v, o, lse, do, n, causal), cold=False, iters=3, warmup=2))
            log(f"[ring] walk {tag} (B{B} S{S} H{H} D{D} bf16, chunks of {S // n}): launches "
                f"{launches} (expected {want} each); "
                + ", ".join(f"{g} err {e:.3e} (err/tol {r:.3f})" for g, _, e, r in checks)
                + f"; device ms forward {ms['walk_fwd']:.4f}, backward {ms['walk_bwd']:.4f}")
            if launches != {name: want for name in counters} or not all(ok for _, ok, _, _ in checks):
                raise AssertionError(f"ring walk {tag} failed: launches {launches}, checks {checks}")
            out[tag] = dict(launches=launches, errors={g: e for g, _, e, _ in checks}, **ms)
        one = dict(fwd=device_ms(torch, lambda: pa.flash_attention(q, k, v, causal, S, S),
                                 cold=False, iters=3, warmup=2),
                   bwd=device_ms(torch, lambda: (
                       pa.flash_attention_bwd_dq(q, k, v, o1, lse1, do, causal=causal),
                       pa.flash_attention_bwd_dkv(q, k, v, o1, lse1, do, causal=causal)),
                       cold=False, iters=3, warmup=2))
        log(f"[ring] one-shot flash on the whole sequence ({'causal' if causal else 'non-causal'}): "
            f"forward {one['fwd']:.4f} ms, dq + dk/dv {one['bwd']:.4f} ms; {smi}")
        out[f"one_shot_{'causal' if causal else 'noncausal'}"] = one
    return out


# one MoE layer of the MoE flagship (benchmarks/moe_bench.py:74-94: E 1024,
# expert hidden 2048, 8 experts, top-2, capacity 1.25) on its batch [4, 2048],
# through the a2a path over EXPERT_WALK_EP virtual expert ranks
EXPERT_WALK_EP = 2


def moe_a2a_walk(torch, mlp, x, ep):
    """``dispatch="a2a"`` of ``models/moe.py`` over ``ep`` virtual expert
    ranks in one process, through the module's own routing, gather
    dispatch, ``_to_experts`` / ``_from_sources`` / ``_to_sources`` /
    ``_from_experts`` packing, ``_expert_ffn`` and gather combine: rank t
    takes rows t·B/ep .. of ``x`` and experts t·E/ep ..; each all-to-all is
    the permutation it performs over the ranks' stacked slabs. Returns y
    [B, S, M] in ``cfg.dtype``."""
    from kubeflow_tpu_torch.models import moe as tm

    cfg = mlp.cfg
    E, S = cfg.num_experts, x.shape[1]
    C, El = cfg.capacity(S), cfg.num_experts // ep
    wi, wo = mlp.experts_wi.to(cfg.dtype), mlp.experts_wo.to(cfg.dtype)
    routes, sent = [], []
    for xt in x.chunk(ep, dim=0):
        plan = mlp.route(xt)
        slot_token, combine_idx = tm.slot_indices(plan, E, C, S)
        routes.append((plan, combine_idx))
        sent.append(tm._to_experts(tm._gather_dispatch(xt, slot_token, E, C, cfg.dtype), ep))
    outs = [tm._to_sources(tm._expert_ffn(tm._from_sources(torch.stack([s[u] for s in sent])),
                                          wi[u * El:(u + 1) * El], wo[u * El:(u + 1) * El],
                                          "becm"), ep)
            for u in range(ep)]
    return torch.cat([tm._gather_combine(tm._from_experts(torch.stack([o[t] for o in outs])),
                                         plan, combine_idx).to(cfg.dtype)
                      for t, (plan, combine_idx) in enumerate(routes)], dim=0)


def _grads_of(torch, fn, inputs, g):
    """(output, gradients of sum(output * g) with respect to ``inputs``)."""
    y = fn()
    return y.detach(), torch.autograd.grad((y.float() * g).sum(), inputs)


def phase_expert_walk(torch):
    """One MoE layer at the flagship width through the a2a path over two
    virtual expert ranks (``moe_a2a_walk``) against the gather dispatch on
    the same weights and rows: the output and the gradients of the input,
    the router and both expert tables, and the MoE kernels' launches."""
    from kubeflow_tpu_torch.models import moe as tm
    from kubeflow_tpu_torch.ops import moe_dispatch as md

    import kubeflow_tpu_torch as kt

    cfg = kt.MoEConfig(**dict(MOE, num_layers=1), dtype=torch.bfloat16)
    model = kt.MoETransformerLM(cfg, device="cuda")
    model.load_state_dict(kt.moe_init_state_dict(cfg, seed=3, device="cuda"))
    mlp = model.layers[0].moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.embed_dim), generator=gen,
                    device="cuda").to(cfg.dtype).requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda")
    inputs = (x, mlp.router, mlp.experts_wi, mlp.experts_wo)
    counters = {"moe_gather": md.gather, "moe_scatter": md.scatter}
    got = {}
    for name, fn in (("gather", lambda: mlp(x)[0]),
                     ("a2a", lambda: moe_a2a_walk(torch, mlp, x, EXPERT_WALK_EP))):
        for c in counters.values():
            c.launches = 0
        got[name] = _grads_of(torch, fn, inputs, g)
        torch.cuda.synchronize()
        got[name + "_launches"] = {k: c.launches for k, c in counters.items()}
    k = cfg.experts_per_token
    want = {"gather": 1 + k, "a2a": EXPERT_WALK_EP * (1 + k)}
    checks = {}
    for what, a, b in zip(("y", "dx", "drouter", "dwi", "dwo"),
                          (got["a2a"][0], *got["a2a"][1]), (got["gather"][0], *got["gather"][1])):
        ok, err, ratio, _ = check_out(a, b, cfg.dtype)
        checks[what] = (ok, err, ratio)
    log(f"[expert walk] one MoE layer (E {cfg.embed_dim}, {cfg.num_experts} experts of "
        f"{cfg.expert_hidden_dim}, top-{k}, batch [{MOE_BATCH}, {MOE_SEQ}]), dispatch a2a over "
        f"{EXPERT_WALK_EP} virtual expert ranks (the all-to-alls as permutations in one process) "
        f"vs gather: " + ", ".join(f"{w} err {e:.3e} (err/tol {r:.3f})" for w, (_, e, r) in checks.items())
        + f"; launches a2a {got['a2a_launches']} (expected {want['a2a']} each), gather "
        f"{got['gather_launches']} (expected {want['gather']} each)")
    if (not all(ok for ok, _, _ in checks.values())
            or got["a2a_launches"] != {c: want["a2a"] for c in counters}
            or got["gather_launches"] != {c: want["gather"] for c in counters}):
        raise AssertionError(f"the a2a walk disagrees with the gather dispatch: {checks}")
    return dict(errors={w: e for w, (_, e, _) in checks.items()},
                launches=got["a2a_launches"], transport="virtual (one process)")


# the MoE layer's span route (models/moe.py under parallel/train.py's seq
# axis) walked over virtual seq ranks in one process
SEQ_WALK_RANKS = (4, 2)


def seq_moe_walk(torch, mlp, x, n, plans=None, spans_run=None):
    """``MoEMLP`` on the span route over ``n`` virtual seq ranks in one
    process: rank r takes positions r·S/n .. of every row of ``x``; the
    ranks' choice counts, which the seq group's all-gather would bring
    (``models/moe._seq_counts``), come from each span's own routing, and
    each span is routed with the scan over them and the whole row's
    capacity, dispatched, run and combined by the module's own forward.
    Returns y [B, S, M] in ``cfg.dtype`` (the spans of ``spans_run`` only,
    all by default); each span's plan is appended to ``plans`` if given."""
    from kubeflow_tpu_torch.models import moe as tm

    E = mlp.cfg.num_experts
    spans = x.chunk(n, dim=1)
    with torch.no_grad():
        counts = torch.stack([torch.stack([tm._one_hot(e, E).sum(dim=1)
                                           for e in mlp.route(s).experts]) for s in spans])
    size, gather = tm._seq_size, tm._seq_counts
    ys = []
    try:
        tm._seq_size = lambda group: n
        mlp.seq_group = "virtual"
        for r, s in enumerate(spans):
            if spans_run is not None and r not in spans_run:
                continue
            tm._seq_counts = lambda c, group, r=r: (counts[:r].sum(dim=0), counts.sum(dim=0))
            if plans is not None:
                with torch.no_grad():
                    plans.append(mlp.route(s))
            ys.append(mlp(s)[0])
    finally:
        tm._seq_size, tm._seq_counts, mlp.seq_group = size, gather, None
    return torch.cat(ys, dim=1)


def phase_seq_moe_walk(torch):
    """One MoE flagship layer on the span route over 4 and 2 virtual seq
    ranks (``seq_moe_walk``) against the whole-row layer on the same weights
    and rows: the spans' plans bit-equal to the whole row's
    ``route_top_k`` (on the same router logits), the output and the
    gradients of the input, the router and both expert tables within the
    kernel bounds, the gather and scatter launches per span, and the device
    ms of the walk's forward and backward beside the whole-row layer's."""
    from kubeflow_tpu_torch.models import moe as tm
    from kubeflow_tpu_torch.ops import moe_dispatch as md

    import kubeflow_tpu_torch as kt

    cfg = kt.MoEConfig(**dict(MOE, num_layers=1), dtype=torch.bfloat16)
    model = kt.MoETransformerLM(cfg, device="cuda")
    model.load_state_dict(kt.moe_init_state_dict(cfg, seed=3, device="cuda"))
    mlp = model.layers[0].moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.embed_dim), generator=gen,
                    device="cuda").to(cfg.dtype).requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda")
    inputs = (x, mlp.router, mlp.experts_wi, mlp.experts_wo)
    counters = {"moe_gather": md.gather, "moe_scatter": md.scatter}
    k, C = cfg.experts_per_token, cfg.capacity(MOE_SEQ)
    with torch.no_grad():
        logits = torch.einsum("bsm,me->bse", x.float(), mlp.router)
        whole_plan = tm.route_top_k(logits, k, C)
    whole = _grads_of(torch, lambda: mlp(x)[0], inputs, g)
    out = {}
    for n in SEQ_WALK_RANKS:
        for c in counters.values():
            c.launches = 0
        plans = []
        y = seq_moe_walk(torch, mlp, x, n, plans)
        got = (y.detach(), torch.autograd.grad((y.float() * g).sum(), inputs))
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        # the spans' plans against the whole row's route_top_k on the spans'
        # own router logits (one GEMM a span, as a rank computes them)
        with torch.no_grad():
            span_logits = torch.cat([torch.einsum("bsm,me->bse", s.float(), mlp.router)
                                     for s in x.chunk(n, dim=1)], dim=1)
            ref_plan = tm.route_top_k(span_logits, k, C)
        equal = {f: torch.equal(torch.cat([getattr(p, f) for p in plans], dim=2),
                                getattr(ref_plan, f)) for f in ("experts", "gates", "pos", "keep")}
        flips = int((ref_plan.experts != whole_plan.experts).sum())
        checks = {}
        for what, a, b in zip(("y", "dx", "drouter", "dwi", "dwo"), (got[0], *got[1]),
                              (whole[0], *whole[1])):
            ok, err, ratio, _ = check_out(a, b, cfg.dtype)
            checks[what] = (ok, err, ratio)

        def walk(run):
            y_run = seq_moe_walk(torch, mlp, x, n, spans_run=run)
            return torch.autograd.grad((y_run.float() * g[:, :y_run.shape[1]]).sum(), inputs)

        walk_ms, span_ms = (device_ms(torch, lambda: walk(run), cold=False, iters=10)
                            for run in (None, (0,)))
        whole_ms = device_ms(torch, lambda: _grads_of(torch, lambda: mlp(x)[0], inputs, g),
                             cold=False, iters=10)
        want = n * (1 + k)
        log(f"[seq moe walk] one MoE layer (E {cfg.embed_dim}, {cfg.num_experts} experts of "
            f"{cfg.expert_hidden_dim}, top-{k}, capacity {C} of the whole row, batch "
            f"[{MOE_BATCH}, {MOE_SEQ}], bf16) over {n} virtual seq ranks: plan bit-equal {equal} "
            f"(routing choices that differ from the whole-row GEMM's logits: {flips}); "
            + ", ".join(f"{w} err {e:.3e} (err/tol {r:.3f})" for w, (_, e, r) in checks.items())
            + f"; launches {launches} (expected {want} each); forward + backward device ms "
            f"{walk_ms:.4f} ({walk_ms / whole_ms:.2f}x; one span's {span_ms:.4f}, with the "
            f"{n} spans' counting routes) vs whole row {whole_ms:.4f}")
        if (not all(equal.values()) or not all(ok for ok, _, _ in checks.values())
                or launches != {c: want for c in counters}):
            raise AssertionError(f"the seq walk at n={n} disagrees with the whole-row layer: "
                                 f"{equal} {checks} {launches}")
        out[n] = dict(plan_equal=equal, flips=flips, launches=launches, walk_ms=walk_ms,
                      span_ms=span_ms, whole_ms=whole_ms,
                      errors={w: e for w, (_, e, _) in checks.items()})
    return out


TENSOR_WALK_TP = 2


def tensor_walk(torch, model, x, rope_cs, tp):
    """The first block (``models/transformer.py`` ``Block``) of ``model``
    over ``tp`` virtual tensor ranks in one process: rank t's attention and
    MLP run on the parts of their weights the tensor rule gives it
    (``parallel/mesh.tensor_param_spec`` through ``param_shardings``: q/k/v/
    gate/up rows, o/down columns; views, so the gradients reach the whole
    weights), at H/tp heads, and their row-parallel partials are summed, as
    the all-reduce sums them. Returns the block's output."""
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    specs = tmesh.param_shardings(tmesh.MeshPlan(tensor=tp), model, tmesh.tensor_param_spec)
    block = model.layers[0]

    def part(module, prefix, t):
        weights = {n: p.chunk(tp, dim=specs[f"layers.0.{prefix}.{n}"].index("tensor"))[t]
                   for n, p in module.named_parameters()}
        return lambda *args: torch.func.functional_call(module, weights, args)

    parts = [(part(block.attn, "attn", t), part(block.mlp, "mlp", t)) for t in range(tp)]
    h = block.attn_norm(x)
    x = x + sum(attn(h, rope_cs) for attn, _ in parts)
    h = block.mlp_norm(x)
    return x + sum(mlp(h) for _, mlp in parts)


def phase_tensor_walk(torch):
    """One dense block at the flagship training width over two virtual
    tensor ranks (``tensor_walk``; flash at 4 heads a rank) against the
    unsplit block on the same weights and input: the output, the gradients
    of the input and of every weight (each rank's part against its slice of
    the whole gradient), and the flash launches."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.models.transformer import rope_tables

    cfg = kt.TransformerConfig(**dict(TRAIN, num_layers=1), dtype=torch.bfloat16)
    model = kt.TransformerLM(cfg, device="cuda")
    model.load_state_dict(kt.init_state_dict(cfg, seed=4, device="cuda"))
    block = model.layers[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.embed_dim), generator=gen,
                    device="cuda").to(cfg.dtype).requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda")
    rope_cs = rope_tables(torch.arange(TRAIN_SEQ, device="cuda"), cfg.head_dim, cfg.rope_theta)
    weights = [p for _, p in block.named_parameters()]
    counters = _flash_counters()
    got = {}
    for name, fn in (("whole", lambda: block(x, rope_cs)),
                     ("split", lambda: tensor_walk(torch, model, x, rope_cs, TENSOR_WALK_TP))):
        for c in counters.values():
            c.launches = 0
        got[name] = _grads_of(torch, fn, (x, *weights), g)
        torch.cuda.synchronize()
        got[name + "_launches"] = {k: c.launches for k, c in counters.items()}
    checks = {}
    names = ["y", "dx"] + [n for n, _ in block.named_parameters()]
    for what, a, b in zip(names, (got["split"][0], *got["split"][1]),
                          (got["whole"][0], *got["whole"][1])):
        ok, err, ratio, _ = check_out(a, b, cfg.dtype)
        checks[what] = (ok, err, ratio)
    heads = cfg.num_heads // TENSOR_WALK_TP
    log(f"[tensor walk] one dense block at the training width (E {cfg.embed_dim}, {cfg.num_heads} "
        f"heads of {cfg.head_dim}, MLP {cfg.mlp_dim}, batch [{TRAIN_BATCH}, {TRAIN_SEQ}]) over "
        f"{TENSOR_WALK_TP} virtual tensor ranks ({heads} heads a rank, partials summed) vs the "
        f"unsplit block: " + ", ".join(f"{w} err {e:.3e} (err/tol {r:.3f})"
                                       for w, (_, e, r) in checks.items())
        + f"; flash launches split {got['split_launches']} (expected {TENSOR_WALK_TP} each), "
        f"whole {got['whole_launches']} (expected 1 each)")
    if (not all(ok for ok, _, _ in checks.values())
            or got["split_launches"] != {c: TENSOR_WALK_TP for c in counters}
            or got["whole_launches"] != {c: 1 for c in counters}):
        raise AssertionError(f"the tensor walk disagrees with the unsplit block: {checks}")
    return dict(errors={w: e for w, (_, e, _) in checks.items()}, launches=got["split_launches"])


# the tensor and expert axes in two real ranks on the one card: two processes
# joined by gloo, whose collectives carry CUDA tensors through the host (NCCL
# takes one card a rank; gloo's point-to-point sends do not take CUDA
# tensors, so seq, whose ring sends K and V point to point, is walked in one
# process by phase_ring instead); the flagship cells' widths, depth cut to
# TWO_RANK_LAYERS, in fp32 (the flash kernels' fp32 route, TF32 off), each
# against the one-device fp32 step on the same weights: the ranks' parts and
# the one device's whole differ in summation order only, and the limits (the
# fused MoE step's fp32 ones) leave room for that alone; a missing or doubled
# reduction moves the loss or the gradient norm by a sizeable fraction
TWO_RANK_LAYERS = 2
TWO_RANK_LOSS_ATOL, TWO_RANK_GNORM_RTOL = MOE_FUSED_F32_LOSS_ATOL, MOE_FUSED_F32_GNORM_RTOL
# (name, kind, plan): "pipeline" is make_pipeline_train_step at 2 microbatches,
# held to the unpipelined full-logits step ("dense_logits" on one device)
# "dense_kv1": the dense cell with one KV head, which does not split over
# tensor=2: q and o split, k and v whole (each rank projects the one KV head)
TWO_RANK_CASES = (("dense_tensor2", "dense", dict(tensor=2)), ("moe_expert2", "moe", dict(expert=2)),
                  ("dense_stage2", "pipeline", dict(stage=2)),
                  ("dense_kv1_tensor2", "dense_kv1", dict(tensor=2)))
TWO_RANK_MICRO = 2


def _two_rank_step(torch, kind, plan, mesh):
    """One SGD step of the dense or MoE cell at TWO_RANK_LAYERS layers in fp32 (on a
    mesh: the a2a dispatch where the plan splits expert, the tensor or MoE
    rule; "pipeline": the pipelined dense step, "dense_logits" its
    unpipelined reference, both with the full-logits loss): {"loss", the
    squares of the gradients the optimizer got, summed apart for the
    parameters split over tensor, expert or stage ("split_sq") and the
    others ("repl_sq"), "launches"}."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import moe_dispatch as md
    from kubeflow_tpu_torch.ops import optimizers as opt
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    a2a = mesh is not None and plan.get("expert", 1) > 1
    counters = dict(_flash_counters(), moe_gather=md.gather, moe_scatter=md.scatter)
    if kind == "pipeline":
        cfg = kt.TransformerConfig(**dict(TRAIN, num_layers=TWO_RANK_LAYERS), dtype=torch.float32)
        got = []
        sgd = opt.sgd(1e-3)

        def update(grads, state, params):
            got.extend(grads)
            return sgd.update(grads, state, params)

        init, step = kt.make_pipeline_train_step(cfg, mesh, opt.GradientTransformation(
            sgd.init, update), num_microbatches=TWO_RANK_MICRO)
        params, opt_state = init(0, device="cuda")
        tokens = cells._tokens(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, "cuda")
        for fn in counters.values():
            fn.launches = 0
        loss = step(params, opt_state, tokens)[2].item()
        out = dict(loss=loss, split_sq=0.0, repl_sq=0.0,
                   launches={k: fn.launches for k, fn in counters.items()})
        for (n, _), g in zip(params.named_parameters(), got):
            out["split_sq" if n.startswith("stages.") else "repl_sq"] += g.float().pow(2).sum().item()
        return out
    if kind in ("dense", "dense_logits", "dense_kv1"):
        kv = dict(num_kv_heads=1) if kind == "dense_kv1" else {}
        cfg = kt.TransformerConfig(**dict(TRAIN, num_layers=TWO_RANK_LAYERS, **kv),
                                   dtype=torch.float32)
        model = kt.TransformerLM(cfg, device="cuda")
        model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cuda"))
        loss_fn, rule, batch, seq = None, tmesh.tensor_param_spec, TRAIN_BATCH, TRAIN_SEQ
        if kind == "dense_logits":
            def loss_fn(model, tokens):
                return kt.lm_loss(model(tokens), tokens)
    else:
        cfg = kt.MoEConfig(**dict(MOE, num_layers=TWO_RANK_LAYERS,
                                  dispatch="a2a" if a2a else "gather"),
                           dtype=torch.float32, mesh=mesh if a2a else None)
        model = kt.MoETransformerLM(cfg, device="cuda")
        model.load_state_dict(kt.moe_init_state_dict(cfg, seed=0, device="cuda"))
        loss_fn, rule, batch, seq = cells.moe_loss_fn("chunked"), tmesh.moe_param_spec, MOE_BATCH, MOE_SEQ
    got = []
    sgd = opt.sgd(1e-3)

    def update(grads, state, params):
        got.extend(grads)
        return sgd.update(grads, state, params)

    bundle = kt.make_lm_train_step(model, opt.GradientTransformation(sgd.init, update), mesh,
                                   param_rule=rule, loss_fn=loss_fn, chunk=TRAIN_CHUNK)
    tokens = cells._tokens(cfg.vocab_size, batch, seq, "cuda")
    state = bundle.init()
    for fn in counters.values():
        fn.launches = 0
    loss = bundle.step(state, tokens)[1]["loss"].item()
    sizes = tmesh.MeshPlan(**plan).axis_sizes()
    specs = bundle.state_shardings["params"] if mesh is not None else {}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    out = dict(loss=loss, split_sq=0.0, repl_sq=0.0,
               launches={k: fn.launches for k, fn in counters.items()})
    for n, g in zip(names, got):
        axes = {a for entry in specs.get(n, ()) if entry is not None
                for a in (entry if isinstance(entry, tuple) else (entry,))}
        split = any(a in ("tensor", "expert") and sizes[a] > 1 for a in axes)
        out["split_sq" if split else "repl_sq"] += g.float().pow(2).sum().item()
    return out


def two_rank_main(rank: int, folder: str) -> None:
    """Rank ``rank`` of ``phase_two_ranks`` (started as ``python3 -c``): each
    case's step on its mesh, its report written to ``folder``."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import mesh as tmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{folder}/store", rank=rank, world_size=2)
    out = {}
    try:
        for name, kind, plan in TWO_RANK_CASES:
            out[name] = _two_rank_step(torch, kind, plan, tmesh.create_mesh(tmesh.MeshPlan(**plan)))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    Path(folder, f"rank{rank}.json").write_text(json.dumps(out))


def phase_two_ranks(torch, np):
    """The sharded train steps on tensor=2 (Megatron, flash at 4 heads a
    rank; and with one KV head, held whole, 4 query heads over it a rank)
    and expert=2 (the a2a dispatch: two real all-to-alls a layer), and
    the pipeline on stage=2 (2 microbatches, the activations and their
    gradients handed over by all_to_all_single), in two ranks, two
    processes on the one card joined by gloo, in fp32 against the
    one-device step on the same weights (the pipeline's: unpipelined, the
    same full-logits loss): the loss on both ranks and the global gradient
    norm within ``TWO_RANK_LOSS_ATOL`` / ``TWO_RANK_GNORM_RTOL``, and each
    rank's launches."""
    import tempfile

    L = TWO_RANK_LAYERS
    refs = {"dense": "dense", "moe": "moe", "pipeline": "dense_logits", "dense_kv1": "dense_kv1"}
    ref = {kind: _two_rank_step(torch, refs[kind], {}, None) for kind in refs}
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as folder:
        procs = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                                   f"chip_smoke.two_rank_main({r}, {folder!r})"], cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError("a rank failed: " + "\n".join(log[-3000:] for log in logs))
        reps = [json.loads(Path(folder, f"rank{r}.json").read_text()) for r in range(2)]
    flash = list(_flash_counters())
    out = {}
    for name, kind, plan in TWO_RANK_CASES:
        a, b = (rep[name] for rep in reps)
        want = ref[kind]
        norm = (a["split_sq"] + b["split_sq"] + a["repl_sq"]) ** 0.5
        norm_ref = (want["split_sq"] + want["repl_sq"]) ** 0.5
        d_loss, d_norm = abs(a["loss"] - want["loss"]), abs(norm - norm_ref) / norm_ref
        loss_atol, gnorm_rtol = TWO_RANK_LOSS_ATOL, TWO_RANK_GNORM_RTOL
        expect = [dict({k: L for k in flash}, moe_gather=3 * L if kind == "moe" else 0,
                       moe_scatter=3 * L if kind == "moe" else 0) for _ in range(2)]
        if kind == "pipeline":      # a rank's L/2 blocks, each microbatch, forward twice (remat)
            per = L // 2 * TWO_RANK_MICRO
            expect = [dict(flash_attention_fwd=2 * per, flash_attention_bwd_dq=per,
                           flash_attention_bwd_dkv=per, moe_gather=0, moe_scatter=0)] * 2
        log(f"[two ranks] {name} ({kind} flagship width, {L} layers, fp32, two processes on one "
            f"card, gloo): loss {a['loss']:.5f} / {b['loss']:.5f} vs one device {want['loss']:.5f} "
            f"(|diff| {d_loss:.2e}, atol {loss_atol}); grad norm {norm:.5f} vs {norm_ref:.5f} "
            f"(rel diff {d_norm:.2e}, rtol {gnorm_rtol}); launches {a['launches']} / "
            f"{b['launches']} (expected {expect[0]} / {expect[1]})")
        if (a["loss"] != b["loss"] or not np.isfinite([a["loss"], norm]).all()
                or d_loss > loss_atol or d_norm > gnorm_rtol
                or [a["launches"], b["launches"]] != expect):
            raise AssertionError(f"the two-rank {name} step disagrees with one device")
        out[name] = dict(losses=[a["loss"], b["loss"]], loss_ref=want["loss"], grad_norm=norm,
                         grad_norm_ref=norm_ref, launches=[a["launches"], b["launches"]],
                         transport="gloo, two processes on one card")
    return out


# the pipeline (parallel/pipeline.py) walked on the one card: the dense training
# flagship through make_pipeline_train_step with a MeshPlan of n virtual
# stages (every stage in this process, the same tick loop as on ranks), at
# (n_stages, num_microbatches); its first step held to the unpipelined
# full-logits step's on the same weights within the dense card-vs-CPU bounds
PIPE_SETTINGS = ((4, 4), (2, 2))
PIPE_STEPS = 4


def _pipe_run(torch, np, tag, build, counters, per_step, tokens):
    """``build(tx) -> step()`` (one train step returning its loss): a first
    step with the launch counters set to 0 just before and read just after
    and the gradient norm it hands the optimizer, then ``PIPE_STEPS`` timed
    steps (peak memory over them) and one profiled step."""
    from kubeflow_tpu_torch.ops import optimizers as opt

    adamw, norms = cells.adamw(), []

    def update(grads, state, params):
        if not norms:
            norms.append(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)).item())
        return adamw.update(grads, state, params)

    step = build(opt.GradientTransformation(adamw.init, update))
    for fn in counters.values():
        fn.launches = 0
    losses = [step().item()]
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != per_step:
        raise AssertionError(f"[pipeline] {tag}: launches {launches} != {per_step}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(PIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = _profile(torch, step, reps=1)[0]
    med = float(np.median(ms))
    return dict(losses=losses, grad_norm=norms[0], launches=launches, step_ms=ms,
                step_ms_median=med, tok_s=tokens.numel() / (med / 1e3), device_busy_ms=busy,
                peak_memory_gb=peak)


def phase_pipeline(torch, np):
    """The dense training flagship (24 layers, E 1024, 8 heads, MLP 4096,
    flash block 1024, bf16, tokens [4, 2048], ``_cells.adamw()``) through
    ``make_pipeline_train_step`` walked over ``PIPE_SETTINGS``' virtual
    stages, against the unpipelined ``TransformerLM`` + ``lm_loss`` step on
    the same weights (seed 0) timed in the same call: the first step's loss
    and gradient norm within ``TRAIN_LOSS_ATOL`` / ``TRAIN_GNORM_RTOL``,
    flash launches a step 2·L·n_micro forward (each stage step runs again in
    its backward) and L·n_micro dq and dk/dv, a falling loss, step ms,
    device busy ms of one profiled step, tok/s, peak GB. The bubble real
    ranks would add, (n_stages − 1) / (n_micro + n_stages − 1) of the
    ticks, is arithmetic here: one card runs the stages one after another."""
    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    cfg = kt.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    tokens = cells._tokens(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    counters, L = _flash_counters(), cfg.num_layers

    def unpipelined(tx):
        model = kt.TransformerLM(cfg, device="cuda")
        model.load_state_dict(kt.init_state_dict(cfg, seed=0, device="cuda"))
        bundle = kt.make_lm_train_step(model, tx, loss_fn=lambda m, t: kt.lm_loss(m(t), t))
        state = bundle.init()
        return lambda: bundle.step(state, tokens)[1]["loss"]

    def pipelined(n_stages, n_micro):
        def build(tx):
            init, step = kt.make_pipeline_train_step(cfg, tmesh.MeshPlan(stage=n_stages), tx,
                                                     num_microbatches=n_micro)
            params, opt_state = init(0, device="cuda")
            return lambda: step(params, opt_state, tokens)[2]
        return build

    ref = _pipe_run(torch, np, "unpipelined", unpipelined, counters, {k: L for k in counters},
                    tokens)
    torch.cuda.empty_cache()
    log(f"[pipeline] unpipelined TransformerLM + lm_loss (full logits), dense flagship, bf16, "
        f"[4, 2048]: first loss {ref['losses'][0]:.5f}, grad norm {ref['grad_norm']:.5f}; step "
        f"{ref['step_ms_median']:.2f} ms median of {[round(x, 2) for x in ref['step_ms']]}, "
        f"{ref['tok_s']:.1f} tok/s, device busy {ref['device_busy_ms']:.2f} ms, peak "
        f"{ref['peak_memory_gb']:.2f} GB; {card()}")
    out = {"unpipelined": ref}
    for n_stages, n_micro in PIPE_SETTINGS:
        per = L * n_micro
        got = _pipe_run(torch, np, f"{n_stages}x{n_micro}", pipelined(n_stages, n_micro),
                        counters, {"flash_attention_fwd": 2 * per, "flash_attention_bwd_dq": per,
                                   "flash_attention_bwd_dkv": per}, tokens)
        torch.cuda.empty_cache()
        d_loss = abs(got["losses"][0] - ref["losses"][0])
        d_norm = abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        bubble = (n_stages - 1) / (n_micro + n_stages - 1)
        log(f"[pipeline] {n_stages} stages x {n_micro} microbatches (walked, one card): first "
            f"loss {got['losses'][0]:.5f} (|diff| {d_loss:.2e}, atol {TRAIN_LOSS_ATOL}); grad "
            f"norm {got['grad_norm']:.5f} (rel diff {d_norm:.2e}, rtol {TRAIN_GNORM_RTOL}); "
            f"flash launches a step {got['launches']}; losses "
            f"{[round(x, 4) for x in got['losses']]}; step {got['step_ms_median']:.2f} ms median "
            f"of {[round(x, 2) for x in got['step_ms']]} ({got['step_ms_median'] / ref['step_ms_median']:.3f}x "
            f"unpipelined), {got['tok_s']:.1f} tok/s, device busy {got['device_busy_ms']:.2f} ms "
            f"({got['device_busy_ms'] / ref['device_busy_ms']:.3f}x), peak "
            f"{got['peak_memory_gb']:.2f} GB; bubble on real ranks {bubble:.4f} of the ticks "
            f"(arithmetic)")
        if (not np.isfinite(got["losses"]).all() or d_loss > TRAIN_LOSS_ATOL
                or d_norm > TRAIN_GNORM_RTOL or not got["losses"][-1] < got["losses"][0]):
            raise AssertionError(f"the {n_stages}x{n_micro} pipeline disagrees with the "
                                 f"unpipelined step: {got}")
        out[f"{n_stages}x{n_micro}"] = dict(got, loss_abs_diff=d_loss, grad_norm_rel_diff=d_norm,
                                            bubble=bubble)
    return out


# the dry run's sections at a world of one (__graft_entry__.py's plans for one device)
DRYRUN_ONE = ("resnet dp=1 fsdp=1: loss=", "parity dp=1 fsdp=1 vs 1-device: loss ",
              "step parity dp=1 fsdp=1 vs 1-device (train step, global BatchNorm statistics): "
              "loss ",
              "transformer fsdp=1 tensor=1 seq=1 (block attention): loss=",
              "moe data=1 expert=1 tensor=1: loss=")


def phase_dryrun(torch):
    """``python -m kubeflow_tpu_torch.graft_entry 1`` (the dry run's
    sections on one card, nccl, one rank process) in a subprocess: every
    section's line, parity included; then ``entry()``'s ResNet-50 forward on
    its example input."""
    from kubeflow_tpu_torch import graft_entry

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.graft_entry", "1"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines() if x.startswith("[dryrun] ")]
    for x in lines:
        log(x)
    if proc.returncode or len(lines) != len(DRYRUN_ONE) or not all(
            x[len("[dryrun] "):].startswith(w) for x, w in zip(lines, DRYRUN_ONE)):
        raise AssertionError(f"the dry run at one rank failed ({proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    fn, args = graft_entry.entry()
    logits = fn(*args)
    torch.cuda.synchronize()
    log(f"[dryrun] one card, {seconds:.1f} s; entry(): ResNet-50 forward on [8, 224, 224, 3] "
        f"bf16 ones: logits {tuple(logits.shape)} {logits.dtype}, finite "
        f"{bool(torch.isfinite(logits).all())}")
    if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("entry()'s forward gave wrong logits")
    return dict(lines=lines, seconds=seconds)


# the notebook's suspend and resume at full width (phase_session): the dense
# flagship fed by the prefetcher, a save called after steps 1-3 on orbax's
# policy (2 kept, every 2nd step, the first always), suspended at step 4,
# resumed from another seed's init, steps 5 and 6 replayed
SESSION_STEPS, SESSION_SUSPEND = 6, 4
SESSION_WORLD_LAYERS = 2      # the world-of-one DTensor round trip's depth
FLASH_KERNELS = {"flash_attention_fwd": "flash_fwd_wgmma",
                 "flash_attention_bwd_dq": "flash_dq_wgmma",
                 "flash_attention_bwd_dkv": "flash_dkv_wgmma"}


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _trace_kernels(logdir: Path):
    """(device events of each flash kernel, user regions) in the Chrome
    traces under ``logdir``."""
    counts = {k: 0 for k in FLASH_KERNELS}
    regions = []
    files = sorted(logdir.rglob("*.pt.trace.json"))
    for f in files:
        for e in json.loads(f.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                for k, sym in FLASH_KERNELS.items():
                    counts[k] += sym in e.get("name", "")
            elif e.get("cat") == "user_annotation":
                regions.append(e.get("name", ""))
    return counts, regions, files


def _adam_slots(state):
    """{"params"/"mu"/"nu"/"count"/"step"} of a one-device state, by name."""
    names = list(state["params"])
    adam = state["opt_state"][0]
    return dict(params=state["params"], mu=dict(zip(names, adam["mu"])),
                nu=dict(zip(names, adam["nu"])), count=adam["count"], step=state["step"])


def _bit_equal(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                                        for k in a)


def _session_world_of_one(torch, root: Path):
    """A world of one joined with ``"cpu:gloo,cuda:nccl"``, its mesh built by
    ``spmd.build_mesh`` from a one-chip derived mesh; the sharded dense step
    (2 layers of the flagship width) saved through the DTensor path, restored
    onto ``mesh=None``: the parameters and moments bit-equal."""
    import types

    import torch.distributed as dist

    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.parallel import mesh as tmesh
    from kubeflow_tpu_torch.spmd import mesh as spmd_mesh

    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        one_chip = types.SimpleNamespace(shape=(1,), num_slices=1, num_hosts=1, chips_per_host=1)
        mesh = spmd_mesh.build_mesh(one_chip)
        cell = cells.dense_train(mesh=mesh, num_layers=SESSION_WORLD_LAYERS)
        state = cell.bundle.init()
        for _ in range(2):
            cell.bundle.step(state, cell.tokens)
        mgr = kt.CheckpointManager(str(root / "world"))
        committed = kt.snapshot_for_suspend(mgr, 2, state)
        names = list(state["params"])
        adam = state["opt_state"][0]
        saved = dict(params=cell.bundle.gather(state["params"]),
                     mu=cell.bundle.gather(dict(zip(names, adam["mu"]))),
                     nu=cell.bundle.gather(dict(zip(names, adam["nu"]))))
        one = cells.dense_train(num_layers=SESSION_WORLD_LAYERS)
        one.model.load_state_dict(kt.init_state_dict(one.cfg, seed=1))
        restored = _adam_slots(mgr.restore(one.bundle.init()))
        mgr.close()
        ok = (committed == 2 and restored["step"] == 2 and restored["count"] == 2
              and all(_bit_equal(torch, saved[k], restored[k]) for k in saved))
        log(f"[session] world of one (cpu:gloo,cuda:nccl, backend {dist.get_backend()}), mesh "
            f"{tmesh.axis_sizes(mesh)} from spmd.build_mesh (device type {mesh.device_type}); "
            f"the sharded {SESSION_WORLD_LAYERS}-layer step saved as DTensors "
            f"({_dir_bytes(root / 'world' / '2')} bytes), restored onto mesh=None: parameters "
            f"and moments bit-equal {ok}")
        if not ok:
            raise AssertionError("the sharded state did not restore bit-equal onto one device")
        return dict(bit_equal=ok, mesh=tmesh.axis_sizes(mesh))
    finally:
        dist.destroy_process_group()


def session_traces_main(folder: str) -> None:
    """``phase_session``'s traces (started as ``python3 -c``): the dense
    flagship's ``trace_n_steps(steps=3)``, then a ``TorchTraceProfiler``
    capture asked for from another thread while this one steps until it
    ends (four steps at least), which runs on this thread between its step
    boundaries; then a loop that steps only through a ``TelemetryAgent``'s
    ``step()`` while another thread asks the agent for a capture (five
    steps at least); the counts, the agent's step numbers and its scrape's
    step total and ended steps written to ``folder/traces.json``.

    Each capture is asked for just after the loop ended a step: a request
    finds a stepping loop only if a step ended within its pickup time, and
    the trace's export and reading after ``trace_n_steps`` can outlast it."""
    import threading

    import torch

    from kubeflow_tpu_torch.utils import profiling

    from kubeflow_tpu_torch.telemetry.agent import (
        TelemetryAgent,
        TorchDeviceBackend,
        TorchTraceProfiler,
    )
    from kubeflow_tpu_torch.utils.profiling import step_annotation, trace_n_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(folder)
    cell = cells.dense_train()
    state = cell.bundle.init()
    counters = _flash_counters()
    trace_n_steps(str(root / "trace"), cell.bundle.step, state, cell.tokens, steps=3)
    counts, regions, files = _trace_kernels(root / "trace")
    out = dict(trace_counts=counts, trace_steps=sorted(r for r in regions if r.startswith("train#")),
               trace_files=[str(f.relative_to(root / "trace")) for f in files],
               trace_launches=[fn.launches for fn in counters.values()])
    profiler = TorchTraceProfiler(logdir_base=str(root / "capture"), step_hint_s=0.2)
    text = {}

    def ask(key, capture):
        text[f"{key}_gap_s"] = time.perf_counter() - profiling._last_step_end
        text[key] = capture(2)

    with step_annotation(100):
        cell.bundle.step(state, cell.tokens)
    n = 1
    capture = threading.Thread(target=ask, args=("lines", profiler.capture))
    capture.start()
    while n < 4 or capture.is_alive():
        with step_annotation(100 + n):
            cell.bundle.step(state, cell.tokens)
        n += 1
    torch.cuda.synchronize()
    capture.join()
    counts, regions, _ = _trace_kernels(root / "capture")
    out.update(capture_counts=counts, capture=text["lines"], capture_main_steps=n,
               capture_route=profiler.last_route, capture_gap_s=text["lines_gap_s"],
               capture_steps=sorted(r for r in regions if r.startswith("train#")))
    # a loop that steps only through the agent's step hook, and a capture
    # asked for through the agent from another thread
    profiler = TorchTraceProfiler(logdir_base=str(root / "agent"), step_hint_s=0.2)
    agent = TelemetryAgent(TorchDeviceBackend(), profiler=profiler)
    numbers = []
    with agent.step() as n:
        numbers.append(n)
        cell.bundle.step(state, cell.tokens)
    capture = threading.Thread(target=ask, args=("agent", agent.capture))
    capture.start()
    while len(numbers) < 5 or capture.is_alive():
        with agent.step() as n:
            numbers.append(n)
            cell.bundle.step(state, cell.tokens)
    torch.cuda.synchronize()
    capture.join()
    counts, regions, _ = _trace_kernels(root / "agent")
    scrape = agent.exposition().splitlines()
    out.update(agent_counts=counts, agent_capture=text["agent"], agent_numbers=numbers,
               agent_route=profiler.last_route, agent_gap_s=text["agent_gap_s"],
               agent_steps=sorted(int(r[len("train#"):]) for r in regions
                                  if r.startswith("train#")),
               agent_total=next(float(x.split()[1]) for x in scrape
                                if x.startswith("tpu_step_total ")),
               agent_ended=sorted(int(x.split('"')[1]) for x in scrape
                                  if x.startswith("tpu_step_end_seconds{")))
    (root / "traces.json").write_text(json.dumps(out))


def phase_session(torch, np, train: dict, monitor, compile_at_build):
    """The notebook's suspend and resume on the dense flagship (module
    docstring, phase 24)."""
    import shutil
    import tempfile

    import kubeflow_tpu_torch as kt
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.telemetry.agent import TorchDeviceBackend
    from kubeflow_tpu_torch.utils.data import DevicePrefetcher, synthetic_token_batches
    from kubeflow_tpu_torch.utils.profiling import step_annotation

    base = Path(__file__).resolve().parent / "_checkout"
    base.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="session-", dir=base))
    try:
        out = {}
        free_gb = shutil.disk_usage(root).free / 1e9
        cell = cells.dense_train()
        cfg, bundle = cell.cfg, cell.bundle
        counters = _flash_counters()
        batches = DevicePrefetcher(synthetic_token_batches(
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size, seed=0,
            steps=SESSION_STEPS), "cuda", depth=2)
        state = bundle.init()
        mgr = kt.CheckpointManager(str(root / "ckpt"), max_to_keep=2, save_interval_steps=2)
        losses, steps, kept, saved = [], [], {}, None
        for fn in counters.values():
            fn.launches = 0
        for n in range(1, SESSION_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = next(batches)
            with step_annotation(n):
                _, metrics = bundle.step(state, tokens)
            loss = metrics["loss"].item()
            t1 = time.perf_counter()
            started = None
            if n < SESSION_SUSPEND:
                started = mgr.save(n, state)
            elif n == SESSION_SUSPEND:
                committed = kt.snapshot_for_suspend(mgr, n, state)
                if committed != SESSION_SUSPEND:
                    raise AssertionError(f"snapshot_for_suspend returned {committed}")
                saved = {k: ({n_: t.clone() for n_, t in v.items()} if isinstance(v, dict) else v)
                         for k, v in _adam_slots(state).items()}
            t2 = time.perf_counter()
            losses.append(loss)
            steps.append(dict(step=n, step_ms=(t1 - t0) * 1e3, save_ms=(t2 - t1) * 1e3,
                              save=("suspend" if n == SESSION_SUSPEND else started)))
            if n > SESSION_SUSPEND:
                kept[n] = tokens
        launches = {k: fn.launches for k, fn in counters.items()}
        mgr.close()
        step_bytes = _dir_bytes(root / "ckpt" / str(SESSION_SUSPEND))
        on_disk = sorted(int(p.name) for p in (root / "ckpt").iterdir())
        want = {k: cfg.num_layers * SESSION_STEPS for k in counters}
        log(f"[session] dense flagship, {SESSION_STEPS} steps from DevicePrefetcher(synthetic "
            f"tokens, 'cuda', depth 2), each in step_annotation(n); launches {launches} "
            f"(expected {want}); losses {[round(x, 5) for x in losses]}")
        for s in steps:
            log(f"[session]   step {s['step']}: step {s['step_ms']:.2f} ms, then "
                f"{'snapshot_for_suspend' if s['save'] == 'suspend' else 'save'} "
                f"{s['save_ms']:.2f} ms (started a save: {s['save']})")
        if launches != want:
            raise AssertionError(f"flash launches {launches} != {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss: {losses}")
        median = float(np.median([s["step_ms"] for s in steps]))
        # a step and its save call: those that started a save against those
        # that did not; the steps after the suspend run with no write in flight
        with_save = [s["step_ms"] + s["save_ms"] for s in steps if s["save"] is True]
        without = [s["step_ms"] + s["save_ms"] for s in steps if s["save"] in (False, None)]
        quiet = float(np.median([s["step_ms"] for s in steps[SESSION_SUSPEND:]]))
        log(f"[session] one step on disk {step_bytes} bytes ({step_bytes / 1e9:.3f} GB; "
            f"steps kept {on_disk}); free disk before the first save {free_gb:.1f} GB; "
            f"step + save call ms where a save started {[round(x, 2) for x in with_save]}, "
            f"where none did {[round(x, 2) for x in without]}; snapshot_for_suspend blocked "
            f"{steps[SESSION_SUSPEND - 1]['save_ms']:.2f} ms; step median with the prefetcher "
            f"{median:.2f} ms ({quiet:.2f} ms with no write in flight) vs the train phase's "
            f"{train['step_ms_median']:.2f} ms on fixed tokens")
        if on_disk != [2, SESSION_SUSPEND]:
            raise AssertionError(f"max_to_keep=2 left steps {on_disk}")
        out.update(losses=losses, steps=steps, launches=launches, step_bytes=step_bytes,
                   free_disk_gb=free_gb, step_ms_median=median, step_ms_no_write=quiet,
                   steps_on_disk=on_disk)
        del cell, state, batches
        torch.cuda.empty_cache()

        # resume: a fresh cell from another seed, the suspend step restored,
        # steps 5 and 6 replayed on the same batches
        cell = cells.dense_train()
        cell.model.load_state_dict(kt.init_state_dict(cell.cfg, seed=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = kt.resume_or_init(str(root / "ckpt"), cell.bundle.init)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        got = _adam_slots(state)
        restored = (got["step"] == SESSION_SUSPEND and got["count"] == SESSION_SUSPEND
                    and all(_bit_equal(torch, saved[k], got[k]) for k in ("params", "mu", "nu")))
        del saved
        replay = [cell.bundle.step(state, kept[n])[1]["loss"].item()
                  for n in range(SESSION_SUSPEND + 1, SESSION_STEPS + 1)]
        d = max(abs(a - b) for a, b in zip(replay, losses[SESSION_SUSPEND:]))
        log(f"[session] resume_or_init {resume_s * 1e3:.2f} ms: step {got['step']}, count "
            f"{got['count']}, parameters and moments bit-equal to the suspend's {restored}; "
            f"replayed losses {replay} vs uninterrupted {losses[SESSION_SUSPEND:]} (max |diff| "
            f"{d:.3e}, bit-equal {d == 0.0})")
        if not restored or d != 0.0:
            raise AssertionError("the resumed session does not continue the suspended one")
        out.update(resume_ms=resume_s * 1e3, replay_losses=replay, replay_max_abs_diff=d)

        # the device backend and the compile monitor
        torch.cuda.synchronize()
        (sample,) = TorchDeviceBackend().samples()
        allocated, total = torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[1]
        log(f"[session] TorchDeviceBackend: hbm_used_bytes {sample.hbm_used_bytes:.0f} "
            f"(memory_allocated {allocated}), hbm_total_bytes {sample.hbm_total_bytes:.0f} "
            f"(the card's {total}), duty_cycle {sample.duty_cycle}")
        if (sample.hbm_used_bytes != allocated or sample.hbm_total_bytes != total
                or sample.duty_cycle is not None):
            raise AssertionError("the device backend's bytes differ from the allocator's")
        totals = monitor.totals()
        log(f"[session] TorchCompileMonitor (made before the build): (compiles, seconds, cache "
            f"hits) {compile_at_build} after the build phase, {totals} now")
        if compile_at_build[0] + compile_at_build[2] != len(_build.SIGNATURES):
            raise AssertionError(f"the compile monitor counted {compile_at_build} for "
                                 f"{len(_build.SIGNATURES)} sources")
        out.update(device_sample=[sample.hbm_used_bytes, sample.hbm_total_bytes],
                   compile_at_build=compile_at_build, compile_now=totals)
        del cell, state, kept
        torch.cuda.empty_cache()

        # the traces, in a process of their own: a process that has run many
        # profiler sessions (the earlier phases') can lose every kernel its
        # main thread launches from later traces (module docstring, phase 24)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                               f"chip_smoke.session_traces_main({str(root)!r})"],
                              cwd=Path(__file__).resolve().parent, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"the session's traces exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        traces = json.loads((root / "traces.json").read_text())
        counts, steps_in = traces["trace_counts"], traces["trace_steps"]
        log(f"[session] in a fresh process ({time.perf_counter() - t0:.1f} s): "
            f"trace_n_steps(steps=3): {traces['trace_files']}; device events {counts} (launched "
            f"{traces['trace_launches']} with the warm-up); step regions {steps_in}")
        if (len(traces["trace_files"]) != 1 or "plugins/profile/" not in traces["trace_files"][0]
                or counts != {k: 3 * cfg.num_layers for k in counts}
                or traces["trace_launches"] != [4 * cfg.num_layers] * 3
                or steps_in != ["train#1", "train#2", "train#3"]):
            raise AssertionError(f"the trace lacks the steps' flash kernels or regions: {counts}")
        cap_counts, cap_steps = traces["capture_counts"], traces["capture_steps"]
        log(f"[session] TorchTraceProfiler(step_hint_s=0.2).capture(2) from a thread beside "
            f"{traces['capture_main_steps']} steps (asked {traces['capture_gap_s']:.3f} s after "
            f"a step ended), route {traces['capture_route']!r}: "
            f"{traces['capture'].strip()}; device events {cap_counts}; step regions {cap_steps}")
        if traces["capture_route"] != "loop" or not cap_steps:
            raise AssertionError(f"the capture did not run on the stepping loop's thread: route "
                                 f"{traces['capture_route']!r}, step regions {cap_steps}")
        if cap_counts != {k: cfg.num_layers * len(cap_steps) for k in cap_counts}:
            raise AssertionError(f"the capture's {len(cap_steps)} whole steps do not hold "
                                 f"{cfg.num_layers} of each flash kernel a step: {cap_counts}")
        out.update(trace_counts=counts, capture_counts=cap_counts, capture=traces["capture"])
        ag_counts, ag_steps, numbers = (traces["agent_counts"], traces["agent_steps"],
                                        traces["agent_numbers"])
        log(f"[session] TelemetryAgent.step() loop of {len(numbers)} steps (numbers "
            f"{numbers}), agent.capture(2) from a thread (asked {traces['agent_gap_s']:.3f} s "
            f"after a step ended), route {traces['agent_route']!r}: "
            f"{traces['agent_capture'].strip()}; device events {ag_counts}; step regions "
            f"{ag_steps}; the scrape's tpu_step_total {traces['agent_total']:.0f}, ended steps "
            f"{traces['agent_ended']}")
        if traces["agent_route"] != "loop" or not ag_steps:
            raise AssertionError(f"the agent's capture did not run on the stepping loop's thread: "
                                 f"route {traces['agent_route']!r}, step regions {ag_steps}")
        if (ag_steps != list(range(ag_steps[0], ag_steps[0] + len(ag_steps)))
                or not set(ag_steps) <= set(numbers) or traces["agent_total"] != len(numbers)
                or traces["agent_ended"] != numbers):
            raise AssertionError(f"the agent's steps {numbers} (scrape: "
                                 f"{traces['agent_total']}, {traces['agent_ended']}) do not "
                                 f"match the trace's regions {ag_steps}")
        if ag_counts != {k: cfg.num_layers * len(ag_steps) for k in ag_counts}:
            raise AssertionError(f"the agent's capture's {len(ag_steps)} whole steps do not hold "
                                 f"{cfg.num_layers} of each flash kernel a step: {ag_counts}")
        out.update(agent_counts=ag_counts, agent_steps=ag_steps, agent_numbers=numbers)

        out["world_of_one"] = _session_world_of_one(torch, root)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# each entry point once with few windows: (module, windows, metric). The
# trainers are device-bound and one repeat gives a steady difference; a
# request is host-bound and its time spreads from request to request, so
# decode takes the bench's own three repeats: with one, a stall of the one
# short window turns long minus short negative
BENCH_ENTRIES = (
    ("transformer_bench", (2, 6, 1), "transformer_train_tokens_per_sec_per_chip"),
    ("moe_bench", (2, 6, 1), "moe_train_tokens_per_sec_per_chip"),
    ("decode_bench", (1, 3, 3), "decode_tokens_per_sec_per_row"),
    ("resnet_bench", (2, 6, 1), "resnet50_train_imgs_per_sec_per_chip"),
)




def _per_step(flash: int, head: int = 0, rows: int = 0, library: int = 0) -> dict:
    """Launches (and MoE library calls) a train step, by counter
    (``_cells.launch_counters``)."""
    return {"flash_attention_fwd": flash, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash, "fused_head_fwd": head,
            "fused_head_bwd_dh": head, "fused_head_bwd_de": head, "moe_gather": rows,
            "moe_scatter": rows, "library_gather": library, "library_scatter": library}


# the A/B modes: (module, flag, metric, key after per_chip_batch, {side: a step's launches})
_L, _ML = TRAIN["num_layers"], MOE["num_layers"]
BENCH_AB = (
    ("transformer_bench", "--ab-head", "transformer_head_ab", None,
     {"fused": _per_step(_L, head=1), "chunked": _per_step(_L)}),
    ("moe_bench", "--ab", "moe_head_ab", "dispatch",
     {"fused": _per_step(_ML, head=1, rows=3 * _ML), "chunked": _per_step(_ML, rows=3 * _ML)}),
    ("moe_bench", "--ab-dispatch", "moe_dispatch_ab", "head",
     {"kernel": _per_step(_ML, rows=3 * _ML), "library": _per_step(_ML, library=3 * _ML)}),
)
AB_WINDOWS = (1, 2, 1)
MFU_ARGV = ["--mfu", "--accelerator", "v5e", "--topology", "1x1", "--n-long", "2", "--repeats", "1"]
SHOOTOUT_WINDOWS = (1, 2, 1)
# the (b, h) slices of the shootout's [2, S, 8, 128] operands held against the
# plain versions at every length: the first, and the last (the largest offsets)
SHOOTOUT_SLICES = ((0, 0), (1, 7))


def _bench_run(name: str, code: list, seconds_limit: int = 600):
    """Run one bench command from the repo root; (stdout lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *code], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=seconds_limit)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"{name} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines(), seconds


def _check_card_fields(torch, name, line, limit):
    if (line.get("card") != torch.cuda.get_device_name(0) or line.get("power_limit_w") != limit
            or "vs_baseline" in line):
        raise AssertionError(f"{name} printed an unexpected line: {line}")


def shootout_main() -> None:
    """``phase_bench_entries``' attention shootout (started as ``python3
    -c``): ``attention_bench.main`` with the flash counters set to 0 just
    before and read just after. Then, at each length, on the bench's own
    inputs and loss (cotangent ones): flash's output, lse and gradients in q,
    k and v held against their plain versions (``flash_attention_plain``,
    ``flash_attention_backward_plain``, the kernels' rounding points) under
    the kernel bounds (``check_out``, ``check_lse``) on the (b, h) slices of
    ``SHOOTOUT_SLICES`` (the plain versions' [S, S] fp32 scores fit the card
    one slice at a time); and flash's and the plain versions' distance from
    block's (fp32 throughout, rounded once), in err/tol of the same bounds
    (flash's over the whole tensors and on the slices), printed beside them: rounding p and ds to bf16 before their products, as
    the TPU kernels do, puts both past those bounds (``PERF.md`` §6).
    Prints ``{"shootout": {"launches", "iterations", "held", "apart"}}``
    after the bench's lines."""
    import torch

    from kubeflow_tpu_torch.benchmarks import attention_bench as ab
    from kubeflow_tpu_torch.ops import pallas_attention as pa

    counters = _flash_counters()
    for c in counters.values():
        c.launches = 0
    ab.main([], windows=SHOOTOUT_WINDOWS)
    launches = {name: c.launches for name, c in counters.items()}
    n_short, n_long, repeats = SHOOTOUT_WINDOWS
    names = ("o", "dq", "dk", "dv")
    held, apart = {}, {}
    for seq in ab.SEQS:
        q, k, v = ab.inputs(seq, "cuda")
        block = ab.block_for(seq)
        fns = ab.impls(block)
        o, grads = ab.fwd_bwd(fns["flash"], q, k, v)
        with torch.no_grad():
            _, lse = pa.flash_attention(q, k, v, True, block, block, return_lse=True)
        b_o, b_grads = ab.fwd_bwd(fns["block"], q, k, v)
        flash, blockwise = (o, *grads), (b_o, *b_grads)
        held[seq] = {n: dict(ok=True, max_abs_err=0.0, err_over_tol=0.0) for n in (*names, "lse")}
        apart[seq] = {"flash": {n: check_out(f, w, q.dtype)[2]
                                for n, f, w in zip(names, flash, blockwise)},
                      "flash_on_slices": dict.fromkeys(names, 0.0),
                      "plain": dict.fromkeys(names, 0.0)}
        do = torch.ones_like(q)
        for b, h in SHOOTOUT_SLICES:
            def part(t):
                return t[b:b + 1, :, h:h + 1].contiguous()

            o_ref, lse_ref = pa.flash_attention_plain(part(q), part(k), part(v), causal=True)
            plain = (o_ref, *pa.flash_attention_backward_plain(
                part(q), part(k), part(v), part(o), lse[b:b + 1, h:h + 1].contiguous(),
                part(do), causal=True))
            ok, err = check_lse(lse[b:b + 1, h:h + 1], lse_ref)
            rows = [("lse", ok, err, 0.0)]
            for n, got, want, fp32 in zip(names, flash, plain, blockwise):
                ok, err, ratio, _ = check_out(part(got), want, q.dtype)
                rows.append((n, ok, err, ratio))
                for side, t in (("flash_on_slices", part(got)), ("plain", want)):
                    apart[seq][side][n] = max(apart[seq][side][n],
                                              check_out(t, part(fp32), q.dtype)[2])
            for n, ok, err, ratio in rows:
                worst = held[seq][n]
                worst.update(ok=worst["ok"] and ok, max_abs_err=max(worst["max_abs_err"], err),
                             err_over_tol=max(worst["err_over_tol"], ratio))
            del o_ref, lse_ref, plain
            torch.cuda.empty_cache()
        del q, k, v, o, grads, lse, b_o, b_grads, flash, blockwise, do
        torch.cuda.empty_cache()
    print(json.dumps({"shootout": {
        "launches": launches, "iterations": len(ab.SEQS) * (n_short + repeats * (n_short + n_long)),
        "held": held, "apart": apart}}), flush=True)


def phase_bench_entries(torch, smi: str):
    """Each bench entry point (``python3 -m kubeflow_tpu_torch.benchmarks.<name>``'s
    ``main``) once, in a subprocess of its own, with few windows: its last
    line is its reference's metric, a positive value, and this card's name
    and power limit. Then the A/B modes, ``resnet_bench --mfu`` and the
    attention shootout (module docstring, phase 25)."""
    limit = float(smi.rsplit(",", 1)[-1].split()[0])
    out = {}
    for name, windows, metric in BENCH_ENTRIES:
        lines, seconds = _bench_run(name, ["-c", f"from kubeflow_tpu_torch.benchmarks import "
                                                 f"{name}; {name}.main([], windows={windows!r})"])
        line = json.loads(lines[-1])
        log(f"[bench entries] {name} (windows {windows}, {seconds:.1f} s): {json.dumps(line)}")
        if line.get("metric") != metric or not line.get("value", 0) > 0:
            raise AssertionError(f"{name} printed an unexpected line: {line}")
        _check_card_fields(torch, name, line, limit)
        out[name] = line
    for name, flag, metric, extra, per_step in BENCH_AB:
        lines, seconds = _bench_run(f"{name} {flag}", [
            "-c", f"from kubeflow_tpu_torch.benchmarks import {name}; "
                  f"{name}.main([{flag!r}], windows={AB_WINDOWS!r})"])
        line, tallies = json.loads(lines[-1]), json.loads(lines[-2])["launches"]
        log(f"[bench entries] {name} {flag} (windows {AB_WINDOWS}, {seconds:.1f} s): "
            f"{json.dumps(line)}; launches {json.dumps(tallies)}")
        a, b = per_step
        keys = (["metric", "unit", "seq_len", "per_chip_batch"] + ([extra] if extra else [])
                + [a, f"{a}_mfu", b, f"{b}_mfu", f"{a}_over_{b}", "card", "power_limit_w"])
        if (line.get("metric") != metric or list(line) != keys
                or not all(line[k] > 0 for k in (a, f"{a}_mfu", b, f"{b}_mfu"))):
            raise AssertionError(f"{name} {flag} printed an unexpected line: {line}")
        _check_card_fields(torch, f"{name} {flag}", line, limit)
        for side, want in per_step.items():
            got = tallies[side]
            if {k: got[k] for k in want} != {k: n * got["steps"] for k, n in want.items()}:
                raise AssertionError(f"{name} {flag}: side {side} launched {got} over "
                                     f"{got['steps']} steps, expected {want} a step")
        out[f"{name} {flag}"] = dict(line, launches=tallies)
    lines, seconds = _bench_run("resnet_bench --mfu",
                                ["-m", "kubeflow_tpu_torch.benchmarks.resnet_bench", *MFU_ARGV])
    mfu = json.loads(next(x for x in lines if x.startswith("MFU_BENCH ")).split(" ", 1)[1])
    log(f"[bench entries] resnet_bench {' '.join(MFU_ARGV)} ({seconds:.1f} s): MFU_BENCH "
        f"{json.dumps(mfu)}")
    if (mfu["backend"] != "cuda" or mfu["n_devices"] != 1
            or mfu["axes"] != {"dcn": 1, "data": 1, "model": 1}
            or mfu["global_batch"] != mfu["per_host_batch"] or not mfu["imgs_per_sec_per_chip"] > 0
            or mfu["mfu"] is None or not (mfu["train_flops_per_image"] or 0) > 0):
        raise AssertionError(f"resnet_bench --mfu printed an unexpected line: {mfu}")
    _check_card_fields(torch, "resnet_bench --mfu", mfu, limit)
    out["resnet_bench --mfu"] = mfu
    lines, seconds = _bench_run("attention_bench", ["-c", "import chip_smoke; "
                                                          "chip_smoke.shootout_main()"])
    line, check = json.loads(lines[-2]), json.loads(lines[-1])["shootout"]
    log(f"[bench entries] attention_bench (windows {SHOOTOUT_WINDOWS}, {seconds:.1f} s): "
        f"{json.dumps(line)}")
    for seq, held in check["held"].items():
        log(f"[bench entries] shootout S {seq}: flash vs plain on slices {SHOOTOUT_SLICES} "
            + ", ".join(f"{k} err/tol {v['err_over_tol']:.3f} (max abs {v['max_abs_err']:.3e})"
                        for k, v in held.items())
            + "; apart from block (err/tol, not held): " + "; ".join(
                f"{side} " + ", ".join(f"{k} {r:.3f}" for k, r in ratios.items())
                for side, ratios in check["apart"][seq].items()))
    log(f"[bench entries] shootout flash launches {check['launches']} over "
        f"{check['iterations']} iterations")
    _check_card_fields(torch, "attention_bench", line, limit)
    from kubeflow_tpu_torch.benchmarks import attention_bench as ab
    ms = {(r["impl"], r["seq"]): r for r in line["results"]}
    if line["metric"] != "attention_fwd_bwd_ms" or set(ms) != {
            (i, s) for s in ab.SEQS for i in ("naive", "block", "flash", "library")}:
        raise AssertionError(f"attention_bench printed an unexpected line: {line}")
    for (impl, seq), r in ms.items():
        # the fewest windows: one iteration's difference, a number but not a rate to keep
        oom = impl == "naive" and seq > 8192 and r.get("note") == "OutOfMemoryError"
        if r["ms"] is None and not oom:
            raise AssertionError(f"attention_bench: {impl} at S {seq} gave no time: {r}")
    if check["launches"] != {k: check["iterations"] for k in check["launches"]}:
        raise AssertionError(f"flash launched {check['launches']} in the shootout's "
                             f"{check['iterations']} iterations")
    bad = [(seq, k) for seq, held in check["held"].items() for k, v in held.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"the shootout's flash is off its plain version at {bad}: "
                             f"{check['held']}")
    out["attention_bench"] = dict(line, check=check)
    return out


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

    smi = card()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from kubeflow_tpu_torch.telemetry.agent import TorchCompileMonitor

    report = {"card": smi}
    t_all = time.perf_counter()
    monitor = TorchCompileMonitor()      # counts the build phase's nvcc runs
    libs, report["ptxas"] = phase_build()
    compile_at_build = monitor.totals()
    report["tensor_core_instructions"] = tensor_core_counts(libs)
    kernels = phase_kernels(torch)
    bwd, fwd_train = phase_kernels_bwd(torch)
    kernels.update(bwd)
    report["wide_heads"] = phase_wide_heads(torch, np)
    report["heads_512"] = phase_heads_512(torch, np)
    gen = phase_generate(torch, np)
    report["parity"] = phase_parity(torch, np)
    report["generate_fp32"] = phase_generate_fp32(torch, np)
    report["generate_small_heads"] = phase_generate_small_heads(torch, np)
    train = phase_train(torch, np)
    report["wide_flagships"] = phase_wide_flagships(torch, np, gen, train)
    report["heads_512_flagships"] = phase_heads_512_flagships(torch, np, gen, train,
                                                              report["wide_flagships"])
    report["train_parity"] = phase_train_parity(torch, np)
    moe_kernels, report["moe_kernel_launches"] = phase_moe_kernels(torch)
    kernels.update(moe_kernels)
    moe_train = phase_moe_train(torch, np)
    report["moe_train_parity"] = phase_moe_train_parity(torch, np)
    head_kernels, report["head_whole"], report["head_detail"] = phase_head_kernels(torch, np)
    kernels.update(head_kernels)
    moe_fused = phase_moe_train(torch, np, fused=True)
    report["moe_train_fused_parity"] = phase_moe_train_parity(torch, np, fused=True)
    bn_kernels, report["bn_kernel_shapes"], scaled_launches = phase_bn_kernels(torch, np)
    kernels.update(bn_kernels)
    bwd_kernels, bwd_launches = phase_bwd_probe(torch, np)
    kernels.update(bwd_kernels)
    resnet, report["resnet_train_others"] = phase_resnet_train(torch, np)
    report["resnet_train_parity"] = phase_resnet_train_parity(torch, np)
    torch.cuda.empty_cache()
    report["sharded"] = phase_sharded(torch, np)
    torch.cuda.empty_cache()
    report["ring"] = phase_ring(torch)
    report["expert_walk"] = phase_expert_walk(torch)
    report["seq_moe_walk"] = phase_seq_moe_walk(torch)
    report["tensor_walk"] = phase_tensor_walk(torch)
    torch.cuda.empty_cache()
    report["two_ranks"] = phase_two_ranks(torch, np)
    torch.cuda.empty_cache()
    report["pipeline"] = phase_pipeline(torch, np)
    torch.cuda.empty_cache()
    report["dryrun"] = phase_dryrun(torch)
    torch.cuda.empty_cache()
    report["session"] = phase_session(torch, np, train, monitor, compile_at_build)
    torch.cuda.empty_cache()
    report["bench_entries"] = phase_bench_entries(torch, smi)
    probes = {"launches": {"bn_moments_scaled": scaled_launches,
                           "fused_bn_relu_conv1x1_bwd": bwd_launches}}
    report.update(resnet_train=resnet)
    report.update(kernels=kernels, fwd_at_train_shape=fwd_train, generate=gen, train=train,
                  moe_train=moe_train, moe_train_fused=moe_fused,
                  seconds=time.perf_counter() - t_all)

    # each kernel's launches come from the main path that drives it: the
    # forward and flash-decode from one generate request, the backward
    # kernels from the timed train steps, the MoE gather and scatter from
    # the timed MoE train steps, the fused head's three kernels from the timed
    # MoE train steps through the fused head, the BatchNorm kernels from the
    # timed ResNet-50 steps, the two probe kernels from their probes' main()
    replaces = {
        "flash_attention_fwd": ("kubeflow_tpu/ops/pallas_attention.py:160", gen),
        "flash_decode": ("kubeflow_tpu/ops/flash_decode.py:53", gen),
        "flash_attention_bwd_dq": ("kubeflow_tpu/ops/pallas_attention.py:290", train),
        "flash_attention_bwd_dkv": ("kubeflow_tpu/ops/pallas_attention.py:336", train),
        "moe_gather": ("kubeflow_tpu/ops/moe_dispatch.py:57", moe_train),
        "moe_scatter": ("kubeflow_tpu/ops/moe_dispatch.py:93", moe_train),
        "fused_head_fwd": ("kubeflow_tpu/ops/fused_head_loss.py:76", moe_fused),
        "fused_head_bwd_dh": ("kubeflow_tpu/ops/fused_head_loss.py:157", moe_fused),
        "fused_head_bwd_de": ("kubeflow_tpu/ops/fused_head_loss.py:183", moe_fused),
        "bn_moments": ("kubeflow_tpu/ops/bn_pallas.py:96", resnet),
        "bn_grad_sums": ("kubeflow_tpu/ops/bn_pallas.py:140", resnet),
        "fused_bn_relu_conv1x1_bwd": ("benchmarks/pallas_bwd_probe.py:25", probes),
        "bn_moments_scaled": ("benchmarks/bn_stats_probe.py:43", probes),
    }
    sources = {"bn_moments_scaled": "bn_moments"}    # one source, two TPU kernels
    line = {"kernels": [
        dict(name=name, route="cuda",
             source=f"kubeflow_tpu_torch/csrc/{sources.get(name, name)}.cu",
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
