"""The flagship cells of the port, built once for the bench entry points and
``chip_smoke.py``.

Each cell is a configuration the reference's benchmarks name, at the same
widths, with seeded random weights at flax's init scale and seeded inputs:

- dense train: ``benchmarks/transformer_bench.py:85-118`` (24 layers, 8
  heads of 128, E 1024, MLP 4096, flash attention with block 1024, AdamW
  with bf16 moments, the chunked tied head with chunk 1024), batch [4, 2048];
- MoE train: ``benchmarks/moe_bench.py:74-94`` (8 layers, 8 experts top-2,
  expert hidden 2048, gather dispatch), batch [4, 2048];
- decode: ``benchmarks/decode_bench.py:39-47`` (the dense width with GQA
  8/4), batch 4, prompt 128;
- ResNet-50 train: ``bench.py:81-103`` (1000 classes, bf16, 224x224
  standard-normal images, nesterov SGD 0.1/0.9) with ``bn_impl="pallas"``,
  the configuration that runs the two BatchNorm kernels, at batch 256 where
  ``bench.py`` runs 16 a chip (256 fills an 80 GB card).

Each cell function takes ``device`` (the card unless the caller says), ``mesh``
(the train steps' mesh, None for one device; also the configuration's
``mesh``, which ring attention and the ``a2a`` dispatch run over) and
keyword overrides of the configuration, which is how the CPU tests run a
cell at a small size.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import kubeflow_tpu_torch as kt
from kubeflow_tpu_torch.ops import fused_head_loss as fh
from kubeflow_tpu_torch.ops import moe_dispatch as md
from kubeflow_tpu_torch.ops import pallas_attention as pa

BATCH, PROMPT, NEW = 4, 128, 128          # decode: batch, prompt, new tokens
TEMPERATURE, TOP_K = 0.8, 40

FLAGSHIP = dict(      # the decode flagship (benchmarks/decode_bench.py:39-47)
    vocab_size=32_000, num_layers=24, num_heads=8, num_kv_heads=4,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, attention_impl="flash",
)
TRAIN = dict(         # the dense training flagship (benchmarks/transformer_bench.py:85-118)
    vocab_size=32_000, num_layers=24, num_heads=8, embed_dim=1024, mlp_dim=4096,
    max_seq_len=2048, attention_impl="flash", attention_block_size=1024,
)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK = 4, 2048, 1024
MOE = dict(           # the MoE training flagship (benchmarks/moe_bench.py:74-94)
    vocab_size=32_000, num_layers=8, num_heads=8, embed_dim=1024, expert_hidden_dim=2048,
    num_experts=8, experts_per_token=2, capacity_factor=1.25, max_seq_len=2048,
    dispatch="gather", attention_impl="flash", attention_block_size=1024,
)
MOE_BATCH, MOE_SEQ, MOE_CHUNK = 4, 2048, 1024
RESNET = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, width=64)
RESNET_IMAGE, RESNET_BATCH = 224, 256


def launch_counters() -> dict:
    """Readers of the counters an LM step moves, by kernel name: the flash
    kernels, the fused head's three, the MoE row gather and scatter, and the
    MoE library route's gathers and scatters (``moe_dispatch.library_route``),
    which launch no kernel. The A/B modes tally them a side."""
    return {
        "flash_attention_fwd": lambda: pa.flash_attention.launches,
        "flash_attention_bwd_dq": lambda: pa.flash_attention_bwd_dq.launches,
        "flash_attention_bwd_dkv": lambda: pa.flash_attention_bwd_dkv.launches,
        "fused_head_fwd": lambda: fh.fused_head_fwd.launches,
        "fused_head_bwd_dh": lambda: fh.fused_head_bwd_dh.launches,
        "fused_head_bwd_de": lambda: fh.fused_head_bwd_de.launches,
        "moe_gather": lambda: md.gather.launches,
        "moe_scatter": lambda: md.scatter.launches,
        "library_gather": lambda: md.gather_rows.library_gathers,
        "library_scatter": lambda: md.gather_rows.library_scatters,
    }


def adamw():
    """The LM benches' optimizer: AdamW with bf16 moments, b2 0.99, decay 0.1."""
    return kt.adamw_lowmem(3e-4, b2=0.99, weight_decay=0.1)


@dataclasses.dataclass
class LMCell:
    """A training LM, its step and batch, and its FLOPs a token (6 P_active
    + 12 L E S / 2, ``transformer_bench.py:208-212``, ``moe_bench.py:250-253``)."""

    cfg: object
    model: torch.nn.Module
    bundle: object
    tokens: torch.Tensor
    n_params: int
    n_active: float
    flops_per_token: float


def _tokens(vocab: int, batch: int, seq: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(0).integers(0, vocab, (batch, seq))).to(device)


def dense_train(*, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, head: str = "chunked",
                device="cuda", mesh=None, **overrides) -> LMCell:
    """The dense flagship's train step: ``head`` "chunked" (``lm_loss_chunked``,
    chunk 1024) or "fused" (``fused_head_nll``); ``overrides`` replace
    fields of the configuration (``remat``, ``remat_policy``, widths)."""
    cfg = kt.TransformerConfig(**dict(TRAIN, max_seq_len=seq, dtype=torch.bfloat16, mesh=mesh,
                                      **overrides))
    model = kt.TransformerLM(cfg, device=device)
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device=device))
    if head not in ("chunked", "fused"):
        raise ValueError(f"head must be 'chunked' or 'fused', got {head!r}")
    loss_fn = None
    if head == "fused":
        def loss_fn(model, tokens):
            return kt.fused_head_nll(model(tokens, return_hidden=True), model.embed.weight, tokens)
    bundle = kt.make_lm_train_step(model, adamw(), mesh, loss_fn=loss_fn,
                                   chunk=min(TRAIN_CHUNK, seq))
    n = sum(p.numel() for p in model.parameters())
    flops = 6 * n + 12 * cfg.num_layers * cfg.embed_dim * seq * 0.5
    return LMCell(cfg, model, bundle, _tokens(cfg.vocab_size, batch, seq, device), n, n, flops)


def moe_loss_fn(head: str, chunk: int = MOE_CHUNK):
    """The MoE flagship's loss: the chunked tied head (``moe_bench.py``'s
    default) or the fused one (``--fused-head``, ``moe_bench.py:116-120``)."""
    if head == "fused":
        return kt.moe_lm_loss_fused
    if head == "chunked":
        return functools.partial(kt.moe_lm_loss_chunked, chunk=chunk)
    raise ValueError(f"head must be 'chunked' or 'fused', got {head!r}")


def moe_train(*, head: str = "chunked", batch: int = MOE_BATCH, seq: int = MOE_SEQ,
              device="cuda", mesh=None, **overrides) -> LMCell:
    """The MoE flagship's train step (``overrides``: ``dispatch``,
    ``remat``, widths); n_active counts k of E experts' tables
    (``moe_bench.py:106-114``)."""
    cfg = kt.MoEConfig(**dict(MOE, max_seq_len=seq, dtype=torch.bfloat16, mesh=mesh, **overrides))
    model = kt.MoETransformerLM(cfg, device=device)
    model.load_state_dict(kt.moe_init_state_dict(cfg, seed=0, device=device))
    bundle = kt.make_lm_train_step(model, adamw(), mesh,
                                   loss_fn=moe_loss_fn(head, min(MOE_CHUNK, seq)))
    n = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for name, p in model.named_parameters() if "experts_w" in name)
    n_active = n - n_expert * (1 - cfg.experts_per_token / cfg.num_experts)
    flops = 6 * n_active + 12 * cfg.num_layers * cfg.embed_dim * seq * 0.5
    return LMCell(cfg, model, bundle, _tokens(cfg.vocab_size, batch, seq, device), n, n_active,
                  flops)


def decode_model(*, device="cuda", batch: int = BATCH, prompt: int = PROMPT, **overrides):
    """(config, decode-mode model in bf16, prompt [batch, prompt]) of the
    decode flagship."""
    cfg = kt.TransformerConfig(**dict(FLAGSHIP, dtype=torch.bfloat16, **overrides))
    model = kt.TransformerLM(kt.decode_config(cfg), device=device)
    model.load_state_dict(kt.init_state_dict(cfg, seed=0, device=device))
    return cfg, model, _tokens(cfg.vocab_size, batch, prompt, device)


@dataclasses.dataclass
class ResNetCell:
    model: torch.nn.Module
    tx: object
    bundle: object
    batch: dict
    n_params: int


def _images(batch: int, image: int, classes: int, device, dtype) -> dict:
    """bench.py's batch: standard-normal images, uniform labels."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return {
        "image": torch.randn((batch, image, image, 3), generator=gen, device=device).to(dtype),
        "label": torch.randint(0, classes, (batch,), generator=gen, device=device),
    }


def resnet_train(*, bn_impl: str = "pallas", batch: int = RESNET_BATCH, image: int = RESNET_IMAGE,
                 device="cuda", mesh=None, dtype=torch.bfloat16, **overrides) -> ResNetCell:
    """ResNet-50's train step (``overrides``: ``stage_sizes``, ``width``,
    ``num_classes``)."""
    arch = dict(RESNET, **overrides)
    model = kt.ResNet(**arch, dtype=dtype, bn_impl=bn_impl, device=device)
    model.load_state_dict(kt.resnet_init_state_dict(**arch, seed=0, device=device))
    tx = kt.sgd(0.1, momentum=0.9, nesterov=True)
    bundle = kt.make_classifier_train_step(model, tx, mesh)
    return ResNetCell(model, tx, bundle,
                      _images(batch, image, arch["num_classes"], device, dtype),
                      sum(p.numel() for p in model.parameters()))
