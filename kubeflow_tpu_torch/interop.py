"""Weights for the port: carried over from the JAX package, or made from a seed.

``params_from_flax`` maps the flax param tree of
``kubeflow_tpu.models.transformer.TransformerLM`` (as numpy arrays; no JAX
import here) onto this package's ``TransformerLM`` state dict, and
``moe_params_from_flax`` that of ``kubeflow_tpu.models.moe.MoETransformerLM``
onto ``MoETransformerLM``'s. ``init_state_dict`` and ``moe_init_state_dict``
draw fresh weights at the scale of flax's default initializers, so a seeded
smoke run sees the activations a real init gives (random weights of the wrong
scale saturate the softmax and hide bugs).

All four return fp32 tensors. A training ``TransformerLM`` keeps them in fp32
(flax's ``param_dtype``) and casts to ``cfg.dtype`` on every call; a decode
model's ``load_state_dict`` casts the projection and embedding weights to
``cfg.dtype`` once, at load.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from kubeflow_tpu_torch.models.moe import MoEConfig
from kubeflow_tpu_torch.models.transformer import TransformerConfig, resolve_device

# flax's lecun_normal is a variance-scaling truncated normal cut at two
# standard deviations; this is the std of the unit normal so truncated
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _attention_from_flax(attn, pre: str) -> dict[str, torch.Tensor]:
    """q/k/v kernels ``[E, heads, D]`` -> ``[heads*D, E]``; o ``[H*D, E]`` -> ``[E, H*D]``."""
    sd = {}
    for proj in ("q_proj", "k_proj", "v_proj"):
        kern = _t(attn[proj]["kernel"])                     # [E, heads, D]
        sd[pre + f"{proj}.weight"] = kern.reshape(kern.shape[0], -1).T.contiguous()
    sd[pre + "o_proj.weight"] = _t(attn["o_proj"]["kernel"]).T.contiguous()
    return sd


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """flax ``{"embed": ..., "layer_i": ..., "final_norm": ...}`` -> state dict.

    - ``q_proj``/``k_proj``/``v_proj`` kernels ``[E, heads, D]`` become
      ``[heads*D, E]``; the ``o_proj`` kernel ``[H*D, E]`` becomes ``[E, H*D]``;
    - ``gate_proj``/``up_proj``/``down_proj`` kernels go from ``[in, out]``
      to ``[out, in]``;
    - ``embed/embedding`` ``[V, E]`` is the tied table as it is;
    - each ``*_norm/scale`` is its norm's weight.
    """
    sd = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "final_norm.weight": _t(params["final_norm"]["scale"]),
    }
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        layer = params[f"layer_{i}"]
        pre = f"layers.{i}."
        for norm in ("attn_norm", "mlp_norm"):
            sd[pre + f"{norm}.weight"] = _t(layer[norm]["scale"])
        sd.update(_attention_from_flax(layer["attn"], pre + "attn."))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[pre + f"mlp.{proj}.weight"] = _t(layer["mlp"][proj]["kernel"]).T.contiguous()
    return sd


def init_state_dict(cfg: TransformerConfig, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Fresh fp32 weights from ``seed`` at flax's default scale.

    Dense kernels: lecun-normal (truncated normal, std sqrt(1/fan_in)), the
    fan-in being the layer's input width. Embedding: variance_scaling(1.0,
    'fan_in', 'normal', out_axis=0) on ``[V, E]``, i.e. std sqrt(1/E). Norm
    scales: ones. Drawn on ``device`` (CUDA unless the caller says), so the
    full-size model is made on the card in a moment.
    """
    init = _Init(seed, device)
    E, M, D = cfg.embed_dim, cfg.mlp_dim, cfg.head_dim
    sd = init.embedding_and_final_norm(cfg.vocab_size, E)
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        sd[pre + "attn_norm.weight"] = init.ones(E)
        sd[pre + "mlp_norm.weight"] = init.ones(E)
        sd.update(init.attention(pre + "attn.", E, cfg.num_heads, cfg.kv_heads, D))
        sd[pre + "mlp.gate_proj.weight"] = init.dense((M, E), fan_in=E)
        sd[pre + "mlp.up_proj.weight"] = init.dense((M, E), fan_in=E)
        sd[pre + "mlp.down_proj.weight"] = init.dense((E, M), fan_in=M)
    return sd


class _Init:
    """Seeded draws at flax's default scales, on one generator."""

    def __init__(self, seed: int, device):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def dense(self, shape, fan_in: int):
        """variance_scaling(1.0, 'fan_in', 'truncated_normal'): std
        sqrt(1/fan_in), cut at two of the unit normal's standard deviations."""
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=self.gen)

    def ones(self, n: int):
        return torch.ones(n, dtype=torch.float32, device=self.device)

    def embedding_and_final_norm(self, vocab: int, E: int):
        return {
            "embed.weight": torch.randn(
                (vocab, E), generator=self.gen, dtype=torch.float32, device=self.device
            ) * math.sqrt(1.0 / E),
            "final_norm.weight": self.ones(E),
        }

    def attention(self, pre: str, E: int, H: int, KV: int, D: int):
        return {
            pre + "q_proj.weight": self.dense((H * D, E), fan_in=E),
            pre + "k_proj.weight": self.dense((KV * D, E), fan_in=E),
            pre + "v_proj.weight": self.dense((KV * D, E), fan_in=E),
            pre + "o_proj.weight": self.dense((E, H * D), fan_in=H * D),
        }


def moe_params_from_flax(params) -> dict[str, torch.Tensor]:
    """flax MoE ``{"embed", "layer_i", "final_norm"}`` -> state dict.

    Attention and norms as ``params_from_flax`` (``attn_norm``, ``moe_norm``);
    ``moe/router`` ``[M, E]`` and the expert tables ``experts_wi`` ``[E, M, H]``
    and ``experts_wo`` ``[E, H, M]`` keep flax's layouts.
    """
    sd = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "final_norm.weight": _t(params["final_norm"]["scale"]),
    }
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        layer = params[f"layer_{i}"]
        pre = f"layers.{i}."
        for norm in ("attn_norm", "moe_norm"):
            sd[pre + f"{norm}.weight"] = _t(layer[norm]["scale"])
        sd.update(_attention_from_flax(layer["attn"], pre + "attn."))
        for name in ("router", "experts_wi", "experts_wo"):
            sd[pre + f"moe.{name}"] = _t(layer["moe"][name])
    return sd


def moe_init_state_dict(cfg: MoEConfig, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """Fresh fp32 MoE weights from ``seed`` at flax's default scale.

    Attention, embedding and norms as ``init_state_dict``. The router is
    lecun-normal on ``[M, E]`` (fan-in M). The expert tables are
    variance_scaling(1.0, 'fan_in', 'truncated_normal') on ``[E, M, H]`` and
    ``[E, H, M]``, and flax counts the leading expert dim into the fan-in:
    std sqrt(1/(E*M)) and sqrt(1/(E*H)), not sqrt(1/M).
    """
    init = _Init(seed, device)
    M, E, H = cfg.embed_dim, cfg.num_experts, cfg.expert_hidden_dim
    att = cfg.attention_cfg()
    sd = init.embedding_and_final_norm(cfg.vocab_size, M)
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        sd[pre + "attn_norm.weight"] = init.ones(M)
        sd[pre + "moe_norm.weight"] = init.ones(M)
        sd.update(init.attention(pre + "attn.", M, att.num_heads, att.kv_heads, att.head_dim))
        sd[pre + "moe.router"] = init.dense((M, E), fan_in=M)
        sd[pre + "moe.experts_wi"] = init.dense((E, M, H), fan_in=E * M)
        sd[pre + "moe.experts_wo"] = init.dense((E, H, M), fan_in=E * H)
    return sd
