"""Weights for the port: carried over from the JAX package, or made from a seed.

``params_from_flax`` maps the flax param tree of
``kubeflow_tpu.models.transformer.TransformerLM`` (as numpy arrays; no JAX
import here) onto this package's ``TransformerLM`` state dict.
``init_state_dict`` draws fresh weights at the scale of flax's default
initializers, so a seeded smoke run sees the activations a real init gives
(random weights of the wrong scale saturate the softmax and hide bugs).

Both return fp32 tensors. A training ``TransformerLM`` keeps them in fp32
(flax's ``param_dtype``) and casts to ``cfg.dtype`` on every call; a decode
model's ``load_state_dict`` casts the projection and embedding weights to
``cfg.dtype`` once, at load.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import TransformerConfig, resolve_device

# flax's lecun_normal is a variance-scaling truncated normal cut at two
# standard deviations; this is the std of the unit normal so truncated
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


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
        for proj in ("q_proj", "k_proj", "v_proj"):
            kern = _t(layer["attn"][proj]["kernel"])          # [E, heads, D]
            sd[pre + f"attn.{proj}.weight"] = kern.reshape(kern.shape[0], -1).T.contiguous()
        sd[pre + "attn.o_proj.weight"] = _t(layer["attn"]["o_proj"]["kernel"]).T.contiguous()
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
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, M, D = cfg.embed_dim, cfg.mlp_dim, cfg.head_dim
    H, KV = cfg.num_heads, cfg.kv_heads

    def dense(n_out, n_in):
        std = math.sqrt(1.0 / n_in) / _TRUNC_STD
        w = torch.empty((n_out, n_in), dtype=torch.float32, device=device)
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)

    def ones():
        return torch.ones(E, dtype=torch.float32, device=device)

    sd = {
        "embed.weight": torch.randn(
            (cfg.vocab_size, E), generator=gen, dtype=torch.float32, device=device
        ) * math.sqrt(1.0 / E),
        "final_norm.weight": ones(),
    }
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        sd[pre + "attn_norm.weight"] = ones()
        sd[pre + "mlp_norm.weight"] = ones()
        sd[pre + "attn.q_proj.weight"] = dense(H * D, E)
        sd[pre + "attn.k_proj.weight"] = dense(KV * D, E)
        sd[pre + "attn.v_proj.weight"] = dense(KV * D, E)
        sd[pre + "attn.o_proj.weight"] = dense(E, H * D)
        sd[pre + "mlp.gate_proj.weight"] = dense(M, E)
        sd[pre + "mlp.up_proj.weight"] = dense(M, E)
        sd[pre + "mlp.down_proj.weight"] = dense(E, M)
    return sd
