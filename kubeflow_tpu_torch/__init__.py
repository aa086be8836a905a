"""PyTorch/CUDA port of the platform's compute plane, for NVIDIA Hopper.

A second package beside ``kubeflow_tpu`` (the JAX reference, unchanged). Its
modules sit at the same relative paths as their JAX counterparts. This slice
ports the serving path: ``models/transformer.py`` and ``models/decoding.py``
(prefill, then single-token decode with a KV cache), with hand-written CUDA
kernels for flash-attention forward (prefill) and flash-decode (every decode
step) in ``csrc/``. Entry points run on the card unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs its plain PyTorch
version.
"""
from kubeflow_tpu_torch.interop import init_state_dict, params_from_flax
from kubeflow_tpu_torch.models.decoding import (
    decode_config,
    decode_steps,
    generate,
    prefill,
)
from kubeflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "decode_config",
    "decode_steps",
    "generate",
    "init_state_dict",
    "params_from_flax",
    "prefill",
]
