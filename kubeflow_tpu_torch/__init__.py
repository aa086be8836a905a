"""PyTorch/CUDA port of the platform's compute plane, for NVIDIA Hopper.

A second package beside ``kubeflow_tpu`` (the JAX reference, unchanged). Its
modules sit at the same relative paths as their JAX counterparts. Ported so
far: the serving path (``models/decoding.py``: prefill, then single-token
decode with a KV cache) and LM training (``parallel/train.py``'s
``make_lm_train_step`` with the chunked tied-head loss and
``ops/optimizers.py``'s low-memory AdamW), with hand-written CUDA kernels in
``csrc/`` for the flash-attention forward, its dq and dk/dv backward, and
flash-decode. Entry points run on the card unless the caller passes
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
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    lm_loss,
    lm_loss_chunked,
    resolve_remat_policy,
)
from kubeflow_tpu_torch.ops.optimizers import adamw_lowmem, with_f32_master
from kubeflow_tpu_torch.parallel.train import TrainStepBundle, make_lm_train_step

__all__ = [
    "TrainStepBundle",
    "TransformerConfig",
    "TransformerLM",
    "adamw_lowmem",
    "decode_config",
    "decode_steps",
    "generate",
    "init_state_dict",
    "lm_loss",
    "lm_loss_chunked",
    "make_lm_train_step",
    "params_from_flax",
    "prefill",
    "resolve_remat_policy",
    "with_f32_master",
]
