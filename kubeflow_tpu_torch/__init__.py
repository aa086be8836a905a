"""PyTorch/CUDA port of the platform's compute plane, for NVIDIA Hopper.

A second package beside ``kubeflow_tpu`` (the JAX reference, unchanged). Its
modules sit at the same relative paths as their JAX counterparts. Ported so
far: the serving path (``models/decoding.py``: prefill, then single-token
decode with a KV cache), LM training (``parallel/train.py``'s
``make_lm_train_step`` with the chunked tied-head loss and
``ops/optimizers.py``'s low-memory AdamW) and MoE LM training
(``models/moe.py`` with gather dispatch, through the same train step, with
the chunked or the fused tied head, ``ops/fused_head_loss.py``), with
hand-written CUDA kernels in ``csrc/`` for the flash-attention forward, its
dq and dk/dv backward, flash-decode, the MoE row gather and its scatter
backward, and the fused head's forward, dh and dE; and ResNet-50 training
(``models/resnet.py`` through ``make_classifier_train_step``) with kernels
for the BatchNorm moments and gradient sums (``ops/bn_pallas.py``). The two
kernel probes and the bench entry points are under ``benchmarks/``; meshes,
sharding rules, the distributed bootstrap, ring attention and the GPipe
pipeline over the stage axis under ``parallel/``, where the train steps also
run sharded over the dcn, data, fsdp, seq (ring attention), expert (the MoE
a2a or einsum dispatch), tensor and stage axes. The notebook runtime is
under ``utils/`` (host-to-device prefetch, checkpoint and resume on
``torch.distributed.checkpoint``, profiling on ``torch.profiler``), the
telemetry agent's device, compile and trace backends under ``telemetry/``,
and a gang's mesh build from its placement under ``spmd/``.
Entry points
run on the card unless the caller passes ``device="cpu"``; on CPU tensors
each kernel wrapper runs its plain PyTorch version.
"""
from kubeflow_tpu_torch.interop import (
    init_state_dict,
    moe_init_state_dict,
    moe_params_from_flax,
    params_from_flax,
    pipeline_params_from_flax,
    pipeline_to_lm_state_dict,
    resnet_init_state_dict,
    resnet_params_from_flax,
)
from kubeflow_tpu_torch.models.decoding import (
    decode_config,
    decode_steps,
    generate,
    prefill,
)
from kubeflow_tpu_torch.models.moe import (
    MoEConfig,
    MoETransformerLM,
    moe_lm_loss,
    moe_lm_loss_chunked,
    moe_lm_loss_fused,
)
from kubeflow_tpu_torch.models.resnet import (
    PallasBatchNorm,
    ResNet,
    ResNet18,
    ResNet50,
    ResNet101,
    ResNet152,
    SpaceToDepthStem,
    flops_per_image,
)
from kubeflow_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    lm_loss,
    lm_loss_chunked,
    resolve_remat_policy,
)
from kubeflow_tpu_torch.ops.bn_pallas import batch_norm_train, bn_grad_sums, channel_moments
from kubeflow_tpu_torch.ops.fused_head_loss import fused_head_nll, fused_lse_gold
from kubeflow_tpu_torch.ops.optimizers import adamw_lowmem, sgd, with_f32_master
from kubeflow_tpu_torch.parallel.pipeline import (
    PipelineLM,
    PipelineStage,
    init_pipeline_lm,
    make_pipeline_train_step,
    pipeline_forward,
    pipeline_value_and_grad,
)
from kubeflow_tpu_torch.parallel.train import (
    TrainState,
    TrainStepBundle,
    cross_entropy_loss,
    make_classifier_train_step,
    make_lm_train_step,
)
from kubeflow_tpu_torch.telemetry.agent import (
    TorchCompileMonitor,
    TorchDeviceBackend,
    TorchTraceProfiler,
)
from kubeflow_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    resume_or_init,
    snapshot_for_precopy,
    snapshot_for_suspend,
)
from kubeflow_tpu_torch.utils.data import DevicePrefetcher, map_batches, synthetic_token_batches
from kubeflow_tpu_torch.utils.profiling import step_annotation, trace_n_steps

__all__ = [
    "CheckpointManager",
    "DevicePrefetcher",
    "MoEConfig",
    "MoETransformerLM",
    "PallasBatchNorm",
    "PipelineLM",
    "PipelineStage",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "SpaceToDepthStem",
    "TorchCompileMonitor",
    "TorchDeviceBackend",
    "TorchTraceProfiler",
    "TrainState",
    "TrainStepBundle",
    "TransformerConfig",
    "TransformerLM",
    "adamw_lowmem",
    "batch_norm_train",
    "bn_grad_sums",
    "channel_moments",
    "cross_entropy_loss",
    "decode_config",
    "decode_steps",
    "flops_per_image",
    "fused_head_nll",
    "fused_lse_gold",
    "generate",
    "init_pipeline_lm",
    "init_state_dict",
    "lm_loss",
    "lm_loss_chunked",
    "make_classifier_train_step",
    "make_lm_train_step",
    "make_pipeline_train_step",
    "map_batches",
    "moe_init_state_dict",
    "moe_lm_loss",
    "moe_lm_loss_chunked",
    "moe_lm_loss_fused",
    "moe_params_from_flax",
    "params_from_flax",
    "pipeline_forward",
    "pipeline_params_from_flax",
    "pipeline_to_lm_state_dict",
    "pipeline_value_and_grad",
    "prefill",
    "resnet_init_state_dict",
    "resnet_params_from_flax",
    "resolve_remat_policy",
    "resume_or_init",
    "sgd",
    "snapshot_for_precopy",
    "snapshot_for_suspend",
    "step_annotation",
    "synthetic_token_batches",
    "trace_n_steps",
    "with_f32_master",
]
