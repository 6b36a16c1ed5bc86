"""Training: the stage-1/2 train step, its state and checkpoint IO.

``stage_config(stage, base)`` builds the configuration a training stage runs
with, as the JAX package's training driver does: gradient checkpointing in
both UNets, feed-forward token chunks of 1024 (the JAX driver's default
whenever checkpointing is on, as both stage recipes set it), a camera
position table of 16 frames (stage 1) or 24 (stage 2), and, in
stage 1, a video UNet with the ReferenceNet's topology (no motion modules).
"""

from __future__ import annotations

import dataclasses

from ..models.configs import CamAnimateConfig
from .checkpoint import (
    filter_motion_modules,
    load_train_checkpoint,
    merge_motion_modules,
    save_train_checkpoint,
)
from .state import (
    TRAIN_COMPONENTS,
    OptimizerConfig,
    TrainState,
    stage1_trainable,
    stage2_trainable,
)
from .step import Draws, TrainConfig, loss_from_draws, sample_draws, train_step


def stage_config(stage: int, base: CamAnimateConfig = CamAnimateConfig()) -> CamAnimateConfig:
    if stage not in (1, 2):
        raise ValueError(f"stage {stage}")
    levers = dict(gradient_checkpointing=True, ff_chunk_tokens=1024)
    return dataclasses.replace(
        base,
        denoising_unet=dataclasses.replace(
            base.denoising_unet if stage == 2 else base.reference_unet, **levers),
        reference_unet=dataclasses.replace(base.reference_unet, **levers),
        camera_encoder=dataclasses.replace(
            base.camera_encoder, position_encoding_max_len=16 if stage == 1 else 24,
            ff_chunk_tokens=1024),
    )


__all__ = [
    "Draws", "OptimizerConfig", "TRAIN_COMPONENTS", "TrainConfig", "TrainState",
    "filter_motion_modules", "load_train_checkpoint", "loss_from_draws",
    "merge_motion_modules", "sample_draws", "save_train_checkpoint", "stage1_trainable",
    "stage2_trainable", "stage_config", "train_step",
]
