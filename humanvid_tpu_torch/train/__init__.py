"""Training: the stage-1/2 train step, its state and checkpoint IO.

``stage_config(stage, base, gradient_checkpointing=..., ff_chunk_tokens=...)``
builds the configuration a training stage runs with, as the JAX package's
training driver does from a train config's ``solver`` keys
(``system_config(cfg, stage)`` reads them, and ``optimizer_config(cfg)`` the
optimizer's)
(``enable_gradient_checkpointing``, ``ff_chunk_tokens``): gradient
checkpointing in both UNets as asked, feed-forward token chunks (by default
1024 with checkpointing and none without: a training-memory lever only), a
camera position table of 16 frames (stage 1) or 24 (stage 2) unless
``camera_frames`` says otherwise, and, in stage 1, a video UNet with the
ReferenceNet's topology (no motion modules). The shipped stage-2 recipe
turns checkpointing on; the stage-1 recipe does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.configs import CamAnimateConfig, tiny_config
from ..utils.config import ConfigDict
from .checkpoint import (
    export_reference_pth,
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


def stage_config(stage: int, base: CamAnimateConfig = CamAnimateConfig(), *,
                 gradient_checkpointing: bool, ff_chunk_tokens: Optional[int] = None,
                 camera_frames: Optional[int] = None) -> CamAnimateConfig:
    if stage not in (1, 2):
        raise ValueError(f"stage {stage}")
    if ff_chunk_tokens is None:
        ff_chunk_tokens = 1024 if gradient_checkpointing else 0
    if camera_frames is None:
        camera_frames = 16 if stage == 1 else 24
    levers = dict(gradient_checkpointing=gradient_checkpointing, ff_chunk_tokens=ff_chunk_tokens)
    return dataclasses.replace(
        base,
        denoising_unet=dataclasses.replace(
            base.denoising_unet if stage == 2 else base.reference_unet, **levers),
        reference_unet=dataclasses.replace(base.reference_unet, **levers),
        camera_encoder=dataclasses.replace(
            base.camera_encoder, position_encoding_max_len=camera_frames,
            ff_chunk_tokens=ff_chunk_tokens),
    )


def system_config(cfg: ConfigDict, stage: int) -> CamAnimateConfig:
    """The system a stage trains, from the config's ``model`` and solver
    levers, as the JAX driver builds it."""
    grad_ckpt = bool(cfg.solver.get("enable_gradient_checkpointing", False))
    tiny = cfg.get("model") == "tiny"
    base = tiny_config(motion_max_len=cfg.get("n_sample_frames", 8)) if tiny else CamAnimateConfig()
    return stage_config(
        stage, base, gradient_checkpointing=grad_ckpt,
        ff_chunk_tokens=int(cfg.solver.get("ff_chunk_tokens", 1024 if grad_ckpt else 0)),
        camera_frames=base.camera_encoder.position_encoding_max_len if tiny else None)


def optimizer_config(cfg: ConfigDict) -> OptimizerConfig:
    """The optimizer of a train config's ``solver`` keys."""
    s = cfg.solver
    return OptimizerConfig(
        learning_rate=float(s.learning_rate), beta1=s.adam_beta1, beta2=s.adam_beta2,
        weight_decay=float(s.adam_weight_decay), eps=float(s.adam_epsilon),
        max_grad_norm=s.max_grad_norm, warmup_steps=s.lr_warmup_steps,
        gradient_accumulation_steps=s.get("gradient_accumulation_steps", 1),
        mu_dtype=s.get("adam_mu_dtype", None))


__all__ = [
    "Draws", "OptimizerConfig", "TRAIN_COMPONENTS", "TrainConfig", "TrainState",
    "export_reference_pth", "filter_motion_modules", "load_train_checkpoint", "loss_from_draws",
    "merge_motion_modules", "optimizer_config", "sample_draws", "save_train_checkpoint",
    "stage1_trainable", "stage2_trainable", "stage_config", "system_config", "train_step",
]
