"""Pose2Image pipeline: the stage-1 sampler.

One frame in one window: a thin wrapper over :class:`Pose2VideoPipeline` at
f = 1, with CFG batched into one UNet pass (the uncond row's reference keys
hidden by the bias) and a decode chunk of 1, as the JAX package's
``Pose2ImagePipeline`` wraps its shared denoise scan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .pose2vid import Pose2VideoPipeline
from .system import CamAnimate


@dataclasses.dataclass
class Pose2ImageOutput:
    images: np.ndarray   # (1, H, W, 3) float32 in [0, 1]
    latents: np.ndarray  # (1, h8, w8, 4) float32
    # host-clock seconds of each phase, each ending in a device synchronize
    seconds: Dict[str, object] = dataclasses.field(default_factory=dict)


class Pose2ImagePipeline:
    def __init__(self, system: CamAnimate):
        self.system = system
        self.video = Pose2VideoPipeline(system)

    def __call__(
        self,
        ref_image: np.ndarray,   # (H, W, 3) in [0, 1]
        pose_image: np.ndarray,  # (H, W, 3) in [0, 1]
        plucker: np.ndarray,     # (H, W, 6)
        clip_image: np.ndarray,  # (S, S, 3) in [0, 1], S = config.clip.image_size
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        generator: Optional[torch.Generator] = None,
        init_latents: Optional[np.ndarray] = None,  # (1, H/8, W/8, 4)
    ) -> Pose2ImageOutput:
        out = self.video(
            ref_image, np.asarray(pose_image)[None], np.asarray(plucker)[None], clip_image,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            context_frames=1, context_overlap=0, generator=generator, decode_chunk=1,
            cfg_mode="batched", window_mode="batched", init_latents=init_latents)
        return Pose2ImageOutput(images=out.videos[0], latents=out.latents, seconds=out.seconds)
