"""Model configuration dataclasses (SD1.5 / AnimateDiff / CameraCtrl operating points).

A copy of the JAX package's configuration classes, so that the PyTorch port
builds the same topologies from the same values:

- UNet: SD1.5 (2D ReferenceNet, and the video UNet with AnimateDiff motion
  modules: 8 heads, 1 block, 2x Temporal_Self, position encoding max_len 32,
  zero-init proj_out)
- camera encoder: CameraCtrl pose adaptor (channels=[320], nums_rb=2, cin=384,
  ksize=1, sk=true, use_conv=false, position encoding max_len 16/24)
- pose guider: PoseGuider(320, (16, 32, 96, 256))
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock",
        "CrossAttnDownBlock",
        "CrossAttnDownBlock",
        "DownBlock",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock",
        "CrossAttnUpBlock",
        "CrossAttnUpBlock",
        "CrossAttnUpBlock",
    )
    cross_attention_dim: int = 768
    # diffusers naming quirk: for SD1.5 "attention_head_dim=8" is the head COUNT;
    # head width is channels // heads.
    attention_heads: int = 8
    transformer_layers: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    time_embed_dim_mult: int = 4  # time_embed_dim = block_out_channels[0] * 4
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    # Video/motion extensions (AnimateDiff), off for the ReferenceNet.
    use_motion_module: bool = False
    motion_mid_block: bool = True
    motion_num_heads: int = 8
    motion_transformer_blocks: int = 1
    motion_attention_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    motion_position_encoding: bool = True
    motion_max_len: int = 32

    # Training memory levers; both are inert under no_grad / inference_mode.
    # gradient_checkpointing recomputes each resnet, spatial transformer and
    # motion module in the backward; ff_chunk_tokens > 0 runs every
    # feed-forward over token chunks of that length, each recomputed.
    gradient_checkpointing: bool = False
    ff_chunk_tokens: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult


SD15_UNET = UNetConfig()
SD15_VIDEO_UNET = UNetConfig(use_motion_module=True)


@dataclasses.dataclass(frozen=True)
class PoseGuiderConfig:
    conditioning_embedding_channels: int = 320
    conditioning_channels: int = 3
    block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class CameraEncoderConfig:
    downscale_factor: int = 8
    channels: Tuple[int, ...] = (320,)
    nums_rb: int = 2
    cin: int = 384  # 6 plucker channels * 8 * 8
    ksize: int = 1
    sk: bool = True
    use_conv: bool = False
    num_heads: int = 8
    attention_block_types: Tuple[str, ...] = ("Temporal_Self",)
    position_encoding: bool = True
    position_encoding_max_len: int = 16  # 16 stage 1 / 24 stage 2+inference
    ff_chunk_tokens: int = 0  # the temporal blocks' feed-forward chunking (training)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD VAE (AutoencoderKL, sd-vae-ft-mse operating point)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 vision tower with projection (sd-image-variations encoder)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CamAnimateConfig:
    reference_unet: UNetConfig = UNetConfig()
    denoising_unet: UNetConfig = UNetConfig(use_motion_module=True)
    pose_guider: PoseGuiderConfig = PoseGuiderConfig()
    camera_encoder: CameraEncoderConfig = CameraEncoderConfig(position_encoding_max_len=24)
    vae: VAEConfig = VAEConfig()
    clip: CLIPVisionConfig = CLIPVisionConfig()
    # inference scheduler: zero-SNR + v-prediction + trailing spacing +
    # LINEAR betas (the reference's inference_v2.yaml)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    rescale_betas_zero_snr: bool = True
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    steps_offset: int = 1


def tiny_config(motion_max_len: int = 8) -> CamAnimateConfig:
    """Small topology for CPU tests: same structure, 2 levels, thin channels."""
    tiny_unet = UNetConfig(
        block_out_channels=(32, 64),
        layers_per_block=1,
        down_block_types=("CrossAttnDownBlock", "DownBlock"),
        up_block_types=("UpBlock", "CrossAttnUpBlock"),
        attention_heads=4,
        cross_attention_dim=32,
        norm_num_groups=8,
    )
    return CamAnimateConfig(
        reference_unet=tiny_unet,
        denoising_unet=dataclasses.replace(
            tiny_unet, use_motion_module=True, motion_num_heads=4,
            motion_max_len=motion_max_len,
        ),
        pose_guider=PoseGuiderConfig(
            conditioning_embedding_channels=32, block_out_channels=(4, 8, 12, 16)
        ),
        camera_encoder=CameraEncoderConfig(
            channels=(32,), nums_rb=1, num_heads=4, position_encoding_max_len=motion_max_len
        ),
        vae=VAEConfig(block_out_channels=(8, 8, 16, 16), norm_num_groups=4),
        clip=CLIPVisionConfig(
            image_size=28, patch_size=14, hidden_size=16, num_layers=2,
            num_heads=2, intermediate_size=32, projection_dim=32,
        ),
    )
