"""CamAnimate system bundle: the six sub-models under one config.

VAE (encoder and decoder), CLIP vision encoder, ReferenceNet (2D UNet),
denoising video UNet, PoseGuider and CameraPoseEncoder, built on one device
in one dtype, with seeded random weights (``init_random``) or weights
converted from the JAX package (``load_jax_params``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..diffusion.schedule import NoiseSchedule, make_noise_schedule
from ..models.camera_encoder import CameraPoseEncoder
from ..models.clip_vision import CLIPVisionEncoder
from ..models.configs import CamAnimateConfig, tiny_config  # noqa: F401
from ..models.pose_guider import PoseGuider
from ..models.unet import UNetConditionModel
from ..models.vae import VAEDecoder, VAEEncoder
from ..utils.weights import from_jax_params

# component -> the weight-translation kind of from_jax_params
COMPONENT_KINDS = {
    "reference_unet": "unet",
    "denoising_unet": "unet",
    "pose_guider": "pose_guider",
    "camera_encoder": "camera_encoder",
    "vae_encoder": "vae_encoder",
    "vae_decoder": "vae_decoder",
    "clip": "clip",
}


def resolve_device(device=None) -> torch.device:
    """The given device, or the first CUDA card; raises rather than fall
    back to the CPU when no device is given and no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


# The layers the reference initializes to zero, by component.
_ZERO_INIT = {
    "pose_guider": lambda name: name.startswith("conv_out."),
    "camera_encoder": lambda name: name.startswith("zero_conv_layers."),
    "denoising_unet": lambda name: ".temporal_transformer.proj_out." in name,
}


def _init_module_(component: str, module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init mirroring the JAX package's: LeCun-normal kernels,
    zero biases, unit norm scales, N(0, 0.02) CLIP embeddings, and the
    reference's zero-initialized layers at zero."""
    norm_types = (nn.GroupNorm, nn.LayerNorm)
    norms = {name for name, m in module.named_modules() if isinstance(m, norm_types)}
    is_zero = _ZERO_INIT.get(component, lambda name: False)
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if owner in norms:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias" or is_zero(name):
            p.zero_()
        elif name.endswith(("class_embedding", "position_embedding.weight")):
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)


class CamAnimate:
    """The module bundle. ``device=None`` means the CUDA card (and raises
    without one); tests pass ``device="cpu"``."""

    def __init__(self, config: CamAnimateConfig = CamAnimateConfig(),
                 device=None, dtype: torch.dtype = torch.float32):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        builders = {
            "reference_unet": lambda: UNetConditionModel(config.reference_unet),
            "denoising_unet": lambda: UNetConditionModel(config.denoising_unet),
            "pose_guider": lambda: PoseGuider(config.pose_guider),
            "camera_encoder": lambda: CameraPoseEncoder(config.camera_encoder),
            "vae_encoder": lambda: VAEEncoder(config.vae),
            "vae_decoder": lambda: VAEDecoder(config.vae),
            "clip": lambda: CLIPVisionEncoder(config.clip),
        }
        for name, build in builders.items():
            # built without storage, then given uninitialized storage on the
            # device: the weights are written by init_random or a load
            with torch.device("meta"):
                module = build()
            module = module.to(dtype).to_empty(device=self.device).eval()
            if self.device.type == "cuda":
                # NHWC convs on the card: cuDNN's native layout, and token
                # views of NCHW activations become free
                module = module.to(memory_format=torch.channels_last)
            module.requires_grad_(False)
            setattr(self, name, module)

    def components(self) -> Dict[str, nn.Module]:
        return {name: getattr(self, name) for name in COMPONENT_KINDS}

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "CamAnimate":
        """Seeded random weights, made on the bundle's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, module in self.components().items():
            _init_module_(name, module, gen)
        return self

    def load_jax_params(self, params: Dict[str, Any]) -> "CamAnimate":
        """Load a JAX ``CamAnimate.init_params``-shaped tree (numpy leaves)."""
        for name, module in self.components().items():
            module.load_state_dict(from_jax_params(params[name], COMPONENT_KINDS[name]),
                                   strict=True)
        return self

    def make_schedule(self, beta_schedule: Optional[str] = None,
                      prediction_type: Optional[str] = None) -> NoiseSchedule:
        """The config's noise schedule; training overrides the beta curve
        with ``beta_schedule="scaled_linear"``, as the reference does."""
        c = self.config
        return make_noise_schedule(
            num_train_timesteps=c.num_train_timesteps,
            beta_start=c.beta_start,
            beta_end=c.beta_end,
            beta_schedule=beta_schedule or c.beta_schedule,
            rescale_betas_zero_snr=c.rescale_betas_zero_snr,
            prediction_type=prediction_type or c.prediction_type,
        )
