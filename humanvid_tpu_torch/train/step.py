"""The training step, shared by stage 1 and stage 2.

The counterpart of ``humanvid_tpu/train/step.py``: VAE-encode the target
frames and the reference image, CLIP-embed the reference (the whole batch
dropped to the unconditional context at ``uncond_ratio``), noise the latents
with offset noise, predict with the ReferenceNet features and the pose and
camera conditioning, and take the min-SNR-gamma weighted MSE against the
v-prediction (or epsilon) target in fp32.

The randomness of a step is explicit: :func:`sample_draws` makes the six
draws of the JAX step's ``jax.random.split(rng, 6)`` (noise, offset noise,
timesteps, the two VAE samples' standard normals and the uncond flag) and
:func:`loss_from_draws` computes the loss from them, so that a test can
hand both packages the same numbers. Draws are NCHW, as the port's tensors.

The frozen encoders (VAE encoder, CLIP, and the ReferenceNet when none of
its leaves trains) run under ``no_grad``. An uncond step zeroes the CLIP
context and hides the reference keys from every row (``ref_disable``): the
ReferenceNet still runs, and the hidden keys get exactly zero gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule, add_noise, get_velocity, min_snr_weights
from ..models.layers import checkpointed
from ..models.vae import gaussian_sample
from ..pipelines.pose2vid import _nchw
from .state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    uncond_ratio: float = 0.1
    noise_offset: float = 0.05
    snr_gamma: float = 5.0
    # Frames per frozen-VAE-encode call; where it does not divide b*f the
    # largest divisor below it is used. 0 encodes the whole batch at once.
    vae_encode_chunk: int = 4
    # Recompute the PoseGuider and CameraPoseEncoder in the backward: both
    # run at full and 1/8 resolution over every frame.
    remat_cond_encoders: bool = True


class Draws(NamedTuple):
    noise: torch.Tensor         # (b, f, 4, h8, w8) standard normal
    offset_noise: torch.Tensor  # (b, 1, 4, 1, 1) standard normal
    t: torch.Tensor             # (b,) int64 in [0, num_train_timesteps)
    vae_eps: torch.Tensor       # (b*f, 4, h8, w8) standard normal
    ref_vae_eps: torch.Tensor   # (b, 4, h8, w8) standard normal
    uncond: bool                # whole-batch CFG dropout


def sample_draws(generator: torch.Generator, b: int, f: int, height: int, width: int,
                 num_train_timesteps: int, uncond_ratio: float,
                 uncond: Optional[bool] = None) -> Draws:
    """One step's draws for a batch of b clips of f frames at height x width,
    on the generator's device. The uncond flag is drawn from the generator
    too unless given (a draw on the card is read back to the host)."""
    h8, w8 = height // 8, width // 8
    kw = dict(generator=generator, device=generator.device)
    noise = torch.randn((b, f, 4, h8, w8), **kw)
    offset = torch.randn((b, 1, 4, 1, 1), **kw)
    t = torch.randint(0, num_train_timesteps, (b,), **kw)
    vae_eps = torch.randn((b * f, 4, h8, w8), **kw)
    ref_eps = torch.randn((b, 4, h8, w8), **kw)
    if uncond is None:
        uncond = bool(torch.rand((), **kw).item() < uncond_ratio)
    return Draws(noise, offset, t, vae_eps, ref_eps, uncond)


def _encode_chunk(n: int, chunk: int) -> int:
    """The largest divisor of n that is <= chunk (n when chunk is 0 or >= n)."""
    if not chunk or chunk >= n:
        return n
    while n % chunk:
        chunk -= 1
    return chunk


def loss_from_draws(system, sched: NoiseSchedule, cfg: TrainConfig,
                    batch: Dict[str, np.ndarray], draws: Draws):
    """(loss, t_mean) of one step. ``batch`` holds channel-last arrays, as
    the JAX package's step takes them, or tensors (on the device, from the
    loader):

    - tgt:     (b, f, H, W, 3) in [-1, 1]
    - ref:     (b, H, W, 3) in [-1, 1]
    - clip:    (b, S, S, 3) CLIP-normalized
    - pose:    (b, f, H, W, 3) in [0, 1]
    - plucker: (b, f, H, W, 6)
    """
    s = system
    dev, dt = s.device, s.dtype
    b, f, H, W = np.shape(batch["tgt"])[:4]
    h8, w8 = H // 8, W // 8
    scaling = s.config.vae.scaling_factor
    t = draws.t.to(dev)

    with torch.no_grad():
        tgt = _nchw(batch["tgt"], dev, dt)
        n = b * f
        moments = torch.cat([s.vae_encoder(x) for x in tgt.split(
            _encode_chunk(n, cfg.vae_encode_chunk))])
        latents = gaussian_sample(moments, draws.vae_eps.to(dev)) * scaling
        ref_moments = s.vae_encoder(_nchw(batch["ref"], dev, dt))
        ref_latents = gaussian_sample(ref_moments, draws.ref_vae_eps.to(dev)) * scaling
        embeds = s.clip(_nchw(batch["clip"], dev, dt).contiguous())
        ctx = (torch.zeros_like(embeds) if draws.uncond else embeds)[:, None, :]

        noise = draws.noise.to(dev)
        if cfg.noise_offset > 0:
            noise = noise + cfg.noise_offset * draws.offset_noise.to(dev)
        latents = latents.float().reshape(b, f, 4, h8, w8)
        noisy = add_noise(sched, latents, noise, t)
        if sched.prediction_type == "epsilon":
            target = noise
        elif sched.prediction_type == "v_prediction":
            target = get_velocity(sched, latents, noise, t)
        else:
            raise ValueError(sched.prediction_type)

    ref_trains = any(p.requires_grad for p in s.reference_unet.parameters())
    with torch.set_grad_enabled(ref_trains and torch.is_grad_enabled()):
        _, ref_feats = s.reference_unet(ref_latents, torch.zeros(b, device=dev), ctx,
                                        collect_ref_features=True)
    pose_fea = checkpointed(cfg.remat_cond_encoders, s.pose_guider, _nchw(batch["pose"], dev, dt))
    cam_fea = checkpointed(cfg.remat_cond_encoders, s.camera_encoder,
                           _nchw(batch["plucker"], dev, dt), f)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    pred, _ = s.denoising_unet(
        noisy.reshape(n, 4, h8, w8).to(dt).contiguous(memory_format=fmt),
        t.float(), ctx, cond_fea=pose_fea + cam_fea, ref_features=ref_feats,
        ref_disable=torch.ones(b, dtype=torch.bool, device=dev) if draws.uncond else None,
        frames=f)

    err = (pred.float().reshape(b, f, 4, h8, w8) - target) ** 2
    per_sample = err.mean(dim=(1, 2, 3, 4))
    if cfg.snr_gamma > 0:
        per_sample = per_sample * min_snr_weights(sched, t, cfg.snr_gamma)
    return per_sample.mean(), t.float().mean()


def train_step(system, state: TrainState, sched: NoiseSchedule, cfg: TrainConfig,
               batch: Dict[str, np.ndarray], draws: Optional[Draws] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One micro-step: the loss, its backward and ``state.apply_gradients``,
    which updates on every ``gradient_accumulation_steps``-th call. Draws
    come from ``generator`` unless given. Returns ``loss``, ``grad_norm``
    (the micro-batch's, before clipping) and ``t_mean`` as 0-dim tensors on
    the system's device. With ``draws`` given, nothing is read back to the
    host."""
    if draws is None:
        b, f, H, W = np.shape(batch["tgt"])[:4]
        draws = sample_draws(generator, b, f, H, W, sched.num_train_timesteps,
                             cfg.uncond_ratio)
    loss, t_mean = loss_from_draws(system, sched, cfg, batch, draws)
    loss.backward()
    grad_norm = state.apply_gradients()
    return {"loss": loss.detach(), "grad_norm": grad_norm, "t_mean": t_mean}
