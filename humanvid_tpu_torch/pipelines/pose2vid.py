"""Pose2Video pipeline: camera-aware long-video inference.

CLIP-embed and VAE-encode the reference image and run the ReferenceNet once;
compute the PoseGuider and CameraPoseEncoder conditioning once for the whole
run (one window set serves every step); then per DDIM step run the video UNet
over the context windows with classifier-free guidance, average overlapping
windows' predictions per frame, and take a DDIM step; finally (after the
optional latent interpolation, ``interpolation_rate`` > 1) VAE-decode in
frame chunks.

CFG: ``cfg_mode="sequential"`` runs two UNet passes per step (the uncond one
without the reference keys/values: hiding every reference key from a row is
the same softmax as leaving them out); ``"batched"`` runs one pass of twice
the rows with the reference keys hidden from the uncond rows by a bias.
``window_mode="sequential"`` runs one window per pass. The ReferenceNet runs
on the cond row only: the uncond row's features are never seen.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..diffusion.ddim import ddim_set_timesteps, ddim_step
from ..models.clip_vision import clip_preprocess
from ..models.vae import gaussian_mean
from .context import uniform_windows
from .interpolation import interpolate_latents
from .system import CamAnimate


@dataclasses.dataclass
class Pose2VideoOutput:
    videos: np.ndarray   # (1, f', H, W, 3) float32 in [0, 1], f' = f + (f-1)(rate-1)
    latents: np.ndarray  # (f, h8, w8, 4) float32, before any interpolation
    # host-clock seconds of each phase, each ending in a device synchronize
    seconds: Dict[str, object] = dataclasses.field(default_factory=dict)


def _nchw(x, device, dtype) -> torch.Tensor:
    """(..., H, W, C) host array or tensor -> (N, C, H, W) tensor."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    t = torch.as_tensor(x, device=device).to(dtype)
    t = t.reshape((-1,) + t.shape[-3:]).permute(0, 3, 1, 2)
    fmt = torch.channels_last if t.device.type == "cuda" else torch.contiguous_format
    return t.contiguous(memory_format=fmt)


class Pose2VideoPipeline:
    def __init__(self, system: CamAnimate):
        self.system = system
        self.sched = system.make_schedule()

    def _sync(self):
        if self.system.device.type == "cuda":
            torch.cuda.synchronize(self.system.device)

    def encode_reference(self, ref_img: torch.Tensor, clip_img: torch.Tensor):
        """-> (context (1, 1, d), ReferenceNet features, each (1, l, c))."""
        s = self.system
        moments = s.vae_encoder(ref_img)
        ref_latents = gaussian_mean(moments) * s.config.vae.scaling_factor
        ctx = s.clip(clip_img)[:, None, :]
        t0 = torch.zeros(1, device=s.device)
        _, feats = s.reference_unet(ref_latents, t0, ctx, collect_ref_features=True)
        return ctx, feats

    @torch.inference_mode()
    def __call__(
        self,
        ref_image: np.ndarray,     # (H, W, 3) in [0, 1]
        pose_video: np.ndarray,    # (f, H, W, 3) in [0, 1]
        plucker: np.ndarray,       # (f, H, W, 6)
        clip_image: np.ndarray,    # (S, S, 3) in [0, 1], S = config.clip.image_size
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        context_frames: int = 24,
        context_stride: int = 1,
        context_overlap: int = 4,
        generator: Optional[torch.Generator] = None,
        decode_chunk: int = 8,
        interpolation_rate: int = 1,
        interpolation_mode: str = "slerp",
        cfg_mode: str = "batched",
        window_mode: str = "batched",
        init_latents: Optional[np.ndarray] = None,
    ) -> Pose2VideoOutput:
        if cfg_mode not in ("batched", "sequential"):
            raise ValueError(f"cfg_mode {cfg_mode!r}")
        if window_mode not in ("batched", "sequential"):
            raise ValueError(f"window_mode {window_mode!r}")
        s = self.system
        dev, dtype = s.device, s.dtype
        f, H, W_img, _ = pose_video.shape
        h8, w8 = H // 8, W_img // 8
        do_cfg = guidance_scale > 1.0
        seconds: Dict[str, object] = {}
        t_start = time.perf_counter()

        ddim = ddim_set_timesteps(self.sched, num_inference_steps,
                                  timestep_spacing=s.config.timestep_spacing,
                                  steps_offset=s.config.steps_offset)
        win = torch.as_tensor(np.asarray(uniform_windows(
            0, f, context_frames, context_stride, context_overlap), np.int64), device=dev)
        W, F = win.shape

        ref_img = _nchw(np.asarray(ref_image)[None] * 2.0 - 1.0, dev, dtype)
        clip_img = clip_preprocess(torch.as_tensor(
            np.asarray(clip_image, np.float32), device=dev).to(dtype))
        clip_img = clip_img[None].permute(0, 3, 1, 2).contiguous()
        # pose conditioning stays in [0, 1] (no normalization)
        pose = _nchw(pose_video, dev, dtype)
        plk = _nchw(plucker, dev, dtype)

        ctx, feats = self.encode_reference(ref_img, clip_img)
        ctx_u = torch.zeros_like(ctx)
        pose_fea = s.pose_guider(pose)
        if init_latents is not None:
            latents = _nchw(init_latents, dev, dtype)
        else:
            latents = torch.randn((f, 4, h8, w8), generator=generator, device=dev,
                                  dtype=torch.float32).to(dtype)
        # hoisted conditioning: one window set for every step
        cam = s.camera_encoder(plk[win.reshape(-1)], F)
        cond = pose_fea[win.reshape(-1)] + cam      # ((W F), c0, h8, w8)
        self._sync()
        seconds["prepare"] = time.perf_counter() - t_start

        def unet(x, t, c, ref, disable, cond_fea):
            rows = c.shape[0]
            t_b = torch.full((rows,), float(t), device=dev)
            eps, _ = s.denoising_unet(x, t_b, c, cond_fea=cond_fea, ref_features=ref,
                                      ref_disable=disable, frames=F)
            return eps

        def rep(t, n):
            return t.repeat_interleave(n, dim=0)

        counter = torch.bincount(win.reshape(-1), minlength=f)
        step_seconds: List[float] = []
        for t, prev_t in zip(ddim.timesteps.tolist(), ddim.prev_timesteps.tolist()):
            t0 = time.perf_counter()
            x = latents[win.reshape(-1)]              # ((W F), 4, h8, w8)
            if window_mode == "sequential":
                banks = []
                for w in range(W):
                    rows = slice(w * F, (w + 1) * F)
                    if do_cfg:
                        banks.append(torch.stack([
                            unet(x[rows], t, ctx_u, None, None, cond[rows]),
                            unet(x[rows], t, ctx, feats, None, cond[rows])]))
                    else:
                        banks.append(unet(x[rows], t, ctx, feats, None, cond[rows])[None])
                eps = torch.cat(banks, dim=1)         # (banks, (W F), ...)
            elif do_cfg and cfg_mode == "sequential":
                eps = torch.stack([
                    unet(x, t, rep(ctx_u, W), None, None, cond),
                    unet(x, t, rep(ctx, W), [rep(fb, W) for fb in feats], None, cond)])
            elif do_cfg:
                # the uncond rows' reference keys are hidden by the bias, so
                # the cond features stand in for them
                disable = torch.cat([torch.ones(W, dtype=torch.bool, device=dev),
                                     torch.zeros(W, dtype=torch.bool, device=dev)])
                eps = unet(torch.cat([x, x]), t, torch.cat([rep(ctx_u, W), rep(ctx, W)]),
                           [rep(fb, 2 * W) for fb in feats], disable,
                           torch.cat([cond, cond])).reshape((2, W * F) + x.shape[1:])
            else:
                eps = unet(x, t, rep(ctx, W), [rep(fb, W) for fb in feats], None, cond)[None]

            # overlap average over the windows that hold each frame
            noise_sum = torch.zeros((eps.shape[0],) + latents.shape, dtype=eps.dtype,
                                    device=dev)
            noise_sum.index_add_(1, win.reshape(-1), eps)
            noise_avg = noise_sum / counter.to(eps.dtype)[None, :, None, None, None]
            if do_cfg:
                noise_pred = noise_avg[0] + guidance_scale * (noise_avg[1] - noise_avg[0])
            else:
                noise_pred = noise_avg[0]
            latents = ddim_step(self.sched, noise_pred.to(latents.dtype), t, prev_t, latents)
            self._sync()
            step_seconds.append(time.perf_counter() - t0)
        seconds["denoise_steps"] = step_seconds

        t0 = time.perf_counter()
        video = self.decode(interpolate_latents(latents, interpolation_rate, interpolation_mode),
                            decode_chunk)
        self._sync()
        seconds["decode"] = time.perf_counter() - t0
        return Pose2VideoOutput(
            videos=video.float().cpu().numpy()[None],
            latents=latents.permute(0, 2, 3, 1).float().cpu().numpy(),
            seconds=seconds,
        )

    def decode(self, latents: torch.Tensor, decode_chunk: int = 8) -> torch.Tensor:
        """(f, 4, h8, w8) latents -> (f, H, W, 3) in [0, 1], decoded in
        chunks of the largest divisor of f within ``decode_chunk`` (as the
        JAX package does: 24 frames interpolated at rate 2 are 47, a prime,
        so they decode one frame at a time)."""
        s = self.system
        f = latents.shape[0]
        chunk = max(d for d in range(1, min(decode_chunk, f) + 1) if f % d == 0)
        scale = 1.0 / s.config.vae.scaling_factor
        imgs = [s.vae_decoder(latents[i:i + chunk] * scale) for i in range(0, f, chunk)]
        imgs = torch.cat(imgs).permute(0, 2, 3, 1)
        return (imgs / 2.0 + 0.5).clamp(0.0, 1.0)
