"""Diffusion noise schedule tables: beta curves and the zero-SNR rescale.

diffusers ``DDIMScheduler`` table construction as the reference configures
it: betas 0.00085..0.012 over 1000 steps ("linear" for inference,
"scaled_linear" for training), with ``rescale_betas_zero_snr`` (Lin et al.
2023). Tables are host numpy arrays; the training-time functions below
gather them at a tensor of timesteps on that tensor's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NoiseSchedule(NamedTuple):
    alphas_cumprod: np.ndarray   # (T,) float32
    num_train_timesteps: int
    prediction_type: str         # "epsilon" | "v_prediction"


def _make_betas(schedule: str, beta_start: float, beta_end: float, n: int) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, n, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2
    raise ValueError(f"unknown beta schedule: {schedule}")


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift/scale sqrt(alpha_cumprod) so terminal SNR is exactly zero."""
    sqrt_ac = np.sqrt(np.cumprod(1.0 - betas))
    first, last = sqrt_ac[0].copy(), sqrt_ac[-1].copy()
    sqrt_ac = (sqrt_ac - last) * first / (first - last)
    alphas_cumprod = sqrt_ac**2
    alphas = np.concatenate([alphas_cumprod[:1], alphas_cumprod[1:] / alphas_cumprod[:-1]])
    return 1.0 - alphas


def make_noise_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    rescale_betas_zero_snr: bool = True,
    prediction_type: str = "v_prediction",
) -> NoiseSchedule:
    betas = _make_betas(beta_schedule, beta_start, beta_end, num_train_timesteps)
    if rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    return NoiseSchedule(
        alphas_cumprod=np.asarray(np.cumprod(1.0 - betas), dtype=np.float32),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _gather(sched: NoiseSchedule, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """alphas_cumprod[t] (fp32) shaped to broadcast over an ndim-rank tensor
    whose leading axis is the batch."""
    a = torch.as_tensor(sched.alphas_cumprod, device=t.device)[t.long()]
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def add_noise(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    a = _gather(sched, t, x0.ndim)
    return a.sqrt() * x0 + (1.0 - a).sqrt() * noise


def get_velocity(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    a = _gather(sched, t, x0.ndim)
    return a.sqrt() * noise - (1.0 - a).sqrt() * x0


def compute_snr(sched: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
    a = _gather(sched, t, 1)
    return a / (1.0 - a)


def min_snr_weights(sched: NoiseSchedule, t: torch.Tensor, gamma: float) -> torch.Tensor:
    """Min-SNR-gamma loss weights per sample. For v-prediction the SNR gets
    +1 before the min and the ratio, which also keeps the zero-terminal-SNR
    timestep finite (weight -> 1)."""
    snr = compute_snr(sched, t)
    if sched.prediction_type == "v_prediction":
        snr = snr + 1.0
    return torch.clamp(snr, max=gamma) / snr
