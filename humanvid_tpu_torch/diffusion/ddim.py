"""DDIM sampling (eta = 0, no clipping or thresholding).

diffusers ``DDIMScheduler``: the reference's operating point is trailing
timestep spacing, zero-SNR rescaled betas, v-prediction and
``steps_offset=1``; the "leading" (with ``steps_offset``) and "linspace"
spacings and ``set_alpha_to_one=False`` (``make_noise_schedule``) are there
too. Scheduler math runs in fp32 whatever the model dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .schedule import NoiseSchedule


class DDIMState(NamedTuple):
    timesteps: np.ndarray       # (S,) int64, descending
    prev_timesteps: np.ndarray  # (S,) int64, timestep of the next (less noisy) state
    num_inference_steps: int


def ddim_set_timesteps(sched: NoiseSchedule, num_inference_steps: int,
                       timestep_spacing: str = "trailing", steps_offset: int = 1) -> DDIMState:
    """The step's timesteps under a spacing; ``steps_offset`` enters only
    the "leading" one."""
    T = sched.num_train_timesteps
    if timestep_spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / num_inference_steps)).astype(np.int64) - 1
    elif timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + steps_offset
    elif timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].astype(np.int64)
    else:
        raise ValueError(f"unknown timestep spacing: {timestep_spacing}")
    return DDIMState(timesteps=ts, prev_timesteps=ts - T // num_inference_steps,
                     num_inference_steps=num_inference_steps)


def _alpha_at(sched: NoiseSchedule, t: int) -> float:
    """alphas_cumprod[t], with t < 0 (past the last step) mapping to the
    schedule's final_alpha_cumprod."""
    t = int(t)
    return sched.final_alpha_cumprod if t < 0 else float(sched.alphas_cumprod[t])


def ddim_pred_x0_eps(sched: NoiseSchedule, model_output: torch.Tensor,
                     sample: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0, eps) from the model output under the schedule's prediction type."""
    a_t = torch.tensor(_alpha_at(sched, t), dtype=torch.float32)
    sqrt_a, sqrt_1ma = torch.sqrt(a_t).item(), torch.sqrt(1.0 - a_t).item()
    if sched.prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sqrt_1ma * eps) / sqrt_a
    elif sched.prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_1ma * model_output
        eps = sqrt_a * model_output + sqrt_1ma * sample
    elif sched.prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_1ma
    else:
        raise ValueError(sched.prediction_type)
    return x0, eps


def ddim_step(sched: NoiseSchedule, model_output: torch.Tensor, t: int,
              prev_t: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update x_t -> x_{prev_t}, in fp32; the result
    keeps the sample's dtype."""
    x0, eps = ddim_pred_x0_eps(sched, model_output.float(), sample.float(), t)
    a_prev = torch.tensor(_alpha_at(sched, prev_t), dtype=torch.float32)
    out = torch.sqrt(a_prev).item() * x0 + torch.sqrt(1.0 - a_prev).item() * eps
    return out.to(sample.dtype)
