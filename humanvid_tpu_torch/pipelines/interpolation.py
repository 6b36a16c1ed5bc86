"""Latent frame interpolation (slerp or linear) for temporal upsampling.

Between each pair of adjacent latent frames, ``rate - 1`` interpolants at
fractions k / rate are inserted before the decode, so a clip sampled at f
frames decodes to ``f + (f - 1)(rate - 1)`` frames. ``slerp`` interpolates
the flattened frames on the sphere and falls back to the linear form where
they are nearly parallel. Plain torch on the latents' device, all pairs at
once.
"""

from __future__ import annotations

import torch

__all__ = ["lerp", "slerp", "interpolate_latents"]


def lerp(v0: torch.Tensor, v1: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=v0.dtype, device=v0.device)
    return (1.0 - t) * v0 + t * v1


def slerp(v0: torch.Tensor, v1: torch.Tensor, t, dot_threshold: float = 0.9995
          ) -> torch.Tensor:
    """Spherical interpolation of the two tensors, flattened, at the scalar
    fraction ``t``; linear where their directions are nearly parallel."""
    return _slerp_flat(v0.reshape(-1), v1.reshape(-1), t, dot_threshold).reshape(v0.shape)


def _slerp_flat(a0: torch.Tensor, b0: torch.Tensor, t, dot_threshold: float) -> torch.Tensor:
    """``a0``, ``b0``: (..., n) pairs of flattened frames; ``t``: a scalar or
    (...) fractions. Computed in fp32, returned in the input dtype."""
    dtype = a0.dtype
    a, b = a0.float(), b0.float()
    t = torch.as_tensor(t, dtype=torch.float32, device=a.device)[..., None]
    dot = (a * b).sum(-1, keepdim=True) / (
        torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        * torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
    dot = dot.clamp(-1.0, 1.0)
    theta0 = torch.arccos(dot)
    sin0 = torch.sin(theta0).clamp_min(1e-12)
    spherical = torch.sin((1.0 - t) * theta0) / sin0 * a + torch.sin(t * theta0) / sin0 * b
    linear = (1.0 - t) * a + t * b
    return torch.where(dot.abs() > dot_threshold, linear, spherical).to(dtype)


def interpolate_latents(latents: torch.Tensor, rate: int, mode: str = "slerp"
                        ) -> torch.Tensor:
    """(f, ...) frames -> (f + (f - 1)(rate - 1), ...): each frame, then its
    ``rate - 1`` interpolants towards the next, then the last frame."""
    if rate <= 1:
        return latents
    if mode not in ("slerp", "linear"):
        raise ValueError(f"interpolation mode {mode!r}")
    f = latents.shape[0]
    frame = latents.shape[1:]
    v0 = latents[:-1].reshape(f - 1, 1, -1)
    v1 = latents[1:].reshape(f - 1, 1, -1)
    fracs = torch.arange(1, rate, device=latents.device, dtype=torch.float32) / rate
    if mode == "slerp":
        inter = _slerp_flat(v0, v1, fracs.expand(f - 1, rate - 1), 0.9995)
    else:
        inter = lerp(v0, v1, fracs.to(latents.dtype)[None, :, None])
    groups = torch.cat([v0, inter], dim=1)          # (f - 1, rate, n)
    flat = groups.reshape((-1,) + frame)
    return torch.cat([flat, latents[-1:]], dim=0)
