"""Evaluation metrics: SSIM, PSNR, L1 (``frame``), the Fréchet distance of
FID and FVD (``frechet``), CLIP frame consistency (``clip_sim``); the
networks behind LPIPS (``lpips``), FID (``inception``), FVD (``i3d``) and
CLIP consistency (``weights.make_clip_apply``), loaded from a directory of
torch checkpoints (``weights``); and the directory evaluation driver
(``runner``). The network modules import on first use, as in the JAX
package's ``humanvid_tpu/metrics/__init__.py``."""

from .clip_sim import frame_consistency
from .frame import l1, psnr, ssim
from .frechet import activation_statistics, frechet_distance, frechet_from_features

__all__ = [
    "ssim",
    "psnr",
    "l1",
    "activation_statistics",
    "frechet_distance",
    "frechet_from_features",
    "frame_consistency",
]
