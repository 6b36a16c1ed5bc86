"""Frame quality metrics: SSIM, PSNR, L1 (batched, on any device).

The counterpart of ``humanvid_tpu/metrics/frame.py``: SSIM with an 11x11
Gaussian window (sigma 1.5) as a depthwise convolution with zero padding,
C1 = 0.01^2 and C2 = 0.03^2 on [0, 1] images, and PSNR from the per-image
MSE clamped at 1e-12. Images are NHWC float in [0, 1] (tensors or numpy
arrays); each function returns a (n,) float32 tensor on the images' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .nets import strict_fp32


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _pair(img1, img2):
    a = torch.as_tensor(img1, dtype=torch.float32)
    return a, torch.as_tensor(img2, dtype=torch.float32, device=a.device)


def ssim(img1, img2, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM per batch element. img: (n, h, w, c) in [0, 1]."""
    a, b = _pair(img1, img2)
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    c = a.shape[1]
    w2d = torch.from_numpy(_gaussian_window(window_size)).to(a.device)
    kernel = w2d.expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x, kernel, padding=pad, groups=c)

    with strict_fp32():
        mu1, mu2 = filt(a), filt(b)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = filt(a * a) - mu1_sq
        sigma2_sq = filt(b * b) - mu2_sq
        sigma12 = filt(a * b) - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1, img2) -> torch.Tensor:
    """Per-batch-element PSNR in dB; images in [0, 1]."""
    a, b = _pair(img1, img2)
    mse = ((a - b) ** 2).mean(dim=(1, 2, 3))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def l1(img1, img2) -> torch.Tensor:
    a, b = _pair(img1, img2)
    return (a - b).abs().mean(dim=(1, 2, 3))
