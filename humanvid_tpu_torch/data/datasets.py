"""Dataset-side image preprocessing.

Only ``clip_crop_raw`` so far, which the inference command lines use; the
training datasets are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def clip_crop_raw(image: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (size, size, 3) in [0, 1] by CLIP's
    short-side bicubic resize and centre crop, without CLIP's normalization
    (the pipelines normalize). The resize is PIL's ``BICUBIC``: antialiased,
    rows first, then columns, the row pass rounded and clipped to uint8
    (which cuts the kernel's overshoot on sharp edges)."""
    h, w = image.shape[:2]
    if h < w:
        new_h, new_w = size, int(size * w / h)
    else:
        new_h, new_w = int(size * h / w), size
    r = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    for out in ((h, new_w), (new_h, new_w)):
        if out != tuple(r.shape[-2:]):
            r = F.interpolate(r, size=out, mode="bicubic", antialias=True,
                              align_corners=False).round().clamp(0, 255)
    r = r[0].permute(1, 2, 0).numpy()
    y0, x0 = (new_h - size) // 2, (new_w - size) // 2
    return r[y0:y0 + size, x0:x0 + size].astype(np.float32) / 255.0
