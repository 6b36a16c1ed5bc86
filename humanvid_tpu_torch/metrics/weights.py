"""The metric networks from a directory of torch checkpoint files.

The counterpart of ``humanvid_tpu/metrics/weights.py``. The reference
downloads its metric networks at run time (pytorch-fid's InceptionV3,
styleganv's I3D, lpips' VGG16, CLIP-L/14); this repo reads a directory of
state-dict files instead, and each metric whose file is present is enabled
(``python -m humanvid_tpu_torch.tools.make_random_metric_weights DIR``
writes the whole set with seeded random values and the real key sets):

  ``lpips_vgg16.pth``    torchvision ``vgg16.features`` keys (``0.weight``, ...)
  ``lpips_lins.pth``     lpips' lin heads (``lin{i}.model.1.weight``)
  ``fid_inception.pth``  pytorch-fid / torchvision InceptionV3 keys
  ``fvd_i3d.pth``        I3D keys (``Mixed_3b.b1a.conv3d.weight``)
  ``clip_vitl14.pth``    transformers ``CLIPVisionModelWithProjection`` keys

Every network runs in float32 on the device it is given.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..data.datasets import clip_crop_raw
from ..models.clip_vision import CLIPVisionEncoder, clip_preprocess
from ..models.configs import CLIPVisionConfig
from ..utils.convert import convert_state_dict
from .nets import run_batched

LPIPS_VGG = "lpips_vgg16.pth"
LPIPS_LINS = "lpips_lins.pth"
FID_INCEPTION = "fid_inception.pth"
FVD_I3D = "fvd_i3d.pth"
CLIP_VITL14 = "clip_vitl14.pth"

# CLIP ViT-L/14 at 224: hidden 1024, 24 layers, 16 heads, projection 768
CLIP_L14 = CLIPVisionConfig()


def torch_load(path: str) -> Dict[str, torch.Tensor]:
    """A state dict of tensors (``weights_only``; a ``state_dict`` wrapper
    unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


class CLIPFrameFeatures:
    """The frame-feature function of the CLIP consistency metric: frames
    (f, H, W, 3) in [0, 1] -> (f, projection_dim) image embeddings. Each
    frame goes to uint8 (rounded), then CLIP's short-side bicubic resize
    and centre crop (``data.datasets.clip_crop_raw``, ``crops``), then
    CLIP's normalization and the encoder (``embed``, on channel-last
    tensors), ``batch`` frames a call."""

    def __init__(self, model: CLIPVisionEncoder, device, batch: int = 8):
        self.model, self.device, self.batch = model, device, batch

    def crops(self, frames: np.ndarray) -> np.ndarray:
        u8 = np.clip(np.asarray(frames) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return np.stack([clip_crop_raw(fr, self.model.config.image_size) for fr in u8])

    def embed(self, crops: torch.Tensor) -> torch.Tensor:
        return self.model(clip_preprocess(crops).permute(0, 3, 1, 2))

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        return run_batched(self.embed, (self.crops(frames),), self.batch, self.device)


def make_clip_apply(state_dict: Mapping[str, Any], device,
                    config: CLIPVisionConfig = CLIP_L14, clip_batch: int = 8) -> CLIPFrameFeatures:
    """CLIP's frame features on ``device`` from HF-keyed weights (any float
    dtype), loaded with ``strict=True`` after the port's key handling
    (``utils/convert.py``), in float32."""
    with torch.device("meta"):
        model = CLIPVisionEncoder(config)
    found, missing, _ = convert_state_dict(model.state_dict(), state_dict)
    if missing:
        raise KeyError(f"clip: {len(missing)} missing keys, e.g. {missing[:3]}")
    model = model.to_empty(device=device)
    model.load_state_dict(found, strict=True)
    return CLIPFrameFeatures(model.eval().requires_grad_(False), device, clip_batch)


def load_metric_nets(weights_dir: Optional[str], device="cuda") -> Dict[str, Any]:
    """The ``runner.evaluate_pairs`` keyword arguments of the networks whose
    files exist under ``weights_dir`` (``{}`` for None or an empty
    directory), each on ``device``."""
    out: Dict[str, Any] = {}
    if not weights_dir:
        return out

    def path(name):
        p = os.path.join(weights_dir, name)
        return p if os.path.exists(p) else None

    if path(LPIPS_VGG) and path(LPIPS_LINS):
        from . import lpips

        out["lpips_model"] = lpips.from_torch(torch_load(path(LPIPS_VGG)),
                                              torch_load(path(LPIPS_LINS)), device)
    if path(FID_INCEPTION):
        from . import inception

        out["inception_model"] = inception.from_torch(torch_load(path(FID_INCEPTION)), device)
    if path(FVD_I3D):
        from . import i3d

        out["i3d_model"] = i3d.from_torch(torch_load(path(FVD_I3D)), device)
    if path(CLIP_VITL14):
        out["clip_apply"] = make_clip_apply(torch_load(path(CLIP_VITL14)), device)
    return out
