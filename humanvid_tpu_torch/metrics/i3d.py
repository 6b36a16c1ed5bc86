"""I3D (Inflated Inception-V1) video features for FVD.

The counterpart of ``humanvid_tpu/metrics/i3d.py``: the standard I3D
topology (Carreira and Zisserman 2017) with styleganv's FVD head (a spatial
mean, the ``logits`` convolution with its bias and no batch norm, then the
mean over time: 400 logits a clip), and its preprocessing (the short side
to 224 by a bilinear resize without antialiasing, the long side rounded up,
a centre crop, [0, 1] -> [-1, 1]).

Padding is TensorFlow's SAME, as flax's ``padding="SAME"`` convolutions and
``reduce_window(..., "SAME")`` pools compute it: per dimension ``total =
max((ceil(n / s) - 1) * s + k - n, 0)``, ``total // 2`` before and the rest
after (asymmetric at stride 2), zeros for the convolutions and -inf for the
max pools, applied by ``F.pad`` before an unpadded convolution or pool.

State-dict keys: ``Mixed_3b.b1a.conv3d.weight``, ``....bn.running_var``,
``logits.conv3d.bias``; ``from_torch`` loads them with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Any, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nets import FrozenBatchNorm, device_of, load_frozen, run_batched

Triple = Tuple[int, int, int]


def same_pads(sizes: Sequence[int], window: Sequence[int], stride: Sequence[int]) -> List[int]:
    """``F.pad``'s list (last dimension first) of TF-SAME padding."""
    pads: List[int] = []
    for n, k, s in reversed(list(zip(sizes, window, stride))):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def max_pool_same(x: torch.Tensor, window: Triple, stride: Triple) -> torch.Tensor:
    """TF-SAME max pool over (t, h, w) of an NCDHW tensor."""
    x = F.pad(x, same_pads(x.shape[2:], window, stride), value=-math.inf)
    return F.max_pool3d(x, window, stride)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Triple = (1, 1, 1),
                 stride: Triple = (1, 1, 1), use_bn: bool = True, activation: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = kernel, stride, activation
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=use_bias)
        self.bn = FrozenBatchNorm(cout, eps=0.001) if use_bn else None

    def forward(self, x):
        pads = same_pads(x.shape[2:], self.kernel, self.stride)
        if any(pads):
            x = F.pad(x, pads)
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, cin: int, c: Sequence[int]):  # c: [b0, b1a, b1b, b2a, b2b, b3]
        super().__init__()
        self.b0 = Unit3D(cin, c[0])
        self.b1a = Unit3D(cin, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(cin, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(cin, c[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


# (name, input channels, [b0, b1a, b1b, b2a, b2b, b3])
_MIXED = (
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
)
# max pools (window, stride) taken before these modules
_POOL_BEFORE = {"Mixed_4b": ((3, 3, 3), (2, 2, 2)), "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class I3D(nn.Module):
    """NCDHW video in [-1, 1] -> (n, num_classes) logits."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, cin, c in _MIXED:
            self.add_module(name, InceptionModule(cin, c))
        self.logits = Unit3D(1024, num_classes, use_bn=False, activation=False, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_same(self.Conv3d_1a_7x7(x), (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for name, _, _ in _MIXED:
            if name in _POOL_BEFORE:
                x = max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        x = self.logits(x.mean(dim=(3, 4), keepdim=True))  # (n, classes, t, 1, 1)
        return x.mean(dim=(2, 3, 4))


def preprocess_video(video: np.ndarray, size: int = 224) -> np.ndarray:
    """(f, H, W, 3) [0, 1] -> (f, size, size, 3) [-1, 1] float32: the short
    side to ``size`` (the long side rounded up) by a bilinear resize
    without antialiasing, then a centre crop."""
    f, h, w, _ = video.shape
    scale = size / min(h, w)
    nh, nw = (size, math.ceil(w * scale)) if h < w else (math.ceil(h * scale), size)
    x = torch.from_numpy(np.ascontiguousarray(video, dtype=np.float32)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top:top + size, left:left + size]
    return x.permute(0, 2, 3, 1).numpy() * 2.0 - 1.0


def from_torch(state_dict: Mapping[str, Any], device="cpu") -> I3D:
    """A torch I3D state dict in this module's key layout -> the network on
    ``device``."""
    return load_frozen(I3D(), state_dict).to(device)


def fvd_logits(model: I3D, videos: np.ndarray, batch: int = 2, device=None) -> np.ndarray:
    """(n, f, 224, 224, 3) in [-1, 1] -> (n, 400) logits, ``batch`` clips a
    call on ``device`` (the model's by default)."""
    return run_batched(lambda v: model(v.permute(0, 4, 1, 2, 3)), (videos,), batch,
                       device or device_of(model))
