"""DWPose wholebody pose estimator (RTMPose / SimCC) and its top-down crop.

The counterpart of ``humanvid_tpu/pose/rtmpose.py``. The reference's DWPose
stage 2 is the ``dw-ll_ucoco_384`` ONNX run on each person box: an affine
crop to 288x384, ImageNet normalization, and a SimCC decode (1-D x and y
classification at split ratio 2).

- backbone: CSPNeXt-l (a stem of three 3x3 convs; four stages of a stride-2
  conv and a CSP layer of depthwise-5x5 blocks with channel attention; SPP
  in the last);
- head: RTMCC, a 7x7 conv to K = 133 channels, ScaleNorm and a linear map
  to a 256-d token per keypoint, one gated attention unit (RoPE,
  squared-ReLU attention over the 133 tokens: plain matmuls, no softmax),
  then the SimCC classifiers over x (576 bins) and y (768 bins).

The ``state_dict`` keys are mmpose's (``backbone.stage1.1.blocks.0.conv2
.depthwise_conv.conv.weight``, ``head.mlp.1.weight``, ``head.gau.uv.weight``).
``crop_affine`` solves OpenCV's ``getAffineTransform`` in numpy and samples
with ``grid_sample`` on the frame's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.nets import FrozenBatchNorm

NUM_KEYPOINTS = 133
INPUT_W, INPUT_H = 288, 384
SIMCC_RATIO = 2.0
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


class ConvModule(nn.Module):
    """conv (no bias) -> frozen BN (eps 1e-5) -> SiLU."""

    def __init__(self, cin: int, cout: int, ksize: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2, groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-5)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DepthwiseSeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, ksize: int = 5):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, ksize, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, cin: int, cout: int, add_identity: bool = True):
        super().__init__()
        hidden = int(cout * 0.5)
        self.conv1 = ConvModule(cin, hidden, 3)
        self.conv2 = DepthwiseSeparableConv(hidden, cout, 5)
        self.add_identity = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class ChannelAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class CSPNeXtLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1, add_identity: bool = True):
        super().__init__()
        mid = int(cout * 0.5)
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, mid, add_identity) for _ in range(n)])
        self.attention = ChannelAttention(2 * mid)
        self.final_conv = ConvModule(2 * mid, cout, 1)

    def forward(self, x):
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], dim=1)
        return self.final_conv(self.attention(y))


class SPPBottleneck(nn.Module):
    """Three chained 5x5 max pools (the SPPF form)."""

    def __init__(self, cin: int, cout: int, kernel: int = 5):
        super().__init__()
        hidden = cin // 2
        self.conv1 = ConvModule(cin, hidden, 1)
        self.kernel = kernel
        self.conv2 = ConvModule(hidden * 4, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        k = self.kernel
        p1 = F.max_pool2d(x, k, 1, k // 2)
        p2 = F.max_pool2d(p1, k, 1, k // 2)
        p3 = F.max_pool2d(p2, k, 1, k // 2)
        return self.conv2(torch.cat([x, p1, p2, p3], dim=1))


class CSPNeXt(nn.Module):
    """The L config (widen 1.0, deepen 1.0); returns the stride-32 feature."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(ConvModule(3, 32, 3, 2), ConvModule(32, 32, 3, 1),
                                  ConvModule(32, 64, 3, 1))
        self.stage1 = nn.Sequential(ConvModule(64, 128, 3, 2), CSPNeXtLayer(128, 128, 3))
        self.stage2 = nn.Sequential(ConvModule(128, 256, 3, 2), CSPNeXtLayer(256, 256, 6))
        self.stage3 = nn.Sequential(ConvModule(256, 512, 3, 2), CSPNeXtLayer(512, 512, 6))
        self.stage4 = nn.Sequential(ConvModule(512, 1024, 3, 2), SPPBottleneck(1024, 1024),
                                    CSPNeXtLayer(1024, 1024, 3, add_identity=False))

    def forward(self, x):
        return self.stage4(self.stage3(self.stage2(self.stage1(self.stem(x)))))


class ScaleNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** -0.5
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp(min=1e-5) * self.g


def _rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over (B, N, D) tokens."""
    n, d = x.shape[-2:]
    half = d // 2
    inv = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    sin, cos = torch.sin(pos).to(x.dtype), torch.cos(pos).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class GAU(nn.Module):
    """Gated attention unit (RTMCCBlock): squared-ReLU attention and gating."""

    def __init__(self, dim: int = 256, expansion: int = 2, s: int = 128):
        super().__init__()
        self.e, self.s = dim * expansion, s
        self.ln = ScaleNorm(dim)
        self.uv = nn.Linear(dim, 2 * self.e + s, bias=False)
        self.gamma = nn.Parameter(torch.ones(2, s))
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.o = nn.Linear(self.e, dim, bias=False)

    def forward(self, x):
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = _rope(base * self.gamma[0] + self.beta[0])
        k = _rope(base * self.gamma[1] + self.beta[1])
        attn = F.relu(torch.bmm(q, k.transpose(1, 2)) / float(np.sqrt(np.float32(self.s)))) ** 2
        return self.o(u * torch.bmm(attn, v)) + x


class RTMCCHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.final_layer = nn.Conv2d(1024, NUM_KEYPOINTS, 7, padding=3)
        flat = (INPUT_H // 32) * (INPUT_W // 32)
        self.mlp = nn.Sequential(ScaleNorm(flat), nn.Linear(flat, 256, bias=False))
        self.gau = GAU()
        self.cls_x = nn.Linear(256, int(INPUT_W * SIMCC_RATIO))
        self.cls_y = nn.Linear(256, int(INPUT_H * SIMCC_RATIO))

    def forward(self, feat):
        tokens = self.final_layer(feat).flatten(2)  # (B, K, 12 * 9)
        tokens = self.gau(self.mlp(tokens))
        return self.cls_x(tokens), self.cls_y(tokens)


class DWPoseModel(nn.Module):
    """Normalized RGB crop (B, 3, 384, 288) -> SimCC logits (B, 133, 576),
    (B, 133, 768)."""

    def __init__(self):
        super().__init__()
        self.backbone = CSPNeXt()
        self.head = RTMCCHead()

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.head(self.backbone(x))


# ---------------------------------------------------------------------------
# top-down crop and decode
# ---------------------------------------------------------------------------

def bbox_to_center_scale(bbox: np.ndarray, padding: float = 1.25) -> Tuple:
    """xyxy -> (center, scale) with the model's aspect ratio enforced."""
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
    w, h = (x2 - x1) * padding, (y2 - y1) * padding
    aspect = INPUT_W / INPUT_H
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return center, np.array([w, h], np.float32)


def _affine_matrix(center: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """OpenCV's ``getAffineTransform`` of the three point pairs the JAX
    ``crop_affine`` passes it: the (2, 3) float64 map of image pixels to
    crop pixels, solved from float32 points."""
    src_w = scale[0]
    src = np.array([
        center,
        center + np.array([0, -src_w * 0.5 * INPUT_H / INPUT_W], np.float32),
        center + np.array([src_w * 0.5, 0], np.float32),
    ], np.float32).astype(np.float64)
    dst = np.array([
        [INPUT_W / 2, INPUT_H / 2],
        [INPUT_W / 2, INPUT_H / 2 - INPUT_W * 0.5 * INPUT_H / INPUT_W],
        [INPUT_W / 2 + INPUT_W * 0.5, INPUT_H / 2],
    ], np.float32).astype(np.float64)
    a = np.zeros((6, 6))
    a[0::2, 0:2], a[0::2, 2] = src, 1.0
    a[1::2, 3:5], a[1::2, 5] = src, 1.0
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's ``invertAffineTransform`` in float64, as ``warpAffine``
    computes it."""
    (a, b, c), (d, e, f) = m
    det = a * e - b * d
    det = 1.0 / det if det != 0 else 0.0
    a11, a12, a21, a22 = e * det, -b * det, -d * det, a * det
    return np.array([[a11, a12, -a11 * c - a12 * f], [a21, a22, -a21 * c - a22 * f]])


def _sample_grid(mat: np.ndarray, height: int, width: int, device) -> torch.Tensor:
    """The (1, INPUT_H, INPUT_W, 2) ``grid_sample`` grid of the crop: each
    crop pixel's source position under the inverse of ``mat``, unquantized
    (as OpenCV 5's ``warpAffine`` takes it, in float; OpenCV 4 rounded it
    to 1/32 pixel), normalized for ``align_corners=False``, where source
    pixel i's centre is at i as in OpenCV."""
    inv = torch.as_tensor(_invert_affine(mat), dtype=torch.float64, device=device)
    ys = torch.arange(INPUT_H, dtype=torch.float64, device=device)[:, None]
    xs = torch.arange(INPUT_W, dtype=torch.float64, device=device)[None, :]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    grid = torch.stack([(2 * sx + 1) / width - 1, (2 * sy + 1) / height - 1], dim=-1)
    return grid[None].float()


def crop_affine(img: torch.Tensor, center: np.ndarray, scale: np.ndarray) -> Tuple:
    """Warp the person region of a (H, W, 3) uint8 image (any device) to a
    (INPUT_H, INPUT_W, 3) uint8 crop on the same device: bilinear, zeros
    outside the image, rounded to uint8 levels as OpenCV's ``warpAffine``
    output is. Returns the crop and (center, scale) for the inverse map."""
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    grid = _sample_grid(_affine_matrix(center, scale), h, w, img.device)
    x = img.permute(2, 0, 1)[None].float()
    crop = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    crop = crop.round_().clamp_(0, 255)[0].permute(1, 2, 0).to(torch.uint8)
    return crop, (center, scale)


def normalize_crop(crop_bgr: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) BGR uint8 -> (3, H, W) normalized RGB float32."""
    rgb = crop_bgr.flip(-1).float()
    mean = torch.as_tensor(MEAN, device=rgb.device)
    std = torch.as_tensor(STD, device=rgb.device)
    return ((rgb - mean) / std).permute(2, 0, 1)


def simcc_decode(x_logits: np.ndarray, y_logits: np.ndarray) -> Tuple:
    """SimCC argmax decode -> keypoints (B, K, 2) in crop pixels and scores
    (B, K)."""
    xi = x_logits.argmax(axis=-1)
    yi = y_logits.argmax(axis=-1)
    sx = x_logits.max(axis=-1)
    sy = y_logits.max(axis=-1)
    scores = np.minimum(sx, sy)
    kpts = np.stack([xi / SIMCC_RATIO, yi / SIMCC_RATIO], axis=-1).astype(np.float32)
    kpts[scores <= 0] = -1
    return kpts, scores


def crop_to_image(kpts: np.ndarray, center: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Map crop-pixel keypoints back to original-image pixels."""
    return (kpts - np.array([INPUT_W / 2, INPUT_H / 2])) * \
        (scale / np.array([INPUT_W, INPUT_H])) + center
