"""YOLOX person detector: the network, the letterbox, NMS and the box filter.

The counterpart of ``humanvid_tpu/pose/yolox.py``. The reference's DWPose
stage 1 is a YOLOX-L ONNX run by onnxruntime: a 640x640 letterbox padded
with 114, CSPDarknet-53 with a Focus stem, a PAFPN neck and decoupled heads,
a grid decode over strides 8/16/32, and a greedy NMS.

The modules' ``state_dict`` keys are the upstream YOLOX names
(``backbone.backbone.dark2.0.conv.weight``, ``head.cls_preds.0.weight``),
so a checkpoint loads with ``load_state_dict(strict=True)``; batch norm is
frozen (eps 1e-3, running statistics). Tensors are NCHW; the network eats
BGR in [0, 255], as upstream YOLOX does. ``letterbox`` resizes on the
frame's device; ``nms`` and ``postprocess_person`` run on the host in numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.nets import FrozenBatchNorm

STRIDES = (8, 16, 32)
INPUT_SIZE = 640
PAD_VALUE = 114.0


class BaseConv(nn.Module):
    """conv (no bias) -> frozen BN (eps 1e-3) -> SiLU."""

    def __init__(self, cin: int, cout: int, ksize: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Focus(nn.Module):
    """Space-to-depth 2x stem: (3, h, w) -> (12, h/2, w/2) -> conv; the
    quarters in the order top-left, bottom-left, top-right, bottom-right."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = BaseConv(cin * 4, cout, 3)

    def forward(self, x):
        tl, bl = x[..., ::2, ::2], x[..., 1::2, ::2]
        tr, br = x[..., ::2, 1::2], x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True):
        super().__init__()
        self.conv1 = BaseConv(cin, cout, 1)
        self.conv2 = BaseConv(cout, cout, 3)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        hidden = int(cout * 0.5)
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(cin, hidden, 1)
        self.conv3 = BaseConv(2 * hidden, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut) for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], dim=1))


class SPPBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, kernels: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        hidden = cin // 2
        self.conv1 = BaseConv(cin, hidden, 1)
        self.kernels = kernels
        self.conv2 = BaseConv(hidden * (len(kernels) + 1), cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in self.kernels]
        return self.conv2(torch.cat([x] + pools, dim=1))


class CSPDarknet(nn.Module):
    """``dep`` / ``wid`` 3 / 64 is the L config: blocks (3, 9, 9, 3),
    channels 64..1024."""

    def __init__(self, dep: int = 3, wid: int = 64):
        super().__init__()
        w, d = wid, dep
        self.stem = Focus(3, w)
        self.dark2 = nn.Sequential(BaseConv(w, w * 2, 3, 2), CSPLayer(w * 2, w * 2, d))
        self.dark3 = nn.Sequential(BaseConv(w * 2, w * 4, 3, 2), CSPLayer(w * 4, w * 4, d * 3))
        self.dark4 = nn.Sequential(BaseConv(w * 4, w * 8, 3, 2), CSPLayer(w * 8, w * 8, d * 3))
        self.dark5 = nn.Sequential(BaseConv(w * 8, w * 16, 3, 2), SPPBottleneck(w * 16, w * 16),
                                   CSPLayer(w * 16, w * 16, d, shortcut=False))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        return c3, c4, self.dark5(c4)


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    def __init__(self, dep: int = 3, wid: int = 64):
        super().__init__()
        w, d = wid, dep
        self.backbone = CSPDarknet(d, w)
        self.lateral_conv0 = BaseConv(w * 16, w * 8, 1)
        self.C3_p4 = CSPLayer(w * 16, w * 8, d, shortcut=False)
        self.reduce_conv1 = BaseConv(w * 8, w * 4, 1)
        self.C3_p3 = CSPLayer(w * 8, w * 4, d, shortcut=False)
        self.bu_conv2 = BaseConv(w * 4, w * 4, 3, 2)
        self.C3_n3 = CSPLayer(w * 8, w * 8, d, shortcut=False)
        self.bu_conv1 = BaseConv(w * 8, w * 8, 3, 2)
        self.C3_n4 = CSPLayer(w * 16, w * 16, d, shortcut=False)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        lat = self.lateral_conv0(c5)
        p4 = self.C3_p4(torch.cat([_upsample2(lat), c4], dim=1))
        red = self.reduce_conv1(p4)
        p3 = self.C3_p3(torch.cat([_upsample2(red), c3], dim=1))
        n3 = self.C3_n3(torch.cat([self.bu_conv2(p3), red], dim=1))
        n4 = self.C3_n4(torch.cat([self.bu_conv1(n3), lat], dim=1))
        return p3, n3, n4


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 80, wid: int = 64):
        super().__init__()
        w = wid * 4
        ins = (wid * 4, wid * 8, wid * 16)
        self.stems = nn.ModuleList(BaseConv(c, w, 1) for c in ins)
        self.cls_convs = nn.ModuleList(
            nn.Sequential(BaseConv(w, w, 3), BaseConv(w, w, 3)) for _ in ins)
        self.reg_convs = nn.ModuleList(
            nn.Sequential(BaseConv(w, w, 3), BaseConv(w, w, 3)) for _ in ins)
        self.cls_preds = nn.ModuleList(nn.Conv2d(w, num_classes, 1) for _ in ins)
        self.reg_preds = nn.ModuleList(nn.Conv2d(w, 4, 1) for _ in ins)
        self.obj_preds = nn.ModuleList(nn.Conv2d(w, 1, 1) for _ in ins)

    def forward(self, feats) -> List[torch.Tensor]:
        outs = []
        for i, f in enumerate(feats):
            x = self.stems[i](f)
            c = self.cls_convs[i](x)
            r = self.reg_convs[i](x)
            outs.append(torch.cat([self.reg_preds[i](r), self.obj_preds[i](r),
                                   self.cls_preds[i](c)], dim=1))
        return outs


class YOLOX(nn.Module):
    """(N, 3, 640, 640) letterboxed BGR -> (N, A, 5 + classes) decoded
    predictions in input pixels: (cx, cy, w, h, obj, cls...)."""

    def __init__(self, num_classes: int = 80, dep: int = 3, wid: int = 64):
        super().__init__()
        self.backbone = YOLOPAFPN(dep, wid)
        self.head = YOLOXHead(num_classes, wid)

    def forward(self, x):
        decoded = []
        for out, stride in zip(self.head(self.backbone(x)), STRIDES):
            n, c, h, w = out.shape
            gy, gx = torch.meshgrid(torch.arange(h, device=out.device),
                                    torch.arange(w, device=out.device), indexing="ij")
            grid = torch.stack([gx, gy], dim=-1).reshape(1, h * w, 2).to(out.dtype)
            flat = out.permute(0, 2, 3, 1).reshape(n, h * w, c)
            xy = (flat[..., :2] + grid) * stride
            wh = torch.exp(flat[..., 2:4]) * stride
            decoded.append(torch.cat([xy, wh, torch.sigmoid(flat[..., 4:])], dim=-1))
        return torch.cat(decoded, dim=1)


# ---------------------------------------------------------------------------
# pre and post processing
# ---------------------------------------------------------------------------

def letterbox(img: torch.Tensor, size: int = INPUT_SIZE) -> Tuple[torch.Tensor, float]:
    """BGR uint8 (H, W, 3) on any device -> (size, size, 3) float32 on the
    same device, and the scale ratio: the image resized by ``r`` (bilinear,
    pixel centres at half integers, no antialias, rounded to uint8 levels as
    OpenCV's ``INTER_LINEAR`` output is) at the top left, 114 elsewhere."""
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    x = img.permute(2, 0, 1)[None].float()
    resized = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                            antialias=False).round_().clamp_(0, 255)[0].permute(1, 2, 0)
    canvas = torch.full((size, size, 3), PAD_VALUE, dtype=torch.float32, device=img.device)
    canvas[:nh, :nw] = resized
    return canvas, r


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.45) -> List[int]:
    """Greedy IoU NMS over xyxy boxes, with the reference detector's "+1"
    pixel-area convention, so that borderline suppressions match."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= iou_thr]
    return keep


def postprocess_person(pred: np.ndarray, ratio: float, score_thr: float = 0.3,
                       iou_thr: float = 0.45) -> np.ndarray:
    """Decoded (A, 85) predictions -> (k, 5) person boxes, xyxy and score,
    in original-image pixels."""
    scores = pred[:, 4] * pred[:, 5]  # objectness * the person class
    mask = scores > score_thr
    if not mask.any():
        return np.zeros((0, 5), np.float32)
    sel, sc = pred[mask], scores[mask]
    cxy, wh = sel[:, :2], sel[:, 2:4]
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=-1) / ratio
    keep = nms(boxes, sc, iou_thr)
    return np.concatenate([boxes[keep], sc[keep, None]], axis=-1).astype(np.float32)
