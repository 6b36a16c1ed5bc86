"""DWPose wholebody detector: detection -> pose -> skeleton dict and canvas.

The counterpart of ``humanvid_tpu/pose/detector.py`` and the reference's
``DWposeDetector``: YOLOX-L person boxes (score > 0.5 after NMS, largest
first, at most ``num_people`` of them when it is positive), SimCC wholebody
keypoints for each box, the COCO-wholebody (133) -> OpenPose remap with a
neck joint made from the shoulders, confidence masking at 0.3, and the feet
extension (6 foot points drawn).

The networks run on the device their weights are on, in IEEE float32
(``metrics.nets.strict_fp32``: no TF32), as the JAX package and the
reference's onnxruntime run them; the letterbox and the crops are made on
that device, the NMS and the decode on the host. A frame's persons go
through the pose network as one batch.

COCO-wholebody layout: 0-16 body, 17-22 feet, 23-90 face, 91-111 left hand,
112-132 right hand.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.pose_draw import draw_pose
from ..metrics.nets import device_of, strict_fp32
from . import rtmpose, yolox
from .onnx_reader import read_onnx_initializers

# COCO(17) -> OpenPose(18) permutation; the neck (index 1) is made from the
# shoulder midpoint
_OPENPOSE_FROM_COCO = [0, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3]
CONF_THR = 0.3


def wholebody_to_openpose(kpts: np.ndarray, scores: np.ndarray) -> Dict:
    """(n, 133, 2) pixel keypoints and (n, 133) scores -> the pose dict, in
    pixels."""
    n = kpts.shape[0]
    bodies = np.zeros((n, 18, 2), np.float32)
    body_scores = np.zeros((n, 18), np.float32)
    for i, src in enumerate(_OPENPOSE_FROM_COCO):
        if src >= 0:
            bodies[:, i] = kpts[:, src]
            body_scores[:, i] = scores[:, src]
    bodies[:, 1] = (kpts[:, 5] + kpts[:, 6]) / 2.0  # neck
    body_scores[:, 1] = np.minimum(scores[:, 5], scores[:, 6])

    return {
        "bodies": bodies,
        "body_scores": body_scores,
        "feet": kpts[:, 17:23],
        "feet_scores": scores[:, 17:23],
        "faces": kpts[:, 23:91],
        "face_scores": scores[:, 23:91],
        "hands": np.concatenate([kpts[:, 91:112], kpts[:, 112:133]], axis=0),
        "hand_scores": np.concatenate([scores[:, 91:112], scores[:, 112:133]], axis=0),
    }


def to_draw_format(pose: Dict, width: int, height: int, conf_thr: float = CONF_THR) -> Dict:
    """Pixel pose dict -> normalized ``draw_pose`` inputs: body joints below
    the threshold get subset -1, the other groups' points coordinates -1."""
    wh = np.array([width, height], np.float32)
    n = pose["bodies"].shape[0]
    candidate = (pose["bodies"] / wh).reshape(-1, 2)
    subset = np.arange(n * 18, dtype=np.float32).reshape(n, 18)
    subset[pose["body_scores"] < conf_thr] = -1

    def masked(coords, scores):
        out = coords / wh
        out[scores < conf_thr] = -1
        return out

    return {
        "bodies": {"candidate": candidate, "subset": subset},
        "feet": masked(pose["feet"].copy(), pose["feet_scores"]),
        "faces": masked(pose["faces"].copy(), pose["face_scores"]),
        "hands": masked(pose["hands"].copy(), pose["hand_scores"]),
    }


class DWposeDetector:
    """RGB uint8 frame (H, W, 3) -> (skeleton canvas uint8, pose dict in
    pixels). ``det_model`` and ``pose_model`` hold their weights on the
    device the detector runs on; ``num_people`` < 0 keeps every detection
    (the reference's multi-person mode)."""

    def __init__(self, det_model: yolox.YOLOX, pose_model: rtmpose.DWPoseModel,
                 num_people: int = -1):
        self.det_model = det_model.eval()
        self.pose_model = pose_model.eval()
        self.num_people = num_people
        self.device = device_of(det_model)

    def _frame(self, frame_rgb) -> torch.Tensor:
        """The frame on the detector's device (a host array is uploaded)."""
        if isinstance(frame_rgb, torch.Tensor):
            return frame_rgb.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frame_rgb)).to(self.device)

    @torch.inference_mode()
    def detect_boxes(self, frame_rgb, score_thr: float = 0.5) -> np.ndarray:
        """Person boxes (k, 5), xyxy and score, largest first."""
        inp, ratio = yolox.letterbox(self._frame(frame_rgb).flip(-1))
        with strict_fp32():
            pred = self.det_model(inp.permute(2, 0, 1)[None]).float().cpu().numpy()[0]
        boxes = yolox.postprocess_person(pred, ratio, score_thr)
        if len(boxes):
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            boxes = boxes[np.argsort(areas)[::-1]]
        if self.num_people > 0:
            boxes = boxes[:self.num_people]
        return boxes

    @torch.inference_mode()
    def estimate_poses(self, frame_rgb, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n, 133, 2) keypoints in image pixels and (n, 133) scores."""
        if not len(boxes):
            return np.zeros((0, 133, 2), np.float32), np.zeros((0, 133), np.float32)
        bgr = self._frame(frame_rgb).flip(-1)
        crops, maps = [], []
        for box in boxes:
            center, scale = rtmpose.bbox_to_center_scale(box)
            crop, cs = rtmpose.crop_affine(bgr, center, scale)
            crops.append(rtmpose.normalize_crop(crop))
            maps.append(cs)
        with strict_fp32():
            xl, yl = self.pose_model(torch.stack(crops))
        kpts, scores = rtmpose.simcc_decode(xl.float().cpu().numpy(), yl.float().cpu().numpy())
        kpts = np.stack([rtmpose.crop_to_image(k, c, s) for k, (c, s) in zip(kpts, maps)])
        return kpts, scores

    def __call__(self, frame_rgb: np.ndarray) -> Tuple[np.ndarray, Dict]:
        h, w = frame_rgb.shape[:2]
        frame = self._frame(frame_rgb)
        boxes = self.detect_boxes(frame)
        kpts, scores = self.estimate_poses(frame, boxes)
        pose_px = wholebody_to_openpose(kpts, scores)
        canvas = draw_pose(to_draw_format(pose_px, w, h), h, w)
        return canvas, pose_px


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The weights of a ``.onnx`` file (its initializers) or a torch
    checkpoint (a state dict, or one under ``state_dict``), as arrays."""
    if path.endswith(".onnx"):
        return read_onnx_initializers(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    return {k: v.numpy() for k, v in sd.items()}


def load_module(module: torch.nn.Module, sd: Dict[str, np.ndarray], path: str = "") -> torch.nn.Module:
    """Load the entries of ``sd`` that ``module`` has (others, such as
    ``num_batches_tracked``, are dropped, as the JAX converters drop them)
    with ``strict=True``; raises naming the keys the file lacks, e.g. the
    batch norms of an ONNX export that folded them into the convs."""
    own = module.state_dict()
    found = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items() if k in own}
    missing = sorted(set(own) - set(found))
    if missing:
        raise KeyError(f"{path or 'the weights'} lack {len(missing)} of the "
                       f"{type(module).__name__}'s {len(own)} keys: {missing[:6]}")
    module.load_state_dict(found, strict=True)
    return module


def load_detector(yolox_path: Optional[str] = None, dwpose_path: Optional[str] = None,
                  num_people: int = -1, device=None) -> DWposeDetector:
    """A detector from YOLOX-L and DWPose checkpoint files (``.pth`` or
    ``.onnx`` in the upstream key layouts), on ``device`` (the CUDA card
    unless the caller passes another)."""
    from ..pipelines.system import resolve_device

    dev = resolve_device(device)

    def build(module, path):
        module = load_module(module, read_state_dict(path), path)
        module = module.to(dev).eval().requires_grad_(False)
        if dev.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        return module

    return DWposeDetector(build(yolox.YOLOX(), yolox_path),
                          build(rtmpose.DWPoseModel(), dwpose_path), num_people)
