"""SMPL-X 2D keypoints -> COCO-wholebody -> skeleton video (the UE path).

The counterpart of ``humanvid_tpu/pose/smplx.py``: UE-rendered clips ship
SMPL-X 2D keypoints (``.npz``) in place of running DWPose; they are remapped
to COCO-wholebody (133) and drawn in the canvas format the PoseGuider was
trained on, with stroke widths scaled by ``max(H, W) / 1920``.

The index table is the public SMPL-X joint layout (55 body joints, hand tips
66-75, 51 face landmarks 76-126, 17 face contour points 127-143).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.pose_draw import draw_pose
from .detector import to_draw_format, wholebody_to_openpose

# COCO body17 from SMPL-X joints
_BODY17 = [55, 57, 56, 59, 58, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
# feet: big toe / small toe / heel, left then right
_FEET6 = [60, 61, 62, 63, 64, 65]
# face68 = 17 contour (127-143) + 51 inner landmarks (76-126)
_FACE68 = list(range(127, 144)) + list(range(76, 127))
# openpose hand order: wrist, thumb(3+tip), index, middle, ring, pinky
_LHAND21 = [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68,
            34, 35, 36, 69, 31, 32, 33, 70]
_RHAND21 = [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,
            49, 50, 51, 74, 46, 47, 48, 75]

SMPLX_TO_COCO_WHOLEBODY = np.array(
    _BODY17 + _FEET6 + _FACE68 + _LHAND21 + _RHAND21, np.int64
)
assert SMPLX_TO_COCO_WHOLEBODY.shape[0] == 133


def smplx_to_coco_wholebody(
    smplx_kpts: np.ndarray, smplx_conf: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(n, >=144, 2) SMPL-X 2D joints -> (n, 133, 2) + scores (n, 133)."""
    kpts = np.asarray(smplx_kpts, np.float32)
    if kpts.ndim == 2:
        kpts = kpts[None]
    sel = kpts[:, SMPLX_TO_COCO_WHOLEBODY]
    if smplx_conf is not None:
        conf = np.asarray(smplx_conf, np.float32)
        if conf.ndim == 1:
            conf = conf[None]
        scores = conf[:, SMPLX_TO_COCO_WHOLEBODY]
    else:
        # visible = inside the frame with finite coords
        scores = np.isfinite(sel).all(-1).astype(np.float32)
    return sel, scores


def render_frame(kpts133: np.ndarray, scores: np.ndarray,
                 width: int, height: int) -> np.ndarray:
    """One frame of COCO-wholebody poses -> skeleton canvas (H, W, 3) uint8.

    UE-prep stroke scaling: ``max(H, W) / 1920``
    (DWPose/dwpose_utils/smplx2openpose.py:21-25).
    """
    pose_px = wholebody_to_openpose(kpts133, scores)
    return draw_pose(to_draw_format(pose_px, width, height), height, width,
                     scale=max(height, width) / 1920.0)


def visualize_video(
    smplx_npz_path: str, out_path: str, width: int, height: int,
    fps: float = 24.0, kpts_key: str = "keypoints",
) -> int:
    """SMPL-X keypoint .npz -> DWPose-style skeleton mp4; returns frame count
    (reference ``smplx2openpose.visualizeVideo:96``)."""
    from ..data.video_io import save_video

    data = np.load(smplx_npz_path, allow_pickle=True)
    kpts = np.asarray(data[kpts_key], np.float32)  # (f, J, 2) or (f, P, J, 2)
    conf = np.asarray(data["confidence"], np.float32) if "confidence" in data else None
    if kpts.ndim == 3:
        kpts = kpts[:, None]  # single person axis
        conf = conf[:, None] if conf is not None else None

    frames = []
    for t in range(kpts.shape[0]):
        k133, s133 = smplx_to_coco_wholebody(
            kpts[t], conf[t] if conf is not None else None)
        frames.append(render_frame(k133, s133, width, height))
    save_video(np.stack(frames), out_path, fps=fps)
    return len(frames)
