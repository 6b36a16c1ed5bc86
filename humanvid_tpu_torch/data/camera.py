"""Camera trajectories and Plücker-ray embeddings (numpy).

TUM-format camera files (``t tx ty tz qx qy qz qw fx fy [scale]`` a line)
with the reference's per-source convention: world-to-camera for rendered
sources, camera-to-world (with an optional translation scale) for the
others, chosen by words in the file's path; the static-camera fallback (fx
1.0 / 1.788079 by orientation); relative poses with the first camera mapped
to identity; pixel intrinsics; and the per-pixel Plücker map ``[o x d, d]``
that conditions the camera encoder.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# pose-file path words that mark world-to-camera storage; the others are
# camera-to-world with an optional translation scale
W2C_SOURCES = ("bedlam", "blender", "ue_rendered")
C2W_SOURCES = ("pexels", "inference", "ubc", "tiktok", "webvid", "test")


def quaternion_to_rotation_matrix(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    return np.array([
        [1 - 2 * qy**2 - 2 * qz**2, 2 * qx * qy - 2 * qz * qw, 2 * qx * qz + 2 * qy * qw],
        [2 * qx * qy + 2 * qz * qw, 1 - 2 * qx**2 - 2 * qz**2, 2 * qy * qz - 2 * qx * qw],
        [2 * qx * qz - 2 * qy * qw, 2 * qy * qz + 2 * qx * qw, 1 - 2 * qx**2 - 2 * qy**2],
    ])


@dataclasses.dataclass
class Camera:
    """One TUM-format camera line: ``t tx ty tz qx qy qz qw fx fy [scale]``."""

    fx: float
    fy: float
    cx: float
    cy: float
    w2c: np.ndarray  # (4, 4)
    c2w: np.ndarray  # (4, 4)

    @classmethod
    def from_entry(cls, entry: Sequence[float], pose_file_name: str,
                   image_size: Tuple[int, int] = (1920, 1080)) -> "Camera":
        """``image_size`` is (width, height). Horizontal frames carry the
        normalized fx (entry[8]), vertical ones fy (entry[9]); the other
        focal follows from the aspect ratio. The convention comes from the
        source words in the whole lower-cased path, and a path with none of
        them raises."""
        if len(entry) not in (10, 11):
            raise ValueError(f"TUM entry must have 10 or 11 fields, got {len(entry)}")
        w, h = image_size
        if w > h:
            fx = entry[8]
            fy = fx * (w / h)
        else:
            fy = entry[9]
            fx = fy * (h / w)
        tx, ty, tz = entry[1:4]
        qx, qy, qz, qw = entry[4:8]
        scale = entry[10] if len(entry) == 11 else 1.0
        norm = float(np.linalg.norm([qx, qy, qz, qw]))
        if abs(norm - 1.0) > 1e-3:
            logger.warning("%s: quaternion not normalized (|q|=%.4f)", pose_file_name, norm)
        R = quaternion_to_rotation_matrix(*(v / norm for v in (qx, qy, qz, qw)))
        t = np.array([tx, ty, tz])

        name = pose_file_name.lower()
        if any(s in name for s in W2C_SOURCES):
            w2c = np.eye(4)
            w2c[:3, :3] = R
            w2c[:3, 3] = t
            c2w = np.linalg.inv(w2c)
        elif any(s in name for s in C2W_SOURCES):
            c2w = np.eye(4)
            c2w[:3, :3] = R
            c2w[:3, 3] = t * scale
            w2c = np.linalg.inv(c2w)
        else:
            raise ValueError(f"unknown camera pose source in file name: {pose_file_name}")
        return cls(fx=float(fx), fy=float(fy), cx=0.5, cy=0.5, w2c=w2c, c2w=c2w)


def load_cameras(pose_file: str, image_size: Tuple[int, int]) -> List[Camera]:
    with open(pose_file) as f:
        lines = [ln.strip().split(" ") for ln in f if ln.strip()]
    return [Camera.from_entry([float(x) for x in ln], pose_file, image_size) for ln in lines]


def static_camera(image_size: Tuple[int, int], video_length: int) -> List[Camera]:
    """Identity-pose cameras when no trajectory file exists; ``image_size``
    is (width, height)."""
    w, h = image_size
    if w > h:
        entry = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.788079, 1.0]
    else:
        entry = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.788079, 1.0, 1.0]
    return [Camera.from_entry(entry, "test", image_size)] * video_length


def get_relative_pose(cameras: Sequence[Camera], zero_t_first_frame: bool = True) -> np.ndarray:
    """c2w poses normalized so the first (reference) camera is identity."""
    source_c2w = cameras[0].c2w
    cam_to_origin = 0.0 if zero_t_first_frame else float(np.linalg.norm(source_c2w[:3, 3]))
    target_c2w = np.array([
        [1, 0, 0, 0],
        [0, 1, 0, -cam_to_origin],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], dtype=np.float64)
    abs2rel = target_c2w @ cameras[0].w2c
    poses = [target_c2w] + [abs2rel @ cam.c2w for cam in cameras[1:]]
    return np.asarray(poses, dtype=np.float32)


def intrinsics_vector(cameras: Sequence[Camera], image_size: Tuple[int, int]) -> np.ndarray:
    """(V, 4) pixel-unit [fx, fy, cx, cy] for each camera."""
    w, h = image_size
    return np.asarray(
        [[c.fx * w, c.fy * h, c.cx * w, c.cy * h] for c in cameras], dtype=np.float32
    )


def ray_condition(K: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """Per-pixel Plücker embedding ``[o x d, d]``: (V, H, W, 6) float32."""
    V = K.shape[0]
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    i = i.reshape(1, H * W) + 0.5  # x pixel coords
    j = j.reshape(1, H * W) + 0.5  # y pixel coords
    K = K.astype(np.float32)
    fx, fy, cx, cy = (K[:, k:k + 1] for k in range(4))  # (V, 1)
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    directions = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (V, HW, 3)
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    R = c2w[:, :3, :3].astype(np.float32)
    o = c2w[:, :3, 3].astype(np.float32)
    zero = np.zeros_like(o[:, 0])
    skew = np.stack([
        np.stack([zero, -o[:, 2], o[:, 1]], axis=-1),
        np.stack([o[:, 2], zero, -o[:, 0]], axis=-1),
        np.stack([-o[:, 1], o[:, 0], zero], axis=-1),
    ], axis=-2)  # (V, 3, 3) = skew(o): o x d = d @ skew(o)^T
    rt = np.swapaxes(R, -1, -2)
    m = np.concatenate([rt @ np.swapaxes(skew, -1, -2), rt], axis=-1)  # (V, 3, 6)
    plucker = directions @ m
    return plucker.reshape(V, H, W, 6).astype(np.float32)


def camera_file_for(pose_path: str) -> str:
    """The camera file of a pose video or image, by the reference's path
    substitution."""
    return (pose_path.replace("/dwpose/", "/camera/").replace("/pose_videos/", "/camera/")
            .replace(".mp4", ".txt").replace(".png", ".txt"))


def camera_file_to_plucker(pose_path: str, video_length: int, ref_idx: int,
                           tgt_indices: Sequence[int], image_size: Tuple[int, int],
                           is_same_video: bool = True) -> np.ndarray:
    """Plücker video (len(tgt_indices), H, W, 6) relative to the reference
    frame (``ref_idx``, or the first target where the reference image is
    not a frame of the same video), from the camera file found next to
    ``pose_path``, or the static camera where there is none."""
    camera_file = camera_file_for(pose_path)
    if os.path.exists(camera_file):
        cams = load_cameras(camera_file, image_size)
    else:
        logger.info("camera file not found (%s); using the static camera", camera_file)
        cams = static_camera(image_size, video_length)
    first = ref_idx if is_same_video else tgt_indices[0]
    sel = [cams[first]] + [cams[i] for i in tgt_indices]
    K = intrinsics_vector(sel[1:], image_size)
    c2w = get_relative_pose(sel)[1:]
    w, h = image_size
    return ray_condition(K, c2w, h, w)
