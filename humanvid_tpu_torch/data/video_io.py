"""Host-side video IO, and frame resizing through torch.

``read_frames``, ``get_fps``, ``get_frame_count``, ``save_video``,
``save_videos_grid`` (orientation aware) and ``write_image``. Arrays are
(f, H, W, 3) RGB uint8, or float in [0, 1] where saved (truncated to uint8,
as the reference's scripts do). Videos go through the native libav core
(``data.native_video``: exact frame indexing, x264 at crf 19) where it
builds and loads, as in the JAX package's facade, and through OpenCV
otherwise (mp4v); images through OpenCV. Both are loaded where they are
used, so the module imports without either. ``resize_frames`` is the antialiased bilinear
resize of the reference's inference scripts (PIL ``BILINEAR``), done by
``F.interpolate`` on host tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _cv2():
    import cv2

    return cv2


def _native():
    """The native libav backend module, or None where it cannot build or
    load."""
    from ..native import available

    if available():
        from . import native_video
        return native_video
    return None


def get_fps(path: str) -> float:
    nv = _native()
    if nv is not None:
        with nv.VideoReader(path) as r:
            return r.fps or 24.0
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        return float(cap.get(cv2.CAP_PROP_FPS)) or 24.0
    finally:
        cap.release()


def get_frame_count(path: str) -> int:
    nv = _native()
    if nv is not None:
        with nv.VideoReader(path) as r:
            return len(r)
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def read_frames(path: str, indices: Optional[Sequence[int]] = None,
                max_frames: Optional[int] = None) -> np.ndarray:
    """Decode frames as (f, H, W, 3) RGB uint8: all of them (up to
    ``max_frames``) in order, or those at ``indices`` (decoded in sorted
    order, seeking only where a frame is not the next one)."""
    nv = _native()
    if nv is not None:
        with nv.VideoReader(path) as r:
            return r.get_batch(indices) if indices is not None else r.read_all(max_frames)
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        frames: List[np.ndarray] = []
        if indices is None:
            while max_frames is None or len(frames) < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        else:
            decoded = {}
            pos = -1
            for idx in sorted(int(i) for i in set(indices)):
                if idx != pos + 1:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                pos = idx
                if not ok:
                    raise IOError(f"frame {idx} unreadable in {path}")
                decoded[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames = [decoded[int(i)] for i in indices]
        return np.stack(frames)
    finally:
        cap.release()


def _uint8(frames: np.ndarray) -> np.ndarray:
    if frames.dtype == np.uint8:
        return frames
    return (np.clip(frames, 0, 1) * 255).astype(np.uint8)


def save_video(frames: np.ndarray, path: str, fps: float = 24.0) -> None:
    """(f, H, W, 3) RGB uint8 or float in [0, 1] -> an mp4 (native x264 at
    crf 19, as the reference saves; OpenCV mp4v where the native core is
    unavailable)."""
    frames = _uint8(frames)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames.shape[1:3]
    nv = _native()
    if nv is not None:
        with nv.VideoWriter(path, w, h, fps=fps) as writer:
            writer.write(frames)
        return
    cv2 = _cv2()
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def write_image(path: str, image: np.ndarray) -> None:
    """(H, W, 3) RGB uint8 or float in [0, 1] -> an image file (OpenCV;
    the format from the extension)."""
    cv2 = _cv2()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not cv2.imwrite(path, cv2.cvtColor(_uint8(image), cv2.COLOR_RGB2BGR)):
        raise IOError(f"cannot write image: {path}")


def videos_grid(videos: Sequence[np.ndarray]) -> np.ndarray:
    """Ref / pose / output (/ gt) clips side by side where they are
    vertical, stacked where they are not, as uint8."""
    videos = [_uint8(v) for v in videos]
    h, w = videos[0].shape[1:3]
    return np.concatenate(videos, axis=2 if h > w else 1)


def save_videos_grid(videos: Sequence[np.ndarray], path: str, fps: float = 24.0) -> None:
    save_video(videos_grid(videos), path, fps)


def resize_frames(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    """(f, H, W, 3) uint8 -> (f, height, width, 3) uint8 by the antialiased
    bilinear resize (PIL's ``BILINEAR``, which the reference's scripts use
    through torchvision; OpenCV's is not antialiased)."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode="bilinear", antialias=True,
                      align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
