"""Training datasets (stage-1 images, stage-2 clips) and their preprocessing.

The counterpart of ``humanvid_tpu/data/datasets.py`` (the reference's
``dance_image_h_v_camera.py`` and ``dance_video_h_v_camera.py``):

- meta JSON entries ``{video_path, kps_path, start_frame, end_frame}`` split
  by orientation; a global index addresses the horizontal entries first;
- stage 1: a random reference frame and a target frame outside a
  ``sample_margin`` window around it;
- stage 2: ``n_sample_frames`` at a random stride in [2, sample_rate] (1
  where the segment is too short for 2), the reference frame outside the
  clip where there is room;
- one resize-and-crop decision a sample, shared by its image and pose
  frames: a cover resize scaled by a factor in ``img_scale``, then a centre
  crop to the orientation's size;
- target and reference in [-1, 1], pose in [0, 1], the CLIP crop of the
  reference frame CLIP-normalized, and Plücker rays from the camera file
  found by path substitution (``_camera_file``).

Each sample's randomness comes from one ``random.Random()`` (unseeded, as
the JAX package's), and ``_load(index, rng)`` makes the same calls on it in
the same order as the JAX package's, so both give the same frames and crop
for the same ``rng``. A sample that fails to load is logged and replaced by
another of the same orientation, at most ``max_retries`` times; no file is
written or removed. The resizes are PIL's (``BILINEAR`` for the frames,
``BICUBIC`` for the CLIP crop, both antialiased), done by ``F.interpolate``
on host tensors within one uint8 level of PIL's: the bilinear one in one
pass (PIL's two passes, each rounded to uint8, land up to 2 levels from
torch's two rounded passes at the 1024x576 -> 910x512 stage-2 resize, and
within 1 of one unrounded pass), the bicubic one in PIL's two passes with
the first rounded (which cuts the kernel's overshoot on sharp edges).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .camera import get_relative_pose, intrinsics_vector, load_cameras, ray_condition
from .video_io import read_frames, resize_frames

logger = logging.getLogger(__name__)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _camera_file(video_path: str) -> str:
    """A training clip's camera file (the pose clip's is ``camera.camera_file_for``)."""
    return (
        video_path.replace("/videos/", "/camera/")
        .replace("/mp4/", "/camera/")
        .replace(".mp4", ".txt")
    )


def random_resize_crop_params(
    rng: random.Random, src_hw: Tuple[int, int], dst_wh: Tuple[int, int],
    scale_range: Tuple[float, float] = (1.0, 1.1),
):
    """One (resize, crop) decision shared by all frames of a sample: an
    aspect-preserving cover resize scaled by a random factor, then a centre
    crop (the reference's ``RandomResizeCrop``; no squeeze and no random
    shift, so the rays' centred intrinsics stay on the pixels). Returns
    (new_w, new_h, x0, y0); raises where the aspect cannot cover ``dst_wh``."""
    scale = rng.uniform(*scale_range)
    h, w = src_hw
    dst_w, dst_h = dst_wh
    aspect = w / h
    if aspect < 1:  # portrait source
        new_w = int(dst_w * scale)
        new_h = int(new_w / aspect)
        if new_h < dst_h:
            new_h = dst_h
            new_w = int(new_h * aspect)
            if new_w < dst_w:
                raise ValueError(f"source aspect {aspect:.3f} cannot cover {dst_wh}")
    else:
        new_h = int(dst_h * scale)
        new_w = int(new_h * aspect)
        if new_w < dst_w:
            new_w = dst_w
            new_h = int(new_w / aspect)
            if new_h < dst_h:
                raise ValueError(f"source aspect {aspect:.3f} cannot cover {dst_wh}")
    x0 = (new_w - dst_w) // 2
    y0 = (new_h - dst_h) // 2
    return (new_w, new_h, x0, y0)


def apply_resize_crop(frames: np.ndarray, params, dst_wh: Tuple[int, int]) -> np.ndarray:
    """(f, H, W, 3) uint8 -> (f, dst_h, dst_w, 3) uint8 by the shared resize
    (PIL ``BILINEAR``, antialiased) and crop."""
    rw, rh, x0, y0 = params
    dst_w, dst_h = dst_wh
    return resize_frames(frames, rw, rh)[:, y0:y0 + dst_h, x0:x0 + dst_w]


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


def clip_preprocess_np(image: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) -> CLIP-normalized float32 (size, size, 3), as
    ``transformers.CLIPImageProcessor()`` prepares the reference frame."""
    return (clip_crop_raw(image, size) - CLIP_MEAN) / CLIP_STD


@dataclasses.dataclass
class DatasetConfig:
    train_size_large: int = 896
    train_size_small: int = 512
    img_scale: Tuple[float, float] = (1.0, 1.1)
    sample_margin: int = 30          # stage 1
    n_sample_frames: int = 24        # stage 2
    sample_rate: int = 4             # stage 2 max stride
    clip_size: int = 224
    max_retries: int = 16


class _MetaIndexed:
    """Meta loading, orientation-aware indexing and the bounded resampling
    of broken samples."""

    def __init__(self, horizontal_meta: Sequence[str], vertical_meta: Sequence[str],
                 config: DatasetConfig):
        self.config = config
        self.horizontal: List[dict] = []
        self.vertical: List[dict] = []
        for metas, paths in ((self.horizontal, horizontal_meta), (self.vertical, vertical_meta)):
            for p in paths:
                if p:
                    with open(p) as f:
                        metas.extend(json.load(f))

    def __len__(self) -> int:
        return len(self.horizontal) + len(self.vertical)

    @property
    def num_horizontal(self) -> int:
        return len(self.horizontal)

    def meta_at(self, index: int) -> dict:
        if index < len(self.horizontal):
            return self.horizontal[index]
        return self.vertical[index - len(self.horizontal)]

    def resample_index(self, rng: random.Random, index: int) -> int:
        if index < len(self.horizontal):
            return rng.randrange(len(self.horizontal))
        return len(self.horizontal) + rng.randrange(len(self.vertical))

    def _img_size(self, w: int, h: int) -> Tuple[int, int]:
        c = self.config
        return ((c.train_size_large, c.train_size_small) if w > h
                else (c.train_size_small, c.train_size_large))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = random.Random()
        for _ in range(self.config.max_retries):
            try:
                return self._load(index, rng)
            except Exception as e:  # noqa: BLE001 — resample on any IO or shape error
                logger.warning("bad sample %d (%s); resampling", index, e)
                index = self.resample_index(rng, index)
        raise RuntimeError("too many consecutive broken samples")

    def _load(self, index: int, rng: random.Random) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _sample(self, video_path: str, img_size: Tuple[int, int], rc, tgt_frames, ref_img,
                pose_frames, cam_indices: List[int]) -> Dict[str, np.ndarray]:
        """The normalized sample: resized target, reference and pose frames,
        the CLIP crop of the reference frame, and the Plücker rays of the
        targets' cameras relative to the reference's (``cam_indices[0]``)."""
        cfg = self.config
        tgt = apply_resize_crop(tgt_frames, rc, img_size)
        ref = apply_resize_crop(ref_img[None], rc, img_size)[0]
        pose = apply_resize_crop(pose_frames, rc, img_size)
        cams = load_cameras(_camera_file(video_path), img_size)
        sel = [cams[i] for i in cam_indices]
        K = intrinsics_vector(sel[1:], img_size)
        c2w = get_relative_pose(sel)[1:]
        return {
            "tgt": tgt.astype(np.float32) / 127.5 - 1.0,
            "ref": ref.astype(np.float32) / 127.5 - 1.0,
            "clip": clip_preprocess_np(ref_img, cfg.clip_size),
            "pose": pose.astype(np.float32) / 255.0,
            "plucker": ray_condition(K, c2w, img_size[1], img_size[0]),
        }


class HumanDanceCameraImageDataset(_MetaIndexed):
    """Stage-1 samples: {tgt, ref, clip, pose, plucker}, one frame each."""

    def _load(self, index: int, rng: random.Random) -> Dict[str, np.ndarray]:
        cfg = self.config
        meta = self.meta_at(index)
        video_path, kps_path = meta["video_path"], meta["kps_path"]
        start, end = meta["start_frame"], meta["end_frame"]
        segment = end - start

        ref_idx = rng.randint(start, end - 1)
        margin = min(cfg.sample_margin, segment)
        lo, hi = max(start, ref_idx - margin), min(end - 1, ref_idx + margin)
        valid = [i for i in range(start, end) if not (lo <= i <= hi)]
        tgt_idx = rng.choice(valid) if valid else rng.randint(start, end - 1)

        frames = read_frames(video_path, indices=[ref_idx, tgt_idx])
        ref_img, tgt_img = frames[0], frames[1]
        pose_img = read_frames(kps_path, indices=[tgt_idx])[0]

        h, w = tgt_img.shape[:2]
        img_size = self._img_size(w, h)  # (W, H)
        rc = random_resize_crop_params(rng, (h, w), img_size, cfg.img_scale)
        sample = self._sample(video_path, img_size, rc, tgt_img[None], ref_img,
                              pose_img[None], [ref_idx, tgt_idx])
        return {k: v[0] if k in ("tgt", "pose", "plucker") else v for k, v in sample.items()}


class HumanDanceCameraVideoDataset(_MetaIndexed):
    """Stage-2 samples: {tgt (f, ...), ref, clip, pose (f, ...), plucker (f, ...)}."""

    def _load(self, index: int, rng: random.Random) -> Dict[str, np.ndarray]:
        cfg = self.config
        meta = self.meta_at(index)
        video_path, kps_path = meta["video_path"], meta["kps_path"]
        start, end = meta["start_frame"], meta["end_frame"]
        n = cfg.n_sample_frames

        # a random stride in [2, min(max_rate, sample_rate)], or a contiguous
        # stride-1 clip where the segment is too short for 2
        segment = end - start
        max_rate = (segment - 1) // max(n - 1, 1)
        if max_rate > 1:
            stride = rng.randint(2, max(2, min(max_rate, cfg.sample_rate)))
        else:
            stride = 1
        span = (n - 1) * stride + 1
        if span > segment:
            raise ValueError(f"segment {segment} too short for {n} frames")
        clip_start = rng.randint(start, end - span)
        tgt_indices = [clip_start + i * stride for i in range(n)]

        outside = [i for i in range(start, end)
                   if i < tgt_indices[0] or i > tgt_indices[-1]]
        ref_idx = rng.choice(outside) if outside else rng.randint(start, end - 1)

        tgt_frames = read_frames(video_path, indices=tgt_indices)
        ref_img = read_frames(video_path, indices=[ref_idx])[0]
        pose_frames = read_frames(kps_path, indices=tgt_indices)

        h, w = tgt_frames.shape[1:3]
        img_size = self._img_size(w, h)
        rc = random_resize_crop_params(rng, (h, w), img_size, cfg.img_scale)
        return self._sample(video_path, img_size, rc, tgt_frames, ref_img, pose_frames,
                            [ref_idx] + tgt_indices)
