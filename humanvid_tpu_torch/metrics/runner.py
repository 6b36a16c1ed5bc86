"""Offline evaluation: pair generated and ground-truth videos, compute metrics.

The counterpart of ``humanvid_tpu/metrics/runner.py`` (the reference's
metric drivers):

- SSIM, PSNR, L1 and LPIPS per paired video over every
  ``frame_stride``-th frame (``metrics/metrics.py``);
- FID over up to 24 frames a clip, picked evenly
  (``np.linspace(0, n - 1, min(24, n))``), Inception features per clip;
- FVD over 24-frame clips at stride 3 (the first 24 frames where a clip is
  shorter than 72; clips under 24 frames are left out), 224 centre crops;
- CLIP frame consistency over every frame.

Where a pair's frame sizes differ, the ground truth is resized to the
generated size (``_align``) by ``data.video_io.resize_frames`` on uint8
frames: an antialiased bilinear ``F.interpolate`` rounded once, where the
JAX package uses PIL's BILINEAR, which rounds each of its two passes (the
two agree within one uint8 level, ``data/datasets.py``). A metric whose
network is not given is left out of the result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.video_io import read_frames, resize_frames
from .clip_sim import frame_consistency
from .frame import l1, psnr, ssim
from .frechet import frechet_from_features


@dataclasses.dataclass
class MetricsConfig:
    frame_stride: int = 1          # frame metrics' subsampling
    fid_frames_per_clip: int = 24
    fvd_clip_len: int = 24
    fvd_stride: int = 3
    lpips_batch: int = 8


def pair_videos(gen_dir: str, gt_dir: str, exts=(".mp4", ".avi", ".mkv")) -> List:
    """(name, generated path, ground-truth path) for every stem in both."""
    def stems(d):
        return {os.path.splitext(f)[0]: os.path.join(d, f)
                for f in sorted(os.listdir(d)) if os.path.splitext(f)[1] in exts}

    gen, gt = stems(gen_dir), stems(gt_dir)
    common = sorted(set(gen) & set(gt))
    if not common:
        raise ValueError(f"no paired videos between {gen_dir} and {gt_dir}")
    return [(k, gen[k], gt[k]) for k in common]


def _align(a: np.ndarray, b: np.ndarray) -> tuple:
    """Both clips cut to the shorter; ``b`` resized to ``a``'s frame size
    through uint8 where they differ."""
    n = min(a.shape[0], b.shape[0])
    a, b = a[:n], b[:n]
    if a.shape[1:3] != b.shape[1:3]:
        u8 = np.clip(b * 255.0 + 0.5, 0, 255).astype(np.uint8)
        b = resize_frames(u8, a.shape[2], a.shape[1]).astype(np.float32) / 255.0
    return a, b


METRIC_GROUPS = ("frame", "lpips", "fid", "fvd", "clip")


def evaluate_pairs(pairs: Sequence, config: MetricsConfig = MetricsConfig(),
                   lpips_model=None, inception_model=None, i3d_model=None, clip_apply=None,
                   groups: Optional[Sequence[str]] = None, device="cuda") -> Dict[str, float]:
    """Every available metric over (name, generated path, ground-truth
    path) pairs; ``groups`` restricts the run to some of
    :data:`METRIC_GROUPS` (so that groups can run, and be retried, apart).
    The frame metrics run on ``device``, each network on its own."""
    groups = set(METRIC_GROUPS if groups is None else groups)
    unknown = groups - set(METRIC_GROUPS)
    if unknown:
        raise ValueError(f"unknown metric groups: {sorted(unknown)}")
    results: Dict[str, List[float]] = {"ssim": [], "psnr": [], "l1": [], "lpips": [],
                                       "clip_sim": []}
    fid_gen, fid_gt, fvd_gen, fvd_gt = [], [], [], []

    for name, gen_path, gt_path in pairs:
        gen = read_frames(gen_path).astype(np.float32) / 255.0
        gt = read_frames(gt_path).astype(np.float32) / 255.0
        gen, gt = _align(gen, gt)
        sub_g, sub_t = gen[::config.frame_stride], gt[::config.frame_stride]

        if "frame" in groups:
            g = torch.from_numpy(np.ascontiguousarray(sub_g)).to(device)
            t = torch.from_numpy(np.ascontiguousarray(sub_t)).to(device)
            for key, fn in (("ssim", ssim), ("psnr", psnr), ("l1", l1)):
                results[key].append(float(fn(g, t).mean()))

        if lpips_model is not None and "lpips" in groups:
            from .lpips import lpips_distance

            results["lpips"].append(float(
                lpips_distance(lpips_model, sub_g, sub_t, config.lpips_batch).mean()))

        if inception_model is not None and "fid" in groups:
            k = config.fid_frames_per_clip
            idx = np.linspace(0, gen.shape[0] - 1, min(k, gen.shape[0])).astype(int)
            fid_gen.append(gen[idx])
            fid_gt.append(gt[idx])

        if i3d_model is not None and "fvd" in groups and gen.shape[0] >= config.fvd_clip_len:
            from .i3d import preprocess_video

            s = config.fvd_stride
            need = config.fvd_clip_len * s
            gsel = gen[:need:s] if gen.shape[0] >= need else gen[:config.fvd_clip_len]
            tsel = gt[:need:s] if gt.shape[0] >= need else gt[:config.fvd_clip_len]
            fvd_gen.append(preprocess_video(gsel))
            fvd_gt.append(preprocess_video(tsel))

        if clip_apply is not None and "clip" in groups:
            results["clip_sim"].append(frame_consistency(clip_apply(gen)))
        print(f"[metrics] {name} done ({'/'.join(sorted(groups))})", file=sys.stderr,
              flush=True)

    out = {k: float(np.mean(v)) for k, v in results.items() if v}
    out["num_videos"] = len(pairs)

    if inception_model is not None and fid_gen:
        from .inception import fid_features

        # per clip: the frame sizes follow each clip's orientation
        fg = [fid_features(inception_model, g) for g in fid_gen]
        ft = [fid_features(inception_model, t) for t in fid_gt]
        out["fid"] = frechet_from_features(fg, ft)

    if i3d_model is not None and fvd_gen:
        from .i3d import fvd_logits

        lg = fvd_logits(i3d_model, np.stack(fvd_gen))
        lt = fvd_logits(i3d_model, np.stack(fvd_gt))
        out["fvd"] = frechet_from_features([lg], [lt])
    return out


def evaluate_dirs(gen_dir: str, gt_dir: str, out_json: Optional[str] = None,
                  merge: bool = False, **kwargs) -> Dict[str, float]:
    """:func:`evaluate_pairs` over the paired videos of two directories;
    with ``merge=True`` the result is folded into an existing ``out_json``
    (runs of single groups accumulate into one record)."""
    result = evaluate_pairs(pair_videos(gen_dir, gt_dir), **kwargs)
    if out_json:
        if merge and os.path.exists(out_json):
            with open(out_json) as f:
                prior = json.load(f)
            prior.update(result)
            result = prior
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
