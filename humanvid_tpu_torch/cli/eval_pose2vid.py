"""Stage-2 quantitative evaluation: generate the test clips, then score them.

    python -m humanvid_tpu_torch.cli.eval_pose2vid --config configs/prompts/stage2.yaml \\
        --test_meta test_meta.json --run_metrics --metric_weights DIR

The counterpart of ``scripts/eval_pose2vid.py`` (the reference's protocol).
For each entry ``{video_path, kps_path, start_frame, end_frame}`` of the
test meta JSON: -L frames at ``--stride`` from ``start_frame`` (the stride
reduced for a segment too short for it, never clamped into a repeated
tail), the reference image the middle one of them, the output size -W x -H
by the clip's orientation (-W/-H as the short and long sides), the camera
from the clip's TUM file (``/videos/`` -> ``/camera/``, ``.mp4`` ->
``.txt``; the static camera where there is none), relative to the
reference frame. The generated clip goes to ``output_dir/gen/<name>.mp4``
and the resized ground truth to ``output_dir/gt/<name>.mp4``, at 8 fps.

``--run_metrics`` then scores the two directories (``metrics/runner.py``)
into ``output_dir/metrics.json``: SSIM, PSNR and L1 always, LPIPS, FID, FVD
and CLIP consistency where ``--metric_weights`` holds their networks.
``--metrics_only`` skips generation; ``--metrics_subset frame,lpips`` runs
some groups and merges them into ``metrics.json``. The system comes from
the config as in ``cli/pose2vid.py`` (``model: tiny`` for the small test
topology); the noise from one ``torch.Generator`` seeded by ``--seed``. Runs
on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.camera import (get_relative_pose, intrinsics_vector, load_cameras, ray_condition,
                           static_camera)
from ..data.datasets import _camera_file, clip_crop_raw
from ..data.video_io import read_frames, resize_frames, save_video
from ..pipelines import Pose2VideoPipeline
from ..utils.config import load_config
from .pose2vid import DTYPES, build_system, oriented_size


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--test_meta", required=True)
    p.add_argument("-W", type=int, default=512)
    p.add_argument("-H", type=int, default=896)
    p.add_argument("-L", type=int, default=24)
    p.add_argument("--stride", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--output_dir", default="./output/eval_pose2vid")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--run_metrics", action="store_true",
                   help="run the metrics over the gen/gt directories after generation")
    p.add_argument("--metrics_only", action="store_true",
                   help="skip generation and score an existing output_dir")
    p.add_argument("--metrics_subset", default=None,
                   help="comma list of metric groups (frame,lpips,fid,fvd,clip) to compute; "
                        "the results merge into metrics.json")
    p.add_argument("--metric_weights", default=None,
                   help="directory of metric-network torch checkpoints (metrics/weights.py "
                        "layout); enables LPIPS, FID, FVD and CLIP consistency")
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


def eval_plucker(video_path: str, ref_idx: int, tgt_idx: Sequence[int],
                 size: Tuple[int, int]) -> np.ndarray:
    """(len(tgt_idx), H, W, 6) rays of the target frames relative to the
    reference frame, from the clip's camera file or the static camera."""
    cam_file = _camera_file(video_path)
    if os.path.exists(cam_file):
        cams = load_cameras(cam_file, size)
    else:
        cams = static_camera(size, max(max(tgt_idx), ref_idx) + 1)
    sel = [cams[ref_idx]] + [cams[i] for i in tgt_idx]
    W, H = size
    return ray_condition(intrinsics_vector(sel[1:], size), get_relative_pose(sel)[1:], H, W)


class Clip(NamedTuple):
    name: str
    tgt_idx: List[int]
    stride: int
    ref_idx: int
    gt: np.ndarray         # (L, H, W, 3) float32 in [0, 1]
    ref: np.ndarray        # (H, W, 3)
    pose: np.ndarray       # (L, H, W, 3)
    plucker: np.ndarray    # (L, H, W, 6)
    clip_image: np.ndarray  # (S, S, 3) CLIP crop of the reference frame, in [0, 1]


def prepare_clip(entry: Dict[str, Any], args: argparse.Namespace, clip_size: int) -> Clip:
    """One test entry's pipeline inputs and ground truth."""
    video_path, kps_path = entry["video_path"], entry["kps_path"]
    start, end = entry.get("start_frame", 0), entry["end_frame"]
    stride = min(args.stride, max(1, (end - start - 1) // max(args.L - 1, 1)))
    tgt_idx = [min(start + i * stride, end - 1) for i in range(args.L)]
    ref_idx = tgt_idx[len(tgt_idx) // 2]

    gt_frames = read_frames(video_path, indices=tgt_idx)
    ref_raw = read_frames(video_path, indices=[ref_idx])[0]
    pose_frames = read_frames(kps_path, indices=tgt_idx)
    W, H = oriented_size(gt_frames.shape[1:3], args)

    def resized(frames):
        return resize_frames(frames, W, H).astype(np.float32) / 255.0

    return Clip(name=os.path.splitext(os.path.basename(video_path))[0], tgt_idx=tgt_idx,
                stride=stride, ref_idx=ref_idx, gt=resized(gt_frames),
                ref=resized(ref_raw[None])[0], pose=resized(pose_frames),
                plucker=eval_plucker(video_path, ref_idx, tgt_idx, (W, H)),
                clip_image=clip_crop_raw(ref_raw, clip_size))


def run_metrics(args: argparse.Namespace) -> Dict[str, float]:
    from ..metrics.runner import evaluate_dirs
    from ..metrics.weights import load_metric_nets

    groups = args.metrics_subset.split(",") if args.metrics_subset else None
    result = evaluate_dirs(
        os.path.join(args.output_dir, "gen"), os.path.join(args.output_dir, "gt"),
        out_json=os.path.join(args.output_dir, "metrics.json"), merge=groups is not None,
        groups=groups, device=args.device, **load_metric_nets(args.metric_weights, args.device))
    print("metrics:", result)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Returns ``{"clips": [{"name", "seconds"}, ...], "metrics": {...}}``
    (the pipeline's phase seconds of each generated clip; the metrics where
    they ran)."""
    args = parse_args(argv)
    done: Dict[str, Any] = {"clips": [], "metrics": None}
    if args.metrics_only:
        done["metrics"] = run_metrics(args)
        return done
    system = build_system(load_config(args.config), DTYPES[args.dtype], args.device)
    pipe = Pose2VideoPipeline(system)
    with open(args.test_meta) as f:
        meta = json.load(f)
    gen_dir, gt_dir = (os.path.join(args.output_dir, d) for d in ("gen", "gt"))
    os.makedirs(gen_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    generator = torch.Generator(device=system.device).manual_seed(args.seed)
    for entry in meta:
        clip = prepare_clip(entry, args, system.config.clip.image_size)
        out = pipe(clip.ref, clip.pose, clip.plucker, clip.clip_image,
                   num_inference_steps=args.steps, guidance_scale=args.cfg, generator=generator)
        save_video(out.videos[0], os.path.join(gen_dir, f"{clip.name}.mp4"), fps=8.0)
        save_video(clip.gt, os.path.join(gt_dir, f"{clip.name}.mp4"), fps=8.0)
        done["clips"].append({"name": clip.name, "seconds": out.seconds})
        print(f"generated {clip.name}.mp4 ({args.L} frames)")
    if args.run_metrics:
        done["metrics"] = run_metrics(args)
    return done


if __name__ == "__main__":
    main()
