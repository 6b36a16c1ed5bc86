"""Stage-1 quantitative evaluation: pose2img over test videos, scored inline.

    python -m humanvid_tpu_torch.cli.eval_pose2img --config configs/prompts/stage2.yaml \\
        --test_meta test_meta.json --lpips_weights lpips.msgpack

The counterpart of ``scripts/eval_pose2img.py``. For each entry
``{video_path, kps_path, start_frame, end_frame}`` of the test meta JSON:
the reference image is frame ``start_frame`` and the target the frame
``--eval_distance`` later (held inside the segment), the pose image the
pose clip's target frame, the output size -W x -H by the orientation, the
camera from the clip's TUM file (the static camera where there is none).
Each of ``--repeat`` samples is scored against the target frame: SSIM,
PSNR, L1, and LPIPS where ``--lpips_weights`` names the JAX package's flax
``.msgpack`` of its LPIPS variables (read without flax,
``utils/msgpack.py``); a ref | pose | output | target PNG is written per
sample, and ``metrics.json`` holds the ``summary`` (means, ``num_videos``)
and the ``per_video`` records. Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import clip_crop_raw
from ..data.video_io import read_frames, resize_frames, write_image
from ..metrics import lpips
from ..metrics.frame import l1, psnr, ssim
from ..pipelines import Pose2ImagePipeline
from ..utils.config import load_config
from ..utils.msgpack import load_msgpack
from .eval_pose2vid import eval_plucker
from .pose2vid import DTYPES, build_system, oriented_size


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--test_meta", required=True, help="meta JSON of test clips")
    p.add_argument("-W", type=int, default=512)
    p.add_argument("-H", type=int, default=896)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--eval_distance", type=int, default=30)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--output_dir", default="./output/eval_pose2img")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--lpips_weights", default=None,
                   help="the JAX package's LPIPS variables as a flax .msgpack; omit to skip "
                        "LPIPS")
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


def prepare_entry(entry: Dict[str, Any], args: argparse.Namespace, clip_size: int):
    """(ref, pose, plucker, CLIP crop, target), resized, for one entry."""
    video_path, kps_path = entry["video_path"], entry["kps_path"]
    start = entry.get("start_frame", 0)
    end = entry.get("end_frame", None)
    ref_idx = start
    tgt_idx = min(ref_idx + args.eval_distance, (end or start + args.eval_distance + 1) - 1)

    vid = read_frames(video_path, indices=[ref_idx, tgt_idx])
    pose_img = read_frames(kps_path, indices=[tgt_idx])[0]
    W, H = oriented_size(vid.shape[1:3], args)
    ref, gt = resize_frames(vid, W, H).astype(np.float32) / 255.0
    pose = resize_frames(pose_img[None], W, H)[0].astype(np.float32) / 255.0
    plucker = eval_plucker(video_path, ref_idx, [tgt_idx], (W, H))[0]
    return ref, pose, plucker, clip_crop_raw(vid[0], clip_size), gt


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Returns what ``metrics.json`` holds."""
    args = parse_args(argv)
    system = build_system(load_config(args.config), DTYPES[args.dtype], args.device)
    pipe = Pose2ImagePipeline(system)
    lpips_model = None
    if args.lpips_weights:
        lpips_model = lpips.from_flax(load_msgpack(args.lpips_weights), system.device)
    with open(args.test_meta) as f:
        meta = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device=system.device).manual_seed(args.seed)
    per_video: List[Dict[str, Any]] = []
    for entry in meta:
        ref, pose, plucker, clip_image, gt = prepare_entry(
            entry, args, system.config.clip.image_size)
        name = os.path.splitext(os.path.basename(entry["video_path"]))[0]
        for _ in range(args.repeat):
            out = pipe(ref, pose, plucker, clip_image, num_inference_steps=args.steps,
                       guidance_scale=args.cfg, generator=generator)
            gen = out.images[0]
            g = torch.from_numpy(gen[None]).to(system.device)
            t = torch.from_numpy(gt[None]).to(system.device)
            rec = {"video": os.path.basename(entry["video_path"]),
                   "ssim": float(ssim(g, t)[0]), "psnr": float(psnr(g, t)[0]),
                   "l1": float(l1(g, t)[0])}
            if lpips_model is not None:
                rec["lpips"] = float(lpips.lpips_distance(lpips_model, gen[None], gt[None])[0])
            per_video.append(rec)
            write_image(os.path.join(args.output_dir, f"{name}.png"),
                        np.concatenate([ref, pose, gen, gt], axis=1))
            print(rec)

    summary: Dict[str, Any] = {k: float(np.mean([r[k] for r in per_video]))
                               for k in per_video[0] if k != "video"}
    summary["num_videos"] = len(per_video)
    result = {"summary": summary, "per_video": per_video}
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("summary:", summary)
    return result


if __name__ == "__main__":
    main()
