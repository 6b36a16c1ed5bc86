"""Single-image inference from a prompt config (the stage-1 sampler).

    python -m humanvid_tpu_torch.cli.pose2img --config configs/prompts/stage2.yaml

The config's test cases are ``{ref_image_path: [pose_image_path, ...]}``;
the camera comes from the TUM file next to each pose image (``.png`` ->
``.txt`` under ``/camera/``; a static camera where there is none); each
ref | pose | output composite is saved as a PNG. The other options and the
config keys are those of ``cli/pose2vid.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.camera import camera_file_to_plucker
from ..data.datasets import clip_crop_raw
from ..data.video_io import resize_frames, write_image
from ..pipelines import Pose2ImagePipeline
from ..utils.config import load_config
from .pose2vid import DTYPES, _read_rgb, build_system, oriented_size


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("-W", type=int, default=512)
    p.add_argument("-H", type=int, default=896)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--output_dir", default="./output/pose2img")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


class Case(NamedTuple):
    image: np.ndarray      # (H, W, 3) float32 in [0, 1]
    ref: np.ndarray        # (H, W, 3) the resized reference image in [0, 1]
    pose: np.ndarray       # (H, W, 3) the resized pose image in [0, 1]
    plucker: np.ndarray    # (H, W, 6) the camera input
    seconds: Dict[str, object]


def run_case(pipe: Pose2ImagePipeline, ref_rgb_uint8: np.ndarray, pose_rgb_uint8: np.ndarray,
             pose_path: str, args: argparse.Namespace,
             generator: Optional[torch.Generator] = None,
             init_latents: Optional[np.ndarray] = None) -> Case:
    """One (reference image, pose image) case on decoded images."""
    W, H = oriented_size(pose_rgb_uint8.shape[:2], args)
    ref = resize_frames(ref_rgb_uint8[None], W, H)[0].astype(np.float32) / 255.0
    pose = resize_frames(pose_rgb_uint8[None], W, H)[0].astype(np.float32) / 255.0
    clip_raw = clip_crop_raw(ref_rgb_uint8, pipe.system.config.clip.image_size)
    plucker = camera_file_to_plucker(pose_path, 1, 0, [0], (W, H), is_same_video=False)[0]
    out = pipe(ref, pose, plucker, clip_raw, num_inference_steps=args.steps,
               guidance_scale=args.cfg, generator=generator, init_latents=init_latents)
    return Case(out.images[0], ref, pose, plucker, out.seconds)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = load_config(args.config)
    system = build_system(cfg, DTYPES[args.dtype], args.device)
    pipe = Pose2ImagePipeline(system)
    os.makedirs(args.output_dir, exist_ok=True)
    gen = torch.Generator(device=system.device).manual_seed(args.seed)
    for ref_path, pose_paths in cfg.test_cases.items():
        ref_raw = _read_rgb(ref_path)
        for pose_path in pose_paths:
            case = run_case(pipe, ref_raw, _read_rgb(pose_path), pose_path, args, gen)
            composite = np.concatenate([case.ref, case.pose, case.image], axis=1)
            name = (os.path.splitext(os.path.basename(ref_path))[0] + "_"
                    + os.path.splitext(os.path.basename(pose_path))[0])
            write_image(os.path.join(args.output_dir, f"{name}.png"), composite)
            print(f"saved {name}.png")


if __name__ == "__main__":
    main()
