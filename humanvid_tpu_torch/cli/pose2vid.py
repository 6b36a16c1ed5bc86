"""Camera-aware long-video inference from a prompt config.

    python -m humanvid_tpu_torch.cli.pose2vid --config configs/prompts/stage2.yaml

The config (YAML, or a ``.py`` module exporting ``cfg``) names the
checkpoints (``utils/weights.py:load_pretrained``) and the test cases,
``{ref_image_path: [pose_video_path, ...]}``; ``model: tiny`` swaps in the
small test topology. For each case: the output size follows the pose
video's orientation (-W/-H as the short and long sides), -L frames are
taken at a stride through the pose video, the camera trajectory comes from
the TUM file found by path substitution (``/pose_videos/`` or ``/dwpose/``
-> ``/camera/``, ``.mp4`` -> ``.txt``; a static camera where there is
none), and a ref | pose | output grid is saved at ``--fps`` or the pose
video's fps over the stride. The noise comes from a ``torch.Generator``
seeded by ``--seed``. Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.camera import camera_file_to_plucker
from ..data.datasets import clip_crop_raw
from ..data.video_io import get_fps, read_frames, resize_frames, save_videos_grid
from ..pipelines import CamAnimate, CamAnimateConfig, Pose2VideoPipeline, tiny_config
from ..utils.config import load_config
from ..utils.weights import load_pretrained

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("-W", type=int, default=512)
    p.add_argument("-H", type=int, default=896)
    p.add_argument("-L", type=int, default=24)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cfg", type=float, default=3.5)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--fps", type=int, default=None)
    p.add_argument("--output_dir", default="./output/pose2vid")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--cfg_mode", default="batched", choices=["batched", "sequential"],
                   help="sequential: two UNet passes a step (lower peak memory)")
    p.add_argument("--window_mode", default="batched", choices=["batched", "sequential"],
                   help="sequential: one context window a UNet pass, for clips longer "
                        "than one window")
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


def build_system(cfg, dtype: torch.dtype, device) -> CamAnimate:
    """The config's system (``model: tiny`` for the small test topology),
    seeded, then overwritten from the checkpoints the config names."""
    config = tiny_config(motion_max_len=24) if cfg.get("model") == "tiny" else CamAnimateConfig()
    return load_pretrained(CamAnimate(config, device=device, dtype=dtype).init_random(0), cfg)


def oriented_size(frame_hw, args) -> tuple:
    """(W, H): -W/-H as the short and long sides, following the frame."""
    ph, pw = frame_hw
    lo, hi = min(args.W, args.H), max(args.W, args.H)
    return (hi, lo) if pw > ph else (lo, hi)


class Case(NamedTuple):
    video: np.ndarray      # (L, H, W, 3) float32 in [0, 1]
    indices: List[int]     # the pose frames it follows
    stride: int            # the frame stride, which divides the saved fps
    ref: np.ndarray        # (H, W, 3) the resized reference image in [0, 1]
    pose: np.ndarray       # (L, H, W, 3) the resized pose frames in [0, 1]
    plucker: np.ndarray    # (L, H, W, 6) the camera input
    seconds: Dict[str, object]


def run_case(pipe: Pose2VideoPipeline, ref_rgb_uint8: np.ndarray,
             pose_frames_uint8: np.ndarray, pose_path: str, args: argparse.Namespace,
             generator: Optional[torch.Generator] = None,
             init_latents: Optional[np.ndarray] = None) -> Case:
    """One (reference image, pose video) case on decoded frames: size,
    strided frames, CLIP crop, camera rays, then the pipeline."""
    W, H = oriented_size(pose_frames_uint8.shape[1:3], args)
    total = len(pose_frames_uint8)
    stride = max(total // args.L, 1)
    indices = list(range(0, min(args.L * stride, total), stride))[: args.L]
    pose = resize_frames(pose_frames_uint8[indices], W, H).astype(np.float32) / 255.0
    ref = resize_frames(ref_rgb_uint8[None], W, H)[0].astype(np.float32) / 255.0
    clip_raw = clip_crop_raw(ref_rgb_uint8, pipe.system.config.clip.image_size)
    plucker = camera_file_to_plucker(pose_path, total, indices[0], indices, (W, H),
                                     is_same_video=False)
    out = pipe(ref, pose, plucker, clip_raw, num_inference_steps=args.steps,
               guidance_scale=args.cfg, cfg_mode=args.cfg_mode, window_mode=args.window_mode,
               generator=generator, init_latents=init_latents)
    return Case(out.videos[0], indices, stride, ref, pose, plucker, out.seconds)


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = load_config(args.config)
    system = build_system(cfg, DTYPES[args.dtype], args.device)
    pipe = Pose2VideoPipeline(system)
    os.makedirs(args.output_dir, exist_ok=True)
    gen = torch.Generator(device=system.device).manual_seed(args.seed)
    for ref_path, pose_paths in cfg.test_cases.items():
        ref_raw = _read_rgb(ref_path)
        for pose_path in pose_paths:
            frames = read_frames(pose_path)
            for r in range(args.repeat):
                case = run_case(pipe, ref_raw, frames, pose_path, args, gen)
                name = (os.path.splitext(os.path.basename(ref_path))[0] + "_"
                        + os.path.splitext(os.path.basename(pose_path))[0]
                        + (f"_r{r}" if args.repeat > 1 else ""))
                fps = args.fps or get_fps(pose_path) / case.stride
                ref_vid = np.repeat(case.ref[None], len(case.indices), axis=0)
                save_videos_grid([ref_vid, case.pose, case.video],
                                 os.path.join(args.output_dir, f"{name}.mp4"), fps=fps)
                print(f"saved {name}.mp4 ({len(case.indices)} frames @ {fps:.1f} fps)")


if __name__ == "__main__":
    main()
