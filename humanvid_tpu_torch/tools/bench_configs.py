"""Seconds per clip at the sampling op-points beside the flagship, on the card.

    python -m humanvid_tpu_torch.tools.bench_configs [c1 c2 c4h c4v] [--runs 3] [--steps N]

The counterpart of ``tools/bench_configs.py``, with its four op-points and
metric names:

- c1: pose2img 256x256, DDIM 20, CFG 3.5 (the stage-1 evaluation point);
- c2: pose2vid, static camera, 16 frames at 512x512, one window (the
  Animate-Anyone reproduction mode);
- c4h: long video, 48 frames 768x512, windows of 24 with overlap 4;
- c4v: the same at 512x768.

The video points take DDIM 30 and CFG 3.5 in two passes
(``cfg_mode="sequential"``), one window a pass above 24 frames
(``window_mode="sequential"``), and decode 8 frames at a time, as the JAX
tool does. ``--steps`` replaces the DDIM step count (each line says which it
ran). The system is ``CamAnimateConfig()`` with seeded weights in bf16.
Each op-point runs once to warm up, then ``--runs`` times between CUDA
events; its line is one JSON object: the median's rate in
``images/sec/card`` or ``frames/sec/card``, the runs' spread in seconds, and
the card's name and power limit. Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Dict, NamedTuple

import numpy as np
import torch


class OpPoint(NamedTuple):
    metric: str
    height: int
    width: int
    frames: int  # 0: one image (pose2img)
    steps: int


OP_POINTS: Dict[str, OpPoint] = {
    "c1": OpPoint("pose2img_images_per_sec_256x256_ddim20_cfg", 256, 256, 0, 20),
    "c2": OpPoint("pose2vid_frames_per_sec_static_512x512x16f_ddim30_cfg", 512, 512, 16, 30),
    "c4h": OpPoint("pose2vid_long_frames_per_sec_768x512x48f_ddim30_cfg", 768, 512, 48, 30),
    "c4v": OpPoint("pose2vid_long_frames_per_sec_512x768x48f_ddim30_cfg", 512, 768, 48, 30),
}
CONTEXT, OVERLAP, DECODE_CHUNK = 24, 4, 8


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def static_plucker(h: int, w: int, f: int) -> np.ndarray:
    from ..data.camera import get_relative_pose, intrinsics_vector, ray_condition, static_camera

    cams = static_camera((w, h), f + 1)
    return ray_condition(intrinsics_vector(cams[1:], (w, h)), get_relative_pose(cams)[1:], h, w)


def op_run(system, point: OpPoint, steps: int):
    """A function that samples the op-point once (seeded inputs) and checks
    its output is finite."""
    from ..pipelines import Pose2ImagePipeline, Pose2VideoPipeline

    h, w, f = point.height, point.width, point.frames
    rng = np.random.default_rng(0)
    size = system.config.clip.image_size
    ref = rng.random((h, w, 3)).astype(np.float32)
    clip = rng.random((size, size, 3)).astype(np.float32)
    dev = system.device
    if f == 0:
        pipe = Pose2ImagePipeline(system)
        pose = rng.random((h, w, 3)).astype(np.float32)
        plucker = static_plucker(h, w, 1)[0]

        def run():
            out = pipe(ref, pose, plucker, clip, num_inference_steps=steps, guidance_scale=3.5,
                       generator=torch.Generator(device=dev).manual_seed(0))
            if not np.isfinite(out.images).all():
                raise RuntimeError("non-finite images")
        return run

    pipe = Pose2VideoPipeline(system)
    pose = rng.random((f, h, w, 3)).astype(np.float32)
    plucker = static_plucker(h, w, f)
    window_mode = "sequential" if f > CONTEXT else "batched"

    def run():
        out = pipe(ref, pose, plucker, clip, num_inference_steps=steps, guidance_scale=3.5,
                   context_frames=CONTEXT, context_overlap=OVERLAP, decode_chunk=DECODE_CHUNK,
                   cfg_mode="sequential", window_mode=window_mode,
                   generator=torch.Generator(device=dev).manual_seed(0))
        if not (np.isfinite(out.latents).all() and np.isfinite(out.videos).all()):
            raise RuntimeError("non-finite output")
    return run


def timed(run, runs: int):
    """Seconds of each of ``runs`` calls after one warm-up, between CUDA
    events (each call ends in a synchronize of its own)."""
    run()
    seconds = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        seconds.append(start.elapsed_time(end) / 1e3)
    return seconds


def measure(system, name: str, runs: int, steps=None) -> dict:
    point = OP_POINTS[name]
    steps = steps or point.steps
    seconds = timed(op_run(system, point, steps), runs)
    median = statistics.median(seconds)
    units = max(point.frames, 1)
    return {"config": name, "metric": point.metric, "value": units / median,
            "unit": "images/sec/card" if point.frames == 0 else "frames/sec/card",
            "seconds": median, "spread_s": [min(seconds), max(seconds)], "runs": runs,
            "ddim_steps": steps, "card": card_line()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", default=list(OP_POINTS), choices=list(OP_POINTS))
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--steps", type=int, default=None,
                   help="DDIM steps in place of each op-point's own")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_configs: no CUDA device", file=sys.stderr)
        return 2
    from ..pipelines import CamAnimate, CamAnimateConfig

    system = CamAnimate(CamAnimateConfig(), device="cuda", dtype=torch.bfloat16).init_random(0)
    for name in args.configs or list(OP_POINTS):
        print(json.dumps(measure(system, name, args.runs, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
