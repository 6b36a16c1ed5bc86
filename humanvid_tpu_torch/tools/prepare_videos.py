"""Offline DWPose extraction: a videos tree -> the skeleton videos beside it.

    python -m humanvid_tpu_torch.tools.prepare_videos --videos_dir data/x/videos \\
        --yolox weights/yolox_l.onnx --dwpose weights/dw-ll_ucoco_384.onnx

The counterpart of ``tools/prepare_videos.py`` (the reference's
``DWPose/prepare_videos.py``): decode every frame of each ``.mp4``,
``.avi`` or ``.mkv`` under ``--videos_dir``, run the wholebody detector
(YOLOX-L, then DWPose for each person), draw the skeleton canvas, and write
an mp4 at the source's frame rate into the mirrored tree (``--out_dir``,
by default the path with ``videos`` replaced by ``dwpose``), skipping
outputs that exist. UE synthetic clips, which ship SMPL-X 2D keypoints
(``.npz``) in place of video, take ``--smplx``: each is drawn at
``--width`` x ``--height``. The networks run on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mkv")


def process_video(detector, video_path: str, out_path: str) -> int:
    from ..data import video_io

    frames = video_io.read_frames(video_path)
    canvases = np.stack([detector(f)[0] for f in frames])
    video_io.save_video(canvases, out_path, fps=video_io.get_fps(video_path))
    return len(frames)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--videos_dir", required=True)
    p.add_argument("--out_dir", default=None, help="default: sibling dwpose/ tree")
    p.add_argument("--yolox", default=None, help="YOLOX-L weights (.onnx/.pth)")
    p.add_argument("--dwpose", default=None, help="DWPose weights (.onnx/.pth)")
    p.add_argument("--smplx", action="store_true",
                   help="treat inputs as SMPL-X .npz keypoint files (UE path)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--num_people", type=int, default=-1)
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


def _walk(root: str, exts):
    """(path, path relative to root) of the files under root with one of
    ``exts``, in sorted order within each directory."""
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(exts):
                path = os.path.join(dirpath, f)
                yield path, os.path.relpath(path, root)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    out_root = args.out_dir or args.videos_dir.rstrip("/").replace("videos", "dwpose")

    if args.smplx:
        from ..pose.smplx import visualize_video

        for path, rel in _walk(args.videos_dir, (".npz",)):
            out = os.path.join(out_root, rel.replace(".npz", ".mp4"))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            n = visualize_video(path, out, args.width, args.height)
            print(f"{rel}: {n} frames")
        return

    from ..pose import load_detector

    detector = load_detector(args.yolox, args.dwpose, args.num_people, device=args.device)
    for path, rel in _walk(args.videos_dir, VIDEO_EXTS):
        out = os.path.join(out_root, rel)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        n = process_video(detector, path, out)
        print(f"{rel}: {n} frames")


if __name__ == "__main__":
    main()
