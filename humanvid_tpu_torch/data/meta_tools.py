"""Training meta-info builders: the JSON lists of ``{video_path, kps_path,
start_frame, end_frame}`` that the datasets read.

The counterpart of ``humanvid_tpu/data/meta_tools.py`` (the reference's
``tools/*.py``):

- per-source extraction walking a videos tree beside its ``dwpose`` tree,
  with an optional CSV human-count filter (single-human clips);
- the check that video, keypoint video and camera file agree on length
  (the UE variant);
- merging per-source JSONs;
- fixed-duration segmentation of long videos into ~10 s segments.

Videos are read through the port's ``video_io``.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Dict, List, Optional, Sequence

from .video_io import get_fps, get_frame_count

logger = logging.getLogger(__name__)


def _kps_path(video_path: str, videos_token: str = "/videos/",
              kps_token: str = "/dwpose/") -> str:
    return video_path.replace(videos_token, kps_token)


def _camera_path(video_path: str, videos_token: str = "/videos/") -> str:
    return video_path.replace(videos_token, "/camera/").rsplit(".", 1)[0] + ".txt"


def load_human_counts(csv_path: str, path_col: str = "video_path",
                      count_col: str = "num_humans") -> Dict[str, int]:
    """CSV human-count table (pexels filter, extract_pexels_meta_info.py)."""
    counts = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            counts[os.path.basename(row[path_col])] = int(float(row[count_col]))
    return counts


def _camera_line_count(path: str) -> int:
    with open(path) as f:
        return sum(1 for ln in f if ln.strip())


def extract_meta(
    videos_dir: str,
    require_camera: bool = True,
    check_lengths: bool = True,
    human_counts: Optional[Dict[str, int]] = None,
    max_humans: int = 1,
    exts=(".mp4", ".avi", ".mkv"),
) -> List[dict]:
    """Walk ``videos_dir`` and emit meta entries for clips whose dwpose (and
    camera) siblings exist and agree on length."""
    entries = []
    for root, _, files in os.walk(videos_dir):
        for fname in sorted(files):
            if os.path.splitext(fname)[1] not in exts:
                continue
            video_path = os.path.join(root, fname)
            kps_path = _kps_path(video_path)
            if not os.path.exists(kps_path):
                logger.info("skip %s: no kps video", fname)
                continue
            if human_counts is not None:
                n = human_counts.get(fname)
                if n is None or n > max_humans:
                    logger.info("skip %s: human count %s", fname, n)
                    continue
            try:
                n_frames = get_frame_count(video_path)
            except Exception as e:  # noqa: BLE001
                logger.warning("skip %s: unreadable (%s)", fname, e)
                continue
            if check_lengths:
                try:
                    n_kps = get_frame_count(kps_path)
                except Exception as e:  # noqa: BLE001
                    logger.warning("skip %s: kps unreadable (%s)", fname, e)
                    continue
                if n_kps != n_frames:
                    logger.info("skip %s: video %d vs kps %d frames",
                                fname, n_frames, n_kps)
                    continue
            cam = _camera_path(video_path)
            if require_camera:
                if not os.path.exists(cam):
                    logger.info("skip %s: no camera file", fname)
                    continue
                if check_lengths and _camera_line_count(cam) < n_frames:
                    logger.info("skip %s: camera shorter than video", fname)
                    continue
            entries.append({
                "video_path": video_path,
                "kps_path": kps_path,
                "start_frame": 0,
                "end_frame": n_frames,
            })
    return entries


def segment_meta(entries: Sequence[dict], segment_seconds: float = 10.0,
                 min_frames: int = 30) -> List[dict]:
    """Split each entry into fixed-duration segments (get_video_segments.py)."""
    out = []
    for e in entries:
        fps = get_fps(e["video_path"]) or 24.0
        seg = max(int(round(segment_seconds * fps)), min_frames)
        start, end = e["start_frame"], e["end_frame"]
        for s in range(start, end, seg):
            t = min(s + seg, end)
            if t - s >= min_frames:
                out.append({**e, "start_frame": s, "end_frame": t})
    return out


def split_by_orientation(entries: Sequence[dict]) -> Dict[str, List[dict]]:
    """{'horizontal': [...], 'vertical': [...]} by first-frame aspect."""
    from .video_io import read_frames

    split: Dict[str, List[dict]] = {"horizontal": [], "vertical": []}
    for e in entries:
        frame = read_frames(e["video_path"], indices=[e["start_frame"]])[0]
        h, w = frame.shape[:2]
        split["horizontal" if w > h else "vertical"].append(e)
    return split


def merge_meta(json_paths: Sequence[str], out_path: str) -> List[dict]:
    """Concatenate per-source meta JSONs (merge_all_meta_info.py:39-51)."""
    merged: List[dict] = []
    for p in json_paths:
        with open(p) as f:
            merged.extend(json.load(f))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged


def save_meta(entries: Sequence[dict], out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(list(entries), f)
