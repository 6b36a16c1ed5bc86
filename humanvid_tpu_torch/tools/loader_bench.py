"""Sustained input-pipeline throughput at the training op-points.

    python -m humanvid_tpu_torch.tools.loader_bench [stage2|stage1] [--workers N]
        [--batches N] [--clips N] [--frames N]

The counterpart of ``tools/loader_bench.py``: can the port's thread-pool
loader (``data/loader.py``) feed a training step at the real op-point (a
24-frame 512x896 clip and its pose clip decoded, cropped and resized, the
Plücker rays built, a sample at a time)? It writes a synthetic x264 tree
of 896x512 portrait clips through the port's video writer (the native libav
core, else OpenCV; where neither can write a video it raises, and it never
serves clips from memory), builds the meta JSON with ``data.meta_tools``,
iterates ``HumanDanceCameraVideoDataset`` (stage 2, a batch of 1) or
``HumanDanceCameraImageDataset`` (stage 1, a batch of 8) through the
``Loader`` and prints one JSON line: the samples of the batches after the
first two over their seconds, the median seconds a batch and the spread. No
device is in the loop, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

HEIGHT, WIDTH = 896, 512  # the flagship training bucket, portrait
BATCH_SIZE = {"stage2": 1, "stage1": 8}  # the recipes' train_bs


def build_tree(root: str, n_clips: int, frames: int, h: int = HEIGHT, w: int = WIDTH) -> str:
    """``n_clips`` clips under ``root/{videos,dwpose,camera}`` (smooth
    content: 8x upsampled noise, whose x264 bitstreams decode at a
    natural-video cost), and the meta JSON of them; returns its path."""
    from ..data.meta_tools import extract_meta, save_meta
    from ..data.video_io import save_video

    dirs = {sub: os.path.join(root, "pexels", sub) for sub in ("videos", "dwpose", "camera")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_clips):
        name = f"clip{i}"  # under "pexels": the c2w camera convention
        small = rng.random((frames, h // 8, w // 8, 3)).astype(np.float32)
        save_video(np.repeat(np.repeat(small, 8, axis=1), 8, axis=2),
                   os.path.join(dirs["videos"], f"{name}.mp4"), fps=24.0)
        pose = np.zeros((frames, h, w, 3), np.float32)
        pose[:, h // 4:h // 2, w // 4:w // 2] = 0.8  # sparse, skeleton-like
        save_video(pose, os.path.join(dirs["dwpose"], f"{name}.mp4"), fps=24.0)
        with open(os.path.join(dirs["camera"], f"{name}.txt"), "w") as f:
            f.write("".join(f"{t} {0.01 * t} 0 0 0 0 0 1 1.0 1.788 1.0\n"
                            for t in range(frames)))
    entries = extract_meta(dirs["videos"])
    if len(entries) != n_clips:
        raise RuntimeError(f"{len(entries)} of {n_clips} written clips read back")
    meta_path = os.path.join(root, "meta.json")
    save_meta(entries, meta_path)
    return meta_path


def measure(stage: str, workers: int, batches: int, clips: int, frames: int) -> dict:
    from ..data.datasets import (DatasetConfig, HumanDanceCameraImageDataset,
                                 HumanDanceCameraVideoDataset)
    from ..data.loader import Loader
    from ..data.samplers import OrientationBatchSampler

    root = tempfile.mkdtemp(prefix="hvt_loader_bench_")
    try:
        t0 = time.perf_counter()
        meta_path = build_tree(root, clips, frames)
        print(f"# synthetic tree built in {time.perf_counter() - t0:.1f} s ({clips} clips x "
              f"{frames}f {HEIGHT}x{WIDTH})", file=sys.stderr, flush=True)
        cls = HumanDanceCameraVideoDataset if stage == "stage2" else HumanDanceCameraImageDataset
        ds = cls([], [meta_path], DatasetConfig())
        bs = BATCH_SIZE[stage]
        sampler = OrientationBatchSampler(ds.num_horizontal, len(ds) - ds.num_horizontal, bs,
                                          seed=0, drop_last=False)
        order = []
        while len(order) < batches + 2:
            sampler.set_epoch(len(order))
            order.extend(itertools.islice(iter(sampler), batches))
        times, samples = [], 0
        t_prev = time.perf_counter()
        for i, batch in enumerate(Loader(ds, order[:batches + 2], num_workers=workers,
                                         prefetch=2)):
            now = time.perf_counter()
            if i >= 2:  # past the pool's start and the page cache's warm-up
                times.append(now - t_prev)
                samples += len(batch["tgt"])
            t_prev = now
            if batch["tgt"].dtype != np.float32:
                raise RuntimeError(f"tgt is {batch['tgt'].dtype}")
        per_batch = statistics.median(times)
        return {"metric": f"{stage}_loader_samples_per_sec", "value": samples / sum(times),
                "unit": "samples/sec", "per_batch_s": per_batch,
                "spread_s": [min(times), max(times)], "workers": workers, "batch_size": bs,
                "batches": len(times), "host_cpus": os.cpu_count()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stage", nargs="?", default="stage2", choices=sorted(BATCH_SIZE))
    p.add_argument("--workers", type=int, default=8)  # stage2.yaml num_workers
    p.add_argument("--batches", type=int, default=10)
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--frames", type=int, default=80)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.stage, args.workers, args.batches, args.clips, args.frames)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
