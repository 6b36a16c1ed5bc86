"""The evaluation path's quality gate at the protocol's shape.

    python -m humanvid_tpu_torch.tools.eval_gate [--clips 4] [--steps 2] [--work DIR]

The counterpart of ``tools/eval_gate.py``: the reference's evaluation
protocol (vertical 512x768, 24-frame clips at stride 3, the middle frame as
the reference; ``scripts/eval_pose2vid.py``) on ``--clips`` synthetic
72-frame clips, with the tiny generator (``model: tiny``) and metric
networks with seeded random weights and the real key sets
(``tools/make_random_metric_weights.py``). The values mean nothing; the
assertion is that no metric is skipped. Weights, data, the generation and
each metric group are separate steps, and the generation and the groups
run as subprocesses of ``python -m humanvid_tpu_torch.cli.eval_pose2vid``,
retried on failure. A work dir holds a stamp of the gate's settings and is
refused by a run with other settings; a run on a work dir keeps the inputs,
weights, generated clips and metric groups found there. The record, in the
shape of ``EVAL_GATE_r05.json``, goes to ``--out`` (``WORK/EVAL_GATE.json``
by default), never over the repository's pre-port records; its ``device``
is the card's name and power limit (``nvidia-smi``), or ``cpu``. Runs on
the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# records from before the port that no run may overwrite
PRE_PORT_RECORDS = tuple(os.path.join(REPO, n) for n in ("EVAL_GATE_r05.json", "EVAL_GATE.json"))
EXPECTED = ("ssim", "psnr", "l1", "lpips", "fid", "fvd", "clip_sim")
GROUP_KEYS = {"frame,lpips": ("ssim", "psnr", "l1", "lpips"), "fid": ("fid",),
              "fvd": ("fvd",), "clip": ("clip_sim",)}
SHAPE = "512x768x24f/stride3/frames72"


def stage_data(root: str, clips: int, frames: int) -> str:
    """Synthetic vertical video / pose clip pairs of ``frames`` frames at
    768x512 (smooth, low-frequency content) and their meta JSON; returns
    the meta's path."""
    import numpy as np

    from ..data.video_io import save_video

    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    os.makedirs(os.path.join(root, "dwpose"), exist_ok=True)
    rng = np.random.default_rng(0)
    meta = []
    for i in range(clips):
        base = rng.random((4, 24, 16, 3)).astype(np.float32)
        clip = np.stack([np.clip(np.kron(base[j % 4] * (0.5 + 0.5 * np.sin(j / 5 + i)),
                                         np.ones((32, 32, 1))), 0, 1)
                         for j in range(frames)])
        vp = os.path.join(root, "videos", f"clip{i}.mp4")
        kp = os.path.join(root, "dwpose", f"clip{i}.mp4")
        save_video(clip, vp, fps=8.0)
        save_video(clip[:, ::-1], kp, fps=8.0)
        meta.append({"video_path": vp, "kps_path": kp, "start_frame": 0, "end_frame": frames})
    meta_path = os.path.join(root, "test_meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return meta_path


def skipped_metrics(summary: Dict[str, Any], expected: Sequence[str] = EXPECTED) -> List[str]:
    """The expected metrics that are missing, not numbers, or not finite."""
    return [m for m in expected
            if not isinstance(summary.get(m), (int, float)) or not math.isfinite(summary[m])]


def device_name(device: str) -> str:
    """The card's name and power limit, or ``cpu``."""
    if not str(device).startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def check_stamp(work: str, clips: int, steps: int) -> None:
    """Write the settings' stamp into a new work dir; refuse one stamped
    with other settings (its clips and metrics would merge into the record)."""
    stamp = hashlib.sha256(json.dumps({"clips": clips, "steps": steps, "shape": SHAPE},
                                      sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(work, "config_stamp.txt")
    os.makedirs(work, exist_ok=True)
    if os.path.exists(path):
        with open(path) as f:
            prev = f.read().strip()
        if prev != stamp:
            raise SystemExit(f"work dir {work} was produced with other gate settings (stamp "
                             f"{prev} != {stamp}); use a fresh --work dir")
    else:
        with open(path, "w") as f:
            f.write(stamp)


def _summary(out_dir: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(out_dir, "metrics.json")) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return {}
    return rec.get("summary", rec)


def run_gate(args: argparse.Namespace) -> Dict[str, Any]:
    work = args.work or tempfile.mkdtemp(prefix="eval_gate_")
    out = os.path.abspath(args.out or os.path.join(work, "EVAL_GATE.json"))
    if out in PRE_PORT_RECORDS:
        raise SystemExit(f"{out} is a record from before the port; give another --out")
    check_stamp(work, args.clips, args.steps)
    timings: Dict[str, Any] = {}
    attempts: Dict[str, int] = {}

    def run_phase(name: str, cmd: List[str], tries: int) -> None:
        t0 = time.time()
        for i in range(tries):
            attempts[name] = attempts.get(name, 0) + 1
            if subprocess.run(cmd, cwd=REPO).returncode == 0:
                timings[f"{name}_s"] = round(time.time() - t0, 1)
                return
            print(f"[eval_gate] {name} attempt {i + 1}/{tries} failed; retrying",
                  file=sys.stderr)
        raise SystemExit(f"{name} failed after {tries} attempts")

    weights_dir = os.path.join(work, "metric_weights")
    t0 = time.time()
    if not os.path.isdir(weights_dir) or not os.listdir(weights_dir):
        subprocess.run([sys.executable, "-m",
                        "humanvid_tpu_torch.tools.make_random_metric_weights", weights_dir],
                       cwd=REPO, check=True)
    timings["make_metric_weights_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    meta_path = os.path.join(work, "test_meta.json")
    if not os.path.exists(meta_path):
        meta_path = stage_data(work, args.clips, frames=72)  # stride 3 x 24 frames
    timings["stage_data_s"] = round(time.time() - t0, 1)

    cfg_path = os.path.join(work, "cfg.py")
    with open(cfg_path, "w") as f:
        f.write('cfg = {"model": "tiny"}\n')
    out_dir = os.path.join(work, "eval_out")
    base = [sys.executable, "-m", "humanvid_tpu_torch.cli.eval_pose2vid", "--config", cfg_path,
            "--test_meta", meta_path, "-W", "512", "-H", "768", "-L", "24", "--stride", "3",
            "--steps", str(args.steps), "--output_dir", out_dir, "--metric_weights",
            weights_dir, "--device", args.device]
    if all(os.path.exists(os.path.join(out_dir, sub, f"clip{i}.mp4"))
           for i in range(args.clips) for sub in ("gen", "gt")):
        print("[eval_gate] reusing the generated clips in", out_dir)
        timings["generate_s"] = 0.0
    else:
        run_phase("generate", base, tries=2)
    for group, keys in GROUP_KEYS.items():
        if not skipped_metrics(_summary(out_dir), keys):
            print(f"[eval_gate] metrics[{group}] already in the merged record; resumed",
                  file=sys.stderr)
            timings[f"metrics[{group}]_s"] = "resumed"
            continue
        run_phase(f"metrics[{group}]", base + ["--run_metrics", "--metrics_only",
                                               "--metrics_subset", group], tries=3)

    summary = _summary(out_dir)
    skipped = skipped_metrics(summary)
    rec = {
        "note": "Protocol-shape quality gate of the PyTorch port: vertical 512x768, 24-frame "
                "stride-3 clips, tiny generator, RANDOM metric weights with the real key sets; "
                "the values mean nothing, zero skipped metrics is the assertion.",
        "command": " ".join(base + ["--run_metrics"]),
        "clips": args.clips,
        "resolution": "512x768x24f",
        "device": device_name(args.device),
        "metrics": summary,
        "skipped_metrics": skipped,
        "timings_s": timings,
        "phase_attempts": attempts,
    }
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: rec[k] for k in ("resolution", "clips", "skipped_metrics",
                                          "timings_s")}))
    if skipped:
        raise SystemExit(f"skipped metrics at the protocol's shape: {skipped}")
    return rec


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clips", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", default=None, help="the record's path (default WORK/EVAL_GATE.json)")
    p.add_argument("--work", default=None,
                   help="a work dir to reuse: the inputs, metric weights, generated clips and "
                        "metric groups found there are kept")
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return run_gate(p.parse_args(argv))


if __name__ == "__main__":
    main()
