"""The port's two measurement tools on the CPU.

- ``tools.bench_configs``: the four op-points, their shapes, step counts,
  window and CFG modes and metric names are the JAX tool's
  (``tools/bench_configs.py``, read as source: importing it would set the
  JAX package's attention backend for every later test in the process);
  without a card it exits 2 and prints no result;
- ``tools.loader_bench``: on a small tree it writes (896x512 portrait
  clips through the port's video writer), one JSON line of finite rates
  for both stages; where no writer can write a video it raises.
"""

import ast
import json
import os

import numpy as np
import pytest

from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.tools import bench_configs, loader_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    with open(os.path.join(ROOT, "tools", "bench_configs.py")) as f:
        return f.read()


def _jax_op_points():
    """{config: (metric, H, W, frames, steps)} from the JAX tool's source."""
    tree = ast.parse(_jax_tool())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    configs = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "CONFIGS")
    points = {}
    vid_steps = next(k.value.value for c in ast.walk(funcs["_bench_vid"])
                     if isinstance(c, ast.Call)
                     for k in c.keywords if k.arg == "num_inference_steps")
    for key, fn in zip(configs.keys, configs.values):
        body = funcs[fn.id]
        call = next((c for c in ast.walk(body) if isinstance(c, ast.Call)
                     and getattr(c.func, "id", "") == "_bench_vid"), None)
        if call is not None:
            metric, h, w, f = (a.value for a in call.args[2:6])
            points[key.value] = (metric, h, w, f, vid_steps)
        else:  # c1: pose2img
            metric = next(c.args[0].value for c in ast.walk(body) if isinstance(c, ast.Call)
                          and getattr(c.func, "id", "") == "_emit")
            size = next(n.value.value for n in ast.walk(body) if isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Constant) and n.value.value == 256)
            steps = next(k.value.value for c in ast.walk(body) if isinstance(c, ast.Call)
                         for k in c.keywords if k.arg == "num_inference_steps")
            points[key.value] = (metric, size, size, 0, steps)
    return points


def test_op_points_are_the_jax_tools():
    jax_points = _jax_op_points()
    assert list(jax_points) == list(bench_configs.OP_POINTS) == ["c1", "c2", "c4h", "c4v"]
    for name, point in bench_configs.OP_POINTS.items():
        assert tuple(point) == jax_points[name], name
    src = _jax_tool()
    # the video points' sampler settings
    assert "context_frames=24, context_overlap=overlap, decode_chunk=8" in src
    assert 'cfg_mode="sequential", window_mode=window_mode' in src
    assert 'window_mode = "sequential" if F > 24 else "batched"' in src
    assert "overlap=4" in src
    assert (bench_configs.CONTEXT, bench_configs.OVERLAP, bench_configs.DECODE_CHUNK) == (24, 4, 8)


def test_bench_configs_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(bench_configs.torch.cuda, "is_available", lambda: False)
    assert bench_configs.main(["c1", "--runs", "1", "--steps", "2"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("stage", ["stage2", "stage1"])
def test_loader_bench_on_a_small_tree(stage, capsys):
    assert loader_bench.main([stage, "--workers", "2", "--batches", "2", "--clips", "2",
                              "--frames", "30"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == f"{stage}_loader_samples_per_sec"
    assert rec["batches"] == 2 and rec["batch_size"] == {"stage2": 1, "stage1": 8}[stage]
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert 0 < rec["spread_s"][0] <= rec["per_batch_s"] <= rec["spread_s"][1]


def test_loader_bench_raises_without_a_video_writer(tmp_path, monkeypatch):
    def no_cv2():
        raise ImportError("no OpenCV")

    monkeypatch.setattr(video_io, "_native", lambda: None)
    monkeypatch.setattr(video_io, "_cv2", no_cv2)
    with pytest.raises(ImportError):
        loader_bench.build_tree(str(tmp_path), 1, 4)
