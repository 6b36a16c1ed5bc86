"""The data-preparation helpers against the JAX package: ``meta_tools`` and
``python -m humanvid_tpu_torch.tools.build_meta`` against the JAX functions
and ``tools/build_meta.py`` on the same tree (equal entries and files), and
``visualization`` as ``tests/test_aux.py`` drives it (PCA and ``to_image``
exact; the composite exact where no panel is resized, and of the same shape
where the port's antialiased resize stands in for OpenCV's).

Both sides read videos through the port's ``video_io``: the JAX facade
builds the JAX package's native library in place, and OpenCV decodes one
frame fewer than the native reader from the x264 files the native writer
makes."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import humanvid_tpu.data.meta_tools as j_meta
import humanvid_tpu.data.video_io as j_video_io
from humanvid_tpu.data import visualization as j_vis
from humanvid_tpu_torch.data import meta_tools, video_io
from humanvid_tpu_torch.data import visualization as vis
from humanvid_tpu_torch.tools import build_meta

ROOT = Path(__file__).resolve().parent.parent


def _write_clip(path, f=12, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    video_io.save_video(rng.random((f, h, w, 3)).astype(np.float32), str(path), fps=6.0)


@pytest.fixture
def same_io(monkeypatch):
    """The JAX meta tools read through the port's video reader."""
    for name in ("get_fps", "get_frame_count"):
        monkeypatch.setattr(j_meta, name, getattr(video_io, name))
    monkeypatch.setattr(j_video_io, "read_frames", video_io.read_frames)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("src")
    videos, dwpose, camera = root / "videos", root / "dwpose", root / "camera"
    for d in (videos / "sub", dwpose / "sub", camera / "sub"):
        d.mkdir(parents=True)
    lines = "\n".join("0 0 0 0 0 0 0 1 1.0 1.788 1.0" for _ in range(40)) + "\n"
    for rel, f, h, w in (("a", 12, 48, 64), ("sub/v", 40, 64, 48), ("short_cam", 12, 48, 64),
                         ("kps_short", 12, 48, 64)):
        _write_clip(videos / f"{rel}.mp4", f, h, w, seed=f)
        _write_clip(dwpose / f"{rel}.mp4", 8 if rel == "kps_short" else f, h, w, seed=f + 1)
        (camera / f"{rel}.txt").write_text(lines if rel != "short_cam" else lines[:100])
    _write_clip(videos / "b.mp4")  # no kps sibling: skipped
    (root / "humans.csv").write_text("video_path,num_humans\na.mp4,1\nv.mp4,2\n")
    return root


@pytest.mark.parametrize("kwargs", [
    {}, {"require_camera": False}, {"check_lengths": False},
    {"human_counts": {"a.mp4": 1, "v.mp4": 2}}, {"human_counts": {"v.mp4": 2}, "max_humans": 2}],
    ids=["default", "no_camera", "no_length_check", "humans", "humans_max2"])
def test_extract_meta_matches_jax(tree, same_io, kwargs):
    got = meta_tools.extract_meta(str(tree / "videos"), **kwargs)
    want = j_meta.extract_meta(str(tree / "videos"), **kwargs)
    assert got == want and got


def test_segment_split_merge_match_jax(tree, same_io, tmp_path):
    entries = meta_tools.extract_meta(str(tree / "videos"), require_camera=False)
    for seconds, min_frames in ((1.0, 5), (2.0, 30), (10.0, 30)):
        assert meta_tools.segment_meta(entries, seconds, min_frames) == \
            j_meta.segment_meta(entries, seconds, min_frames)
    split = meta_tools.split_by_orientation(entries)
    assert split == j_meta.split_by_orientation(entries)
    assert split["vertical"] and split["horizontal"]
    meta_tools.save_meta(entries, str(tmp_path / "m1.json"))
    merged = meta_tools.merge_meta([str(tmp_path / "m1.json")] * 2, str(tmp_path / "out" / "m.json"))
    assert merged == j_meta.merge_meta([str(tmp_path / "m1.json")] * 2, str(tmp_path / "j.json"))
    assert meta_tools.load_human_counts(str(tree / "humans.csv")) == \
        j_meta.load_human_counts(str(tree / "humans.csv"))


def _jax_build_meta(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_build_meta", ROOT / "tools" / "build_meta.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["build_meta.py"] + argv)
    mod.main()


@pytest.mark.parametrize("extra", [
    [], ["--segment", "2", "--split_orientation"],
    ["--human_csv", "HUMANS", "--max_humans", "2", "--no_camera"]],
    ids=["plain", "segments_split", "humans"])
def test_build_meta_extract_matches_jax_tool(tree, same_io, tmp_path, monkeypatch, extra):
    extra = [str(tree / "humans.csv") if a == "HUMANS" else a for a in extra]
    build_meta.main(["extract", "--videos_dir", str(tree / "videos"),
                     "--out", str(tmp_path / "port" / "m")] + extra)
    _jax_build_meta(["extract", "--videos_dir", str(tree / "videos"),
                     "--out", str(tmp_path / "jax" / "m")] + extra, monkeypatch)
    got = sorted(os.listdir(tmp_path / "port"))
    assert got == sorted(os.listdir(tmp_path / "jax")) and got
    for name in got:
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())


def test_build_meta_merge_matches_jax_tool(tmp_path, monkeypatch):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps([{"video_path": "x", "start_frame": 0}]))
    b.write_text(json.dumps([{"video_path": "y", "start_frame": 4}] * 2))
    build_meta.main(["merge", "--inputs", str(a), str(b), "--out", str(tmp_path / "p.json")])
    _jax_build_meta(["merge", "--inputs", str(a), str(b), "--out", str(tmp_path / "j.json")],
                    monkeypatch)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


def test_visualization_pca_and_to_image_match_jax():
    rng = np.random.default_rng(0)
    plk = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    np.testing.assert_array_equal(vis.pca_visualize(plk), j_vis.pca_visualize(plk))
    for x, rng_ in ((rng.normal(size=(3, 8, 8)), (-1.0, 1.0)), (rng.random((8, 6, 3)), (0.0, 1.0))):
        x = x.astype(np.float32)
        np.testing.assert_array_equal(vis.to_image(x, rng_), j_vis.to_image(x, rng_))


def test_sample_composite_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    plk = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    sample = {"ref": rng.normal(size=(16, 16, 3)).astype(np.float32),
              "tgt": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
              "pose": rng.random((16, 16, 3)).astype(np.float32), "plucker": plk[0]}
    got = vis.sample_composite(sample, str(tmp_path / "p.png"))
    want = j_vis.sample_composite(sample, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(got, want)  # every panel at its own height
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
    sample["ref"] = rng.normal(size=(32, 24, 3)).astype(np.float32)  # resized to 16 rows
    got, want = vis.sample_composite(sample), j_vis.sample_composite(sample)
    assert got.shape == want.shape == (16, 12 + 3 * 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:, 12:], want[:, 12:])


def test_camera_pose_visualizer_writes_a_plot(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    c2ws = [np.eye(4) for _ in range(3)]
    for i, m in enumerate(c2ws):
        m[:3, 3] = [0.1 * i, 0.0, 0.2 * i]
    viz = vis.CameraPoseVisualizer()
    viz.add_trajectory(c2ws)
    viz.save(str(tmp_path / "cams.png"))
    assert (tmp_path / "cams.png").stat().st_size > 0
