"""``python -m humanvid_tpu_torch.tools.prepare_videos`` on the CPU, against
the JAX detector and ``visualize_video`` on the same frames.

The tool runs on a tree of two short clips (landscape and portrait) with
seeded YOLOX-L weights written as a ``.pth`` and DWPose weights as an
``.onnx`` (``tools/make_random_pose_weights.py``); the canvases it saves are
held to the JAX ``load_detector`` on the frames the tool decoded: the same
bits, but for pixels on a stroke's edge in the JAX canvas (a keypoint whose
pixel coordinate sits on an integer may truncate the other way), at most
0.5% of a canvas (none differ on these frames). The ``--smplx`` branch is held bit for bit to the JAX
``visualize_video``. The JAX video reader and writer build the JAX package's
native library in place, so frames reach the JAX side from the port's
reader and its ``save_video`` is replaced by a recorder.
"""

import os

import numpy as np
import pytest
import torch

import humanvid_tpu.data.video_io as j_video_io
from humanvid_tpu.pose import load_detector as j_load_detector
from humanvid_tpu.pose.smplx import visualize_video as j_visualize_video
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.tools import make_random_pose_weights as mk
from humanvid_tpu_torch.tools import prepare_videos

torch.set_num_threads(2)
CLIPS = {"a/landscape.mp4": (3, 96, 128), "portrait.mp4": (2, 128, 96)}


def _clip(f, h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.random((f, 3, 4, 3)) * 255  # blocks, so that edges cross the frame
    frames = base[:, np.arange(h) * 3 // h][:, :, np.arange(w) * 4 // w]
    return np.clip(frames + rng.normal(0, 10, frames.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep")
    for i, (rel, (f, h, w)) in enumerate(CLIPS.items()):
        video_io.save_video(_clip(f, h, w, i), str(root / "videos" / rel), fps=6.0)
    return root, mk.write(str(root / "weights"), seed=0)


def _edge(canvas):
    """Pixels that differ from a 4-neighbour in the canvas."""
    c = np.pad(canvas.astype(int), ((1, 1), (1, 1), (0, 0)), mode="edge")
    mid = c[1:-1, 1:-1]
    return ((mid != c[:-2, 1:-1]) | (mid != c[2:, 1:-1]) | (mid != c[1:-1, :-2])
            | (mid != c[1:-1, 2:])).any(-1)


def test_tool_matches_jax_detector_and_skips_existing(tree, monkeypatch):
    root, weights = tree
    saved = {}
    save = video_io.save_video

    def record(frames, path, fps=24.0):
        saved[path] = np.asarray(frames)
        save(frames, path, fps)

    monkeypatch.setattr(video_io, "save_video", record)
    argv = ["--videos_dir", str(root / "videos"), "--yolox", weights["yolox"],
            "--dwpose", weights["dwpose"], "--device", "cpu"]
    prepare_videos.main(argv)
    assert sorted(os.path.relpath(p, root / "dwpose") for p in saved) == sorted(CLIPS)

    jd = j_load_detector(weights["yolox"], weights["dwpose"])
    for rel, (f, h, w) in CLIPS.items():
        out = str(root / "dwpose" / rel)
        canvases = saved[out]
        assert canvases.shape == (f, h, w, 3) and canvases.dtype == np.uint8
        assert video_io.get_frame_count(out) == f
        assert video_io.get_fps(out) == pytest.approx(6.0)
        for frame, got in zip(video_io.read_frames(str(root / "videos" / rel)), canvases):
            want, pose = jd(frame)
            assert len(pose["bodies"]) >= 1 and (want.max(-1) > 0).mean() > 0.01
            differ = (got != want).any(-1)
            assert differ.mean() <= 0.005, differ.mean()
            assert _edge(want)[differ].all()

    saved.clear()
    prepare_videos.main(argv)  # every output exists: nothing is redone
    assert not saved


def test_smplx_branch_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    src = tmp_path / "ue" / "videos" / "s"
    src.mkdir(parents=True)
    kpts = rng.uniform(10, 300, (3, 144, 2)).astype(np.float32)
    np.savez(src / "take.npz", keypoints=kpts,
             confidence=rng.uniform(0, 1, (3, 144)).astype(np.float32))
    saved = {}
    save = video_io.save_video

    def record(frames, path, fps=24.0):
        saved[path] = np.asarray(frames)
        save(frames, path, fps)

    monkeypatch.setattr(video_io, "save_video", record)
    prepare_videos.main(["--videos_dir", str(tmp_path / "ue" / "videos"), "--smplx",
                         "--width", "320", "--height", "240", "--device", "cpu"])
    out = str(tmp_path / "ue" / "dwpose" / "s" / "take.mp4")
    assert list(saved) == [out] and os.path.exists(out)

    jsaved = {}
    monkeypatch.setattr(j_video_io, "save_video",
                        lambda frames, path, fps=24.0: jsaved.update({path: frames}))
    assert j_visualize_video(str(src / "take.npz"), "jax.mp4", 320, 240) == 3
    np.testing.assert_array_equal(saved[out], jsaved["jax.mp4"])
    assert saved[out].shape == (3, 240, 320, 3) and saved[out].max() > 0
