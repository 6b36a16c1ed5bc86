"""The port's native libav video core (``humanvid_tpu_torch/native``): the
JAX package's ``test_native_video.py`` cases on the port's reader and
writer, clips written by the test, and the build's atomic rename under
concurrent first use. Skips, saying why, where the library cannot build
(no g++ or no FFmpeg development files)."""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from humanvid_tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_library()
    except RuntimeError as err:
        pytest.skip(str(err))


@pytest.fixture(scope="module")
def clip(lib, tmp_path_factory):
    from humanvid_tpu_torch.data.native_video import VideoWriter

    H, W, F_ = 64, 96, 30
    rng = np.random.default_rng(0)
    # smooth content so that the lossy round trip stays close
    base = torch.from_numpy(rng.integers(0, 255, (8, 12, 3)).astype(np.float32))
    big = F.interpolate(base.permute(2, 0, 1)[None], size=(H, W), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).clamp(0, 255).byte().numpy()
    frames = np.stack([np.roll(big, 3 * i, axis=1) for i in range(F_)])
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    with VideoWriter(path, W, H, fps=12.0) as w:
        w.write(frames)
    return path, frames


def test_index_and_metadata(clip):
    from humanvid_tpu_torch.data.native_video import VideoReader

    path, frames = clip
    with VideoReader(path) as r:
        assert len(r) == frames.shape[0]
        assert (r.width, r.height) == (frames.shape[2], frames.shape[1])
        assert abs(r.fps - 12.0) < 1e-3


def test_random_access_and_duplicates(clip):
    from humanvid_tpu_torch.data.native_video import VideoReader

    path, frames = clip
    with VideoReader(path) as r:
        batch = r.get_batch([29, 0, 7, 7, 15])
        assert batch.shape == (5, 64, 96, 3)
        assert (batch[2] == batch[3]).all()
        for out_i, src_i in [(0, 29), (1, 0), (2, 7), (4, 15)]:
            err = np.abs(batch[out_i].astype(int) - frames[src_i].astype(int)).mean()
            assert err < 16, (src_i, err)


def test_sequential_matches_batch(clip):
    from humanvid_tpu_torch.data.native_video import VideoReader

    path, frames = clip
    with VideoReader(path) as r:
        allf = r.read_all()
        single = np.stack([r[i] for i in [0, 10, 29]])
    assert allf.shape[0] == frames.shape[0]
    assert (allf[[0, 10, 29]] == single).all()


def test_video_io_facade_uses_native(clip, tmp_path):
    from humanvid_tpu_torch.data import video_io
    from humanvid_tpu_torch.data.native_video import VideoReader

    path, frames = clip
    assert video_io._native() is not None
    assert video_io.get_frame_count(path) == frames.shape[0]
    sel = video_io.read_frames(path, indices=[3, 1])
    with VideoReader(path) as r:
        np.testing.assert_array_equal(sel, r.get_batch([3, 1]))
    out = str(tmp_path / "grid.mp4")
    video_io.save_videos_grid([frames, frames], out, fps=12.0)
    assert video_io.get_frame_count(out) == frames.shape[0]


def test_out_of_range_raises(clip):
    from humanvid_tpu_torch.data.native_video import VideoReader

    path, frames = clip
    with VideoReader(path) as r:
        with pytest.raises(IOError):
            r.get_batch([frames.shape[0]])


@pytest.mark.parametrize("hw", [(96, 56), (48, 50), (30, 98), (64, 270)])
def test_round_trip_at_widths_whose_rows_are_not_vector_aligned(lib, tmp_path, hw):
    """Rows of 3 * width bytes that are not a multiple of swscale's vector
    width: decode and encode go through aligned frames of the core's own
    (a 56-pixel-wide clip once corrupted the heap)."""
    from humanvid_tpu_torch.data.native_video import VideoReader, VideoWriter

    h, w = hw
    base = torch.from_numpy(np.random.default_rng(w).random((6, 3, 4, 4)).astype(np.float32))
    frames = (F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False) * 255
              ).permute(0, 2, 3, 1).byte().numpy()  # smooth, so the codec keeps it
    path = str(tmp_path / f"{h}x{w}.mp4")
    with VideoWriter(path, w, h, fps=8.0) as writer:
        writer.write(frames)
    for _ in range(3):
        with VideoReader(path) as r:
            got = r.get_batch([5, 0, 3, 3])
    assert got.shape == (4, h, w, 3)
    assert np.abs(got[1].astype(int) - frames[0]).mean() < 16


def test_random_access_equals_sequential_decode_across_scene_cuts(lib, tmp_path):
    """A clip of distinct frames with hard cuts (x264 starts new keyframes
    there, one of them next to the first): every frame, read sequentially,
    by index in reverse, and by backward seeks, is the same frame. A rewind
    or seek that landed on a later keyframe lost or shifted frames."""
    from humanvid_tpu_torch.data.native_video import VideoReader, VideoWriter

    h, w, n = 48, 64, 30
    rng = np.random.default_rng(5)
    scenes = [rng.integers(0, 256, (3,), dtype=np.uint8) for _ in range(n // 3 + 1)]
    # cuts after frames 0, 3, 6, ...: the second keyframe is the second frame
    frames = np.stack([np.broadcast_to(scenes[(i + 2) // 3], (h, w, 3)).copy()
                       for i in range(n)])
    frames[:, :8, :8] = np.arange(n, dtype=np.uint8)[:, None, None, None] * 8  # frame id
    path = str(tmp_path / "cuts.mp4")
    with VideoWriter(path, w, h, fps=8.0) as writer:
        writer.write(frames)
    with VideoReader(path) as r:
        assert len(r) == n
        seq = r.read_all()
        back = r.get_batch(list(range(n))[::-1])
        jumps = np.stack([r[i] for i in (29, 1, 20, 0, 14, 2)])
    assert np.abs(seq.astype(int) - frames).mean() < 8
    np.testing.assert_array_equal(back, seq[::-1])
    np.testing.assert_array_equal(jumps, seq[[29, 1, 20, 0, 14, 2]])
    for i in (0, 1, 5):
        with VideoReader(path) as r:
            np.testing.assert_array_equal(r[i], seq[i])


def test_concurrent_first_builds_leave_one_whole_library(lib, tmp_path, monkeypatch):
    """Threads that all find the library missing compile it at once; each
    renames its own finished file onto the name, so every caller gets a
    whole library and no temporary file is left behind."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except RuntimeError as err:
            errors.append(err)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and paths[0].startswith(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [native._target().name]
    ctypes.CDLL(paths[0]).hvt_last_error  # loads and resolves
