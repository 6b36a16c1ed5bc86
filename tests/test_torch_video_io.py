"""Host-side video IO and resizing: ``resize_frames`` against the JAX
package's PIL bilinear (at most 1 uint8 level), ``clip_crop_raw`` against
its PIL bicubic crop (at most 4 levels, mean at most 0.25), the grid's
orientation, and a save -> read round trip through the backend the facade
picks (the native libav core where it builds, else OpenCV), compared with
that backend's own decode (the JAX read and save functions build the JAX
package's native library in place, so they are not called here)."""

import numpy as np
import pytest

from humanvid_tpu.data.datasets import clip_crop_raw as jax_clip_crop_raw
from humanvid_tpu.data.video_io import resize_frames as jax_resize_frames
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.data.datasets import clip_crop_raw


def _frames(n, h, w, seed, smooth=False):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, 3)) * 255
    if smooth:  # a gradient with some texture, like a real frame
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
        x = 0.8 * (255 * (yy + xx) / 2)[None, ..., None] + 0.2 * x
    return x.astype(np.uint8)


@pytest.mark.parametrize("src,dst", [
    ((48, 32), (48, 32)),      # the CLI tests' portrait clip at its own size
    ((1920, 1080), (896, 512)),  # a portrait 1080p clip down to the CLI's size
    ((1080, 1920), (512, 896)),
    ((32, 48), (512, 768)),    # up
    ((333, 517), (57, 33)),    # ragged, both ways
])
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_resize_frames_matches_jax(src, dst, smooth):
    frames = _frames(2, *src, seed=sum(src), smooth=smooth)
    ours = video_io.resize_frames(frames, dst[1], dst[0])
    ref = jax_resize_frames(frames, dst[1], dst[0])
    assert ours.shape == ref.shape == (2,) + dst + (3,) and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("src", [(48, 32), (32, 48), (1920, 1080), (896, 512), (224, 224)])
@pytest.mark.parametrize("size", [28, 224])
def test_clip_crop_raw_matches_jax(src, size):
    img = _frames(1, *src, seed=src[0])[0]
    ours, ref = clip_crop_raw(img, size), jax_clip_crop_raw(img, size)
    assert ours.shape == ref.shape == (size, size, 3) and ours.dtype == np.float32
    diff = np.abs(ours - ref) * 255
    assert diff.max() <= 4 + 1e-3 and diff.mean() <= 0.25


@pytest.mark.parametrize("h,w,axis", [(48, 32, 2), (32, 48, 1)], ids=["portrait", "landscape"])
def test_grid_puts_portrait_side_by_side_and_stacks_landscape(h, w, axis):
    a = _frames(3, h, w, 0)
    b = np.random.default_rng(1).random((3, h, w, 3)).astype(np.float32)
    grid = video_io.videos_grid([a, b, a])
    assert grid.dtype == np.uint8
    assert grid.shape == ((3, h, 3 * w, 3) if axis == 2 else (3, 3 * h, w, 3))
    parts = np.split(grid, 3, axis=axis)
    np.testing.assert_array_equal(parts[0], a)
    np.testing.assert_array_equal(parts[1], (b * 255).astype(np.uint8))


def _direct_decode(path):
    """The file decoded by the backend the facade uses, called directly."""
    from humanvid_tpu_torch.native import available

    if available():
        from humanvid_tpu_torch.data.native_video import VideoReader

        with VideoReader(path) as r:
            return r.read_all()
    import cv2

    cap = cv2.VideoCapture(path)
    direct = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        direct.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(direct)


def test_save_read_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "clip.mp4")
    frames = _frames(9, 48, 32, 2, smooth=True)
    video_io.save_video(frames, path, fps=8.0)
    assert video_io.get_fps(path) == pytest.approx(8.0)
    assert video_io.get_frame_count(path) == 9
    seq = video_io.read_frames(path)
    np.testing.assert_array_equal(seq, _direct_decode(path))
    assert seq.shape == (9, 48, 32, 3)
    assert np.abs(seq.astype(int) - frames).mean() < 20  # lossy, but the same picture
    idx = [7, 0, 3, 3, 8]
    np.testing.assert_array_equal(video_io.read_frames(path, indices=idx), seq[idx])
    np.testing.assert_array_equal(video_io.read_frames(path, max_frames=4), seq[:4])


def test_save_videos_grid_writes_the_grid(tmp_path):
    path = str(tmp_path / "grid.mp4")
    a = _frames(4, 48, 32, 3, smooth=True)
    video_io.save_videos_grid([a, a.astype(np.float32) / 255.0], path, fps=4.0)
    out = video_io.read_frames(path)
    assert out.shape == (4, 48, 64, 3)
    assert video_io.get_fps(path) == pytest.approx(4.0)


def test_read_of_a_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        video_io.read_frames(str(tmp_path / "none.mp4"))
