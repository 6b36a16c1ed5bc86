"""Camera trajectories from TUM files, against the JAX package: the
quaternion rotation, ``load_cameras`` under the world-to-camera and the
camera-to-world conventions (with and without the scale column), and
``camera_file_to_plucker`` with the path substitution, both reference
choices and the static fallback; all at atol 1e-5.

The convention comes from words in the whole path, and a pytest
``tmp_path`` holds ``test``, a camera-to-world word: the world-to-camera
files carry ``bedlam`` in their names (those words are tried first)."""

import numpy as np
import pytest

from humanvid_tpu.data import camera as jcam
from humanvid_tpu_torch.data import camera

TOL = 1e-5


def _trajectory(n, scale, seed=0):
    """n TUM lines of a pan and a dolly with unit quaternions."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        yaw = 0.03 * i + 0.01 * rng.normal()
        q = np.array([0.02 * rng.normal(), np.sin(yaw / 2), 0.01 * rng.normal(), np.cos(yaw / 2)])
        q /= np.linalg.norm(q)
        t = [0.1 * i, 0.02 * rng.normal(), -0.05 * i]
        row = [i / 30.0] + t + list(q) + [0.9, 1.6]
        if scale:
            row.append(1.7)
        lines.append(" ".join(repr(float(v)) for v in row))
    return "\n".join(lines) + "\n"


def _cams_close(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose([a.fx, a.fy, a.cx, a.cy], [b.fx, b.fy, b.cx, b.cy],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(a.w2c, b.w2c, atol=TOL, rtol=0)
        np.testing.assert_allclose(a.c2w, b.c2w, atol=TOL, rtol=0)


def test_quaternion_to_rotation_matrix_matches_jax():
    rng = np.random.default_rng(0)
    for q in rng.normal(size=(16, 4)):
        q = q / np.linalg.norm(q)
        R = camera.quaternion_to_rotation_matrix(*q)
        np.testing.assert_allclose(R, jcam.quaternion_to_rotation_matrix(*q), atol=TOL, rtol=0)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(R) == pytest.approx(1.0)


@pytest.mark.parametrize("scale", [False, True], ids=["no_scale", "scale"])
@pytest.mark.parametrize("source", ["bedlam_walk", "pexels_pan"])
@pytest.mark.parametrize("size", [(32, 48), (48, 32)], ids=["portrait", "landscape"])
def test_load_cameras_matches_jax(tmp_path, source, scale, size):
    path = tmp_path / f"{source}.txt"
    path.write_text(_trajectory(6, scale))
    ours = camera.load_cameras(str(path), size)
    _cams_close(ours, jcam.load_cameras(str(path), size))
    # line 3 moved (0.3, ., -0.15): stored as w2c as it is, or as c2w times the scale
    pose, s = (ours[3].w2c, 1.0) if source.startswith("bedlam") else (ours[3].c2w, 1.7)
    np.testing.assert_allclose(pose[[0, 2], 3], np.array([0.3, -0.15]) * (s if scale else 1.0),
                               atol=1e-12)
    R = pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_from_entry_raises_without_a_source_word():
    entry = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="unknown camera pose source"):
        camera.Camera.from_entry(entry, "clip.txt")
    with pytest.raises(ValueError, match="fields"):
        camera.Camera.from_entry(entry[:9], "pexels.txt")


def test_static_camera_matches_jax():
    for size in ((32, 48), (48, 32), (512, 896)):
        _cams_close(camera.static_camera(size, 3), jcam.static_camera(size, 3))


def _layout(tmp_path, name, kind, n=10):
    """A pose path under ``pose_videos/`` or ``dwpose/`` (or a pose image)
    and its camera file under ``camera/``."""
    (tmp_path / "camera").mkdir(exist_ok=True)
    (tmp_path / "camera" / f"{name}.txt").write_text(_trajectory(n, True, seed=3))
    sub, ext = {"video": ("pose_videos", ".mp4"), "dwpose": ("dwpose", ".mp4"),
                "image": ("pose_images", ".png")}[kind]
    if kind == "image":  # a pose image sits beside its camera directory's name
        return str(tmp_path / "camera" / f"{name}{ext}")
    return str(tmp_path / sub / f"{name}{ext}")


@pytest.mark.parametrize("kind", ["video", "dwpose", "image"])
@pytest.mark.parametrize("same_video", [True, False])
def test_camera_file_to_plucker_matches_jax(tmp_path, kind, same_video):
    pose_path = _layout(tmp_path, "pexels_dolly", kind)
    assert camera.camera_file_for(pose_path) == str(tmp_path / "camera" / "pexels_dolly.txt")
    args = (pose_path, 10, 2, [1, 3, 5, 7], (32, 48))
    ours = camera.camera_file_to_plucker(*args, is_same_video=same_video)
    ref = jcam.camera_file_to_plucker(*args, is_same_video=same_video)
    assert ours.shape == (4, 48, 32, 6) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    static = camera.camera_file_to_plucker(str(tmp_path / "elsewhere" / "a.mp4"), 10, 2,
                                           [1, 3, 5, 7], (32, 48))
    assert not np.allclose(ours, static)  # the trajectory moved the rays


def test_missing_camera_file_falls_back_to_the_static_camera(tmp_path):
    pose_path = str(tmp_path / "pose_videos" / "none.mp4")
    args = (pose_path, 6, 0, [0, 2, 4], (48, 32))
    ours = camera.camera_file_to_plucker(*args, is_same_video=False)
    np.testing.assert_allclose(ours, jcam.camera_file_to_plucker(*args, is_same_video=False),
                               atol=TOL, rtol=0)
    cams = camera.static_camera((48, 32), 3)
    want = camera.ray_condition(camera.intrinsics_vector(cams, (48, 32)),
                                camera.get_relative_pose(cams), 32, 48)
    np.testing.assert_array_equal(ours, want)
