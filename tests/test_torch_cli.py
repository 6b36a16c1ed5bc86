"""The port's inference command lines (``humanvid_tpu_torch.cli``) on the
CPU, at the tiny config in fp32, on data of the kind that the JAX
package's command-line tests build (a portrait 48x32 clip of 8 frames)
plus a TUM camera file: ``main`` end to end (output names, frame count, fps,
grid), the argument surface against the JAX scripts', and ``run_case``
against the JAX pipelines on the same resized inputs (TOL 1e-3, as
``tests/test_torch_pose2vid.py``), with its resizes, CLIP crop and camera
rays held to the JAX package's."""

import argparse
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_system_params
from humanvid_tpu.data.camera import camera_file_to_plucker as j_camera_file_to_plucker
from humanvid_tpu.data.video_io import resize_frames as j_resize_frames
from humanvid_tpu.pipelines.pose2img import Pose2ImagePipeline as JPose2Image
from humanvid_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPose2Video
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu_torch.cli import pose2img, pose2vid
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.data.datasets import clip_crop_raw
from humanvid_tpu_torch.pipelines import (
    CamAnimate, Pose2ImagePipeline, Pose2VideoPipeline, tiny_config)

TOL = 1e-3
F, H, W = 8, 48, 32  # the clip: vertical


def _trajectory(n):
    """A pan and a dolly, TUM lines with the scale column."""
    lines = []
    for i in range(n):
        yaw = 0.05 * i
        row = [i / 8.0, 0.05 * i, 0.0, -0.1 * i, 0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2),
               0.9, 1.6, 1.2]
        lines.append(" ".join(repr(float(v)) for v in row))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("cli_data")
    for sub in ("ref_images", "pose_videos", "pose_images", "camera"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    cv2.imwrite(str(root / "ref_images" / "ref.png"),
                (rng.random((H, W, 3)) * 255).astype(np.uint8))
    cv2.imwrite(str(root / "pose_images" / "pexels_pose.png"),
                (rng.random((H, W, 3)) * 255).astype(np.uint8))
    video_io.save_video(rng.random((F, H, W, 3)).astype(np.float32),
                        str(root / "pose_videos" / "pexels_dance.mp4"), fps=8.0)
    (root / "camera" / "pexels_dance.txt").write_text(_trajectory(F))
    (root / "pose_images" / "pexels_pose.txt").write_text(_trajectory(1))
    return root


def _config(tmp_path, cases, kind="yaml"):
    cfg = {"model": "tiny", "test_cases": cases}
    if kind == "yaml":
        import yaml

        path = tmp_path / "prompts.yaml"
        path.write_text(yaml.safe_dump(cfg))
    else:
        path = tmp_path / "prompts.py"
        path.write_text(f"cfg = {cfg!r}\n")
    return str(path)


@pytest.mark.parametrize("kind,repeat", [("yaml", 1), ("py", 2)])
def test_pose2vid_main(cli_data, tmp_path, kind, repeat, capsys):
    root = cli_data
    ref, pose = str(root / "ref_images" / "ref.png"), str(root / "pose_videos" / "pexels_dance.mp4")
    out = tmp_path / "out"
    pose2vid.main(["--config", _config(tmp_path, {ref: [pose]}, kind), "-W", "32", "-H", "48",
                   "-L", "4", "--steps", "2", "--output_dir", str(out), "--dtype", "float32",
                   "--device", "cpu", "--repeat", str(repeat)])
    names = ["ref_pexels_dance.mp4"] if repeat == 1 else [
        f"ref_pexels_dance_r{r}.mp4" for r in range(repeat)]
    assert sorted(p.name for p in out.iterdir()) == names
    for name in names:
        path = str(out / name)
        assert video_io.get_frame_count(path) == 4      # 8 frames at stride 2
        assert video_io.get_fps(path) == pytest.approx(4.0)  # 8 fps over the stride
        assert video_io.read_frames(path).shape == (4, H, 3 * W, 3)  # ref | pose | output
    assert "saved ref_pexels_dance" in capsys.readouterr().out


def test_pose2img_main(cli_data, tmp_path):
    import cv2

    root = cli_data
    ref, pose = str(root / "ref_images" / "ref.png"), str(root / "pose_images" / "pexels_pose.png")
    out = tmp_path / "out"
    pose2img.main(["--config", _config(tmp_path, {ref: [pose]}), "-W", "32", "-H", "48",
                   "--steps", "2", "--output_dir", str(out), "--dtype", "float32",
                   "--device", "cpu"])
    assert [p.name for p in out.iterdir()] == ["ref_pexels_pose.png"]
    assert cv2.imread(str(out / "ref_pexels_pose.png")).shape == (H, 3 * W, 3)


@pytest.mark.parametrize("script,argv", [
    ("pose2vid", []),
    ("pose2vid", ["-W", "32", "-H", "48", "-L", "4", "--seed", "3", "--cfg", "2.0",
                  "--steps", "2", "--repeat", "2", "--fps", "12", "--output_dir", "o",
                  "--dtype", "float32", "--cfg_mode", "sequential",
                  "--window_mode", "sequential"]),
    ("pose2img", []),
    ("pose2img", ["-W", "64", "-H", "40", "--seed", "1", "--cfg", "1.0", "--steps", "3",
                  "--output_dir", "o", "--dtype", "float32"]),
])
def test_argument_surface_matches_the_jax_scripts(monkeypatch, script, argv):
    import importlib

    from humanvid_tpu.ops import attention

    backend = attention.get_default_attention_backend()
    jax_script = importlib.import_module(f"scripts.{script}")
    attention.set_default_attention_backend(backend)  # the script sets it at import
    argv = ["--config", "c.yaml"] + argv
    monkeypatch.setattr(sys, "argv", [f"{script}.py"] + argv)
    ref = vars(jax_script.parse_args())
    ours = vars({"pose2vid": pose2vid, "pose2img": pose2img}[script].parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref


@pytest.mark.parametrize("frame_hw,want", [((48, 32), (512, 896)), ((32, 48), (896, 512)),
                                           ((50, 50), (512, 896))])
def test_output_size_follows_the_orientation(frame_hw, want):
    args = argparse.Namespace(W=896, H=512)
    assert pose2vid.oriented_size(frame_hw, args) == want


@pytest.fixture(scope="module")
def systems():
    js = JCamAnimate(jax_tiny_config(motion_max_len=24))
    params = jax_system_params(js, 4, H, W)
    port = CamAnimate(tiny_config(motion_max_len=24), device="cpu").load_jax_params(params)
    return js, params, port


def test_pose2vid_run_case_matches_jax(cli_data, systems):
    js, params, port = systems
    root = cli_data
    pose_path = str(root / "pose_videos" / "pexels_dance.mp4")
    frames = video_io.read_frames(pose_path)
    ref_raw = np.asarray(video_io.read_frames(pose_path, indices=[5])[0][::-1])  # any image
    args = pose2vid.parse_args(["--config", "c", "-W", "32", "-H", "48", "-L", "4",
                                "--steps", "2", "--dtype", "float32", "--device", "cpu"])
    init = np.random.default_rng(1).normal(size=(4, H // 8, W // 8, 4)).astype(np.float32)
    case = pose2vid.run_case(Pose2VideoPipeline(port), ref_raw, frames, pose_path, args,
                             init_latents=init)
    assert case.indices == [0, 2, 4, 6] and case.stride == 2
    assert case.video.shape == (4, H, W, 3)
    # the inputs, against the JAX package's
    assert np.abs(case.pose * 255 - j_resize_frames(frames[case.indices], W, H)).max() <= 1 + 1e-3
    assert np.abs(case.ref * 255 - j_resize_frames(ref_raw[None], W, H)[0]).max() <= 1 + 1e-3
    want_plk = j_camera_file_to_plucker(pose_path, F, 0, case.indices, (W, H),
                                        is_same_video=False)
    np.testing.assert_allclose(case.plucker, want_plk, atol=1e-5, rtol=0)
    ref = JPose2Video(js, params)(
        case.ref, case.pose, case.plucker, clip_crop_raw(ref_raw, 28), num_inference_steps=2,
        guidance_scale=3.5, cfg_mode="batched", window_mode="batched", init_latents=init)
    np.testing.assert_allclose(case.video, ref.videos[0], atol=TOL, rtol=0)


def test_pose2img_run_case_matches_jax(cli_data, systems):
    js, params, port = systems
    root = cli_data
    pose_path = str(root / "pose_images" / "pexels_pose.png")
    pose_raw = video_io.read_frames(str(root / "pose_videos" / "pexels_dance.mp4"),
                                    indices=[3])[0]
    ref_raw = np.ascontiguousarray(pose_raw[:, ::-1])
    args = pose2img.parse_args(["--config", "c", "-W", "32", "-H", "48", "--steps", "2",
                                "--dtype", "float32", "--device", "cpu"])
    key = jax.random.PRNGKey(4)
    init = np.array(jax.random.normal(key, (1, H // 8, W // 8, 4), js.dtype))
    case = pose2img.run_case(Pose2ImagePipeline(port), ref_raw, pose_raw, pose_path, args,
                             generator=torch.Generator().manual_seed(0), init_latents=init)
    assert case.image.shape == (H, W, 3)
    want_plk = j_camera_file_to_plucker(pose_path, 1, 0, [0], (W, H), is_same_video=False)[0]
    np.testing.assert_allclose(case.plucker, want_plk, atol=1e-5, rtol=0)
    ref = JPose2Image(js, params)(case.ref, case.pose, case.plucker, clip_crop_raw(ref_raw, 28),
                                  num_inference_steps=2, guidance_scale=3.5, rng=key)
    np.testing.assert_allclose(case.image, ref.images[0], atol=TOL, rtol=0)
