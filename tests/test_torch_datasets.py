"""The port's training datasets against the JAX package's, on the CPU, on
clips, meta JSON and TUM camera files this test writes (OpenCV mp4; both
packages read the frames through the port's OpenCV reader, so that they
see the same pixels).

- ``_load(index, random.Random(seed))`` of both dataset classes, on a
  landscape and a portrait clip, several seeds: the frames read (paths and
  indices) and the resize-and-crop decision exactly, the generator left in
  the same state; ``plucker`` to 1e-5; ``tgt``, ``ref`` and ``pose`` within
  one uint8 level (the port resizes with ``F.interpolate`` in floating
  point, PIL in fixed point); ``clip`` within one level over CLIP_STD;
- ``apply_resize_crop`` within one level of PIL on noise, down and up, at the
  stage-2 recipe's 1024x576 -> 910x512 among others;
- ``random_resize_crop_params`` exactly, results and errors, over a sweep of
  sizes and scale ranges, including ones that cannot cover the target;
- a meta entry whose file is missing is resampled in both (same generator
  seeds), logged, and no file is written or removed;
- the dataset's camera-file substitution is the JAX package's.
"""

import json
import logging
import math
import random
import types

import numpy as np
import pytest

from humanvid_tpu.data import datasets as jds
from humanvid_tpu_torch.data import datasets as tds
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.data.camera import camera_file_for

FRAMES = 14
SIZES = {"landscape": (56, 96), "portrait": (96, 56)}  # (H, W) of the source clips
LEVEL = 1.0 + 1e-4  # one uint8 level, in levels


def _config(mod):
    return mod.DatasetConfig(train_size_large=48, train_size_small=32, clip_size=28,
                             sample_margin=4, n_sample_frames=4, sample_rate=3)


def _trajectory(n):
    lines = []
    for i in range(n):
        yaw = 0.04 * i
        row = [i / 8.0, 0.03 * i, 0.0, -0.05 * i, 0.0, math.sin(yaw / 2), 0.0,
               math.cos(yaw / 2), 1.0, 1.788, 1.0]
        lines.append(" ".join(repr(float(v)) for v in row))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("pexels_clips")
    for sub in ("videos", "dwpose", "camera"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    metas = {}
    for name, (h, w) in SIZES.items():
        # noise over a gradient: edges for the resize, structure for the crop
        ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, :, None]
        for sub in ("videos", "dwpose"):
            frames = 0.5 * ramp + 0.5 * rng.random((FRAMES, h, w, 3)).astype(np.float32)
            video_io.save_video(frames, str(root / sub / f"{name}.mp4"), fps=8.0)
        (root / "camera" / f"{name}.txt").write_text(_trajectory(FRAMES))
        meta = root / f"{name}.json"
        meta.write_text(json.dumps([{"video_path": str(root / "videos" / f"{name}.mp4"),
                                     "kps_path": str(root / "dwpose" / f"{name}.mp4"),
                                     "start_frame": 0, "end_frame": FRAMES}]))
        metas[name] = str(meta)
    return root, metas


def _datasets(metas, kind, horizontal=("landscape",), vertical=("portrait",)):
    h = [metas[n] for n in horizontal]
    v = [metas[n] for n in vertical]
    j_cls = {"image": jds.HumanDanceCameraImageDataset, "video": jds.HumanDanceCameraVideoDataset}
    t_cls = {"image": tds.HumanDanceCameraImageDataset, "video": tds.HumanDanceCameraVideoDataset}
    return j_cls[kind](h, v, _config(jds)), t_cls[kind](h, v, _config(tds))


def _record(monkeypatch, mod, name, calls):
    fn = video_io.read_frames if name == "read_frames" else getattr(mod, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out if name != "read_frames" else None))
        return out

    monkeypatch.setattr(mod, name, wrapped)


def _assert_samples_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    np.testing.assert_allclose(got["plucker"], want["plucker"], atol=1e-5, rtol=0)
    for k, scale in (("tgt", 127.5), ("ref", 127.5), ("pose", 255.0)):
        assert np.abs(got[k] - want[k]).max() * scale <= LEVEL, k
    clip_levels = np.abs(got["clip"] - want["clip"]) * tds.CLIP_STD * 255.0
    assert clip_levels.max() <= LEVEL


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("index", [0, 1], ids=["landscape", "portrait"])
@pytest.mark.parametrize("kind", ["image", "video"])
def test_load_matches_jax(clips, monkeypatch, kind, index, seed):
    _, metas = clips
    jset, tset = _datasets(metas, kind)
    calls = {}
    for key, mod in (("jax", jds), ("port", tds)):
        calls[key] = {"read": [], "crop": []}
        _record(monkeypatch, mod, "read_frames", calls[key]["read"])
        _record(monkeypatch, mod, "random_resize_crop_params", calls[key]["crop"])
    rj, rt = random.Random(seed), random.Random(seed)
    want = jset._load(index, rj)
    got = tset._load(index, rt)
    assert calls["port"]["read"] == calls["jax"]["read"]
    assert [c[2] for c in calls["port"]["crop"]] == [c[2] for c in calls["jax"]["crop"]]
    assert rt.getstate() == rj.getstate()
    _assert_samples_close(got, want)
    f = 1 if kind == "image" else 4
    w, h = (48, 32) if index == 0 else (32, 48)
    assert got["tgt"].shape == ((h, w, 3) if f == 1 else (f, h, w, 3))
    assert got["clip"].shape == (28, 28, 3)


@pytest.mark.parametrize("scale_range", [(1.0, 1.1), (0.5, 0.6)])
@pytest.mark.parametrize("src_hw", [(1080, 1920), (1920, 1080), (720, 1280), (96, 56),
                                    (56, 96), (500, 500), (899, 512), (100, 60)])
def test_random_resize_crop_params_matches_jax(src_hw, scale_range):
    def outcome(mod, rng, dst):
        try:
            return mod.random_resize_crop_params(rng, src_hw, dst, scale_range)
        except ValueError as e:
            return ("ValueError", str(e))

    for dst in ((512, 896), (896, 512), (32, 48), (48, 32)):
        for seed in range(5):
            rj, rt = random.Random(seed), random.Random(seed)
            assert outcome(tds, rt, dst) == outcome(jds, rj, dst), (dst, seed)
            assert rt.getstate() == rj.getstate()


def test_random_resize_crop_params_raises_where_it_cannot_cover():
    args = ((100, 60), (32, 48), (0.5, 0.6))
    for mod in (jds, tds):
        with pytest.raises(ValueError, match="cannot cover"):
            mod.random_resize_crop_params(random.Random(0), *args)


@pytest.mark.parametrize("src_hw,params,dst_wh", [
    ((96, 56), (33, 56, 0, 4), (32, 48)),      # downscale, crop in y
    ((56, 96), (58, 33, 5, 0), (48, 32)),      # downscale, crop in x
    ((30, 20), (35, 52, 1, 2), (32, 48)),      # upscale both ways
    ((1080, 1920), (91, 51, 21, 1), (48, 32)),  # a large downscale
    ((1024, 576), (512, 910, 0, 7), (512, 896)),  # the stage-2 recipe's
])
def test_apply_resize_crop_within_one_level_of_pil(src_hw, params, dst_wh):
    rng = np.random.default_rng(sum(src_hw))
    frames = (rng.random((2,) + src_hw + (3,)) * 255).astype(np.uint8)
    got = tds.apply_resize_crop(frames, params, dst_wh)
    want = jds.apply_resize_crop(frames, params, dst_wh)
    assert got.shape == want.shape == (2, dst_wh[1], dst_wh[0], 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(96, 56), (56, 96)])
def test_clip_preprocess_within_one_level(hw):
    img = (np.random.default_rng(hw[0]).random(hw + (3,)) * 255).astype(np.uint8)
    got, want = tds.clip_preprocess_np(img, 28), jds.clip_preprocess_np(img, 28)
    assert got.shape == want.shape == (28, 28, 3)
    assert (np.abs(got - want) * tds.CLIP_STD * 255.0).max() <= LEVEL
    np.testing.assert_array_equal(tds.CLIP_MEAN, jds.CLIP_MEAN)
    np.testing.assert_array_equal(tds.CLIP_STD, jds.CLIP_STD)


@pytest.mark.parametrize("kind", ["image", "video"])
def test_missing_file_is_resampled_in_both(clips, tmp_path, monkeypatch, caplog, kind):
    root, metas = clips
    good = json.loads(open(metas["portrait"]).read())[0]
    broken = dict(good, video_path=str(root / "videos" / "gone.mp4"))
    meta = tmp_path / "vertical.json"
    meta.write_text(json.dumps([broken, good]))
    for mod in (jds, tds):
        monkeypatch.setattr(mod, "read_frames", video_io.read_frames)
        # each sample's generator, unseeded in both packages, seeded alike here
        monkeypatch.setattr(mod, "random", types.SimpleNamespace(
            Random=lambda *a: random.Random(a[0] if a else 5)))
    before = sorted(p.name for p in root.rglob("*")) + sorted(p.name for p in tmp_path.iterdir())
    j_cls = {"image": jds.HumanDanceCameraImageDataset, "video": jds.HumanDanceCameraVideoDataset}
    t_cls = {"image": tds.HumanDanceCameraImageDataset, "video": tds.HumanDanceCameraVideoDataset}
    with caplog.at_level(logging.WARNING):
        want = j_cls[kind]([], [str(meta)], _config(jds))[0]
        n_jax = sum("bad sample 0" in r.getMessage() for r in caplog.records)
        got = t_cls[kind]([], [str(meta)], _config(tds))[0]
    n_port = sum("bad sample 0" in r.getMessage() for r in caplog.records) - n_jax
    assert n_jax >= 1 and n_port == n_jax
    _assert_samples_close(got, want)
    after = sorted(p.name for p in root.rglob("*")) + sorted(p.name for p in tmp_path.iterdir())
    assert after == before


@pytest.mark.parametrize("path", ["/d/pexels/videos/a.mp4", "/d/ue/mp4/b.mp4",
                                  "/d/tiktok/videos/sub/c.mp4", "/d/x/clip.mp4"])
def test_camera_file_is_the_jax_datasets(path):
    assert tds._camera_file(path) == jds._camera_file(path)
    if "/videos/" in path:  # not the pose clip's substitution
        assert tds._camera_file(path) != camera_file_for(path)
