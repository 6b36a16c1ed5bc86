"""The port's evaluation command lines (``cli.eval_pose2vid``,
``cli.eval_pose2img``) and its gate (``tools.eval_gate``) on the CPU, with
``--device cpu --dtype float32`` and ``model: tiny``.

- The JAX scripts' ``main`` and the port's on the same meta and clips, the
  clips served from memory in both (the JAX ``read_frames`` would build the
  native library), the pipelines' ``__call__`` replaced in both by one that
  records its inputs and returns a fixed output: the same frames read (the
  stride reduced for a short segment, the middle reference frame), ref,
  pose and ground truth within one uint8 level (PIL's rounded passes
  against the port's one), the CLIP crop within one level, the Plücker
  rays to 1e-5, the steps and guidance the same. ``eval_pose2img``'s
  ``metrics.json`` (SSIM, PSNR, L1 and LPIPS from the same flax
  ``.msgpack``) matches the JAX script's to 1e-4 given the same generated
  image, and so does its composite PNG, pixel for pixel.
- ``--metrics_only`` and ``--metrics_subset`` runs merging into one
  ``metrics.json``, against the JAX script's, to 1e-4.
- One run of each ``main`` with nothing replaced (OpenCV files, the tiny
  generator, the metric networks).
- The gate's steps with its subprocesses replaced: the settings stamp, the
  group resume, retries, the skipped-metric assertion, the record's path.
"""

import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
from flax import serialization

import test_torch_helpers  # noqa: F401  (two torch threads a worker)
from humanvid_tpu.metrics import lpips as j_lpips
from humanvid_tpu.metrics import runner as j_runner
from humanvid_tpu.pipelines.pose2img import Pose2ImagePipeline as JPose2Image
from humanvid_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPose2Video
from humanvid_tpu_torch.cli import eval_pose2img, eval_pose2vid
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.metrics import weights as W
from humanvid_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
from humanvid_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from humanvid_tpu_torch.tools import eval_gate
from humanvid_tpu_torch.tools import make_random_metric_weights as mk

METRIC_TOL = 1e-4
RAY_TOL = 1e-5
L = 4


def _jax_script(name):
    from humanvid_tpu.ops import attention

    backend = attention.get_default_attention_backend()
    module = importlib.import_module(f"scripts.{name}")
    attention.set_default_attention_backend(backend)  # the script sets it at import
    return module


def _trajectory(n):
    rows = []
    for i in range(n):
        yaw = 0.05 * i
        rows.append(" ".join(repr(float(v)) for v in (
            i / 8.0, 0.05 * i, 0.0, -0.1 * i, 0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2), 0.9,
            1.6, 1.2)))
    return "\n".join(rows) + "\n"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Clips in memory (a portrait 96x64 one of 30 frames with a TUM file, a
    landscape 64x96 segment 2..10 without, and a portrait 48x32 one at the
    output size), the meta JSONs and a ``model: tiny`` config."""
    root = tmp_path_factory.mktemp("eval_data")
    for sub in ("videos", "dwpose", "camera"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    frames, entries = {}, {}
    for name, n, hw, seg in (("pexels_a", 30, (96, 64), (0, 30)), ("b", 12, (64, 96), (2, 10)),
                             ("pexels_c", 40, (48, 32), (3, 40))):
        video, pose = str(root / "videos" / f"{name}.mp4"), str(root / "dwpose" / f"{name}.mp4")
        frames[video] = (rng.random((n,) + hw + (3,)) * 255).astype(np.uint8)
        frames[pose] = (rng.random((n,) + hw + (3,)) * 255).astype(np.uint8)
        entries[name] = {"video_path": video, "kps_path": pose, "start_frame": seg[0],
                         "end_frame": seg[1]}
    (root / "camera" / "pexels_a.txt").write_text(_trajectory(30))
    (root / "camera" / "pexels_c.txt").write_text(_trajectory(40))
    metas = {}
    for key, names in (("vid", ["pexels_a", "b"]), ("img", ["pexels_c", "pexels_a"])):
        path = root / f"meta_{key}.json"
        path.write_text(json.dumps([entries[n] for n in names]))
        metas[key] = str(path)
    cfg = root / "tiny.yaml"
    cfg.write_text("model: tiny\n")
    return types.SimpleNamespace(root=root, frames=frames, meta=metas, cfg=str(cfg))


def _serve(monkeypatch, module, frames, reads, saved=None):
    def read_frames(path, indices=None, max_frames=None):
        reads.append((os.path.basename(path), None if indices is None else list(indices)))
        clip = frames[path]
        return clip[list(indices)] if indices is not None else clip

    monkeypatch.setattr(module, "read_frames", read_frames)
    if saved is not None:
        monkeypatch.setattr(module, "save_video", lambda v, path, fps=24.0: saved.update(
            {path: (np.asarray(v), fps)}))


def _record(monkeypatch, cls, calls, output):
    def call(self, ref, pose, plucker, clip, **kwargs):
        calls.append(dict(ref=np.asarray(ref), pose=np.asarray(pose),
                          plucker=np.asarray(plucker), clip=np.asarray(clip), **kwargs))
        return output(np.asarray(pose).shape)

    monkeypatch.setattr(cls, "__call__", call)


def _within_a_level(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() * 255 <= 1 + 1e-3


@pytest.mark.parametrize("script,argv", [
    ("eval_pose2vid", []),
    ("eval_pose2vid", ["-W", "32", "-H", "48", "-L", "4", "--stride", "2", "--seed", "3",
                       "--cfg", "2.0", "--steps", "2", "--output_dir", "o", "--dtype",
                       "float32", "--run_metrics", "--metrics_only", "--metrics_subset",
                       "frame,fid", "--metric_weights", "w"]),
    ("eval_pose2img", []),
    ("eval_pose2img", ["-W", "64", "-H", "40", "--seed", "1", "--cfg", "1.0", "--steps", "3",
                       "--eval_distance", "5", "--repeat", "2", "--output_dir", "o",
                       "--dtype", "float32", "--lpips_weights", "l.msgpack"]),
])
def test_argument_surface_matches_the_jax_scripts(monkeypatch, script, argv):
    jax_script = _jax_script(script)
    argv = ["--config", "c.yaml", "--test_meta", "m.json"] + argv
    monkeypatch.setattr(sys, "argv", [f"{script}.py"] + argv)
    ref = vars(jax_script.parse_args())
    ours = vars({"eval_pose2vid": eval_pose2vid, "eval_pose2img": eval_pose2img}[script]
                .parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref


def test_eval_pose2vid_feeds_the_pipeline_as_jax(data, tmp_path, monkeypatch):
    jax_script = _jax_script("eval_pose2vid")
    fixed = np.random.default_rng(1).random((1, L, 48, 32, 3)).astype(np.float32)

    def output(pose_shape):
        video = fixed if pose_shape[1] > pose_shape[2] else fixed.transpose(0, 1, 3, 2, 4)
        return types.SimpleNamespace(videos=video, seconds={})

    runs = {}
    for side, module, cls in (("jax", jax_script, JPose2Video),
                              ("port", eval_pose2vid, Pose2VideoPipeline)):
        run = runs[side] = types.SimpleNamespace(reads=[], saved={}, calls=[])
        _serve(monkeypatch, module, data.frames, run.reads, run.saved)
        _record(monkeypatch, cls, run.calls, output)
        argv = ["--config", data.cfg, "--test_meta", data.meta["vid"], "-W", "32", "-H", "48",
                "-L", str(L), "--stride", "3", "--steps", "2", "--cfg", "2.5", "--dtype",
                "float32", "--output_dir", str(tmp_path / side)]
        if side == "jax":
            monkeypatch.setattr(module, "load_pretrained_params", lambda system, cfg: None)
            monkeypatch.setattr(sys, "argv", ["eval_pose2vid.py"] + argv)
            module.main()
        else:
            module.main(argv + ["--device", "cpu"])
    jax_run, port = runs["jax"], runs["port"]
    assert port.reads == jax_run.reads
    assert ("pexels_a.mp4", [0, 3, 6, 9]) in port.reads  # stride 3
    assert ("b.mp4", [2, 4, 6, 8]) in port.reads        # reduced to 2, never clamped
    assert ("pexels_a.mp4", [6]) in port.reads and ("b.mp4", [6]) in port.reads  # middle
    assert len(port.calls) == len(jax_run.calls) == 2
    for ours, ref in zip(port.calls, jax_run.calls):
        for key in ("ref", "pose", "clip"):
            assert ours[key].shape == ref[key].shape and _within_a_level(ours[key], ref[key]), key
        np.testing.assert_allclose(ours["plucker"], ref["plucker"], atol=RAY_TOL, rtol=0)
        assert (ours["num_inference_steps"], ours["guidance_scale"]) == (
            ref["num_inference_steps"], ref["guidance_scale"]) == (2, 2.5)
    assert port.calls[0]["pose"].shape == (L, 48, 32, 3)  # portrait
    assert port.calls[1]["pose"].shape == (L, 32, 48, 3)  # landscape
    # the moving trajectory reached the first clip, the static camera the second
    assert np.abs(port.calls[0]["plucker"] - port.calls[1]["plucker"].transpose(
        0, 2, 1, 3)).max() > 1e-3
    names = {os.path.relpath(p, str(tmp_path / side)) for side, r in runs.items()
             for p in r.saved}
    assert names == {"gen/pexels_a.mp4", "gt/pexels_a.mp4", "gen/b.mp4", "gt/b.mp4"}
    for path, (video, fps) in port.saved.items():
        ref, ref_fps = jax_run.saved[path.replace(str(tmp_path / "port"), str(tmp_path / "jax"))]
        assert fps == ref_fps == 8.0 and video.shape == ref.shape
        assert _within_a_level(video, ref), path


@pytest.fixture(scope="module")
def lpips_msgpack(tmp_path_factory):
    """The port tool's LPIPS files and the JAX ``LPIPS`` variables of them,
    written by flax as a ``.msgpack``."""
    root = tmp_path_factory.mktemp("lpips")
    mk.main([str(root / "w"), "--skip-clip"])
    vgg = W.torch_load(str(root / "w" / W.LPIPS_VGG))
    lins = W.torch_load(str(root / "w" / W.LPIPS_LINS))
    variables = j_lpips.load_torch_weights({k: v.numpy() for k, v in vgg.items()},
                                           {k: v.numpy() for k, v in lins.items()})
    path = root / "lpips.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    return types.SimpleNamespace(path=str(path), weights=str(root / "w"))


def test_eval_pose2img_matches_jax(data, tmp_path, monkeypatch, lpips_msgpack):
    import cv2

    jax_script = _jax_script("eval_pose2img")
    image = np.random.default_rng(2).random((48, 32, 3)).astype(np.float32)

    def output(pose_shape):
        img = image if pose_shape[0] > pose_shape[1] else image.transpose(1, 0, 2)
        return types.SimpleNamespace(images=img[None], seconds={})

    runs = {}
    for side, module, cls in (("jax", jax_script, JPose2Image),
                              ("port", eval_pose2img, Pose2ImagePipeline)):
        run = runs[side] = types.SimpleNamespace(reads=[], calls=[])
        _serve(monkeypatch, module, data.frames, run.reads)
        _record(monkeypatch, cls, run.calls, output)
        argv = ["--config", data.cfg, "--test_meta", data.meta["img"], "-W", "32", "-H", "48",
                "--steps", "2", "--eval_distance", "30", "--repeat", "2", "--dtype", "float32",
                "--lpips_weights", lpips_msgpack.path, "--output_dir", str(tmp_path / side)]
        if side == "jax":
            monkeypatch.setattr(module, "load_pretrained_params", lambda system, cfg: None)
            monkeypatch.setattr(sys, "argv", ["eval_pose2img.py"] + argv)
            module.main()
        else:
            module.main(argv + ["--device", "cpu"])
    jax_run, port = runs["jax"], runs["port"]
    # reference = start, target = eval_distance later, held inside the segment
    assert port.reads == jax_run.reads
    assert ("pexels_c.mp4", [3, 33]) in port.reads and ("pexels_a.mp4", [0, 29]) in port.reads
    assert len(port.calls) == len(jax_run.calls) == 4
    for ours, ref in zip(port.calls, jax_run.calls):
        for key in ("ref", "pose", "clip"):
            assert ours[key].shape == ref[key].shape and _within_a_level(ours[key], ref[key]), key
        np.testing.assert_allclose(ours["plucker"], ref["plucker"], atol=RAY_TOL, rtol=0)
    with open(tmp_path / "jax" / "metrics.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "metrics.json") as f:
        ours = json.load(f)
    assert set(ours["summary"]) == set(ref["summary"]) == {"ssim", "psnr", "l1", "lpips",
                                                            "num_videos"}
    assert ours["summary"]["num_videos"] == ref["summary"]["num_videos"] == 4
    # the first clip is at the output size: no resize, so the same target
    for rec_ours, rec_ref in zip(ours["per_video"][:2], ref["per_video"][:2]):
        assert rec_ours["video"] == rec_ref["video"] == "pexels_c.mp4"
        for key in ("ssim", "psnr", "l1", "lpips"):
            assert abs(rec_ours[key] - rec_ref[key]) <= METRIC_TOL * abs(rec_ref[key]), key
    png_ours = cv2.imread(str(tmp_path / "port" / "pexels_c.png"))
    png_ref = cv2.imread(str(tmp_path / "jax" / "pexels_c.png"))
    assert png_ours.shape == (48, 4 * 32, 3) and np.array_equal(png_ours, png_ref)


@pytest.fixture(scope="module")
def written(data, tmp_path_factory, lpips_msgpack):
    """gen/gt mp4 files (OpenCV) of two 24-frame 48x32 clips and the LPIPS +
    I3D weights (no Inception: its 2048-d square root takes ~20 s here)."""
    root = tmp_path_factory.mktemp("written")
    rng = np.random.default_rng(3)
    for i in range(2):
        clip = rng.random((24, 48, 32, 3)).astype(np.float32)
        video_io.save_video(clip, str(root / "out" / "gen" / f"c{i}.mp4"), fps=8.0)
        noisy = np.clip(clip + rng.normal(0, 0.05, clip.shape), 0, 1)
        video_io.save_video(noisy, str(root / "out" / "gt" / f"c{i}.mp4"), fps=8.0)
    weights = root / "w"
    weights.mkdir()
    for name in (W.LPIPS_VGG, W.LPIPS_LINS, W.FVD_I3D):
        shutil.copy(os.path.join(lpips_msgpack.weights, name), weights / name)
    return types.SimpleNamespace(out=str(root / "out"), weights=str(weights))


def test_metrics_only_and_subsets_merge_as_jax(data, written, monkeypatch, tmp_path):
    jax_script = _jax_script("eval_pose2vid")
    monkeypatch.setattr(j_runner, "read_frames", video_io.read_frames)
    base = ["--config", data.cfg, "--test_meta", data.meta["vid"], "--output_dir",
            written.out, "--metric_weights", written.weights, "--run_metrics",
            "--metrics_only"]
    out_json = os.path.join(written.out, "metrics.json")
    merged = {}
    for side in ("jax", "port"):
        if os.path.exists(out_json):
            os.remove(out_json)
        for group in ("frame", "lpips", "fvd"):
            argv = base + ["--metrics_subset", group]
            if side == "jax":
                monkeypatch.setattr(sys, "argv", ["eval_pose2vid.py"] + argv)
                jax_script.main()
            else:
                eval_pose2vid.main(argv + ["--device", "cpu"])
        with open(out_json) as f:
            merged[side] = json.load(f)
    assert set(merged["port"]) == set(merged["jax"]) == {"ssim", "psnr", "l1", "lpips", "fvd",
                                                          "num_videos"}
    for key in ("ssim", "psnr", "l1", "lpips"):
        assert abs(merged["port"][key] - merged["jax"][key]) <= METRIC_TOL * abs(
            merged["jax"][key]), key
    assert abs(merged["port"]["fvd"] - merged["jax"]["fvd"]) <= 1e-3 * abs(merged["jax"]["fvd"])
    # without a subset: one whole record, not merged
    whole = eval_pose2vid.main(base[:-1] + ["--metrics_only", "--device", "cpu"])["metrics"]
    with open(out_json) as f:
        assert json.load(f) == whole
    assert whole == pytest.approx(merged["port"], rel=1e-6)


def test_eval_pose2vid_runs_end_to_end(data, written, tmp_path):
    out = tmp_path / "run"
    meta = tmp_path / "meta.json"
    rng = np.random.default_rng(4)
    (tmp_path / "videos").mkdir()
    (tmp_path / "dwpose").mkdir()
    entries = []
    for i in range(2):
        video, pose = tmp_path / "videos" / f"v{i}.mp4", tmp_path / "dwpose" / f"v{i}.mp4"
        video_io.save_video(rng.random((26, 48, 32, 3)).astype(np.float32), str(video), 8.0)
        video_io.save_video(rng.random((26, 48, 32, 3)).astype(np.float32), str(pose), 8.0)
        entries.append({"video_path": str(video), "kps_path": str(pose), "start_frame": 0,
                        "end_frame": 26})
    meta.write_text(json.dumps(entries))
    done = eval_pose2vid.main(["--config", data.cfg, "--test_meta", str(meta), "-W", "32", "-H",
                               "48", "-L", "24", "--stride", "1", "--steps", "2", "--dtype",
                               "float32", "--device", "cpu", "--output_dir", str(out),
                               "--run_metrics", "--metric_weights", written.weights])
    assert [c["name"] for c in done["clips"]] == ["v0", "v1"]
    for sub in ("gen", "gt"):
        for i in range(2):
            assert video_io.read_frames(str(out / sub / f"v{i}.mp4")).shape == (24, 48, 32, 3)
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics == done["metrics"] and metrics["num_videos"] == 2
    for key in ("ssim", "psnr", "l1", "lpips", "fvd"):
        assert np.isfinite(metrics[key]), key


def test_eval_pose2img_runs_end_to_end(data, tmp_path, lpips_msgpack):
    import cv2

    (tmp_path / "videos").mkdir()
    (tmp_path / "dwpose").mkdir()
    rng = np.random.default_rng(5)
    video, pose = tmp_path / "videos" / "w.mp4", tmp_path / "dwpose" / "w.mp4"
    video_io.save_video(rng.random((8, 48, 32, 3)).astype(np.float32), str(video), 8.0)
    video_io.save_video(rng.random((8, 48, 32, 3)).astype(np.float32), str(pose), 8.0)
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps([{"video_path": str(video), "kps_path": str(pose),
                                 "start_frame": 0, "end_frame": 8}]))
    res = eval_pose2img.main(["--config", data.cfg, "--test_meta", str(meta), "-W", "32", "-H",
                              "48", "--steps", "2", "--eval_distance", "5", "--dtype", "float32",
                              "--device", "cpu", "--output_dir", str(tmp_path / "out"),
                              "--lpips_weights", lpips_msgpack.path])
    with open(tmp_path / "out" / "metrics.json") as f:
        assert json.load(f) == res
    assert res["summary"]["num_videos"] == 1
    assert all(np.isfinite(res["summary"][k]) for k in ("ssim", "psnr", "l1", "lpips"))
    assert cv2.imread(str(tmp_path / "out" / "w.png")).shape == (48, 4 * 32, 3)


class FakeRuns:
    """Stands in for ``subprocess.run`` in the gate: the weights tool makes
    its directory, a generation writes (empty) gen/gt clips, a metrics run
    merges its group's values into ``metrics.json``. ``fail`` names steps
    that fail once; ``missing`` metrics are never written."""

    def __init__(self, fail=(), missing=()):
        self.calls, self.fail, self.missing = [], set(fail), set(missing)

    def __call__(self, cmd, cwd=None, check=False):
        self.calls.append(cmd)
        module = cmd[2]
        if module.endswith("make_random_metric_weights"):
            os.makedirs(cmd[3], exist_ok=True)
            open(os.path.join(cmd[3], W.FVD_I3D), "w").close()
            return subprocess.CompletedProcess(cmd, 0)
        out = cmd[cmd.index("--output_dir") + 1]
        step = cmd[-1] if "--metrics_subset" in cmd else "generate"
        if step in self.fail:
            self.fail.discard(step)
            return subprocess.CompletedProcess(cmd, 1)
        if step == "generate":
            meta = json.load(open(cmd[cmd.index("--test_meta") + 1]))
            for sub in ("gen", "gt"):
                os.makedirs(os.path.join(out, sub), exist_ok=True)
                for i in range(len(meta)):
                    open(os.path.join(out, sub, f"clip{i}.mp4"), "w").close()
        else:
            path = os.path.join(out, "metrics.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            rec.update({k: 0.5 for k in eval_gate.GROUP_KEYS[step] if k not in self.missing})
            rec["num_videos"] = 1
            json.dump(rec, open(path, "w"))
        return subprocess.CompletedProcess(cmd, 0)

    def steps(self):
        return [c[-1] if "--metrics_subset" in c else c[2].rsplit(".", 1)[1] for c in self.calls]


def _gate(monkeypatch, runs, work, *extra):
    monkeypatch.setattr(eval_gate.subprocess, "run", runs)
    monkeypatch.setattr(eval_gate, "stage_data", lambda root, clips, frames: _meta(root, clips))
    return eval_gate.main(["--clips", "2", "--device", "cpu", "--work", str(work), *extra])


def _meta(root, clips):
    path = os.path.join(root, "test_meta.json")
    with open(path, "w") as f:
        json.dump([{"video_path": f"v{i}.mp4"} for i in range(clips)], f)
    return path


def test_gate_runs_every_step_and_records_in_the_work_dir(monkeypatch, tmp_path):
    runs = FakeRuns(fail={"generate"})
    rec = _gate(monkeypatch, runs, tmp_path / "w")
    assert runs.steps() == ["make_random_metric_weights", "eval_pose2vid", "eval_pose2vid",
                            "frame,lpips", "fid", "fvd", "clip"]
    assert all(c[:3] == [sys.executable, "-m", "humanvid_tpu_torch.cli.eval_pose2vid"]
               for c in runs.calls[1:])
    gen = runs.calls[1]
    assert gen[gen.index("-W") + 1: gen.index("-W") + 2] == ["512"]
    assert ["-H", "768", "-L", "24", "--stride", "3"] == gen[gen.index("-H"):gen.index("-H") + 6]
    assert gen[-2:] == ["--device", "cpu"]
    assert rec["phase_attempts"] == {"generate": 2, "metrics[frame,lpips]": 1,
                                     "metrics[fid]": 1, "metrics[fvd]": 1, "metrics[clip]": 1}
    assert rec["skipped_metrics"] == [] and rec["device"] == "cpu"
    assert rec["resolution"] == "512x768x24f" and rec["clips"] == 2
    with open(tmp_path / "w" / "EVAL_GATE.json") as f:
        assert json.load(f) == rec
    assert (tmp_path / "w" / "cfg.py").read_text() == 'cfg = {"model": "tiny"}\n'


def test_gate_resumes_clips_and_groups(monkeypatch, tmp_path):
    _gate(monkeypatch, FakeRuns(), tmp_path / "w")
    metrics = tmp_path / "w" / "eval_out" / "metrics.json"
    rec = json.load(open(metrics))
    del rec["fvd"]
    json.dump(rec, open(metrics, "w"))
    again = FakeRuns()
    rec = _gate(monkeypatch, again, tmp_path / "w")
    assert again.steps() == ["fvd"]  # weights, data, clips and three groups kept
    assert rec["timings_s"]["generate_s"] == 0.0
    assert rec["timings_s"]["metrics[fid]_s"] == "resumed"
    assert rec["skipped_metrics"] == []


def test_gate_refuses_a_work_dir_of_other_settings(monkeypatch, tmp_path):
    _gate(monkeypatch, FakeRuns(), tmp_path / "w")
    runs = FakeRuns()
    with pytest.raises(SystemExit, match="other gate settings"):
        _gate(monkeypatch, runs, tmp_path / "w", "--steps", "3")
    assert runs.calls == []


def test_gate_fails_on_a_skipped_metric_after_recording_it(monkeypatch, tmp_path):
    with pytest.raises(SystemExit, match="skipped metrics.*fvd"):
        _gate(monkeypatch, FakeRuns(missing={"fvd"}), tmp_path / "w")
    rec = json.load(open(tmp_path / "w" / "EVAL_GATE.json"))
    assert rec["skipped_metrics"] == ["fvd"]


def test_gate_never_writes_the_pre_port_records(monkeypatch, tmp_path):
    for record in eval_gate.PRE_PORT_RECORDS:
        before = hashlib.sha256(open(record, "rb").read()).hexdigest()
        runs = FakeRuns()
        with pytest.raises(SystemExit, match="before the port"):
            _gate(monkeypatch, runs, tmp_path / "w", "--out", record)
        assert runs.calls == []
        assert hashlib.sha256(open(record, "rb").read()).hexdigest() == before
    assert os.path.basename(eval_gate.PRE_PORT_RECORDS[0]) == "EVAL_GATE_r05.json"


def test_gate_stages_protocol_shaped_clips(monkeypatch, tmp_path):
    saved = {}
    monkeypatch.setattr(video_io, "save_video", lambda v, path, fps=24.0: saved.update(
        {path: (v.shape, float(v.min()), float(v.max()), fps)}))
    meta = json.load(open(eval_gate.stage_data(str(tmp_path), 2, 5)))
    assert [os.path.basename(e["video_path"]) for e in meta] == ["clip0.mp4", "clip1.mp4"]
    assert all(e["start_frame"] == 0 and e["end_frame"] == 5 for e in meta)
    assert len(saved) == 4 and {s[0] for s in saved.values()} == {(5, 768, 512, 3)}
    assert all(0.0 <= s[1] <= s[2] <= 1.0 and s[3] == 8.0 for s in saved.values())
