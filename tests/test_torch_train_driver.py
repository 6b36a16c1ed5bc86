"""The port's training command lines on the CPU (tiny model, fp32), the
mirror of ``tests/test_train_driver.py``, on clips, meta JSON and TUM camera
files this test writes.

- both stages end to end through ``run_training``: the per-module files and
  their rotation, the validation renders, ``run/metrics.jsonl`` and
  ``run/config.json``, and a profiler trace of steps 10-12;
- an exact resume: 4 steps straight and 2 steps plus a resumed 2 give the
  same masters, moments and batch order bit for bit, also with accumulation
  2 and a checkpoint in the middle of an accumulation, and in stage 1. Each
  sample's generator (unseeded in both packages) is seeded alike here, so
  that both runs see the same samples;
- a stage-2 resume from a stage-1 directory raises in the port, naming the
  video UNet's motion keys, as the JAX driver raises (flax's ``ValueError``,
  shown beside it); a resume at or past ``max_train_steps`` takes no step;
- the argument surface is the JAX script's plus ``--device``, and the
  optimizer and step configs a train config gives are the JAX driver's;
- the system a stage trains (gradient checkpointing, FF chunks, the camera
  position table, the stage-1 video UNet's topology) is the JAX driver's
  for ``configs/train/stage{1,2}.yaml`` and for tiny configs;
- the JAX-only settings raise.
"""

import argparse
import dataclasses
import json
import math
import os
import random
import types

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import jax_system_params
from humanvid_tpu_torch.cli import train_stage_1 as drv
from humanvid_tpu_torch.cli import train_stage_2 as drv2
from humanvid_tpu_torch.data import datasets as tds
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.train import system_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 14, 48, 32  # the clips: vertical


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pexels_train_data")
    for sub in ("videos", "dwpose", "camera"):
        (root / "src" / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = ("a", "b", "c")
    for name in names:
        for sub in ("videos", "dwpose"):
            video_io.save_video(rng.random((F, H, W, 3)).astype(np.float32),
                                str(root / "src" / sub / f"{name}.mp4"), fps=8.0)
        lines = []
        for i in range(F):  # c2w lines: t tx ty tz qx qy qz qw fx fy scale
            yaw = 0.03 * i
            lines.append(f"{i} {0.01 * i} 0 {-0.02 * i} 0 {math.sin(yaw / 2)} 0 "
                         f"{math.cos(yaw / 2)} 1.0 1.788 1.0")
        (root / "src" / "camera" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    meta = [{"video_path": str(root / "src" / "videos" / f"{n}.mp4"),
             "kps_path": str(root / "src" / "dwpose" / f"{n}.mp4"),
             "start_frame": 0, "end_frame": F} for n in names]
    meta_path = root / "meta.json"
    meta_path.write_text(json.dumps(meta))
    return str(meta_path)


def _config(tmp_path, meta_path, stage, exp, **overrides):
    cfg = {
        "model": "tiny",
        "n_sample_frames": 4,
        "data": {"train_bs": 2, "train_size_small": 32, "train_size_large": 48,
                 "horizontal_meta": [], "vertical_meta": [meta_path], "sample_margin": 4,
                 "sample_rate": 3, "n_sample_frames": 4, "num_workers": 2},
        "solver": {"gradient_accumulation_steps": 1,
                   "enable_gradient_checkpointing": stage == 2, "max_train_steps": 3,
                   "max_grad_norm": 1.0, "learning_rate": 1.0e-4, "lr_warmup_steps": 0,
                   "lr_scheduler": "constant", "adam_beta1": 0.9, "adam_beta2": 0.999,
                   "adam_weight_decay": 1.0e-2, "adam_epsilon": 1.0e-8},
        "val": {"validation_steps": 0},
        "uncond_ratio": 0.1, "noise_offset": 0.05, "snr_gamma": 5.0, "seed": 0,
        "checkpointing_steps": 2, "exp_name": exp, "output_dir": str(tmp_path / "out"),
    }
    for key, value in overrides.items():
        if key in cfg["solver"] or key in ("dcn_slices", "checkpoint_backend", "adam_mu_dtype"):
            cfg["solver"][key] = value
        elif key in cfg["data"]:
            cfg["data"][key] = value
        else:
            cfg[key] = value
    path = tmp_path / f"{exp}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _argv(path, *extra):
    return ["--config", path, "--dtype", "float32", "--device", "cpu", *extra]


def _steps_of(files, prefix):
    return sorted(int(f[len(prefix) + 1:-3]) for f in files
                  if f.startswith(prefix + "-") and f.endswith(".pt"))


def test_stage1_driver_end_to_end(data_tree, tmp_path):
    cfg = _config(tmp_path, data_tree, 1, "s1", max_train_steps=13, checkpointing_steps=3,
                  val={"validation_steps": 6})
    out = drv.run_training(1, _argv(cfg, "--profile_dir", str(tmp_path / "trace")))
    exp = tmp_path / "out" / "s1"
    files = os.listdir(exp)
    for prefix in ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder",
                   "opt_state"):
        # saves at 3, 6, 9, 12 with the last 3 kept, and the final save at 13
        assert _steps_of(files, prefix) == [6, 9, 12, 13], (prefix, files)
    assert not any(f.startswith("motion_module") for f in files)
    assert sorted(os.listdir(exp / "validation")) == ["val_12.png", "val_6.png"]
    records = [json.loads(line) for line in open(exp / "run" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [13]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)
    assert out["logged"] == [{k: r[k] for k in ("step", "loss", "grad_norm")} for r in records]
    assert json.load(open(exp / "run" / "config.json"))["exp_name"] == "s1"
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert len(out["step_seconds"]) == len(out["data_seconds"]) == 13
    assert set(out["averages"]) == {"data", "step"}
    assert [c["step"] for c in out["checkpoints"]] == [3, 6, 9, 12, 13]


def test_stage2_driver_end_to_end(data_tree, tmp_path):
    cfg = _config(tmp_path, data_tree, 2, "s2", max_train_steps=24, checkpointing_steps=2,
                  val={"validation_steps": 12})
    drv2.main(_argv(cfg))
    exp = tmp_path / "out" / "s2"
    files = os.listdir(exp)
    for prefix in ("motion_module", "camera_encoder", "opt_state"):
        assert _steps_of(files, prefix) == list(range(6, 25, 2)), (prefix, files)
    for prefix in ("reference_unet", "denoising_unet", "pose_guider"):
        assert not any(f.startswith(prefix) for f in files)
    motion = torch.load(exp / "motion_module-24.pt", weights_only=True)
    assert motion and all(".motion_modules." in k for k in motion)
    assert sorted(os.listdir(exp / "validation")) == ["val_12.mp4", "val_24.mp4"]
    frames = video_io.read_frames(str(exp / "validation" / "val_24.mp4"))
    assert frames.shape == (4, H, 4 * W, 3)  # ref | pose | generated | target
    records = [json.loads(line) for line in open(exp / "run" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [20, 24]


def _seed_samples(monkeypatch):
    """Each sample's generator seeded alike (it is unseeded in both packages)."""
    monkeypatch.setattr(tds, "random", types.SimpleNamespace(
        Random=lambda *a: random.Random(a[0] if a else 5)))


def _recording_steps(monkeypatch):
    seen = []
    step = drv.train_step

    def recorded(system, state, sched, cfg, batch, draws=None, generator=None):
        seen.append((state.step, float(batch["tgt"].double().sum()), draws.t.tolist(),
                     draws.uncond))
        return step(system, state, sched, cfg, batch, draws=draws, generator=generator)

    monkeypatch.setattr(drv, "train_step", recorded)
    return seen


def _final(exp_dir, step, stage):
    prefixes = (("motion_module", "camera_encoder") if stage == 2 else
                ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder"))
    return {p: torch.load(os.path.join(exp_dir, f"{p}-{step}.pt"), weights_only=True)
            for p in prefixes + ("opt_state",)}


def _assert_same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("stage,k,split", [(2, 1, 2), (2, 2, 3), (1, 1, 2)],
                         ids=["stage2", "stage2-accumulate2-mid", "stage1"])
def test_resume_is_exact(data_tree, tmp_path, monkeypatch, stage, k, split):
    _seed_samples(monkeypatch)
    seen = _recording_steps(monkeypatch)
    kw = dict(train_bs=1, gradient_accumulation_steps=k, lr_warmup_steps=1,
              checkpointing_steps=100, uncond_ratio=0.5)
    drv.run_training(stage, _argv(_config(tmp_path, data_tree, stage, "straight",
                                          max_train_steps=4, **kw)))
    straight = list(seen)
    seen.clear()
    drv.run_training(stage, _argv(_config(tmp_path, data_tree, stage, "broken",
                                          max_train_steps=split, **kw)))
    exp = str(tmp_path / "out" / "broken")
    run = drv.setup(stage, _argv(_config(
        tmp_path, data_tree, stage, "broken", max_train_steps=4,
        resume_from_checkpoint=exp, resume_step=split, **kw)))
    # before its first step the resumed run holds what the files hold
    saved = _final(exp, split, stage)
    state = run.state
    assert state.step == split and state.micro == split % k
    assert state.updates == split // k
    opt = saved["opt_state"]
    for i, name in enumerate(state.names):
        assert torch.equal(state.mu[i], opt["mu"][name]) and torch.equal(state.nu[i],
                                                                          opt["nu"][name])
        comp, _, key = name.partition("/")
        prefix = "motion_module" if stage == 2 and comp == "denoising_unet" else comp
        assert torch.equal(state.masters[i], saved[prefix][key]), name
    out = drv.train(run)
    assert [c["step"] for c in out["checkpoints"]] == [4]
    assert seen == straight  # the batches in the same order, and the same draws
    _assert_same_bits(_final(exp, 4, stage), _final(str(tmp_path / "out" / "straight"), 4, stage))


def test_stage2_resume_from_a_stage1_dir_raises_in_the_port(data_tree, tmp_path):
    drv.run_training(1, _argv(_config(tmp_path, data_tree, 1, "s1", max_train_steps=2)))
    cfg = _config(tmp_path, data_tree, 2, "s2", max_train_steps=4,
                  resume_from_checkpoint=str(tmp_path / "out" / "s1"), resume_step=2)
    with pytest.raises(ValueError, match=r"denoising_unet-2\.pt lacks .*motion_modules"):
        drv.run_training(2, _argv(cfg))


def _jax_driver():
    import importlib

    from humanvid_tpu.ops import attention

    backend = attention.get_default_attention_backend()
    script = importlib.import_module("scripts.train_stage_1")
    attention.set_default_attention_backend(backend)  # the script sets it at import
    return script


def test_jax_driver_stage2_resume_from_a_stage1_dir_raises(data_tree, tmp_path, monkeypatch):
    """The JAX side of the finding above (the JAX package is not repaired):
    the driver's ``load_checkpoint`` of stage 1's video UNet into stage 2's
    raises flax's ``ValueError``."""
    from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
    from humanvid_tpu.train.checkpoint import save_train_checkpoint as j_save

    script = _jax_driver()
    s1 = _config(tmp_path, data_tree, 1, "s1")
    js1 = JCamAnimate(_jax_system_cfg(script, 1, s1))
    assert not js1.config.denoising_unet.use_motion_module
    params = jax_system_params(js1, 4, H, W)
    j_save(str(tmp_path / "s1"), {k: params[k] for k in (
        "reference_unet", "denoising_unet", "pose_guider", "camera_encoder")}, 2)
    # seeded trees in place of the JAX init (its CPU compile is the slow part)
    monkeypatch.setattr(script, "load_pretrained_params",
                        lambda system, cfg: jax_system_params(system, 4, H, W))
    cfg = _config(tmp_path, data_tree, 2, "s2", max_train_steps=4,
                  resume_from_checkpoint=str(tmp_path / "s1"), resume_step=2)
    with pytest.raises(ValueError, match=r"target dict contains keys .*_motion_"):
        script.run_training(2, ["--config", cfg, "--dtype", "float32"])


def _jax_system_cfg(script, stage, path):
    """The JAX driver's ``system_cfg`` for the config at ``path``:
    ``CamAnimate`` is replaced by a recorder that stops the run."""
    class Stop(Exception):
        pass

    captured = {}

    def record(config, **kwargs):
        captured["config"] = config
        raise Stop

    orig = script.CamAnimate
    script.CamAnimate = record
    try:
        with pytest.raises(Stop):
            script.run_training(stage, ["--config", path])
    finally:
        script.CamAnimate = orig
    return captured["config"]


def test_a_resume_at_max_steps_takes_no_step(data_tree, tmp_path, caplog):
    drv.run_training(2, _argv(_config(tmp_path, data_tree, 2, "s2", max_train_steps=2)))
    cfg = _config(tmp_path, data_tree, 2, "s2", max_train_steps=2,
                  resume_from_checkpoint=str(tmp_path / "out" / "s2"), resume_step=2)
    with caplog.at_level("WARNING"):
        out = drv.run_training(2, _argv(cfg))
    assert out["step_seconds"] == [] and out["logged"] == []
    assert "no step is taken" in caplog.text


@pytest.mark.parametrize("argv", [[], ["--dtype", "float32", "--profile_dir", "p"]])
def test_argument_surface_is_the_jax_scripts_plus_device(monkeypatch, argv):
    script = _jax_driver()

    class Stop(Exception):
        pass

    captured = {}
    parse = argparse.ArgumentParser.parse_args

    def record(self, args=None, namespace=None):
        captured.update(vars(parse(self, args, namespace)))
        raise Stop

    argv = ["--config", "c.yaml"] + argv
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    with pytest.raises(Stop):
        script.run_training(1, argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    ours = vars(drv.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == captured


def _levers(config):
    return {
        "unet": {n: (getattr(config, n).gradient_checkpointing, getattr(config, n).ff_chunk_tokens)
                 for n in ("reference_unet", "denoising_unet")},
        "motion": config.denoising_unet.use_motion_module,
        "camera": (config.camera_encoder.position_encoding_max_len,
                   config.camera_encoder.ff_chunk_tokens),
    }


@pytest.mark.parametrize("case", ["stage1.yaml", "stage2.yaml", "tiny-1", "tiny-2-ckpt",
                                  "tiny-2-chunk"])
def test_system_config_is_the_jax_drivers(tmp_path, case):
    script = _jax_driver()
    if case.endswith(".yaml"):
        stage, path = int(case[5]), os.path.join(ROOT, "configs", "train", case)
    else:
        stage = int(case.split("-")[1])
        solver = {"tiny-1": {}, "tiny-2-ckpt": {"enable_gradient_checkpointing": True},
                  "tiny-2-chunk": {"enable_gradient_checkpointing": True,
                                   "ff_chunk_tokens": 96}}[case]
        path = str(tmp_path / "c.yaml")
        (tmp_path / "c.yaml").write_text(yaml.safe_dump(
            {"model": "tiny", "n_sample_frames": 6, "solver": solver}))
    want = _jax_system_cfg(script, stage, path)
    got = system_config(drv.load_config(path), stage)
    assert _levers(got) == _levers(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == "stage1.yaml":  # the recipe as shipped: no checkpointing, no chunks
        assert _levers(got)["unet"]["denoising_unet"] == (False, 0)
    if case == "stage2.yaml":
        assert _levers(got)["unet"]["denoising_unet"] == (True, 1024)


@pytest.mark.parametrize("solver", [{}, {"gradient_accumulation_steps": 2,
                                         "adam_mu_dtype": "bfloat16", "lr_warmup_steps": 3,
                                         "max_grad_norm": 0.5}])
def test_optimizer_and_step_configs_are_the_jax_drivers(data_tree, tmp_path, monkeypatch,
                                                        solver):
    script = _jax_driver()

    class Stop(Exception):
        pass

    captured = {}
    make_optimizer = script.make_optimizer

    def record_opt(params, predicate, config):
        captured["opt"] = config
        return make_optimizer(params, predicate, config)

    def record_step(system, sched, cfg, trainable_predicate=None):
        captured["step"] = cfg
        raise Stop

    monkeypatch.setattr(script, "load_pretrained_params",
                        lambda system, cfg: jax_system_params(system, 4, H, W))
    monkeypatch.setattr(script, "make_optimizer", record_opt)
    monkeypatch.setattr(script, "make_train_step", record_step)
    cfg = _config(tmp_path, data_tree, 2, "s2", uncond_ratio=0.3, noise_offset=0.02,
                  snr_gamma=3.0, **solver)
    with pytest.raises(Stop):
        script.run_training(2, ["--config", cfg, "--dtype", "float32"])
    run = drv.setup(2, _argv(cfg))
    assert dataclasses.asdict(run.state.config) == dataclasses.asdict(captured["opt"])
    assert dataclasses.asdict(run.tcfg) == dataclasses.asdict(captured["step"])


@pytest.mark.parametrize("setting,match", [({"dcn_slices": 2}, "dcn_slices"),
                                           ({"checkpoint_backend": "orbax"}, "orbax")])
def test_jax_only_settings_raise(data_tree, tmp_path, setting, match):
    cfg = _config(tmp_path, data_tree, 2, "s2", **setting)
    with pytest.raises(ValueError, match=match):
        drv.run_training(2, _argv(cfg))
    assert not os.path.exists(tmp_path / "out" / "s2")
