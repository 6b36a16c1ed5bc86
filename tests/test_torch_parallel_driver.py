"""The training command lines on several gloo ranks on the CPU, as
``torchrun`` runs them (``parallel.launch`` sets the same environment and
joins the ranks through a ``file://`` store), tiny model, fp32, on clips
this test writes:

- stage 2 on 4 ranks with ``dcn_slices: 2`` (a 2 x 2 mesh) and
  ``shard_optimizer_states: true`` (ZeRO-1 over the 2 ranks of a slice):
  every rank logs the same losses, and rank 0 alone writes the per-module
  files, with whole moments;
- stage 1 on 2 ranks with ``checkpoint_backend: orbax``
  (``torch.distributed.checkpoint``) and ZeRO-1, and a resume from its
  newest step that takes the next step;
- a global batch that the ranks do not divide raises, naming the gcd.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from humanvid_tpu_torch.cli.train_stage_1 import run_training
from humanvid_tpu_torch.data import video_io
from humanvid_tpu_torch.parallel.launch import launch

F, H, W = 14, 48, 32  # the clips: vertical


@pytest.fixture(scope="module")
def meta_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("pexels_dp_data")
    for sub in ("videos", "dwpose", "camera"):
        (root / "src" / sub).mkdir(parents=True)
    rng = np.random.default_rng(1)
    names = ("a", "b", "c", "d")
    for name in names:
        for sub in ("videos", "dwpose"):
            video_io.save_video(rng.random((F, H, W, 3)).astype(np.float32),
                                str(root / "src" / sub / f"{name}.mp4"), fps=8.0)
        lines = [f"{i} {0.01 * i} 0 {-0.02 * i} 0 {math.sin(0.015 * i)} 0 "
                 f"{math.cos(0.015 * i)} 1.0 1.788 1.0" for i in range(F)]
        (root / "src" / "camera" / f"{name}.txt").write_text("\n".join(lines) + "\n")
    meta = [{"video_path": str(root / "src" / "videos" / f"{n}.mp4"),
             "kps_path": str(root / "src" / "dwpose" / f"{n}.mp4"),
             "start_frame": 0, "end_frame": F} for n in names]
    path = root / "meta.json"
    path.write_text(json.dumps(meta))
    return str(path)


def _config(tmp_path, meta, stage, exp, train_bs, **solver):
    cfg = {
        "model": "tiny", "n_sample_frames": 4,
        "data": {"train_bs": train_bs, "train_size_small": 32, "train_size_large": 48,
                 "horizontal_meta": [], "vertical_meta": [meta], "sample_margin": 4,
                 "sample_rate": 3, "n_sample_frames": 4, "num_workers": 1},
        "solver": {"gradient_accumulation_steps": 1,
                   "enable_gradient_checkpointing": stage == 2, "max_train_steps": 3,
                   "max_grad_norm": 1.0, "learning_rate": 1.0e-4, "lr_warmup_steps": 1,
                   "lr_scheduler": "constant", "adam_beta1": 0.9, "adam_beta2": 0.999,
                   "adam_weight_decay": 1.0e-2, "adam_epsilon": 1.0e-8,
                   "shard_optimizer_states": True, **solver},
        "val": {"validation_steps": 0},
        "uncond_ratio": 0.1, "noise_offset": 0.05, "snr_gamma": 5.0, "seed": 0,
        "checkpointing_steps": 2, "exp_name": exp, "output_dir": str(tmp_path / "out"),
    }
    path = tmp_path / f"{exp}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return ["--config", str(path), "--dtype", "float32", "--device", "cpu"]


def test_stage2_on_a_2x2_mesh_with_zero1(meta_path, tmp_path):
    argv = _config(tmp_path, meta_path, 2, "s2", 4, dcn_slices=2)
    out = launch(run_training, 4, args=(2, argv), timeout_s=180, join_timeout_s=420)
    assert all(r["logged"] == out[0]["logged"] for r in out)
    assert [r["step"] for r in out[0]["logged"]] == [3]
    assert np.isfinite(out[0]["logged"][0]["loss"])
    exp = tmp_path / "out" / "s2"
    files = sorted(os.listdir(exp))
    assert {f"{p}-{s}.pt" for p in ("motion_module", "camera_encoder", "opt_state")
            for s in (2, 3)} <= set(files)
    opt = torch.load(exp / "opt_state-3.pt", weights_only=True)
    motion = torch.load(exp / "motion_module-3.pt", weights_only=True)
    assert opt["step"] == 3 and opt["updates"] == 3
    for name, nu in opt["nu"].items():  # whole moments, gathered from the shards
        component, _, key = name.partition("/")
        if component == "denoising_unet":
            assert nu.shape == motion[key].shape, name
    assert [c["step"] for c in out[0]["checkpoints"]] == [2, 3]


def test_stage1_distributed_checkpoints_and_resume(meta_path, tmp_path):
    argv = _config(tmp_path, meta_path, 1, "s1", 2, max_train_steps=2,
                   checkpoint_backend="orbax")
    launch(run_training, 2, args=(1, argv), timeout_s=180, join_timeout_s=420)
    dcp = tmp_path / "out" / "s1" / "dcp"
    assert sorted(os.listdir(dcp)) == ["2"]
    assert not any(f.endswith(".pt") for f in os.listdir(tmp_path / "out" / "s1"))
    cfg = tmp_path / "s1.yaml"
    text = yaml.safe_load(cfg.read_text())
    text["solver"]["max_train_steps"] = 3
    text["resume_from_checkpoint"] = str(tmp_path / "out" / "s1")
    cfg.write_text(yaml.safe_dump(text))
    out = launch(run_training, 2, args=(1, argv), timeout_s=180, join_timeout_s=420)
    assert [r["step"] for r in out[0]["logged"]] == [3]
    assert len(out[0]["step_seconds"]) == 1
    assert sorted(os.listdir(dcp)) == ["2", "3"]


def test_a_batch_the_ranks_do_not_divide_raises(meta_path, tmp_path):
    argv = _config(tmp_path, meta_path, 2, "odd", 1)
    with pytest.raises(Exception, match=r"train_bs=1 does not divide over 2 ranks \(gcd 1\)"):
        launch(run_training, 2, args=(2, argv), timeout_s=60, join_timeout_s=180)
    assert not os.path.exists(tmp_path / "out" / "odd")
