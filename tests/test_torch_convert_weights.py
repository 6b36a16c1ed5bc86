"""``python -m humanvid_tpu_torch.cli.convert_weights`` on the CPU at the tiny
config.

- ``import`` of released-layout files written from seeded parameters (the
  files of ``test_torch_load_pretrained.py``) gives ``{component}-0.pt``
  files equal, tensor for tensor, to ``load_pretrained`` into a zeroed
  system, which the port's checkpoint loader takes back;
- ``export`` of a checkpoint directory gives the ``.pth`` files, key sets
  and tensors, that the JAX ``scripts/convert_weights.py export`` writes
  from the same weights (its msgpack checkpoints; its ``init_params`` is
  handed the seeded trees, as ``abstract=True`` is slow here), only for the
  modules the directory holds.
"""

import copy
import importlib.util
import os
import sys
from pathlib import Path

import pytest
import torch

from test_torch_helpers import fill_params, jax_system_params
from test_torch_load_pretrained import write_release
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from humanvid_tpu_torch.cli import convert_weights
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from humanvid_tpu_torch.utils.weights import load_pretrained

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def params():
    raw = jax_system_params(JCamAnimate(jax_tiny_config()), 2, 64, 64)
    return {name: fill_params(tree, 200 + i) for i, (name, tree) in enumerate(raw.items())}


def test_import_writes_what_load_pretrained_loads(tmp_path, params):
    cfg = write_release(str(tmp_path / "release"), params)
    out = tmp_path / "converted"
    paths = convert_weights.main([
        "import", "--base_model", cfg["base_model_path"], "--vae", cfg["vae_model_path"],
        "--image_encoder", cfg["image_encoder_path"],
        "--denoising_unet", cfg["denoising_unet_path"],
        "--pose_guider", cfg["pose_guider_path"],
        "--camera_encoder", cfg["camera_pose_encoder_path"],
        "--motion_module", cfg["motion_module_path"],
        "--out_dir", str(out), "--tiny", "--device", "cpu"])
    want = CamAnimate(tiny_config(), device="cpu")
    for module in want.components().values():
        for t in module.state_dict().values():
            t.zero_()
    load_pretrained(want, cfg)
    assert sorted(paths) == sorted(str(out / f"{c}-0.pt") for c in want.components())
    fresh = CamAnimate(tiny_config(), device="cpu")
    for name, module in want.components().items():
        got = load_checkpoint(str(out / f"{name}-0.pt"))
        ref = module.state_dict()
        assert set(got) == set(ref), name
        for key, value in ref.items():
            assert torch.equal(got[key], value), f"{name}: {key}"
        getattr(fresh, name).load_state_dict(got, strict=True)


def _jax_export(argv, params, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", ROOT / "scripts" / "convert_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(JCamAnimate, "init_params", lambda self, *a, **k: copy.deepcopy(params))
    monkeypatch.setattr(sys, "argv", ["convert_weights.py"] + argv)
    mod.main()


@pytest.mark.parametrize("held", [
    ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder"),
    ("denoising_unet", "camera_encoder")], ids=["all_four", "two"])
def test_export_matches_jax_script(tmp_path, params, monkeypatch, held):
    system = CamAnimate(tiny_config(), device="cpu").load_jax_params(params)
    ckpt = tmp_path / "ckpt"
    for name in held:
        save_checkpoint(str(ckpt), name, getattr(system, name).state_dict(), 5)
        j_save_checkpoint(str(ckpt), name, params[name], 5)
    paths = convert_weights.main(["export", "--ckpt_dir", str(ckpt), "--step", "5",
                                  "--out_dir", str(tmp_path / "port"), "--tiny",
                                  "--device", "cpu"])
    _jax_export(["export", "--ckpt_dir", str(ckpt), "--step", "5", "--out_dir",
                 str(tmp_path / "jax"), "--tiny"], params, monkeypatch)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in paths) == names
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == len(held)
    for name in names:
        got = torch.load(tmp_path / "port" / name, weights_only=True)
        want = torch.load(tmp_path / "jax" / name, weights_only=True)
        assert set(got) == set(want), name
        for key, value in want.items():
            assert torch.equal(got[key], value), f"{name}: {key}"
