"""Loading the released checkpoints: the port's ``load_pretrained`` against
the JAX package's ``load_pretrained_params`` followed by ``from_jax_params``,
on files written in the released layouts from seeded tiny parameters (the
JAX ``export_state_dict``): the SD1.5 UNet under ``unet/`` feeding both
UNets, the VAE in one file under the pre-diffusers-0.18 attention names,
the CLIP image encoder, the per-module ``.pth`` files with their wrappers
(``state_dict``, ``pose_encoder_state_dict``), a 5-D conv weight, and a
motion module file holding only the motion keys. Both loaders start from
the same seeded weights of their own (the JAX loader's ``init_params`` is
handed them), so the keys no file holds are compared too. Equal tensors,
exact."""

import copy
import logging
import os
import types

import numpy as np
import pytest
import torch

from test_torch_helpers import fill_params, jax_system_params
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.utils.convert import export_state_dict
from humanvid_tpu.utils.weights import load_pretrained_params
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.pipelines.system import COMPONENT_KINDS
from humanvid_tpu_torch.utils import convert
from humanvid_tpu_torch.utils.weights import from_jax_params, load_pretrained

OLD_NAMES = ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
             (".to_out.0.", ".proj_attn."))


@pytest.fixture(scope="module")
def jax_side():
    """(a JAX system whose ``init_params`` gives seeded weights, the seeded
    weights that the released files are written from)."""
    params = jax_system_params(JCamAnimate(jax_tiny_config()), 2, 64, 64)
    start = {name: fill_params(tree, 100 + i) for i, (name, tree) in enumerate(params.items())}
    return types.SimpleNamespace(init_params=lambda *a, **k: copy.deepcopy(start)), params


def _port(js, dtype=torch.float32):
    """The port's system from the JAX system's starting weights."""
    return CamAnimate(tiny_config(), device="cpu", dtype=dtype).load_jax_params(js.init_params())


def _export(params, name, seed_shift=0.0):
    sd = export_state_dict(params[name], COMPONENT_KINDS[name])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32) + seed_shift)
            for k, v in sd.items()}


def _is_motion(key):
    return ".motion_modules." in key


def write_release(root, params, safetensors_clip=False, reference_file=False):
    """The released files and a config naming them; returns the config."""
    base = os.path.join(root, "stable-diffusion-v1-5")
    os.makedirs(os.path.join(base, "unet"))
    torch.save(_export(params, "reference_unet"),
               os.path.join(base, "unet", "diffusion_pytorch_model.bin"))
    vae_dir = os.path.join(root, "sd-vae-ft-mse")
    os.makedirs(vae_dir)
    vae = {**_export(params, "vae_encoder"), **_export(params, "vae_decoder")}
    old = {}
    for k, v in vae.items():
        for new, was in OLD_NAMES:
            k = k.replace(new, was)
        old[k] = v
    assert any(".query." in k for k in old) and not any(".to_q." in k for k in old)
    torch.save(old, os.path.join(vae_dir, "diffusion_pytorch_model.bin"))
    enc = os.path.join(root, "image_encoder")
    os.makedirs(enc)
    if safetensors_clip:
        from safetensors.torch import save_file

        save_file(_export(params, "clip"), os.path.join(enc, "model.safetensors"))
    else:
        torch.save(_export(params, "clip"), os.path.join(enc, "pytorch_model.bin"))
    guider = _export(params, "pose_guider")
    guider["conv_in.weight"] = guider["conv_in.weight"][:, :, None]  # (O, I, 1, kh, kw)
    torch.save({"state_dict": guider}, os.path.join(root, "pose_guider.pth"))
    torch.save({"pose_encoder_state_dict": _export(params, "camera_encoder")},
               os.path.join(root, "camera_pose_encoder.pth"))
    den = _export(params, "denoising_unet")
    torch.save({k: v for k, v in den.items() if not _is_motion(k)},
               os.path.join(root, "denoising_unet.pth"))
    torch.save({k: v for k, v in den.items() if _is_motion(k)},
               os.path.join(root, "motion_module.pth"))
    cfg = {"base_model_path": base, "vae_model_path": vae_dir, "image_encoder_path": enc,
           "pose_guider_path": os.path.join(root, "pose_guider.pth"),
           "camera_pose_encoder_path": os.path.join(root, "camera_pose_encoder.pth"),
           "denoising_unet_path": os.path.join(root, "denoising_unet.pth"),
           "motion_module_path": os.path.join(root, "motion_module.pth")}
    if reference_file:  # a stage checkpoint over the base weights
        torch.save(_export(params, "reference_unet", 0.5),
                   os.path.join(root, "reference_unet.pth"))
        cfg["reference_unet_path"] = os.path.join(root, "reference_unet.pth")
    return cfg


@pytest.mark.parametrize("safetensors_clip,reference_file", [
    (False, False), (True, False), (False, True)],
    ids=["bin", "safetensors_clip", "reference_unet_pth"])
def test_load_pretrained_matches_jax(tmp_path, jax_side, safetensors_clip, reference_file):
    js, params = jax_side
    cfg = write_release(str(tmp_path), params, safetensors_clip, reference_file)
    ref = load_pretrained_params(js, cfg)
    port = load_pretrained(_port(js), cfg)
    for name, module in port.components().items():
        want = from_jax_params(ref[name], COMPONENT_KINDS[name])
        got = module.state_dict()
        assert set(got) == set(want), name
        for key, value in want.items():
            assert torch.equal(got[key], value), f"{name}: {key}"
    # every file took part: the seeded weights, not the init, are what loaded
    for name in ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder", "clip"):
        shift = 0.5 if reference_file and name == "reference_unet" else 0.0
        exported = _export(params, name, shift)
        for key, value in port.components()[name].state_dict().items():
            assert torch.equal(value, exported[key]), f"{name}: {key}"


def test_load_pretrained_writes_in_place_in_the_module_dtype(tmp_path, jax_side):
    js, params = jax_side
    cfg = write_release(str(tmp_path), params)
    system = _port(js, torch.bfloat16)
    before = {n: p for n, p in system.denoising_unet.named_parameters()}
    load_pretrained(system, cfg)
    den = _export(params, "denoising_unet")
    for name, p in system.denoising_unet.named_parameters():
        assert p is before[name] and p.dtype == torch.bfloat16
        assert torch.equal(p, den[name].to(torch.bfloat16)), name


def test_missing_path_keeps_the_weights_and_warns(tmp_path, jax_side, caplog):
    js, _ = jax_side
    cfg = {"pose_guider_path": str(tmp_path / "nowhere.pth"),
           "base_model_path": str(tmp_path / "no_base")}
    system = _port(js)
    before = {k: v.clone() for k, v in system.pose_guider.state_dict().items()}
    with caplog.at_level(logging.WARNING, logger="humanvid_tpu_torch.utils.weights"):
        load_pretrained(system, cfg)
    assert "weights not found" in caplog.text and "nowhere.pth" in caplog.text
    ref = from_jax_params(load_pretrained_params(js, cfg)["pose_guider"], "pose_guider")
    for k, v in system.pose_guider.state_dict().items():
        assert torch.equal(v, before[k]) and torch.equal(v, ref[k])


def test_missing_keys_are_logged_and_kept(tmp_path, jax_side, caplog):
    _, params = jax_side
    guider = _export(params, "pose_guider")
    dropped = sorted(guider)[0]
    del guider[dropped]
    guider["extra.weight"] = torch.zeros(3)
    torch.save(guider, tmp_path / "pose_guider.pth")
    system = CamAnimate(tiny_config(), device="cpu").init_random(2)
    kept = system.pose_guider.state_dict()[dropped].clone()
    with caplog.at_level(logging.INFO, logger="humanvid_tpu_torch.utils.weights"):
        load_pretrained(system, {"pose_guider_path": str(tmp_path / "pose_guider.pth")})
    assert "1 missing keys" in caplog.text and "1 unused checkpoint keys" in caplog.text
    assert torch.equal(system.pose_guider.state_dict()[dropped], kept)


def test_shape_mismatch_raises(tmp_path, jax_side):
    js, params = jax_side
    guider = _export(params, "pose_guider")
    guider["conv_in.weight"] = guider["conv_in.weight"][:, :, :2]
    path = str(tmp_path / "pose_guider.pth")
    torch.save(guider, path)
    with pytest.raises(ValueError, match="conv_in.weight"):
        load_pretrained(CamAnimate(tiny_config(), device="cpu"), {"pose_guider_path": path})
    with pytest.raises(ValueError):
        load_pretrained_params(js, {"pose_guider_path": path})


def test_msgpack_path_raises(tmp_path):
    path = tmp_path / "denoising_unet.msgpack"
    path.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        load_pretrained(CamAnimate(tiny_config(), device="cpu"),
                        {"denoising_unet_path": str(path)})


def test_convert_state_dict_aliases_squeeze_and_reports():
    target = {"a.to_q.weight": torch.zeros(2, 3), "a.to_out.0.bias": torch.zeros(2),
              "conv.weight": torch.zeros(4, 3, 3, 3), "gone.weight": torch.zeros(1)}
    source = {"a.query.weight": torch.ones(2, 3), "a.proj_attn.bias": torch.ones(2),
              "conv.weight": torch.ones(4, 3, 1, 3, 3), "spare": torch.ones(1)}
    found, missing, unused = convert.convert_state_dict(target, source)
    assert set(found) == {"a.to_q.weight", "a.to_out.0.bias", "conv.weight"}
    assert found["conv.weight"].shape == (4, 3, 3, 3)
    assert missing == ["gone.weight"] and unused == ["spare"]


def test_load_torch_state_dict_unwraps(tmp_path):
    sd = {"w": torch.arange(3.0)}
    for i, wrap in enumerate(({"state_dict": sd}, {"pose_encoder_state_dict": sd}, sd)):
        torch.save(wrap, tmp_path / f"{i}.pth")
        got = convert.load_torch_state_dict(str(tmp_path / f"{i}.pth"))
        assert list(got) == ["w"] and torch.equal(got["w"], sd["w"])
