"""Weights for the port's modules: JAX parameter trees and released checkpoints.

``from_jax_params(flax_params, kind)`` takes a flax parameter tree (nested
dicts of numpy arrays, ``{"params": {...}}``) of one component and returns
the state dict that the matching port module loads with
``load_state_dict(strict=True)``. Keys are the reference's diffusers /
transformers / AnimateDiff / CameraCtrl state-dict keys; layouts change as

- conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw)
- dense kernel (in, out)        -> weight (out, in)
- norm scale                    -> weight
- the CLIP layers, stacked by ``nn.scan`` under ``params/layers`` with a
  leading (num_layers,) axis   -> one key set per layer

This module keeps its own copy of the key translation; it needs no JAX.

``load_pretrained(system, cfg)`` fills a ``CamAnimate`` from the released
torch checkpoints that a prompt config names (``utils/convert.py``), or from
the JAX package's flax ``.msgpack`` trees (read by ``utils/msgpack.py``).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List

import numpy as np
import torch

from .convert import TorchDict, convert_state_dict, load_torch_state_dict
from .msgpack import load_msgpack

logger = logging.getLogger(__name__)

KINDS = ("unet", "pose_guider", "camera_encoder", "vae_encoder", "vae_decoder", "clip")

_ATTN = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}
_FF = {"proj_in": "net.0.proj", "proj_out": "net.2"}


def _suffix(leaf: str) -> str:
    return "weight" if leaf in ("kernel", "scale") else leaf


def _unet_key(parts: List[str]) -> str:
    name, mid, leaf = parts[0], parts[1:-1], _suffix(parts[-1])

    def tblock(rest: List[str], base: str) -> str:
        base = f"{base}.transformer_blocks.{rest[0].split('_')[1]}"
        sub = rest[1]
        if sub in ("attn1", "attn2"):
            return f"{base}.{sub}.{_ATTN[rest[2]]}.{leaf}"
        if sub == "ff":
            return f"{base}.ff.{_FF[rest[2]]}.{leaf}"
        return f"{base}.{sub}.{leaf}"

    def motion(rest: List[str], base: str) -> str:
        tt = f"{base}.temporal_transformer"
        if rest[0] in ("norm", "proj_in", "proj_out"):
            return f"{tt}.{rest[0]}.{leaf}"
        base = f"{tt}.transformer_blocks.{rest[0].split('_')[1]}"
        sub = rest[1]
        if sub.startswith("attention_blocks_"):
            # the JAX TemporalAttention wraps its attention as "attn"
            return f"{base}.attention_blocks.{sub.rsplit('_', 1)[1]}.{_ATTN[rest[3]]}.{leaf}"
        if sub.startswith("norms_"):
            return f"{base}.norms.{sub.rsplit('_', 1)[1]}.{leaf}"
        if sub == "ff":
            return f"{base}.ff.{_FF[rest[2]]}.{leaf}"
        if sub == "ff_norm":
            return f"{base}.ff_norm.{leaf}"
        raise KeyError("/".join(parts))

    if name in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{name}.{leaf}"
    if name.startswith("time_embedding_"):
        return f"time_embedding.{name[len('time_embedding_'):]}.{leaf}"
    m = re.match(r"(down|up|mid)_(\d+)?_?(resnets|attentions|motion|downsample|upsample)_?(\d+)?$",
                 name)
    if not m:
        raise KeyError("/".join(parts))
    where, idx, kind, j = m.groups()
    prefix = "mid_block" if where == "mid" else f"{where}_blocks.{idx}"
    if kind == "resnets":
        return f"{prefix}.resnets.{j}.{mid[0]}.{leaf}"
    if kind == "downsample":
        return f"{prefix}.downsamplers.0.conv.{leaf}"
    if kind == "upsample":
        return f"{prefix}.upsamplers.0.conv.{leaf}"
    if kind == "attentions":
        base = f"{prefix}.attentions.{j}"
        if mid[0] in ("norm", "proj_in", "proj_out"):
            return f"{base}.{mid[0]}.{leaf}"
        return tblock(mid, base)
    return motion(mid, f"{prefix}.motion_modules.{j}")


def _pose_guider_key(parts: List[str]) -> str:
    return f"{parts[0].replace('blocks_', 'blocks.')}.{_suffix(parts[-1])}"


def _camera_encoder_key(parts: List[str]) -> str:
    name, leaf = parts[0], _suffix(parts[-1])
    if name == "conv_in":
        return f"encoder_conv_in.{leaf}"
    m = re.match(r"(res|attn|zero_conv)_(\d+)_?(\d+)?$", name)
    if not m:
        raise KeyError("/".join(parts))
    what, i, j = m.groups()
    if what == "res":
        return f"encoder_down_conv_blocks.{i}.{j}.{parts[1]}.{leaf}"
    if what == "zero_conv":
        return f"zero_conv_layers.{i}.{leaf}"
    base = f"encoder_down_attention_blocks.{i}.{j}"
    sub = parts[1]
    if sub.startswith("attention_blocks_"):
        return f"{base}.attention_blocks.{sub.rsplit('_', 1)[1]}.{_ATTN[parts[3]]}.{leaf}"
    if sub.startswith("norms_"):
        return f"{base}.norms.{sub.rsplit('_', 1)[1]}.{leaf}"
    if sub == "ff":
        return f"{base}.ff.{_FF[parts[2]]}.{leaf}"
    return f"{base}.{sub}.{leaf}"  # ff_norm


def _vae_key(parts: List[str], side: str) -> str:
    name, leaf = parts[0], _suffix(parts[-1])
    if name in ("quant_conv", "post_quant_conv"):
        return f"{name}.{leaf}"
    m = re.match(r"(down|up)_(\d+)_resnets_(\d+)$", name)
    if m:
        where, i, j = m.groups()
        return f"{side}.{where}_blocks.{i}.resnets.{j}.{parts[1]}.{leaf}"
    m = re.match(r"(down|up)_(\d+)_(downsample|upsample)$", name)
    if m:
        where, i, what = m.groups()
        return f"{side}.{where}_blocks.{i}.{what}rs.0.conv.{leaf}"
    m = re.match(r"mid_resnets_(\d+)$", name)
    if m:
        return f"{side}.mid_block.resnets.{m.group(1)}.{parts[1]}.{leaf}"
    if name == "mid_attn":
        base = f"{side}.mid_block.attentions.0"
        if parts[1] == "group_norm":
            return f"{base}.group_norm.{leaf}"
        return f"{base}.{_ATTN[parts[2]]}.{leaf}"
    if name in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{side}.{name}.{leaf}"
    raise KeyError("/".join(parts))


def _clip_key(parts: List[str]) -> str:
    name, leaf = parts[0], _suffix(parts[-1])
    vm = "vision_model"
    if name == "class_embedding":
        return f"{vm}.embeddings.class_embedding"
    if name in ("position_embedding", "patch_embedding"):
        return f"{vm}.embeddings.{name}.weight"
    if name in ("pre_layrnorm", "post_layernorm"):
        return f"{vm}.{name}.{leaf}"
    if name == "visual_projection":
        return f"visual_projection.{leaf}"
    m = re.match(r"layers_(\d+)$", name)
    if m:
        base = f"{vm}.encoder.layers.{m.group(1)}"
        sub = parts[1]
        if sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
            return f"{base}.self_attn.{sub}.{leaf}"
        if sub in ("fc1", "fc2"):
            return f"{base}.mlp.{sub}.{leaf}"
        return f"{base}.{sub}.{leaf}"  # layer_norm1/2
    raise KeyError("/".join(parts))


_TRANSLATORS = {
    "unet": _unet_key,
    "pose_guider": _pose_guider_key,
    "camera_encoder": _camera_encoder_key,
    "vae_encoder": lambda p: _vae_key(p, "encoder"),
    "vae_decoder": lambda p: _vae_key(p, "decoder"),
    "clip": _clip_key,
}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else np.transpose(a)
    return a


def from_jax_params(flax_params: Dict[str, Any], kind: str) -> Dict[str, torch.Tensor]:
    """Flax parameter tree of one component -> the port module's state dict."""
    translate = _TRANSLATORS[kind]
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(flax_params).items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        leaf = parts[-1]
        if kind == "clip" and parts[0] == "layers":
            for i in range(arr.shape[0]):
                key = translate([f"layers_{i}"] + parts[1:])
                sd[key] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(leaf, arr[i])))
            continue
        sd[translate(parts)] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(leaf, arr)))
    return sd


def _load_sd(path: str) -> TorchDict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return load_torch_state_dict(path)


@torch.no_grad()
def _load_into(modules, path: str, kind: str = "") -> None:
    """Overwrite the weights of each module in place (its device and dtype)
    with those of the checkpoint at ``path`` that it has, non-strict; the
    file is read once. A missing file keeps the current weights and logs a
    warning. A flax ``.msgpack`` tree (the JAX package's checkpoints) holds
    one whole component of weight-translation ``kind``: it is translated by
    ``from_jax_params`` and loaded with ``strict=True``, as flax's
    ``from_bytes`` needs the whole tree."""
    if not os.path.exists(path):
        logger.warning("weights not found: %s (keeping the current weights)", path)
        return
    if path.endswith(".msgpack"):
        sd = from_jax_params(load_msgpack(path), kind)
        for module in modules:
            want = set(module.state_dict())
            if set(sd) != want:
                raise ValueError(f"{path}: the flax tree is not the module's "
                                 f"({len(want - set(sd))} keys missing, "
                                 f"{len(set(sd) - want)} unexpected)")
            module.load_state_dict(sd, strict=True)
        return
    source = _load_sd(path)
    for module in modules:
        target = module.state_dict()
        found, missing, unused = convert_state_dict(target, source)
        for key, value in found.items():
            target[key].copy_(value)
        if missing:
            logger.warning("%s: %d missing keys (e.g. %s)", path, len(missing), missing[:3])
        if unused:
            logger.info("%s: %d unused checkpoint keys", path, len(unused))


def _first_existing(root: str, names) -> str:
    """The first ``root/name`` that exists, or "" (also where root is "")."""
    for name in names:
        path = os.path.join(root, name)
        if root and os.path.exists(path):
            return path
    return ""


def load_pretrained(system, cfg) -> Any:
    """Fill ``system`` (a ``CamAnimate``) from the checkpoints that ``cfg``
    names, as the reference assembles its weights. Every key is optional:

    - ``base_model_path``: ``unet/diffusion_pytorch_model.{bin,safetensors}``
      feeds both UNets (the 3-D UNet's motion keys are left as they were);
    - ``vae_model_path``: ``diffusion_pytorch_model.{bin,safetensors}``
      feeds the VAE encoder and decoder;
    - ``image_encoder_path``: ``{pytorch_model.bin,model.safetensors}``
      feeds the CLIP image encoder;
    - ``pose_guider_path``, ``camera_pose_encoder_path``,
      ``reference_unet_path``, ``denoising_unet_path``: one file each;
    - ``motion_module_path``: into the denoising UNet, last, so its keys
      (the motion modules') win.

    The one-file keys also take the JAX package's flax ``.msgpack`` trees
    (a whole component each, as its checkpoints and ``convert_weights``
    write them).

    Returns the system."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)

    base = _first_existing(get("base_model_path", "") or "", (
        os.path.join("unet", "diffusion_pytorch_model.bin"),
        os.path.join("unet", "diffusion_pytorch_model.safetensors")))
    if base:
        _load_into((system.reference_unet, system.denoising_unet), base)
    vae = _first_existing(get("vae_model_path", "") or "", (
        "diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors"))
    if vae:
        _load_into((system.vae_encoder, system.vae_decoder), vae)
    clip = _first_existing(get("image_encoder_path", "") or "",
                           ("pytorch_model.bin", "model.safetensors"))
    if clip:
        _load_into((system.clip,), clip)
    for key, name, kind in (("pose_guider_path", "pose_guider", "pose_guider"),
                            ("camera_pose_encoder_path", "camera_encoder", "camera_encoder"),
                            ("reference_unet_path", "reference_unet", "unet"),
                            ("denoising_unet_path", "denoising_unet", "unet"),
                            ("motion_module_path", "denoising_unet", "unet")):
        path = get(key, "") or ""
        if path:
            _load_into((getattr(system, name),), path, kind)
    return system
