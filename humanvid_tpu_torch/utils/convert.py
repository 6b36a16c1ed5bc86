"""Reference checkpoints -> this port's module state dicts.

The reference splits its checkpoints by module (``reference_unet.pth``,
``denoising_unet.pth``, ``pose_guider.pth``, ``camera_pose_encoder.pth``,
``motion_module.pth``) on top of the upstream SD1.5 UNet, sd-vae-ft-mse VAE
and CLIP image encoder. The port's modules already carry the reference's
diffusers / transformers / AnimateDiff / CameraCtrl key names and layouts,
so a conversion is a lookup per key of the module's own state dict, with:

- the checkpoint wrappers unwrapped (``state_dict``, and the camera
  encoder's ``pose_encoder_state_dict``);
- the pre-diffusers-0.18 attention names of the 2022-era sd-vae-ft-mse
  (``query``/``key``/``value``/``proj_attn``) tried where the current name
  is absent;
- a 5-D ``(O, I, 1, kh, kw)`` conv weight squeezed to 4-D (defensive);
- a shape that still differs raising ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import torch

TorchDict = Dict[str, torch.Tensor]

# Pre-diffusers-0.18 attention naming, tried when the current key is absent.
_OLD_NAME_ALIASES = (
    (".to_q.", ".query."),
    (".to_k.", ".key."),
    (".to_v.", ".value."),
    (".to_out.0.", ".proj_attn."),
)


def load_torch_state_dict(path: str) -> TorchDict:
    """A ``.pth`` / ``.ckpt`` / ``.bin`` on the host, its wrappers unwrapped.
    The file is unpickled in full (the released files hold more than
    tensors): load only checkpoints from a source you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("pose_encoder_state_dict", "state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return dict(sd)


def _candidate_keys(key: str) -> Iterator[str]:
    yield key
    for new, old in _OLD_NAME_ALIASES:
        if new in key:
            yield key.replace(new, old)


def _fit(key: str, value: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    if value.ndim == 5 and len(shape) == 4:  # InflatedConv3d stored (O, I, 1, kh, kw)
        value = value.squeeze(2)
    if value.shape != shape:
        raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)} != "
                         f"module shape {tuple(shape)}")
    return value


def convert_state_dict(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                       ) -> Tuple[TorchDict, List[str], List[str]]:
    """The values of ``source`` for the keys of ``target`` (a module's state
    dict), shape-checked, in ``source``'s dtype on the host.

    Returns (found, missing target keys, unused source keys)."""
    found: TorchDict = {}
    missing: List[str] = []
    used = set()
    for key, value in target.items():
        src = next((c for c in _candidate_keys(key) if c in source), None)
        if src is None:
            missing.append(key)
            continue
        found[key] = _fit(key, torch.as_tensor(source[src]), value.shape)
        used.add(src)
    unused = [k for k in source if k not in used]
    return found, missing, unused
