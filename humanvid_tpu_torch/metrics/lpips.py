"""LPIPS perceptual distance: a VGG16 backbone and five linear heads.

The counterpart of ``humanvid_tpu/metrics/lpips.py`` (lpipsPyTorch's vgg
variant): images are shift/scale normalized, the relu{1_2, 2_2, 3_3, 4_3,
5_3} activations of VGG16 are unit-normalized over channels (eps 1e-10),
their squared differences pass through bias-free 1x1 "lin" convolutions,
applied raw (no clamp), and are averaged over space and summed.

The input normalization is ``(im - shift) / scale`` on [0, 1] images, with
no rescale to [-1, 1]: the reference feeds ``ToTensor`` images straight into
the network, although lpips' constants were fit for [-1, 1] (the JAX
module's ``norm_input`` explains it), and parity needs its convention.

State-dict keys: ``vgg.<i>.weight`` / ``.bias`` with torchvision's
``vgg16.features`` indices, and ``lin<i>.model.1.weight`` (lpips'
``NetLinLayer``). ``from_torch`` loads the two released files,
``from_flax`` the JAX module's variables.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from .nets import device_of, run_batched

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (out_channels, layers) per stage; relu taps at stage ends
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Sequential):
    """torchvision's ``vgg16.features`` up to relu5_3 (indices 0-29: conv,
    relu, ..., max pool between stages); NCHW in, the five stage-end relu
    maps out."""

    def __init__(self):
        layers: List[nn.Module] = []
        taps = []
        cin = 3
        for si, (ch, n_layers) in enumerate(_VGG_STAGES):
            for _ in range(n_layers):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            taps.append(len(layers) - 1)
            if si < len(_VGG_STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.taps = frozenset(taps)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.taps:
                taps.append(x)
        return taps


class _NetLin(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Pairwise perceptual distance of NCHW images in [0, 1] -> (n,)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(LPIPS_CHANNELS):
            self.add_module(f"lin{i}", _NetLin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.vgg((x - self.shift) / self.scale)
        fy = self.vgg((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + 1e-10)
            lin = getattr(self, f"lin{i}").model[1]
            total = total + lin((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


def from_torch(vgg_features_sd: Mapping[str, Any], lin_sd: Mapping[str, Any],
               device="cpu") -> LPIPS:
    """An LPIPS on ``device`` from torchvision ``vgg16.features`` keys and
    lpips' ``lin{i}.model.1.weight`` (or ``lins.{i}.model.1.weight``) keys,
    loaded with ``strict=True``."""
    sd = {f"vgg.{k}": torch.as_tensor(v) for k, v in vgg_features_sd.items()}
    for i in range(len(LPIPS_CHANNELS)):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in lin_sd:
                sd[f"lin{i}.model.1.weight"] = torch.as_tensor(lin_sd[cand])
                break
        else:
            raise KeyError(f"missing lpips lin weights for stage {i}")
    model = LPIPS()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)


def from_flax(variables: Mapping[str, Any], device="cpu") -> LPIPS:
    """An LPIPS on ``device`` from the JAX ``LPIPS`` variables
    (``{"params": {"vgg": {"conv_<i>": {kernel, bias}}, "lin_<i>": (c,)}}``,
    e.g. read from its ``.msgpack``): the inverse of the JAX
    ``load_torch_weights``, loaded with ``strict=True``."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in params["vgg"].items():
        idx = name.split("_")[1]
        sd[f"vgg.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"vgg.{idx}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
    for i in range(len(LPIPS_CHANNELS)):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.array(params[f"lin_{i}"]).reshape(1, -1, 1, 1))
    model = LPIPS()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)


def lpips_distance(model: LPIPS, a: np.ndarray, b: np.ndarray, batch: int = 8,
                   device=None) -> np.ndarray:
    """(n, H, W, 3) [0, 1] pairs -> (n,) perceptual distances, ``batch``
    pairs a call on ``device`` (the model's by default)."""
    def run(x, y):
        return model(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))

    return run_batched(run, (a, b), batch, device or device_of(model))
