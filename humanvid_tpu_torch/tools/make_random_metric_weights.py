"""Metric-network checkpoints with seeded random values and the real key sets.

    python -m humanvid_tpu_torch.tools.make_random_metric_weights OUT_DIR [--skip-clip]

The counterpart of ``tools/make_random_metric_weights.py``. It writes the
five files of ``metrics/weights.py`` from the port's own modules' state
dicts, so that the whole evaluation path (LPIPS, FID, FVD, CLIP
consistency) runs end to end where the real weights are not at hand; the
numbers it yields mean nothing, and real checkpoints dropped into the same
directory replace them. Values, from one seeded ``torch.Generator``, follow
the JAX tool's laws: convolution weights N(0, 0.05), batch-norm scales and
running variances |N(1, 0.02)|, running means N(0, 0.02), biases 0, LPIPS
lin heads |N(0, 0.1)|; InceptionV3 also gets a zero ``fc`` head (skipped
on load); CLIP-L/14 (``CLIPVisionModelWithProjection`` keys) is written in
fp16 with N(0, 0.02) weights and embeddings, unit LayerNorm scales and
zero biases. The modules are built on the meta device: only the written
tensors take memory.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..metrics import weights as W
from ..metrics.i3d import I3D
from ..metrics.inception import InceptionV3Features
from ..metrics.lpips import LPIPS
from ..models.clip_vision import CLIPVisionEncoder

Law = Callable[[str, torch.Size, torch.Generator], torch.Tensor]


def _normal(shape, mean: float, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).normal_(mean, std, generator=gen)


def conv_bn_law(key: str, shape: torch.Size, gen: torch.Generator) -> torch.Tensor:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "running_var" or key.endswith("bn.weight"):
        return _normal(shape, 1.0, 0.02, gen).abs()
    if leaf == "running_mean":
        return _normal(shape, 0.0, 0.02, gen)
    if leaf == "bias":
        return torch.zeros(shape)
    return _normal(shape, 0.0, 0.05, gen)


def lpips_law(key: str, shape: torch.Size, gen: torch.Generator) -> torch.Tensor:
    if key.startswith("lin"):
        return _normal(shape, 0.0, 0.1, gen).abs()
    return conv_bn_law(key, shape, gen)


def clip_law(key: str, shape: torch.Size, gen: torch.Generator) -> torch.Tensor:
    if "norm" in key:  # layer_norm1/2, pre_layrnorm, post_layernorm
        return torch.ones(shape) if key.endswith("weight") else torch.zeros(shape)
    if key.endswith("bias"):
        return torch.zeros(shape)
    return _normal(shape, 0.0, 0.02, gen)


def random_state_dict(build: Callable[[], nn.Module], law: Law, gen: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The module's state-dict keys and shapes (built on the meta device)
    with values drawn by ``law``, in key order."""
    with torch.device("meta"):
        module = build()
    return {k: law(k, v.shape, gen).to(dtype) for k, v in module.state_dict().items()}


def _save(sd: Dict[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.contiguous() for k, v in sd.items()}, path)
    print(f"wrote {path} ({len(sd)} keys)")


def make_lpips(out_dir: str, gen: torch.Generator) -> None:
    sd = random_state_dict(LPIPS, lpips_law, gen)
    _save({k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")},
          os.path.join(out_dir, W.LPIPS_VGG))
    _save({k: v for k, v in sd.items() if k.startswith("lin")},
          os.path.join(out_dir, W.LPIPS_LINS))


def make_inception(out_dir: str, gen: torch.Generator) -> None:
    sd = random_state_dict(InceptionV3Features, conv_bn_law, gen)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    _save(sd, os.path.join(out_dir, W.FID_INCEPTION))


def make_i3d(out_dir: str, gen: torch.Generator) -> None:
    _save(random_state_dict(I3D, conv_bn_law, gen), os.path.join(out_dir, W.FVD_I3D))


def make_clip(out_dir: str, gen: torch.Generator) -> None:
    sd = random_state_dict(lambda: CLIPVisionEncoder(W.CLIP_L14), clip_law, gen, torch.float16)
    _save(sd, os.path.join(out_dir, W.CLIP_VITL14))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--skip-clip", action="store_true", help="leave out CLIP-L/14 (~0.6 GB)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    make_lpips(args.out_dir, gen)
    make_inception(args.out_dir, gen)
    make_i3d(args.out_dir, gen)
    if not args.skip_clip:
        make_clip(args.out_dir, gen)


if __name__ == "__main__":
    main()
