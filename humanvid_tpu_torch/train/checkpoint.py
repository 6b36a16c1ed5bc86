"""Checkpoint IO: per-module save with keep-last-K rotation, exact resume.

The counterpart of ``humanvid_tpu/train/checkpoint.py`` (its msgpack
files become ``torch.save`` state dicts):

- one file per module and step, ``{prefix}-{step}.pt``, with the oldest
  files of a prefix removed beyond ``total_limit``;
- stage 2 saves the video UNet's motion modules only (``motion_module``)
  and the CameraPoseEncoder whole, and merges a motion-only file back into
  a full video-UNet state dict on load;
- ``opt_state`` holds the step and AdamW's moments, and the module files
  hold the trainable leaves as their fp32 masters, so a resume continues
  exactly where the run stopped.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from .state import TRAIN_COMPONENTS, TrainState

MOTION_PREFIX = "motion_module"


def save_checkpoint(save_dir: str, prefix: str, tree, step: int,
                    total_limit: Optional[int] = None) -> str:
    """``torch.save`` ``tree`` to ``{save_dir}/{prefix}-{step}.pt``, first
    removing the oldest files of ``prefix`` so that at most ``total_limit``
    remain after the save."""
    os.makedirs(save_dir, exist_ok=True)
    if total_limit is not None:
        pat = re.compile(rf"^{re.escape(prefix)}-(\d+)\.pt$")
        existing = sorted((int(m.group(1)), f) for f in os.listdir(save_dir)
                          if (m := pat.match(f)))
        while len(existing) >= total_limit:
            os.remove(os.path.join(save_dir, existing.pop(0)[1]))
    path = os.path.join(save_dir, f"{prefix}-{step}.pt")
    torch.save(tree, path)
    return path


def load_checkpoint(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def filter_motion_modules(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The motion-module entries of a video-UNet state dict."""
    return {k: v for k, v in state_dict.items() if ".motion_modules." in k}


def merge_motion_modules(state_dict: Dict[str, torch.Tensor],
                         motion: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full video-UNet state dict with its motion modules from ``motion``."""
    unknown = set(motion) - set(state_dict)
    if unknown:
        raise KeyError(f"not in the video UNet: {sorted(unknown)[:3]}")
    return {**state_dict, **motion}


def _module_files(motion_only: bool):
    """(component, file prefix) of each module file a checkpoint holds."""
    if motion_only:
        return [("denoising_unet", MOTION_PREFIX), ("camera_encoder", "camera_encoder")]
    return [(c, c) for c in TRAIN_COMPONENTS]


def save_train_checkpoint(save_dir: str, system, state: TrainState,
                          motion_only: bool = False,
                          total_limit: Optional[int] = None) -> List[str]:
    """Per-module checkpoints at ``state.step`` (trainable leaves as their
    fp32 masters) plus the optimizer state. ``motion_only`` is stage 2's
    layout: the video UNet's motion modules and the CameraPoseEncoder."""
    masters = dict(zip(state.names, state.masters))
    paths = []
    for component, prefix in _module_files(motion_only):
        sd = {k: masters.get(f"{component}/{k}", v)
              for k, v in getattr(system, component).state_dict().items()}
        if prefix == MOTION_PREFIX:
            sd = filter_motion_modules(sd)
        paths.append(save_checkpoint(save_dir, prefix, sd, state.step, total_limit))
    paths.append(save_checkpoint(save_dir, "opt_state", state.state_dict(), state.step,
                                 total_limit))
    return paths


@torch.no_grad()
def load_train_checkpoint(save_dir: str, step: int, system, state: TrainState,
                          motion_only: bool = False) -> None:
    """Load what :func:`save_train_checkpoint` wrote at ``step`` into the
    modules and the train state."""
    masters = {}
    for component, prefix in _module_files(motion_only):
        module = getattr(system, component)
        sd = load_checkpoint(os.path.join(save_dir, f"{prefix}-{step}.pt"))
        if prefix == MOTION_PREFIX:
            sd = merge_motion_modules(module.state_dict(), sd)
        module.load_state_dict(sd, strict=True)
        masters.update({f"{component}/{k}": v for k, v in sd.items()})
    state.load_state_dict(load_checkpoint(os.path.join(save_dir, f"opt_state-{step}.pt")),
                          masters)
