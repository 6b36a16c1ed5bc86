"""Checkpoint IO: per-module save with keep-last-K rotation, resume, export.

The counterpart of ``humanvid_tpu/train/checkpoint.py`` (its msgpack
files become ``torch.save`` state dicts):

- one file per module and step, ``{prefix}-{step}.pt``, with the oldest
  files of a prefix removed beyond ``total_limit``;
- stage 2 saves the video UNet's motion modules only (``motion_module``)
  and the CameraPoseEncoder whole, and merges a motion-only file back into
  a full video-UNet state dict on load;
- ``opt_state`` holds the counts, AdamW's moments and the accumulation, and
  the module files hold the trainable leaves as their fp32 masters, so a
  resume continues exactly where the run stopped;
- :func:`load_train_checkpoint` loads whichever of those files exist at a
  step, as the JAX training driver's resume does;
- :func:`export_reference_pth` writes the reference's ``.pth`` files.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

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
def load_train_checkpoint(save_dir: str, step: int, system, state: TrainState) -> List[str]:
    """Load each of ``{component}-{step}.pt``, ``motion_module-{step}.pt`` and
    ``opt_state-{step}.pt`` under ``save_dir`` that exists into the modules
    and the train state, and skip those that do not, as the JAX driver's
    resume does; the trainable leaves' masters come from the module files.
    A module file must hold every key of its module: a video-UNet file
    without the motion modules (stage 1's) raises, naming them. Returns the
    paths loaded."""
    loaded, masters = [], {}
    for component, prefix in [(c, c) for c in TRAIN_COMPONENTS] + [
            ("denoising_unet", MOTION_PREFIX)]:
        path = os.path.join(save_dir, f"{prefix}-{step}.pt")
        if not os.path.exists(path):
            continue
        module = getattr(system, component)
        sd = load_checkpoint(path)
        if prefix == MOTION_PREFIX:
            sd = merge_motion_modules(module.state_dict(), sd)
        missing = sorted(set(module.state_dict()) - set(sd))
        if missing:
            raise ValueError(f"{path} lacks {len(missing)} keys of the {component} "
                             f"(e.g. {missing[:3]})")
        module.load_state_dict(sd, strict=True)
        masters.update({f"{component}/{k}": v for k, v in sd.items()})
        loaded.append(path)
    state.load_masters(masters)
    path = os.path.join(save_dir, f"opt_state-{step}.pt")
    if os.path.exists(path):
        state.load_state_dict(load_checkpoint(path))
        loaded.append(path)
    return loaded


def export_reference_pth(system, state: Optional[TrainState], out_dir: str, step: int,
                         components: Sequence[str] = TRAIN_COMPONENTS) -> List[str]:
    """The reference's ``.pth`` files of the trained modules named in
    ``components``: the module's state dict (diffusers keys) with each
    trainable leaf as its fp32 master where there is a ``state``, as
    ``{component}-{step}.pth`` and the CameraPoseEncoder's as
    ``camera_pose_encoder-{step}.pth``."""
    os.makedirs(out_dir, exist_ok=True)
    masters = dict(zip(state.names, state.masters)) if state is not None else {}
    paths = []
    for component in components:
        sd = {k: masters.get(f"{component}/{k}", v).detach().cpu()
              for k, v in getattr(system, component).state_dict().items()}
        name = "camera_pose_encoder" if component == "camera_encoder" else component
        path = os.path.join(out_dir, f"{name}-{step}.pth")
        torch.save(sd, path)
        paths.append(path)
    return paths
