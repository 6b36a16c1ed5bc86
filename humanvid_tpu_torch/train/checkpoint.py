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
- :func:`export_reference_pth` writes the reference's ``.pth`` files;
- :class:`DcpCheckpointer` is the ``checkpoint_backend: orbax`` of the JAX
  drivers on ``torch.distributed.checkpoint``: each rank writes its own
  shards (a ZeRO-1 moment as a ``DTensor`` over the mesh), asynchronously
  where ``dcp.async_save`` exists, with the newest ``keep`` steps kept; it
  resumes onto the same mesh.

Data parallel: every rank calls :func:`save_train_checkpoint` (a ZeRO-1
state gathers its moments), rank 0 alone writes, and the files hold whole
tensors, so a run saved at one world size resumes at another.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel import mesh as pmesh
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
    layout: the video UNet's motion modules and the CameraPoseEncoder.
    Every rank calls it; rank 0 writes and returns the paths, the others
    return [] once the files are whole."""
    opt = state.state_dict()
    paths = []
    if pmesh.rank() == 0:
        masters = dict(zip(state.names, state.masters))
        for component, prefix in _module_files(motion_only):
            sd = {k: masters.get(f"{component}/{k}", v)
                  for k, v in getattr(system, component).state_dict().items()}
            if prefix == MOTION_PREFIX:
                sd = filter_motion_modules(sd)
            paths.append(save_checkpoint(save_dir, prefix, sd, state.step, total_limit))
        paths.append(save_checkpoint(save_dir, "opt_state", opt, state.step, total_limit))
    if dist.is_initialized():
        dist.barrier()
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


class DcpCheckpointer:
    """Train-state checkpoints on ``torch.distributed.checkpoint`` under
    ``save_dir/{step}``: the masters, the moments and the accumulation by
    leaf name and the counts. A leaf ZeRO-1 shards is a ``DTensor`` (its
    dim-0 shard on ``data``, replicated on the other axes), so each rank
    writes its own shard; the replicated leaves are written once. Saves are
    asynchronous where ``dcp.async_save`` exists (on a gloo group of their
    own, so that they never interleave with the training collectives); a
    save waits for the one before it, and the oldest steps beyond ``keep``
    are removed once a newer save is whole. Every rank makes it and calls
    each method."""

    def __init__(self, save_dir: str, state: TrainState, keep: Optional[int] = None):
        import torch.distributed.checkpoint as dcp

        self._dcp = dcp
        self.save_dir = os.path.abspath(save_dir)
        self.state = state
        self.keep = keep
        self.group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._pending = None
        if pmesh.rank() == 0:
            os.makedirs(self.save_dir, exist_ok=True)

    def _tree(self) -> Dict[str, object]:
        """The state by leaf name; the live tensors, so a load fills them."""
        s = self.state
        tree: Dict[str, object] = {
            "counts": torch.tensor([s.step, s.updates, s.micro]),
            "masters": dict(zip(s.names, s.masters))}
        for key, own in (("mu", s.mu), ("nu", s.nu), ("acc", s.acc)):
            tree[key] = {name: self._distributed(t, i) for i, (name, t)
                         in enumerate(zip(s.names, own))}
        return tree

    def _distributed(self, t: torch.Tensor, i: int):
        s = self.state
        if not s.sharded[i]:
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = s.mesh
        placements = [Shard(0) if name == pmesh.DATA else Replicate()
                      for name in mesh.mesh_dim_names]
        whole = s.masters[i]
        return DTensor.from_local(t, mesh, placements, run_check=False, shape=whole.shape,
                                  stride=whole.stride())

    def steps(self) -> List[int]:
        """The steps whose checkpoint is whole (DCP writes ``.metadata`` last)."""
        if not os.path.isdir(self.save_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.save_dir) if d.isdigit()
                      and os.path.exists(os.path.join(self.save_dir, d, ".metadata")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int) -> None:
        """Write the state at ``step`` (asynchronously where possible)."""
        self.wait()
        path = os.path.join(self.save_dir, str(step))
        tree = self._tree()
        if hasattr(self._dcp, "async_save"):
            self._pending = self._dcp.async_save(tree, checkpoint_id=path,
                                                 process_group=self.group)
        else:
            self._dcp.save(tree, checkpoint_id=path, process_group=self.group)
            self._rotate()

    def wait(self) -> None:
        """Wait for the save in flight, then apply the rotation."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            result = getattr(pending, "upload_completion", pending)
            result.result()
            self._rotate()

    def _rotate(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)
        if self.keep is None or pmesh.rank() != 0:
            return
        for step in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.save_dir, str(step)), ignore_errors=True)

    @torch.no_grad()
    def restore(self, step: Optional[int] = None) -> int:
        """Load ``step`` (the newest whole one by default) into the train
        state and its modules; returns the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.save_dir}")
        tree = self._tree()
        self._dcp.load(tree, checkpoint_id=os.path.join(self.save_dir, str(step)),
                       process_group=self.group)
        s = self.state
        s.step, s.updates, s.micro = (int(v) for v in tree["counts"])
        for p, m in zip(s.params, s.masters):
            p.copy_(m)
        return step

    def close(self) -> None:
        self.wait()
