"""Data-parallel dry run: a sharded train step and the sampling fan-out on N ranks.

    python -m humanvid_tpu_torch.tools.dryrun_multichip --ranks 8 [--device cuda|cpu]
        [--backend nccl|gloo]

The counterpart of the JAX package's ``dryrun_multichip`` (its record is
``MULTICHIP_r05.json``), on N ranks that this process spawns
(``parallel.launch``, a ``file://`` store): the tiny config at 32x32,
stage-2 trainability, one clip a rank. It runs on the cards (NCCL, one rank
a card) unless the caller names the CPU (gloo); ranks that outnumber the
cards need ``--backend gloo``.

1. a flat N-way train step with ZeRO-1 on every leaf (``min_size=1``):
   the loss finite, the step counter 1;
2. with N even, a hierarchical 2 x N/2 step (the batch over both axes,
   ZeRO-1 on ``data``) whose loss is within 1e-4 of the flat one;
3. the window x CFG fan-out: 8 frames, context 4, overlap 2 (4 windows, 8
   rows with CFG) over the N ranks, against one rank's run of the same
   pipeline (latents within 2e-4, videos within 2e-3).

Rank 0 prints one ``OK`` line a check. The workers the tests spawn live
here too (each child imports this module, and with it nothing of JAX):
``train_worker`` runs train steps from a spec, ``fanout_worker`` the
pipeline, ``dcp_worker`` the ``torch.distributed.checkpoint`` round trip;
each runs on the card unless its spec names the ``device``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..parallel.launch import launch

H = W = 32
F = 2


def _system(spec: Dict, device):
    """The spec's system on ``device``: its ``state_dicts`` or ``seed``."""
    from ..pipelines import CamAnimate

    system = CamAnimate(spec["config"], device=device, dtype=spec.get("dtype", torch.float32))
    if spec.get("state_dicts") is None:
        return system.init_random(spec.get("seed", 0))
    for name, module in system.components().items():
        module.load_state_dict(spec["state_dicts"][name], strict=True)
    return system


def _mesh(kind):
    if kind is None:
        return None
    if kind == "flat":
        return pmesh.make_mesh()
    return pmesh.make_hierarchical_mesh(kind[1])


def train_worker(spec: Dict) -> Dict[str, object]:
    """Train steps on this rank from ``spec``:

    - ``config``, ``state_dicts`` (or ``seed``), ``device`` (default cuda);
    - ``optimizer`` (``OptimizerConfig``), ``train`` (``TrainConfig``);
    - ``mesh``: None, ``"flat"`` or ``("hier", slices)``; ``zero1``,
      ``min_size``;
    - ``batches`` and ``draws``: the global batches (channel-last arrays)
      and their draws, one a micro-step;
    - ``load``: (dir, step) to resume from before the steps; ``save``: a
      dir to save in after them (the per-module files);
    - ``keep_grads``: also return each micro-step's gradients as reduced
      over the mesh (the mean), by leaf name.

    Returns the logged loss and grad norm of each micro-step, the masters
    after each update, the names of the ZeRO-1 leaves, this
    rank's rows of ``range(2 * world)`` and, on rank 0, the gathered
    ``opt_state``."""
    from ..train import (TrainState, load_train_checkpoint, save_train_checkpoint,
                         stage2_trainable, train_step)

    device = pmesh.init_distributed(spec.get("device", "cuda"), spec.get("backend"))
    mesh = _mesh(spec.get("mesh"))
    system = _system(spec, device)
    state = TrainState(system, stage2_trainable, spec["optimizer"], mesh=mesh,
                       zero1=spec.get("zero1", False),
                       zero1_min_size=spec.get("min_size", pmesh.ZERO1_MIN_SIZE))
    if spec.get("load") is not None:
        load_train_checkpoint(*spec["load"], system, state)
        state.step = spec["load"][1]
    sched = system.make_schedule(beta_schedule="scaled_linear")
    out = {"loss": [], "grad_norm": [], "masters": [],
           "sharded": [n for n, s in zip(state.names, state.sharded) if s],
           "rows": (pmesh.rank_rows(list(range(2 * pmesh.world_size())), mesh)
                    if mesh is not None else None), "grads": []}
    if spec.get("keep_grads"):
        reduce = pmesh.all_reduce_mean_

        def reduce_and_keep(tensors, *args, **kwargs):
            reduce(tensors, *args, **kwargs)
            if len(tensors) == len(state.names):  # the gradients, not the logged loss
                out["grads"].append({n: t.cpu().clone() for n, t in zip(state.names, tensors)})

        pmesh.all_reduce_mean_ = reduce_and_keep  # TrainState calls it through the module
    for batch, draws in zip(spec["batches"], spec["draws"]):
        local = pmesh.rank_rows(batch, mesh) if mesh is not None else batch
        aux = train_step(system, state, sched, spec["train"], local, draws=draws)
        out["loss"].append(float(aux["loss"]))
        out["grad_norm"].append(float(aux["grad_norm"]))
        if state.micro == 0:
            out["masters"].append({n: m.cpu().clone() for n, m in zip(state.names,
                                                                       state.masters)})
    if spec.get("save") is not None:
        save_train_checkpoint(spec["save"], system, state, motion_only=True)
    out["opt_state"] = state.state_dict()
    out["names"] = state.names
    return out


def fanout_worker(spec: Dict) -> Dict[str, object]:
    """The spec's ``Pose2VideoPipeline`` call (``inputs``: ref, pose,
    plucker, clip; ``kwargs``) on this rank, with the rows fanned out over a
    flat mesh of every rank, or on one rank alone with ``single``."""
    from ..pipelines import Pose2VideoPipeline

    device = pmesh.init_distributed(spec.get("device", "cuda"), spec.get("backend"))
    system = _system(spec, device)
    mesh = None if spec.get("single") else pmesh.make_mesh()
    out = Pose2VideoPipeline(system, mesh=mesh)(*spec["inputs"], **spec["kwargs"])
    return {"latents": out.latents, "videos": out.videos}


def dcp_worker(spec: Dict) -> Dict[str, object]:
    """Train steps with ZeRO-1 on a flat mesh, a ``DcpCheckpointer`` save
    (keep ``keep``) after each, then a fresh state restored from the newest
    step: whether it holds the saved state bit for bit, and the steps kept."""
    from ..train import DcpCheckpointer, TrainState, stage2_trainable, train_step

    device = pmesh.init_distributed(spec.get("device", "cuda"), spec.get("backend"))
    mesh = pmesh.make_mesh()
    system = _system(spec, device)
    state = TrainState(system, stage2_trainable, spec["optimizer"], mesh=mesh, zero1=True,
                       zero1_min_size=spec.get("min_size", pmesh.ZERO1_MIN_SIZE))
    ckpt = DcpCheckpointer(spec["dir"], state, keep=spec["keep"])
    sched = system.make_schedule(beta_schedule="scaled_linear")
    for i, (batch, draws) in enumerate(zip(spec["batches"], spec["draws"])):
        train_step(system, state, sched, spec["train"], pmesh.rank_rows(batch, mesh),
                   draws=draws)
        ckpt.save(i + 1)
    ckpt.close()
    fresh_system = _system(spec, device)
    fresh = TrainState(fresh_system, stage2_trainable, spec["optimizer"], mesh=mesh,
                       zero1=True, zero1_min_size=spec.get("min_size", pmesh.ZERO1_MIN_SIZE))
    step = DcpCheckpointer(spec["dir"], fresh).restore()
    same = (fresh.step, fresh.updates, fresh.micro) == (state.step, state.updates, state.micro)
    for a, b in ((state.masters, fresh.masters), (state.mu, fresh.mu), (state.nu, fresh.nu)):
        same = same and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    params = all(torch.equal(p, q) for p, q in zip(state.params, fresh.params))
    return {"restored_step": step, "same": same, "params_same": params,
            "kept": ckpt.steps(), "sharded": sum(fresh.sharded)}


def _tiny_batch(b: int, seed: int, clip_size: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"tgt": rng.normal(size=(b, F, H, W, 3)).astype(f32),
            "ref": rng.normal(size=(b, H, W, 3)).astype(f32),
            "clip": rng.normal(size=(b, clip_size, clip_size, 3)).astype(f32),
            "pose": rng.normal(size=(b, F, H, W, 3)).astype(f32),
            "plucker": rng.normal(size=(b, F, H, W, 6)).astype(f32)}


def _dryrun(device: str, backend: Optional[str]) -> List[str]:
    """One rank of the dry run; returns the lines rank 0 printed."""
    from ..pipelines import CamAnimate, Pose2VideoPipeline, tiny_config
    from ..train import TrainConfig, TrainState, sample_draws, stage2_trainable, train_step

    dev = pmesh.init_distributed(device, backend)
    n, lead = pmesh.world_size(), pmesh.rank() == 0
    lines = []

    def say(line):
        if lead:
            print(line, flush=True)
            lines.append(line)

    config = tiny_config(motion_max_len=4)
    sz = config.clip.image_size
    batch = _tiny_batch(n, 0, sz)
    draws = sample_draws(torch.Generator(device=dev).manual_seed(1), n, F, H, W, 1000,
                         TrainConfig().uncond_ratio)

    def step(mesh):
        system = CamAnimate(config, device=dev).init_random(0)
        state = TrainState(system, stage2_trainable, mesh=mesh, zero1=True, zero1_min_size=1)
        sched = system.make_schedule(beta_schedule="scaled_linear")
        aux = train_step(system, state, sched, TrainConfig(), pmesh.rank_rows(batch, mesh),
                         draws=draws)
        return float(aux["loss"]), state

    loss, state = step(pmesh.make_mesh())
    if not (np.isfinite(loss) and state.step == 1 and any(state.sharded)):
        raise RuntimeError(f"flat step: loss {loss}, step {state.step}")
    say(f"dryrun_multichip({n}) OK: loss={loss:.5f}")
    if n % 2 == 0:
        hloss, _ = step(pmesh.make_hierarchical_mesh(2, n // 2))
        if not (np.isfinite(hloss) and abs(hloss - loss) < 1e-4):
            raise RuntimeError(f"hierarchical loss {hloss} against the flat {loss}")
        say(f"dryrun_multichip({n}) hierarchical 2x{n // 2} OK: loss={hloss:.5f}")

    f_inf = 8  # context 4 / overlap 2 -> 4 windows -> CFG x 4 = 8 rows
    rng = np.random.default_rng(2)
    ref = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((f_inf, H, W, 3)).astype(np.float32)
    plucker = rng.standard_normal((f_inf, H, W, 6)).astype(np.float32)
    clip = rng.random((sz, sz, 3)).astype(np.float32)
    system = CamAnimate(config, device=dev).init_random(0)
    kw = dict(num_inference_steps=2, guidance_scale=3.5, context_frames=4, context_overlap=2,
              generator=torch.Generator(device=dev).manual_seed(7))
    sharded = Pose2VideoPipeline(system, mesh=pmesh.make_mesh())(ref, pose, plucker, clip, **kw)
    if lead:
        kw["generator"] = torch.Generator(device=dev).manual_seed(7)
        base = Pose2VideoPipeline(system)(ref, pose, plucker, clip, **kw)
        if not np.isfinite(base.videos).all():
            raise RuntimeError("non-finite videos")
        np.testing.assert_allclose(sharded.latents, base.latents, atol=2e-4)
        np.testing.assert_allclose(sharded.videos, base.videos, atol=2e-3)
    say(f"dryrun_multichip({n}) inference window fan-out OK: 4 windows x CFG sharded over "
        f"{n} ranks")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda (one rank a card), gloo on cpu")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before a hung rank fails the run")
    args = p.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 2
    if backend == "nccl" and args.ranks > torch.cuda.device_count():
        p.error(f"{args.ranks} ranks on {torch.cuda.device_count()} CUDA card(s): NCCL "
                f"refuses two ranks on one device; run them with --backend gloo")
    launch(_dryrun, args.ranks, args=(args.device, backend), backend=backend,
           timeout_s=args.timeout, join_timeout_s=args.timeout,
           threads=None if args.device == "cuda" else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
