"""Stage-1 (pose2img) training from a train config; stage 2 shares the loop.

    python -m humanvid_tpu_torch.cli.train_stage_1 --config configs/train/stage1.yaml
    python -m humanvid_tpu_torch.cli.train_stage_2 --config configs/train/stage2.yaml

The counterpart of ``scripts/train_stage_1.py``, with the same config keys:

- ``model: tiny`` swaps in the small test topology; the weights are seeded
  (``seed``) and then overwritten from the checkpoints the config names
  (``utils/weights.load_pretrained``);
- ``solver``: AdamW and clip settings, ``lr_warmup_steps``,
  ``gradient_accumulation_steps``, ``adam_mu_dtype``,
  ``enable_gradient_checkpointing`` and ``ff_chunk_tokens`` (1024 with
  checkpointing, else none), ``max_train_steps``;
- ``data``: the meta JSON files by orientation, sizes, ``train_bs``, the
  sampling keys and ``num_workers``;
- ``uncond_ratio``, ``noise_offset``, ``snr_gamma``; ``checkpointing_steps``,
  ``val.validation_steps``, ``output_dir`` / ``exp_name``;
- ``resume_from_checkpoint`` / ``resume_step``: each module, motion-module
  and optimizer file of that step found there is loaded, and the data order
  fast-forwards to the step (epoch ``step // len(sampler)``, skipping
  ``step % len(sampler)`` batches).

Stage 1 trains both UNets, the PoseGuider and the camera encoder on single
frames; stage 2 the motion modules and the camera encoder on clips. Under
``output_dir/exp_name``: ``{module}-{step}.pt`` with ``opt_state-{step}.pt``
(stage 2: ``motion_module``, ``camera_encoder`` and ``opt_state`` only),
the last 3 steps kept in stage 1 and 10 in stage 2, and an unrotated final
save; ``run/metrics.jsonl`` (the loss and grad norm every 20 steps and at
the end) and ``run/config.json``; validation renders under
``validation/``; with ``--profile_dir``, a torch.profiler trace of steps
10-12 there. Training runs on the one device ``--device`` names (the CUDA
card by default; tests pass ``cpu``). Two JAX-only settings raise:
``solver.dcn_slices`` > 1 and ``solver.checkpoint_backend: orbax``
(multi-card training is ROADMAP queue 1 item 8); ``shard_optimizer_states``
changes nothing on one device.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import random
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.datasets import (
    CLIP_MEAN,
    CLIP_STD,
    DatasetConfig,
    HumanDanceCameraImageDataset,
    HumanDanceCameraVideoDataset,
)
from ..data.loader import Loader
from ..data.samplers import OrientationBatchSampler
from ..diffusion.schedule import NoiseSchedule
from ..parallel import mesh as pmesh
from ..pipelines import CamAnimate
from ..train import (
    DcpCheckpointer,
    TrainConfig,
    TrainState,
    load_train_checkpoint,
    optimizer_config,
    sample_draws,
    save_train_checkpoint,
    stage1_trainable,
    stage2_trainable,
    system_config,
    train_step,
)
from ..train.step import Draws
from ..utils.config import ConfigDict, load_config
from ..utils.profiling import StepTimers, annotate, device_trace
from ..utils.tracker import Tracker
from ..utils.weights import load_pretrained

logger = logging.getLogger("train_stage_1")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOG_EVERY = 20  # steps between loss logs (the only reads of the device)
STAGE = 1


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler trace of steps 10-12 here")
    p.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (default: nccl on the card, "
                        "gloo on the CPU)")
    return p.parse_args(argv)


def build_dataset(cfg: ConfigDict, stage: int, clip_size: int = 224):
    dcfg = DatasetConfig(
        train_size_large=cfg.data.train_size_large,
        train_size_small=cfg.data.train_size_small,
        sample_margin=cfg.data.get("sample_margin", 30),
        n_sample_frames=cfg.data.get("n_sample_frames", 24),
        sample_rate=cfg.data.get("sample_rate", 4),
        clip_size=clip_size,
    )
    cls = HumanDanceCameraVideoDataset if stage == 2 else HumanDanceCameraImageDataset
    return cls(cfg.data.horizontal_meta, cfg.data.vertical_meta, dcfg)


def to_train_batch(batch: Dict[str, object], stage: int) -> Dict[str, object]:
    """A loader batch -> a train-step batch (stage 1 gains the frame axis)."""
    if stage == 1:
        return {k: v[:, None] if k in ("tgt", "pose", "plucker") else v
                for k, v in batch.items()}
    return batch


def step_draws(seed: int, step: int, device, batch: Dict[str, object], sched: NoiseSchedule,
               cfg: TrainConfig, ranks: int = 1) -> Draws:
    """Step ``step``'s draws for the global batch of which ``batch`` is one
    of ``ranks`` equal parts, a function of (seed, step) alone, so that a
    resumed run draws what an unbroken one does and every rank draws the
    same; the uncond flag is drawn on the host, so nothing is read back from
    the device."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(s)
    b, f, H, W = np.shape(batch["tgt"])[:4]
    return sample_draws(gen, b * ranks, f, H, W, sched.num_train_timesteps, cfg.uncond_ratio,
                        uncond=random.Random(s).random() < cfg.uncond_ratio)


def _first(batch, key: str) -> np.ndarray:
    v = batch[key][0]
    return np.asarray(v.float().cpu() if isinstance(v, torch.Tensor) else v, np.float32)


def log_validation(pipe, batch, out_dir: str, step: int) -> None:
    """Render the first sample of the batch through the stage-1 sampler (20
    DDIM steps, CFG 3.5) and save a ref | pose | generated | target grid
    as ``val_{step}.png``."""
    import cv2

    tgt = _first(batch, "tgt")
    tgt = tgt[0] if tgt.ndim == 4 else tgt  # stage-2 batches carry frames
    ref = (_first(batch, "ref") + 1.0) / 2.0
    pose = _first(batch, "pose")
    pose = pose[0] if pose.ndim == 4 else pose
    plucker = _first(batch, "plucker")
    plucker = plucker[0] if plucker.ndim == 4 else plucker
    clip_raw = np.clip(_first(batch, "clip") * CLIP_STD + CLIP_MEAN, 0, 1)
    gen = torch.Generator(device=pipe.system.device).manual_seed(step)
    out = pipe(ref, pose, plucker, clip_raw, num_inference_steps=20, guidance_scale=3.5,
               generator=gen)
    grid = np.concatenate([ref, pose, out.images[0], (tgt + 1.0) / 2.0], axis=1)
    os.makedirs(out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(out_dir, f"val_{step}.png"),
                cv2.cvtColor((grid * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))


def log_validation_video(pipe, batch, out_dir: str, step: int) -> None:
    """Render the first clip of the batch through the video sampler (8 DDIM
    steps, CFG 3.5 sequential, one window) and save a ref | pose |
    generated | target panel video as ``val_{step}.mp4``."""
    from ..data.video_io import save_video

    tgt = (_first(batch, "tgt") + 1.0) / 2.0  # (f, H, W, 3)
    ref = (_first(batch, "ref") + 1.0) / 2.0
    pose = _first(batch, "pose")
    plucker = _first(batch, "plucker")
    clip_raw = np.clip(_first(batch, "clip") * CLIP_STD + CLIP_MEAN, 0, 1)
    f = pose.shape[0]
    gen = torch.Generator(device=pipe.system.device).manual_seed(step)
    # sequential CFG: the training state shares the card
    out = pipe(ref, pose, plucker, clip_raw, num_inference_steps=8, guidance_scale=3.5,
               context_frames=f, cfg_mode="sequential", generator=gen)
    gen_v = out.videos[0]
    panels = np.concatenate([np.broadcast_to(ref[None], gen_v.shape), pose, gen_v, tgt], axis=2)
    os.makedirs(out_dir, exist_ok=True)
    save_video(panels.astype(np.float32), os.path.join(out_dir, f"val_{step}.mp4"), fps=8.0)


class Run(NamedTuple):
    """A training run ready to start: what :func:`setup` built."""
    stage: int
    args: argparse.Namespace
    cfg: ConfigDict
    system: CamAnimate
    state: TrainState
    sched: NoiseSchedule
    tcfg: TrainConfig
    dataset: object
    sampler: OrientationBatchSampler
    save_dir: str
    step0: int
    seed: int
    mesh: object = None
    dcp: Optional[DcpCheckpointer] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(stage: int, argv: Optional[Sequence[str]] = None) -> Run:
    """Parse the command line, join the process group where ``torchrun``
    started this process, build the mesh, the system, the train state
    (resumed where the config says), the dataset and the sampler."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    solver = cfg.solver
    device = pmesh.init_distributed(args.device, args.dist_backend)
    world = pmesh.world_size()
    pmesh.data_parallel_world(cfg.data.train_bs, world)
    n_slices = int(solver.get("dcn_slices", 1))
    if world % n_slices:
        raise ValueError(f"dcn_slices={n_slices} does not divide the {world}-rank mesh")
    mesh = None
    if n_slices > 1:
        mesh = pmesh.make_hierarchical_mesh(n_slices, world // n_slices)
    elif dist.is_initialized():
        mesh = pmesh.make_mesh(world)
    zero1 = (bool(solver.get("shard_optimizer_states", False)) and mesh is not None
             and pmesh.axis_size(mesh, pmesh.DATA) > 1)
    seed = int(cfg.get("seed", 0))
    system = CamAnimate(system_config(cfg, stage), device=device,
                        dtype=DTYPES[args.dtype]).init_random(seed)
    load_pretrained(system, cfg)
    predicate = stage1_trainable if stage == 1 else stage2_trainable
    state = TrainState(system, predicate, optimizer_config(cfg), mesh=mesh, zero1=zero1)
    step0 = 0
    if cfg.get("resume_from_checkpoint"):
        step0 = int(cfg.get("resume_step", 0))
        for path in load_train_checkpoint(cfg.resume_from_checkpoint, step0, system, state):
            logger.info("resumed from %s", path)
        state.step = step0
    save_dir = os.path.join(cfg.output_dir, cfg.exp_name)
    dcp = None
    if solver.get("checkpoint_backend", "msgpack") == "orbax":
        keep = 3 if stage == 1 else 10
        dcp = DcpCheckpointer(os.path.join(save_dir, "dcp"), state, keep=keep)
        if cfg.get("resume_from_checkpoint"):
            src = dcp
            resume_dir = os.path.join(cfg.resume_from_checkpoint, "dcp")
            if os.path.abspath(resume_dir) != dcp.save_dir:
                src = DcpCheckpointer(resume_dir, state)
            if src.latest_step() is None:
                logger.warning("no torch.distributed.checkpoint under %s; the resume used the "
                               "per-module files only", cfg.resume_from_checkpoint)
            else:
                step0 = src.restore(step0 or None)
                logger.info("resumed the train state at step %d from %s", step0, src.save_dir)

    tcfg = TrainConfig(uncond_ratio=cfg.get("uncond_ratio", 0.1),
                       noise_offset=cfg.get("noise_offset", 0.05),
                       snr_gamma=cfg.get("snr_gamma", 5.0))
    dataset = build_dataset(cfg, stage, clip_size=system.config.clip.image_size)
    sampler = OrientationBatchSampler(dataset.num_horizontal,
                                      len(dataset) - dataset.num_horizontal,
                                      cfg.data.train_bs, seed=seed)
    os.makedirs(save_dir, exist_ok=True)
    return Run(stage, args, cfg, system, state,
               system.make_schedule(beta_schedule="scaled_linear"), tcfg, dataset, sampler,
               save_dir, step0, seed, mesh, dcp)


def train(run: Run) -> Dict[str, object]:
    """The step loop from ``run.step0`` to ``solver.max_train_steps``.
    Returns what it logged (``logged``: step, loss, grad norm), the mean
    seconds a step of each ``StepTimers`` segment (``averages``), each
    step's ``data`` and ``step`` segments (``data_seconds``,
    ``step_seconds``) and each checkpoint's step, seconds (with the wait for
    the device) and bytes (``checkpoints``)."""
    stage, cfg, system, state = run.stage, run.cfg, run.system, run.state
    max_steps = cfg.solver.max_train_steps
    timers = StepTimers(max_steps, log_every=LOG_EVERY, log=logger)
    val_steps = cfg.get_path("val.validation_steps", 0) or 0
    val_pipe = None
    logged: List[Dict[str, float]] = []
    data_seconds: List[float] = []
    step_seconds: List[float] = []
    checkpoints: List[Dict[str, float]] = []
    lead = pmesh.rank() == 0  # the rank that writes files and renders
    tracker = Tracker(os.path.join(run.save_dir, "run"), config=dict(cfg)) if lead else None
    trace = contextlib.ExitStack()  # the profiler trace of steps 10-12
    ranks = pmesh.mesh_position(run.mesh)[1] if run.mesh is not None else 1

    def log(step, aux):
        rec = {"step": step, "loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"])}
        if tracker is not None:
            tracker.log(step, loss=rec["loss"], grad_norm=rec["grad_norm"])
        logged.append(rec)
        return rec

    def checkpoint(limit):
        _sync(system.device)
        t0 = time.time()
        if run.dcp is not None:  # limit: the checkpointer's own keep
            run.dcp.save(global_step)
            checkpoints.append({"step": global_step, "seconds": time.time() - t0})
        else:
            paths = save_train_checkpoint(run.save_dir, system, state,
                                          motion_only=(stage == 2), total_limit=limit)
            checkpoints.append({"step": global_step, "seconds": time.time() - t0,
                                "bytes": sum(os.path.getsize(p) for p in paths)})
        logger.info("checkpointed at step %d", global_step)

    global_step, aux = run.step0, None
    # the sampler's order is a function of (seed, epoch) and every epoch has
    # len(sampler) batches, so the resume point follows from the step alone
    epoch, skip = divmod(run.step0, len(run.sampler))
    if run.step0:
        logger.info("resume fast-forward: epoch %d, skipping %d batches", epoch, skip)
    if run.step0 >= max_steps:
        logger.warning("resume step %d is not below max_train_steps %d: no step is taken",
                       run.step0, max_steps)
    try:
        while global_step < max_steps:
            run.sampler.set_epoch(epoch)
            batches = list(run.sampler)[skip:]
            if run.mesh is not None:  # this rank's rows of each global batch
                batches = [pmesh.rank_rows(b, run.mesh) for b in batches]
            skip = 0
            loader = Loader(run.dataset, batches, num_workers=cfg.data.get("num_workers", 4),
                            device=system.device)
            t_data = time.time()
            for batch in loader:
                batch = to_train_batch(batch, stage)
                data_seconds.append(time.time() - t_data)
                timers.acc["data"] += data_seconds[-1]
                if run.args.profile_dir and lead and global_step - run.step0 == 10:
                    trace.enter_context(device_trace(run.args.profile_dir))
                before = timers.acc["step"]
                with timers.segment("step"), annotate("train_step"):
                    aux = train_step(system, state, run.sched, run.tcfg, batch,
                                     draws=step_draws(run.seed, global_step, system.device,
                                                      batch, run.sched, run.tcfg, ranks))
                step_seconds.append(timers.acc["step"] - before)
                if global_step - run.step0 == 12:
                    trace.close()
                global_step += 1
                if global_step % LOG_EVERY == 0:
                    timers.step(global_step, loss=log(global_step, aux)["loss"])
                else:
                    timers.step(global_step)
                if val_steps and lead and global_step % val_steps == 0:
                    from ..pipelines import Pose2ImagePipeline, Pose2VideoPipeline

                    if val_pipe is None:
                        val_pipe = (Pose2VideoPipeline if stage == 2
                                    else Pose2ImagePipeline)(system)
                    (log_validation_video if stage == 2 else log_validation)(
                        val_pipe, batch, os.path.join(run.save_dir, "validation"), global_step)
                    logger.info("validation render at step %d", global_step)
                if global_step % cfg.get("checkpointing_steps", 5000) == 0:
                    checkpoint(3 if stage == 1 else 10)
                if global_step >= max_steps:
                    break
                t_data = time.time()
            epoch += 1
        trace.close()
        checkpoint(None)
        if run.dcp is not None:
            run.dcp.close()
        if aux is not None and global_step % LOG_EVERY:
            log(global_step, aux)
    finally:
        trace.close()
        if tracker is not None:
            tracker.close()
    logger.info("training done at step %d", global_step)
    return {"logged": logged, "averages": timers.averages(), "data_seconds": data_seconds,
            "step_seconds": step_seconds, "checkpoints": checkpoints}


def run_training(stage: int, argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    return train(setup(stage, argv))


def main(argv: Optional[Sequence[str]] = None, stage: int = STAGE) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    try:
        run_training(stage, argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
