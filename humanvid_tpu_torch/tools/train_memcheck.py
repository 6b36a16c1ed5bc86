"""Peak device memory of a full-width training step, on the CUDA card.

    python -m humanvid_tpu_torch.tools.train_memcheck --stage 1 [--gradient_checkpointing]

The port's counterpart of the JAX package's ``tools/stage2_memcheck.py``,
whose XLA memory analysis becomes ``torch.cuda.max_memory_allocated``. It
builds the system a stage trains through ``train.system_config``, as the
training drivers do (``CamAnimateConfig()``, the stage's trainable set, bf16
modules with fp32 masters and moments), feeds a seeded synthetic batch at
the shipped recipe's shape (``configs/train/stage1.yaml``: bs 8 at
896x512, one frame; ``stage2.yaml``: bs 1, 24 frames at 896x512) and takes
``--steps`` steps, each ``train_step``'s parts in its order: the loss
(``loss_from_draws``) and its backward, then ``state.apply_gradients``.
Gradient checkpointing (and with it FF chunks of 1024) is off unless
``--gradient_checkpointing``: stage 1 ships it off, stage 2 on. Prints one
JSON line: the card, the levers, and for each step its seconds, the peak
GiB of the forward and backward (activations and gradients:
``backward_peak_gib``), of the update (the optimizer's fp32 temporaries:
``update_peak_gib``) and the larger of the two (``peak_gib``); or the
out-of-memory error with the peak reached before it. The tool runs on the
card only: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..pipelines import CamAnimate
from ..train import (
    OptimizerConfig,
    TrainConfig,
    TrainState,
    loss_from_draws,
    sample_draws,
    stage1_trainable,
    stage2_trainable,
    system_config,
)
from ..utils.config import ConfigDict

# the shipped recipes' batch shapes: (batch, frames, height, width)
SHAPES = {1: (8, 1, 896, 512), 2: (1, 24, 896, 512)}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", type=int, choices=(1, 2), required=True)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_memcheck measures the CUDA card, and there is none")
    dev = torch.device("cuda")
    cfg = ConfigDict.wrap({"solver": {
        "enable_gradient_checkpointing": args.gradient_checkpointing}})
    system = CamAnimate(system_config(cfg, args.stage), device=dev,
                        dtype=torch.bfloat16).init_random(0)
    state = TrainState(system, stage1_trainable if args.stage == 1 else stage2_trainable,
                       OptimizerConfig(warmup_steps=1))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    b, f, H, W = SHAPES[args.stage]
    rng = np.random.default_rng(0)
    s = system.config.clip.image_size
    batch = {"tgt": torch.empty((b, f, H, W, 3), device=dev).uniform_(-1, 1),
             "ref": torch.empty((b, H, W, 3), device=dev).uniform_(-1, 1),
             "clip": torch.as_tensor(rng.normal(size=(b, s, s, 3)), dtype=torch.float32,
                                     device=dev),
             "pose": torch.rand((b, f, H, W, 3), device=dev),
             "plucker": torch.randn((b, f, H, W, 6), device=dev)}
    record = {"device": _card(), "stage": args.stage, "batch": [b, f, H, W],
              "gradient_checkpointing": args.gradient_checkpointing,
              "ff_chunk_tokens": system.config.denoising_unet.ff_chunk_tokens,
              "trainable": sum(m.numel() for m in state.masters),
              "after_setup_gib": torch.cuda.memory_allocated() / 2**30,
              "steps": []}
    gen = torch.Generator(device=dev).manual_seed(1)
    try:
        for _ in range(args.steps):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            draws = sample_draws(gen, b, f, H, W, sched.num_train_timesteps, 0.0, uncond=False)
            loss, _ = loss_from_draws(system, sched, TrainConfig(), batch, draws)
            loss.backward()
            torch.cuda.synchronize()
            backward_peak = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            state.apply_gradients()
            torch.cuda.synchronize()
            update_peak = torch.cuda.max_memory_allocated() / 2**30
            record["steps"].append({"seconds": time.perf_counter() - t0,
                                    "backward_peak_gib": backward_peak,
                                    "update_peak_gib": update_peak,
                                    "peak_gib": max(backward_peak, update_peak)})
    except torch.OutOfMemoryError as err:
        record["out_of_memory"] = str(err).splitlines()[0]
        record["peak_before_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(record))


if __name__ == "__main__":
    main()
