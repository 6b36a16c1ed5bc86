#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card: name and power limit (``nvidia-smi``);
2. build: compile every CUDA kernel of ``humanvid_tpu_torch/csrc`` with nvcc
   into ``build/`` (one nvcc per source, all started together), and print
   each kernel's registers and spills and ptxas's wgmma notes;
3. kernel A (flash attention forward) against its plain PyTorch version at
   the main path's bf16 shapes; the plain version runs on a slice of query
   rows (the full level-0 fp32 logits would be 58 GB) for the error, and on
   all rows in chunks for its time; kernel A's time also as a share of
   SDPA's on the same inputs;
4. kernel B (frame-axis attention) against its plain version at the five
   temporal shapes of the main path, by device time (torch.profiler) with
   the CUDA-event time through the wrapper beside it;
5. the same tiny-config pipeline on the card (bf16, kernels) and on the CPU
   (fp32, plain versions), compared;
6. the main path: full-width CamAnimate (default config, seeded random
   weights, bf16), Pose2VideoPipeline at 768x512, 24 frames, one 24-frame
   window, CFG 3.5 sequential, full decode, with a few DDIM steps (the
   flagship runs 30); checks the video and that every kernel launched;
7. profile: torch.profiler's device time by kernel group over one denoise
   step and one decode of the same model.

The training path (stage 2) adds:

- kernel A bwd: the dk/dv and dq kernels against the plain backward at the
  stage-2 shapes (896x512x24f: level 0 with and without the CFG-dropout
  bias, level 1) and the stage-1 ReferenceNet's level-0 self-attention;
  keys hidden by the bias must get exactly zero dk and dv, a repeat launch
  the same bits, and the key tiles passed over as hidden the same bits as
  the same tiles computed;
- kernel B bwd: the frame-axis backward at the five stage-2 temporal shapes
  and the stage-1 camera encoder's (one frame), per gradient, a repeat
  launch the same bits, by device time (torch.profiler) with the event time
  beside it, and SDPA's backward as the library yardstick;
- tiny train: one uncond and one cond stage-2 step of the tiny config on the
  card (bf16, kernels) and on the CPU (fp32, plain versions), compared;
- train: full-width stage 2 (grad checkpointing, FF chunks of 1024, fp32
  masters of the motion modules and the camera encoder), 896x512x24f, bs 1,
  TRAIN_STEPS steps; checks finite values, that the trainable leaves move
  and the frozen ones do not, and that its kernels launched;
- profile: one more train step, device time by kernel group.

GroupNorm and stage 1 (pose2img and the stage-1 step) add:

- kernel C: GroupNorm(+SiLU) against its plain version at the decode's, the
  UNet's (the concatenations among them; a shape of every plan of the size
  rule that the paths reach) and a ragged shape,
  act None and SiLU, channels_last and contiguous, on both sides of its
  size rule (the one-pass cluster kernel, the two-pass kernels), a repeat
  launch the same bits, with device ms (torch.profiler) and event ms,
  plain ms, library ms (``F.group_norm`` + ``F.silu``) and bound ms; and
  the autograd Function's dx, dgamma and dbeta against plain autograd at
  the stage-2 level-0 shape;
- tiny reference: the tiny pose2img too, card bf16 against CPU fp32;
- stage 1: one full-width stage-1 system (``stage_config(1)``): pose2img
  at 896x512 with MAIN_STEPS DDIM steps and batched CFG 3.5, then
  STAGE1_STEPS stage-1 steps at 896x512, bs 8, one frame (step 0 uncond
  at lr 0); checks finite values, that step 0 moves nothing, that step 1
  moves every trainable leaf and that the frozen ones stay (per-leaf fp64
  checksums, no clones), and that the kernels launched; then one more
  step under the profiler.

The measurement probes and the wide-head backward add:

- kernel A bwd at d = 512: the dk/dv and dq kernels of the VAE's single
  512-wide head (8x6144x6144, and a small ragged case with the bias), with
  SDPA's backward at d = 512 by backend as the library yardstick;
- probes: kernel 8 (the orientation probe, every arm, and its device time
  at half the keys, which shows that the unstored products are computed;
  the d-major arm's time over the lanes arm's, the probe's answer),
  kernel 9 (the transposed flash forward, beside kernel A and its own
  un-transposed variant at UNet level 0)
  and kernel 10 (the streaming map, exact, beside ``torch.add`` and a
  device-to-device copy: the card's measured streaming rate), each against
  its plain version; kernels 8 and 10 by device time (torch.profiler) and
  by CUDA events through the wrapper;
- microbench: the port's ``humanvid_tpu_torch.tools.microbench`` entry with
  every probe but ``unet`` and ``vae`` (whose work the main phase times);
  every probe must pass and launch its kernels.

The inference command lines add:

- kernel A isolation: an Inf in one head's columns at some positions, at
  d = 40 and 80, with and without the bias, forward and backward: every
  other head finite and the same bits as the clean run;
- the CLI's default shapes (896x512, batched CFG) among kernel A's, B's
  and C's cases;
- tiny reference: one more tiny pose2vid with latent interpolation, the
  "leading" spacing and a schedule without ``set_alpha_to_one``;
- cli: a full-width CamAnimate with seeded weights written in the released
  checkpoint layouts (fp16) with a ``.py`` prompt config and a moving TUM
  camera file, loaded by the command line's own ``build_system`` (every
  tensor equal to the saved one), then ``cli.pose2vid.run_case`` at the
  CLI's defaults (-W 512 -H 896 -L 24, batched CFG 3.5, bf16) with CLI_STEPS
  DDIM steps on a seeded 48-frame 1080x1920 clip; checks the video, that
  the camera input is not the static camera's, and that kernels A (d = 40,
  80 and 512), B and C launched.

The training command lines add:

- train_cli: ``cli.train_stage_1``'s loop from ``.py`` configs with the
  shipped recipes' values and seeded weights, on two seeded 96-frame
  1024x576 portrait clips with pose clips and moving TUM cameras, served
  from memory in place of ``datasets.read_frames`` (the only stand-in: the
  card's machine has no OpenCV). Stage 2 at full width (896x512x24f, bs 1,
  grad checkpointing, 4 steps, checkpoints every 2): finite logged losses
  and grad norms and masters, the stage-2 checkpoint files, kernels A, B
  and C (forward and backward) launched; the step and data segments, the
  checkpoint writes and the peak memory. A resume at step 2 for one more
  step: the step counter, masters and moments equal to the files bit for
  bit before it, step 3's files after it. Stage 1 at full width (bs 8,
  896x512, grad checkpointing on, 2 steps) and its final save, gathered
  but not written (the ~19 GiB it would write, counted).

The evaluation command lines add:

- eval: ``tools.make_random_metric_weights`` writes the five metric files
  (CLIP-L/14 included); ``cli.eval_pose2vid.main`` generates EVAL_CLIPS
  seeded 72-frame 768x512 portrait clips (pose clips, moving TUM cameras)
  at full width (``CamAnimateConfig()`` from a ``.py`` config, seeded,
  bf16), -W 512 -H 768 -L 24 --stride 3, EVAL_STEPS DDIM steps, batched
  CFG 3.5, then scores them group by group (``--metrics_only
  --metrics_subset``, merged): all seven metrics present and finite;
  ``cli.eval_pose2img.main`` at its defaults (896x512, 30 steps) on two of
  the clips with LPIPS from a seeded flax ``.msgpack``; every metric
  network on the card (TF32 off, and on) against the CPU within
  METRIC_NET_TOL. Video and image file IO is served from memory (the only
  stand-in: the card's machine has no OpenCV). Kernels A (d = 40, 80 and
  512), B and C must have launched in the generation, and none in the
  metric runs.

The data-preparation path adds:

- pose: ``tools.make_random_pose_weights`` writes seeded YOLOX-L weights
  as a ``.pth`` (the upstream names; objectness, person-class and box-size
  biases set so that a few anchors pass) and DWPose weights as an ``.onnx``
  (mmpose names), then ``tools.prepare_videos`` runs on the card at full
  width (YOLOX-L at 640x640, DWPose-L at 384x288, IEEE fp32) over two
  seeded POSE_CLIPS clips, 1080x1920 and 1920x1080, decoding and encoding
  through the port's native libav core where it builds there, else serving
  ``read_frames``, ``get_fps`` and ``save_video`` from memory (it says
  which); then its ``--smplx`` branch on a POSE_SMPLX_FRAMES-frame ``.npz``. Checks a
  canvas a frame with drawn limbs, a person in every frame, and no
  hand-written kernel launched (the path has none: its networks are plain
  PyTorch on cuDNN and cuBLAS); prints the seconds a frame of detection,
  pose and drawing, the persons a frame and the peak memory; and holds the
  card to the CPU on the first frame of each clip: boxes, SimCC logits,
  keypoints and canvases within POSE_TOL.

The data-parallel path adds, before ``pose`` (each run's ranks are
processes of ``torch.distributed.run``, this script with ``--rank-worker``;
a rank that fails fails the phase):

- dp_train: ``cli.train_stage_1``'s setup and loop for stage 2 at full
  width (896x512x24f, grad checkpointing, ``shard_optimizer_states``, 1 clip
  a rank, the train_cli phase's clips from memory, each sample's crop
  generator seeded alike): world 1 on NCCL at global batch 2 (DP_STEPS
  steps), then world 2 on gloo with both ranks on the one card (NCCL
  refuses two ranks on one device): ZeRO-1, DP_SAVE_STEP steps, its save
  and a resume from it to DP_STEPS. Checks the ranks' masters the same
  bits after each update, the gathered moments after the resume within
  DP_MOMENT_TOL of the one-rank run's, the resumed state equal to the
  files bit for bit, kernels A, B and C (forward and backward) launched;
  prints per rank s/step, the all-reduce's seconds and bytes a step and
  the peak memory;
- fanout: ``Pose2VideoPipeline`` with a mesh at full width, 768x512x48f
  (3 windows x CFG = 6 rows) over 2 gloo ranks sharing the card, the
  ranks' latents the same bits and near the one-process batched run
  (FANOUT_STEPS DDIM steps); then ``tools.bench_configs`` at its four
  op-points (BENCH_STEPS steps, one run).

``python3 chip_smoke.py --long-wide-steps TREE`` times the long_wide path
alone with the port of the checkout at TREE (its own kernels, built into
its own ``build/``), so that two commits compare in one call, in turns:
``long_wide_steps``; ``--heads64-steps TREE`` the heads64 path the same
way.

Every head width the JAX kernels take adds (after the probes, and
``heads64`` before stage 1):

- head widths: kernel A's forward and backward at d = 64 and 128 (the
  heads of 5-head configs, at the main path's and the stage-2 step's
  shapes, with the batched-CFG and CFG-dropout biases), d = 96 and 112
  (the own-width kernels' other boxes; d = 96 at a level-1 size both
  ways), through the zero pad at d = 36 (to 40), and d = 192 (the mid
  kernels: the forward and, at a level-1 size, the backward at the head's
  own width), ragged with the bias; kernel B's forward and backward at d =
  64, 128 and 256 (the 5-head motion modules) and at d = 320, 640 and 1280
  (column chunks) and 36 (padded), at f = 24 and one frame; each held to its plain version with
  the same bits on a repeat launch, timed beside its bound and SDPA; kernel
  A's head isolation at d = 64, 128, 36 and 192 too;
- heads64: ``heads64_config()`` (5 heads wherever the default has 8) at
  full width: pose2vid at 768x512x24f with HEADS64_STEPS DDIM steps,
  sequential and batched CFG, then one uncond stage-2 step at 896x512x24f;
  checks finite outputs, launches of kernel A at d = 64 and 128 (forward;
  backward in the step), every one in the own-width configurations
  (printed by width and configuration), and of kernel B at d = 64, 128
  and 256, printed by head width, and no plain attention on CUDA tensors but the
  short-sequence route (Lq < 1024) that the JAX package also takes.

The last shapes the JAX kernels take add (after the head widths, and
``long_wide`` after ``heads64``):

- long and wide: kernel A's xwide kernels (d > 512: the forward, dK/dV
  and dQ, the head's depth split over a thread-block cluster, each line
  with the cluster plan) at d = 640 (the long_wide path's level-1 shapes:
  sequential cond and uncond, the batched-CFG bias, the stage-2 forward
  and backward with the CFG-dropout bias), 520 and 1280, kernel A's mid
  backward at the long_wide stage-2 step's level-0 shapes (d = 320, cond
  and uncond with the CFG-dropout bias on every row, with SDPA's backward
  by backend), and kernel B past 32 frames (the long forward; the
  backward's frames kernel up to 128 frames, its long kernel past that) at
  f = 48 (the path's four motion levels, at 768x512 forward and 896x512
  backward), f = 33, 64 and 96 at d = 40, 160 and 256, f = 200 and 256 (d
  = 40, and 160 in streamed panels) and the backward at f = 100 and 128
  (d = 40, and 160 at 128) and, in the long kernel, 136, 200 and 256, the
  backward's head isolation at f = 33-200; each line with the kernel's
  plan, each held to its plain version, a repeat launch the same bits, device ms
  (torch.profiler) and event ms beside the bound, the plain version's and
  the library's ms;
- long_wide: ``long_wide_config()`` (one spatial head in both UNets, so
  heads 320, 640 and 1280 wide; motion and camera tables of 48 frames) at
  full width: pose2vid at 768x512x48f in one 48-frame window with
  LONG_WIDE_STEPS DDIM steps, sequential and batched CFG, then one uncond
  stage-2 step at 896x512x48f (grad checkpointing), then one uncond
  stage-2 step of ``long_frames_config()`` (motion and camera tables of
  100 frames) at 256x256x100f and one of 136 frames at 128x128x136f;
  checks finite outputs, kernel A's xwide launches at d = 640 and its mid
  kernels' at d = 320 (forward; backward in the step) with none through
  the zero pad, kernel B's past 32 frames at f = 48 (the long forward; the
  backward's frames kernel), at f = 100 (the backward's frames kernel, no
  long kernel) and at f = 136 (the backward's long kernel), no plain
  attention on CUDA tensors but the short-sequence route; prints each
  run's seconds, peak GiB and launches by d and by f.

Every main-path run (pose2vid, the stage-2 steps, pose2img, the stage-1
steps, the denoise step and decode of the profile phase, the heads64 and
long_wide runs (the 100- and 136-frame stage-2 steps among them), the cli run, the train_cli stage-2 and stage-1 runs, the eval generation
and its pose2img run, each rank's dp_train and fanout runs, the pose runs
and the microbench run) sets every launch count to 0 just before it and
reads the counts just after.

Then one JSON line of per-kernel numbers, a ``[phase seconds]`` line (each
phase's wall seconds), the card line, and the last line
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 2 without one.

Each kernel is held to its plain version (bf16 in, fp32 softmax) by two
limits, each about 3x the largest reading of a sound kernel at the main
path's shapes on an H100: the relative L2 error ||out - plain|| / ||plain||,
which a systematic fault (a wrong scale, a lost bias) exceeds, and the
largest elementwise error over rms(plain), which a fault in a few rows or
columns (a ragged tile, a masked key) exceeds.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time

MAIN_STEPS = 5             # DDIM steps of the main path (the flagship runs 30)
MAIN_SIZE = (24, 768, 512)  # frames, height, width of the main path
TRAIN_STEPS = 4            # stage-2 steps of the training path
TRAIN_SIZE = (24, 896, 512)  # frames, height, width of the stage-2 recipe
STAGE1_STEPS = 3           # stage-1 steps
STAGE1_SIZE = (8, 896, 512)  # batch, height, width of the stage-1 recipe (one frame)
CLI_STEPS = 3              # DDIM steps of the cli phase (the CLI runs 30 by default)
CLI_CLIP = (48, 1920, 1080)  # frames, height, width of its pose clip: stride 2 to -L 24
# (relative L2 error, max error / rms(plain)) limits against the plain version.
# Kernel A rounds unnormalized probabilities to bf16 (sound: 3.1e-3, 0.066);
# kernel B rounds normalized ones, as its plain version does (sound: 6.9e-5, 0.026).
FLASH_TOL = (1e-2, 0.2)
TEMPORAL_TOL = (2e-4, 0.08)
# The backward kernels, per gradient (dq, dk, dv): both round p and ds to bf16
# as their plain versions do (sound: kernel A 3.5e-4, 0.070; kernel B 5.4e-5, 0.058).
FLASH_BWD_TOL = (1e-3, 0.2)
TEMPORAL_BWD_TOL = (2e-4, 0.2)
# Kernel C and its plain version both compute in fp32 and round once; they
# differ by summation order and fused multiply-adds, which flip a bf16
# rounding here and there (sound: 4.1e-5, 0.031).
GN_TOL = (1.5e-4, 0.1)
# The Function's gradients (F.group_norm's backward on bf16) against plain
# autograd in fp32, per gradient (dx, dgamma, dbeta) (sound: 3.2e-3, 0.074).
GN_GRAD_TOL = (1e-2, 0.25)
# Kernel 8 and its plain version both accumulate in fp32 and round once to
# bf16: summation order only. Kernel 9 rounds unnormalized probabilities as
# kernel A does and takes FLASH_TOL; kernel 10 must be exact.
DMAJOR_TOL = (4e-3, 0.05)
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (data sheet, SXM, 700 W)
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (data sheet)
H100_BYTES = 3.35e12       # HBM3 rate (data sheet)
PROFILE_TRIES = 8          # torch.profiler sessions a device-time reading may take
PROFILE_RETRIES_AFTER_MISS = 2  # and right after a reading that captured nothing
# Host pauses (s) in a session before the launches and after their
# synchronize: the first session's, and each retry's. Without them the
# profiler missed every launch of a session now and then (tools/profiler_window.py).
PROFILE_PADS = (0.05, 0.2)
_profiler_missed = False

FLASH_SRC = "humanvid_tpu_torch/csrc/flash_attention.cu"
TEMPORAL_SRC = "humanvid_tpu_torch/csrc/temporal_attention.cu"
FLASH_BWD_SRC = "humanvid_tpu_torch/csrc/flash_attention_bwd.cu"
MID_BWD_SRC = "humanvid_tpu_torch/csrc/flash_attention_mid_bwd.cu"
TEMPORAL_BWD_SRC = "humanvid_tpu_torch/csrc/temporal_attention_bwd.cu"
GN_SRC = "humanvid_tpu_torch/csrc/group_norm.cu"
DMAJOR_SRC = "humanvid_tpu_torch/csrc/probe_dmajor.cu"
PVT_SRC = "humanvid_tpu_torch/csrc/probe_pvt.cu"
HBM_SRC = "humanvid_tpu_torch/csrc/probe_hbm.cu"


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    """(least ms the card could take, what bounds it); ``peak`` is the
    rate of the operations' type."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def agreement(out, ref, tol):
    """(max abs error, relative L2 error, ok) of a kernel's output against
    its plain version, under tol = (relative L2 limit, max error / rms limit);
    where the plain version is exactly zero (dq and dk over one frame), so
    must the output be."""
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    norm = ref.norm().item()
    rel = diff.norm().item() / norm if norm else (0.0 if err == 0 else float("inf"))
    rms = ref.pow(2).mean().sqrt().item()
    return err, rel, rel <= tol[0] and err <= tol[1] * rms


def library_ms(torch, fn, reps: int):
    """Time of the PyTorch library call used as a yardstick; None where the
    library cannot run the shape (out of memory or no backend for it)."""
    try:
        return time_ms(torch, fn, reps)
    except (torch.OutOfMemoryError, RuntimeError) as err:
        print(f"  library call unavailable: {type(err).__name__}: {str(err)[:120]}")
        torch.cuda.empty_cache()
        return None


def phase_card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print("[card]")
    print(out)
    return out


def _ptxas_report(log):
    """(kernel, what ptxas said) for each entry function of an ``-Xptxas -v``
    log: its registers with its spill bytes, and ptxas's notes that wgmma
    was serialized (C7514) or setmaxnreg ignored (C7508)."""
    import re

    rows, kernel, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        elif "bytes spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append([kernel, line.split(":", 1)[-1].strip() + "; " + spill])
        elif "C7514" in line or "C7508" in line:
            rows.append([kernel, line.strip()])
    try:  # readable names where the toolchain has c++filt
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(rows):
        for row, name in zip(rows, names):
            name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            row[0] = name.split("(", 1)[0]
    return rows


def phase_build():
    from humanvid_tpu_torch.ops import cuda_build

    seconds, logs = cuda_build.build_all()
    print(f"[build] {seconds:.1f} s for {len(logs)} sources")
    for name, log in logs.items():
        for kernel, said in _ptxas_report(log):
            print(f"  {name}: {kernel}: {said}")


def flash_cases():
    """Kernel A at the main path's shapes: (name, B, Lq, Lk, heads, d, bias rows)."""
    return [
        ("level0 cond (ref KV)", 24, 6144, 12288, 8, 40, 0),
        ("level0 uncond", 24, 6144, 6144, 8, 40, 0),
        ("level0 batched CFG bias", 48, 6144, 12288, 8, 40, 24),
        ("level1 cond (ref KV)", 24, 1536, 3072, 8, 80, 0),
        ("VAE mid decode chunk", 8, 6144, 6144, 1, 512, 0),
        # the CLI's default, 896x512 with batched CFG: the bias hides the
        # reference keys from the 24 uncond rows of the 48
        ("cli 896x512 level0 batched CFG bias", 48, 7168, 14336, 8, 40, 24),
        ("cli 896x512 level1 batched CFG bias", 48, 1792, 3584, 8, 80, 24),
        ("cli 896x512 VAE mid decode chunk", 8, 7168, 7168, 1, 512, 0),
        # the long_wide path's level 0 (768x512, one 320-wide head): the mid
        # kernel, sequential cond (Lk doubled by the reference KV) and
        # uncond, and batched CFG with the bias
        ("long_wide level0 cond (ref KV) d320", 48, 6144, 12288, 1, 320, 0),
        ("long_wide level0 uncond d320", 48, 6144, 6144, 1, 320, 0),
        ("long_wide level0 batched CFG bias d320", 96, 6144, 12288, 1, 320, 48),
    ]


def phase_flash(torch, results, dev, cases):
    from humanvid_tpu_torch.ops import flash_attention as fa

    print(f"[kernel A] flash attention forward vs plain (bf16; tol: rel L2 {FLASH_TOL[0]}, "
          f"max err {FLASH_TOL[1]} x rms(plain), lse 1e-3)")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, B, lq, lk, heads, d, bias_rows in cases:
        c = heads * d
        q, k, v = (torch.randn((B, n, c), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (lq, lk, lk))
        bias = None
        unmasked = B * lk
        if bias_rows:
            # uncond rows hide the reference half of the keys
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked = B * lk - bias_rows * (lk // 2)
        out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        again = fa.flash_attention_cuda(q, k, v, heads, bias)
        repeat_same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        del again
        width = fa.flash_plan(d).width
        kernel = _flash_kernel(width)
        hidden_exact = None
        if bias_rows and kernel in ("flash_fwd_mid", "flash_fwd_own"):
            # the keys the bias hides add exactly nothing: other values there
            # give the same bits
            v2 = v.clone()
            v2[:bias_rows, lk // 2:] = torch.randn_like(v2[:bias_rows, lk // 2:])
            hidden_exact = torch.equal(out, fa.flash_attention_cuda(q, k, v2, heads, bias)[0])
            del v2
        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = fa.flash_attention_plain(q[:, rows], k, v, heads, bias)
        torch.cuda.synchronize()
        err, rel, close = agreement(out[:, rows], ref, FLASH_TOL)
        lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
        ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, heads, bias), 3)
        chunk = max(1, (2 << 30) // (B * heads * lk * 4))

        def plain_full():
            for i in range(0, lq, chunk):
                fa.flash_attention_plain(q[:, i:i + chunk], k, v, heads, bias)

        plain_ms = time_ms(torch, plain_full, 1)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        lib = library_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 3)
        flops = 4.0 * heads * lq * unmasked * d
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel() \
            + (0 if bias is None else 4 * bias.numel())
        b_ms, b_by = bound(flops, nbytes)
        ok = close and lse_err <= 1e-3 and repeat_same and hidden_exact is not False
        share = None if lib is None else ms / lib  # < 1: faster than SDPA
        extra = {}
        if kernel in ("flash_fwd_xwide", "flash_fwd_mid"):
            # its device time beside the event time, its plan; a case but the
            # headline whose sessions all miss the kernel keeps the events'
            headline = _is_headline(results, kernel, name)
            plan = fa.xwide_plan(width) if kernel == "flash_fwd_xwide" else fa.mid_plan(width)
            dev_ms, source = _device_ms(
                torch, lambda: fa.flash_attention_cuda(q, k, v, heads, bias), kernel + "_kernel",
                ms, headline)
            extra = dict(event_ms=ms, device_ms=dev_ms, device_ms_from=source,
                         plan=plan._asdict())
            ok = ok and (source == "profiler" or not headline)
        if hidden_exact is not None:
            extra["hidden_keys_exact"] = hidden_exact
        print(f"  {name}: B={B} Lq={lq} Lk={lk} heads={heads} d={d}"
              + (f" (padded to {width})" if width != d else "")
              + f" max_abs_err={err:.3e} rel_l2={rel:.3e} lse_err={lse_err:.3e} "
              f"repeat same bits={repeat_same} "
              + (f"hidden keys add nothing={hidden_exact} " if hidden_exact is not None else "")
              + f"ms={ms:.3f} "
              + (f"device_ms={extra['device_ms']:.3f} plan={tuple(extra['plan'].values())} "
                 if "device_ms" in extra else "")
              + f"plain_ms={plain_ms:.3f} "
              f"library_ms={lib} sdpa_share={share if share is None else round(share, 3)} "
              f"bound_ms={b_ms:.3f} ({b_by}) TFLOP/s={flops / ms / 1e9:.1f} "
              f"{'ok' if ok else 'FAIL'}")
        results.append(dict(kernel=kernel, shape=name, config=fa.flash_plan(d).forward,
                            d=d, kernel_d=width, max_abs_err=err, rel_l2=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=lib, sdpa_share=share, bound_ms=b_ms,
                            bound_by=b_by, ok=ok, **extra))
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()


def _flash_kernel(width):
    """Kernel A's forward kernel (the name of its row) for heads run
    ``width`` wide."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    if fa.is_own(width):
        return "flash_fwd_own"
    if width <= 128:
        return "flash_fwd"
    if width < 512:
        return "flash_fwd_mid"
    return "flash_fwd_d512" if width == 512 else "flash_fwd_xwide"


def phase_flash_isolation(torch, dev, direction):
    """Kernel A (forward, or the dk/dv and dq backward) with an Inf in one
    head's q, k, v and g columns at every third position, at d = 40 and 80,
    64 and 128 (the heads of 5-head configs), 36 (through the zero pad to
    40) and 192 and 320 (the mid forward; the backward through the zero pad
    to 512), the poisoned head in the middle and last, with and without the
    bias:
    every element outside that head's columns (and the forward's lse of the
    other heads) must be finite and the same bits as the clean run. Returns
    ok."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    b, lq, lk, heads = 2, 300, 700, 8
    ok = True
    for d in (40, 80, 64, 128, 36, 192, 320):
        c = heads * d
        gen = torch.Generator(device=dev).manual_seed(d)
        clean = [torch.randn((b, n, c), generator=gen, device=dev).to(torch.bfloat16)
                 for n in (lq, lk, lk, lq)]
        for hot in (1, heads - 1):
            hot_in = [t.clone() for t in clean]
            for t in hot_in:
                t[:, 1::3, hot * d:(hot + 1) * d] = float("inf")
            keep = torch.ones(c, dtype=torch.bool, device=dev)
            keep[hot * d:(hot + 1) * d] = False
            others = [h for h in range(heads) if h != hot]
            for with_bias in (False, True):
                bias = None
                if with_bias:
                    bias = torch.zeros((b, lk), device=dev)
                    bias[0, lk // 2:] = -1e9
                runs = []
                for q, k, v, g in (clean, hot_in):
                    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
                    if direction == "forward":
                        runs.append([out[..., keep], lse[:, others]])
                    else:
                        grads = fa.flash_attention_backward_cuda(
                            q, k, v, bias, g, lse, fa.attention_delta(g, out, heads), heads)
                        runs.append([t[..., keep] for t in grads])
                torch.cuda.synchronize()
                finite = all(bool(torch.isfinite(t).all()) for t in runs[1])
                same = all(torch.equal(x, y) for x, y in zip(*runs))
                ok = ok and finite and same
                print(f"  isolation {direction} d={d} Inf in head {hot} bias={with_bias}: "
                      f"other heads finite {finite}, same bits {same} "
                      f"{'ok' if finite and same else 'FAIL'}")
    return ok


def temporal_cases():
    """Kernel B at the main path's shapes: (name, b, f, l, c, heads)."""
    return [
        ("motion level0", 1, 24, 6144, 320, 8),
        ("motion level1", 1, 24, 1536, 640, 8),
        ("motion level2", 1, 24, 384, 1280, 8),
        ("motion level3/mid", 1, 24, 96, 1280, 8),
        ("camera encoder", 1, 24, 6144, 320, 8),
        # the CLI's default, 896x512: the camera encoder's, and the motion
        # modules' under batched CFG (the cond and uncond windows)
        ("cli 896x512 motion level0", 1, 24, 7168, 320, 8),
        ("cli 896x512 motion level0 batched CFG", 2, 24, 7168, 320, 8),
    ]


def phase_temporal(torch, results, dev, cases):
    from humanvid_tpu_torch.ops import temporal_attention as ta

    print(f"[kernel B] frame-axis attention vs plain (bf16; tol: rel L2 {TEMPORAL_TOL[0]}, "
          f"max err {TEMPORAL_TOL[1]} x rms(plain))")
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, b, f, l, c, heads in cases:
        d = c // heads
        q, k, v = (torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out = ta.temporal_attention_cuda(q, k, v, heads)
        ref = ta.temporal_attention_plain(q, k, v, heads)
        torch.cuda.synchronize()
        err, rel, ok = agreement(out, ref, TEMPORAL_TOL)
        same = torch.equal(out, ta.temporal_attention_cuda(q, k, v, heads))
        # over one frame p = 1: the output is v, exactly
        exact = torch.equal(out, v) if f == 1 else None
        same = same and exact is not False
        event_ms = time_ms(torch, lambda: ta.temporal_attention_cuda(q, k, v, heads), 10)
        long = f > ta.ITEM_FRAMES
        key = ("temporal_fwd_long_kernel" if long else "temporal_fwd_split_kernel"
               if d > ta.CHUNK_COLUMNS else "temporal_fwd_kernel")
        kernel = "temporal_fwd_long" if long else "temporal_fwd"
        headline = _is_headline(results, kernel, name)
        ms, ms_from = _device_ms(torch, lambda: ta.temporal_attention_cuda(q, k, v, heads),
                                 key, event_ms, headline)
        ok = ok and same and ms > 0 and (ms_from == "profiler" or not headline)
        plain_ms = time_ms(torch, lambda: ta.temporal_attention_plain(q, k, v, heads), 3)

        def split(t):
            return t.view(b, f, l, heads, d).permute(0, 2, 3, 1, 4)

        lib = library_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)), 10)
        flops = 4.0 * b * l * heads * f * f * d
        b_ms, b_by = bound(flops, 2.0 * 4 * q.numel())
        print(f"  {name}: b={b} f={f} l={l} c={c} heads={heads} d={d} "
              f"{_temporal_route(ta, c, heads, f)} max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} same_bits={same} "
              + (f"one frame exact (out = v)={exact} " if exact is not None else "")
              + f"device_ms={ms:.4f} ({ms_from}) "
              f"event_ms={event_ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib} "
              f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms if ms else 0:.2f} "
              f"{'ok' if ok else 'FAIL'}")
        results.append(dict(kernel=kernel, shape=name, d=d, f=f, max_abs_err=err, rel_l2=rel,
                            ms=ms, event_ms=event_ms, device_ms=ms, device_ms_from=ms_from,
                            plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                            same_bits=same, ok=ok))


def _temporal_route(ta, c, heads, f, backward=False):
    """Which item kernel B runs a head of c // heads columns over f frames
    in: whole heads, or column slices (the split kernels' plan), after any zero
    pad; past ITEM_FRAMES frames the long kernels' plans (whole heads, or
    one head streamed in panels and chunks), or the backward's frames
    kernel and its plan."""
    d = c // heads
    width = ta.temporal_width(d)
    plan = ta.temporal_plan(heads * width, heads, f)
    pad = f"padded to {width}, " if width != d else ""
    frames = ta.long_backward_plan(heads * width, heads, f) if backward else None
    if frames is not None:
        item = (f"{frames.heads} heads an item" if frames.chunks == 1
                else f"{frames.chunks} chunks of {frames.cols} columns")
        return f"({pad}frames kernel: {item}, {frames.stages} stages, {frames.smem} bytes)"
    if f > ta.ITEM_FRAMES:
        p = (ta.long_bwd_plan if backward else ta.long_fwd_plan)(heads * width, heads, f)
        item = (f"{p.heads} heads an item, all frames a stage" if p.mode == ta.MODE_RESIDENT
                else f"one head in {p.chunks} chunks of {p.cols} columns, "
                     f"{ta.LONG_PANEL}-frame panels")
        return f"({pad}long kernel: {item}, {p.stages} stages, {p.smem} bytes)"
    if plan.chunks > 1:
        p = ta.split_plan(width, f, backward)
        mode = " streamed" if p.mode == ta.MODE_SPLIT_STREAMED else ""
        return (f"({pad}split{mode}: {p.positions} positions x {p.slices} slices of {p.cols} "
                f"columns, {p.stages} slots, {p.smem} bytes)")
    return f"({pad}{plan.heads} heads an item)"


def flash_bwd_cases():
    """Kernel A's backward at the stage-2 training shapes (896x512x24f) and
    the stage-1 ReferenceNet's: (name, B, Lq, Lk, heads, d, bias rows)."""
    return [
        ("level0 cond (ref KV)", 24, 7168, 14336, 8, 40, 0),
        ("level0 uncond (CFG dropout bias)", 24, 7168, 14336, 8, 40, 24),
        ("level1 cond (ref KV)", 24, 1792, 3584, 8, 80, 0),
        # stage 1 (896x512, bs 8): the ReferenceNet's level-0 self-attention
        ("stage1 refnet level0 self", 8, 7168, 7168, 8, 40, 0),
        # the VAE mid block's 512-wide head (no training stage reaches it)
        ("VAE mid 8x(6144x6144) d512", 8, 6144, 6144, 1, 512, 0),
        ("ragged d512 with the bias", 2, 300, 700, 1, 512, 1),
    ]


def _profile_split(torch, fn, keys, tries=None):
    """Device ms per call of ``fn`` summed over the CUDA kernels whose names
    contain each key (each launched once a call), from torch.profiler over 3
    calls. A kernel's time is its captured total over its captured launches:
    the profiler can miss a launch, and a total over the 3 calls then reads a
    third low. A session that stops right after the launches' synchronize
    at times holds fewer of their device records, or none, though it holds
    their runtime calls (on the H100, 12 of 174 sessions of three
    long-forward launches, 10 of them none; with 50 ms of host pause before
    the launches and after the synchronize, 0 of 174:
    ``tools/profiler_window.py``, PERF.md §7). So each session pauses
    so (PROFILE_PADS), and a key it missed is taken again with longer
    pauses, up to PROFILE_TRIES sessions; a key captured in none reads 0.
    After a call that captured nothing, the next takes at most
    PROFILE_RETRIES_AFTER_MISS sessions (``tries`` where given) until one
    captures again."""
    from torch.profiler import ProfilerActivity, profile

    global _profiler_missed
    fn()
    torch.cuda.synchronize()
    tries = tries or (PROFILE_RETRIES_AFTER_MISS if _profiler_missed else PROFILE_TRIES)
    for attempt in range(tries):
        pad = PROFILE_PADS[min(attempt, 1)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)  # the launches' device records come after them
        out, missed = {key: 0.0 for key in keys}, set(keys)
        for evt in prof.key_averages():
            for key in keys:
                if key in evt.key and evt.count:
                    out[key] += evt.self_device_time_total / 1e3 / evt.count
                    missed.discard(key)
        if not missed:
            break
        print(f"  (the profiler captured no launch of {sorted(missed)}: profiling again)")
    _profiler_missed = len(missed) == len(keys)
    return out


def _is_headline(results, kernel, shape):
    """Whether ``kernel``'s case ``shape``, about to join ``results``, gives
    numbers of the kernels line: the kernel's headline (its first case,
    unless HEADLINES names one), or kernel C's one-pass headline."""
    if kernel in HEADLINES:
        return shape == HEADLINES[kernel]
    return shape == GN_ONE_PASS_HEADLINE or not any(r["kernel"] == kernel for r in results)


def _device_ms(torch, fn, key, event_ms, headline):
    """(ms, source): the device ms of the kernel named by ``key`` per call
    of ``fn`` from torch.profiler, or, where no session captured it, the
    CUDA-event ms per call already taken (``event_ms``). A ``headline``
    case takes every session PROFILE_TRIES allows, and its caller fails it
    where the events stand in."""
    ms = _profile_split(torch, fn, (key,), PROFILE_TRIES if headline else None)[key]
    if ms > 0:
        return ms, "profiler"
    print(f"  (no device record of {key}: its CUDA-event time stands for it)")
    return event_ms, "events"


def _sdpa_backward_ms(torch, tensors, g, mask, reps):
    """Time of the backward of scaled_dot_product_attention through
    autograd on contiguous head-split copies: the library yardstick."""
    def run():
        q, k, v = (t.detach().clone().requires_grad_() for t in tensors)
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return q, k, v, out

    def timed():
        q, k, v, out = state
        torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

    try:
        state = run()
    except (torch.OutOfMemoryError, RuntimeError) as err:
        print(f"  library call unavailable: {type(err).__name__}: {str(err)[:120]}")
        torch.cuda.empty_cache()
        return None
    ms = library_ms(torch, timed, reps)
    del state
    torch.cuda.empty_cache()
    return ms


def _sdpa_backward_by_backend(torch, tensors, g, mask, reps):
    """SDPA's backward under each backend that takes the shape: {name: ms};
    the library yardstick of a head width where the default may not say
    which backend ran."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend):
            ms = _sdpa_backward_ms(torch, tensors, g, mask, reps)
        if ms is not None:
            times[backend.name] = ms
    return times


def phase_flash_bwd(torch, results, dev, cases):
    """Kernel A's dk/dv and dq kernels against the plain backward (all q
    rows, through its chunk loop) on the CUDA forward's lse; hidden keys
    must get exactly zero dk and dv, a repeat launch the same bits, and,
    with the bias, a bias of -0.99e9 (hidden all the same, but above the
    -1e9 at which whole hidden key tiles are passed over) the same bits;
    the profiler must see both kernels."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    print(f"[kernel A bwd] flash attention dk/dv + dq vs plain backward (bf16; tol: rel L2 "
          f"{FLASH_BWD_TOL[0]}, max err {FLASH_BWD_TOL[1]} x rms(plain))")
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, B, lq, lk, heads, d, bias_rows in cases:
        c = heads * d
        q, g = (torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((B, lk, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias = None
        unmasked = B * lk
        if bias_rows:
            # CFG dropout: the uncond rows hide the reference half of the keys
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked = B * lk - bias_rows * (lk // 2)
        width = fa.flash_plan(d).backward_width
        wide = width > 128
        xwide = width > 512
        mid = 128 < width < fa.WIDE_HEAD_DIM
        out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        delta = fa.attention_delta(g, out, heads)
        args = (q, k, v, bias, g, lse, delta, heads)
        grads = fa.flash_attention_backward_cuda(*args)
        refs = fa.flash_attention_backward_plain(*args)
        torch.cuda.synchronize()
        errs = [agreement(o, r, FLASH_BWD_TOL) for o, r in zip(grads, refs)]
        ratios = "/".join(f"{e[0] / r.float().pow(2).mean().sqrt().item():.3e}"
                          for e, r in zip(errs, refs))
        hidden_zero, skip_same = True, True
        if bias_rows:
            hidden_zero = all(bool((t[:bias_rows, lk // 2:] == 0).all()) for t in grads[1:])
            computed = fa.flash_attention_backward_cuda(
                q, k, v, torch.where(bias <= -1e9, -0.99e9, bias), *args[4:])
            skip_same = all(torch.equal(x, y) for x, y in zip(grads, computed))
            del computed
        again = fa.flash_attention_backward_cuda(*args)
        repeat_same = all(torch.equal(x, y) for x, y in zip(grads, again))
        del again
        ms = time_ms(torch, lambda: fa.flash_attention_backward_cuda(*args), 3)
        # d = 512 (and 128 < d < 512 past 320): the dk/dv entry point
        # launches a dV and a dK kernel; d > 512: the xwide dK/dV kernel and
        # dQ kernel; 128 < d <= 320: the mid dK/dV and dQ kernels
        mid_plan = fa.mid_backward_plan(width) if mid else None
        dv_dk = (wide and not xwide and not mid) or (mid and mid_plan.layout == "split")
        kind = "mid" if mid else "wide" if dv_dk else "xwide" if xwide else ""
        names = ("dv", "dk", "dq") if dv_dk else ("dkv", "dq")
        keys = tuple(f"flash_bwd_{n}_{kind}_kernel" if kind else f"flash_bwd_{n}_kernel"
                     for n in names)
        if mid and mid_plan.dq_layout == "roles":  # dq by role: a kernel of its own name
            keys = keys[:-1] + ("flash_bwd_dqr_mid_kernel",)
        split = _profile_split(torch, lambda: fa.flash_attention_backward_cuda(*args), keys)
        split = dict(zip(names, split.values()))
        if dv_dk:
            split["dkv"] = split["dv"] + split["dk"]
        ok = (all(e[2] for e in errs) and hidden_zero and skip_same and repeat_same
              and all(ms > 0 for ms in split.values()))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_backward_plain(*args), 1)
        del refs
        torch.cuda.empty_cache()

        def heads_first(t):
            return t.view(B, t.shape[1], heads, d).transpose(1, 2).contiguous()

        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        tensors = [heads_first(t) for t in (q, k, v)]
        backends = {}
        if wide:
            backends = _sdpa_backward_by_backend(torch, tensors, heads_first(g), mask, 3)
            print(f"  SDPA backward at d={d} by backend (ms): {backends}")
            lib = min(backends.values()) if backends else None
        else:
            lib = _sdpa_backward_ms(torch, tensors, heads_first(g), mask, 3)
        flops = 10.0 * heads * lq * unmasked * d
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * (lse.numel() + delta.numel()) \
            + (0 if bias is None else 4 * bias.numel())
        b_ms, b_by = bound(flops, nbytes)
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        print(f"  {name}: B={B} Lq={lq} Lk={lk} heads={heads} d={d}"
              + (f" (padded to {width})" if width != d else "")
              + (f" (mid backward {mid_plan.layout}, depth {mid_plan.width})" if mid else "")
              + " "
              f"rel_l2 dq/dk/dv={errs[0][1]:.3e}/{errs[1][1]:.3e}/{errs[2][1]:.3e} "
              f"max_err/rms dq/dk/dv={ratios} "
              f"hidden keys zero={hidden_zero} repeat same bits={repeat_same} "
              f"passed-over tiles same bits={skip_same} ms={ms:.3f} (dkv {split['dkv']:.3f}"
              + (f" = dv {split['dv']:.3f} + dk {split['dk']:.3f}" if dv_dk else "")
              + f" + dq {split['dq']:.3f}) plain_ms={plain_ms:.3f} "
              f"library_ms={lib} bound_ms={b_ms:.3f} ({b_by}) "
              f"TFLOP/s={flops / ms / 1e9:.1f} {'ok' if ok else 'FAIL'}")
        extra = dict(library_backends=backends) if wide else {}
        if dv_dk:
            extra.update(dv_ms=split["dv"], dk_ms=split["dk"])
        if xwide:
            extra["plan"] = fa.xwide_plan(width)._asdict()
        if mid:
            extra["plan"] = mid_plan._asdict()
        results.append(dict(kernel=("flash_bwd_xwide" if xwide else "flash_bwd_mid" if mid
                                    else "flash_bwd_d512") if wide
                            else "flash_bwd_own" if fa.is_own(width) else "flash_bwd",
                            shape=name, config=fa.flash_plan(d).backward,
                            d=d, kernel_d=width, max_abs_err=err, rel_l2=rel, ms=ms, dkv_ms=split["dkv"],
                            dq_ms=split["dq"], plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by, ok=ok, **extra))
        del q, k, v, g, out, lse, delta, grads, args
        torch.cuda.empty_cache()


def temporal_bwd_cases():
    """Kernel B's backward at the stage-2 training shapes (896x512x24f) and
    the stage-1 camera encoder's (896x512, bs 8, one frame):
    (name, b, f, l, c, heads)."""
    return [
        ("motion level0", 1, 24, 7168, 320, 8),
        ("motion level1", 1, 24, 1792, 640, 8),
        ("motion level2", 1, 24, 448, 1280, 8),
        ("motion level3/mid", 1, 24, 112, 1280, 8),
        ("camera encoder", 1, 24, 7168, 320, 8),
        ("stage1 camera encoder", 8, 1, 7168, 320, 8),
    ]


def phase_temporal_bwd(torch, results, dev, cases):
    """Kernel B's backward against its plain version, per gradient, with the
    same bits on a repeat launch; device ms (torch.profiler) with the event
    ms through the wrapper beside it, plain ms, SDPA's backward ms and the
    byte bound."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from humanvid_tpu_torch.ops import temporal_attention as ta

    print(f"[kernel B bwd] frame-axis attention backward vs plain (bf16; tol: rel L2 "
          f"{TEMPORAL_BWD_TOL[0]}, max err {TEMPORAL_BWD_TOL[1]} x rms(plain))")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, b, f, l, c, heads in cases:
        d = c // heads
        q, k, v, g = (torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))

        def run():
            return ta.temporal_attention_backward_cuda(q, k, v, g, heads)

        grads = run()
        refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
        torch.cuda.synchronize()
        errs = [agreement(o, r, TEMPORAL_BWD_TOL) for o, r in zip(grads, refs)]
        ratios = "/".join(f"{e[0] / max(r.float().pow(2).mean().sqrt().item(), 1e-30):.3e}"
                          for e, r in zip(errs, refs))
        same = all(torch.equal(a, b_) for a, b_ in zip(grads, run()))
        # over one frame p = 1 and ds = 0: dq = dk = 0 and dv = g, exactly
        exact = (f != 1 or (not grads[0].any() and not grads[1].any()
                            and torch.equal(grads[2], g)))
        ok = all(e[2] for e in errs) and same and exact
        del grads, refs
        event_ms = time_ms(torch, run, 10)
        long = f > ta.ITEM_FRAMES
        key = ("temporal_bwd_long_kernel" if f > ta.FRAMES_KERNEL_FRAMES
               else "temporal_bwd_frames_kernel" if long else "temporal_bwd_split_kernel"
               if d > ta.CHUNK_COLUMNS else "temporal_bwd_kernel")
        kernel = ("temporal_bwd_long" if f > ta.FRAMES_KERNEL_FRAMES
                  else "temporal_bwd_frames" if long else "temporal_bwd")
        headline = _is_headline(results, kernel, name)
        ms, ms_from = _device_ms(torch, run, key, event_ms, headline)
        ok = ok and ms > 0 and (ms_from == "profiler" or not headline)
        plain_ms = time_ms(
            torch, lambda: ta.temporal_attention_backward_plain(q, k, v, g, heads), 3)

        def split(t):  # (b, f, l, c) -> (b*l, heads, f, d), contiguous
            return t.view(b, f, l, heads, d).permute(0, 2, 3, 1, 4).reshape(b * l, heads, f, d)

        # SDPA's default backend faults at one frame over 57344 x 8 heads
        backend = SDPBackend.MATH if f == 1 else None
        with sdpa_kernel(backend) if backend else contextlib.nullcontext():
            lib = _sdpa_backward_ms(torch, [split(t) for t in (q, k, v)], split(g), None, 10)
        flops = 10.0 * b * l * heads * f * f * d
        b_ms, b_by = bound(flops, 2.0 * 7 * q.numel())
        print(f"  {name}: b={b} f={f} l={l} c={c} heads={heads} d={d} "
              f"{_temporal_route(ta, c, heads, f, backward=True)} "
              f"rel_l2 dq/dk/dv={errs[0][1]:.3e}/{errs[1][1]:.3e}/{errs[2][1]:.3e} "
              f"max_err/rms dq/dk/dv={ratios} same_bits={same} "
              + (f"one frame exact (dq = dk = 0, dv = g)={exact} " if f == 1 else "")
              + f"device_ms={ms:.4f} ({ms_from}) event_ms={event_ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms if ms else 0:.2f} {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel=kernel, shape=name, d=d, f=f,
                            max_abs_err=max(e[0] for e in errs),
                            rel_l2=max(e[1] for e in errs), ms=ms, event_ms=event_ms,
                            device_ms=ms, device_ms_from=ms_from, plain_ms=plain_ms,
                            library_ms=lib,
                            library_backend=backend.name if backend else "default",
                            bound_ms=b_ms, bound_by=b_by, same_bits=same, ok=ok))
        del q, k, v, g
        torch.cuda.empty_cache()


def phase_temporal_isolation(torch, dev):
    """Kernel B's backward past 32 frames (the frames kernel, and the long
    kernel past 128), and both split kernels (heads wider than 160 columns
    up to 32 frames), with an Inf in one head's q, k, v and g columns at
    every third position: every element outside that head's columns at
    those positions must be finite and the same bits as the clean run.
    Returns ok."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    ok = True
    b, l = 2, 30
    for f, c, heads, hot in ((24, 1280, 4, 1), (13, 2640, 10, 3), (24, 1280, 5, 4),
                             (33, 320, 8, 1), (48, 320, 8, 3), (48, 640, 8, 7), (48, 1280, 8, 2),
                             (64, 1280, 5, 4), (96, 1280, 5, 2), (96, 320, 8, 7),
                             (100, 320, 8, 1), (128, 640, 8, 3), (128, 1280, 5, 2),
                             (136, 320, 8, 1), (200, 320, 8, 5), (200, 1280, 8, 6)):
        d = c // heads
        gen = torch.Generator(device=dev).manual_seed(f + c)
        clean = [torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(4)]
        hot_in = [t.clone() for t in clean]
        for t in hot_in:
            t[:, :, 1::3, hot * d:(hot + 1) * d] = float("inf")
        hit = torch.zeros((b, f, l, c), dtype=torch.bool, device=dev)
        hit[:, :, 1::3, hot * d:(hot + 1) * d] = True
        grads = [ta.temporal_attention_backward_cuda(*ts, heads) for ts in (clean, hot_in)]
        runs = [("backward", grads)]
        if f <= ta.ITEM_FRAMES:
            runs.append(("forward", [[ta.temporal_attention_cuda(*ts[:3], heads)]
                                     for ts in (clean, hot_in)]))
        torch.cuda.synchronize()
        for direction, (want_all, got_all) in runs:
            finite = all(bool(torch.isfinite(got[~hit]).all()) for got in got_all)
            same = all(torch.equal(want[~hit], got[~hit]) for want, got in zip(want_all, got_all))
            ok = ok and finite and same
            print(f"  isolation {direction} f={f} d={d} Inf in head {hot}: other heads and "
                  f"positions finite {finite}, same bits {same} "
                  f"{'ok' if finite and same else 'FAIL'}")
    return ok


# ---- every head width the kernels take (other head counts, the zero pad) ----

HEADS64_STEPS = 2          # DDIM steps of each heads64 pose2vid run
LONG_WIDE_STEPS = 2        # DDIM steps of each long_wide pose2vid run
LONG_WIDE_SIZE = (48, 768, 512)        # frames, height, width: one 48-frame window
LONG_WIDE_TRAIN_SIZE = (48, 896, 512)  # the stage-2 step's
LONG_FRAMES_TRAIN_SIZE = (100, 256, 256)  # a stage-2 step of the frames kernel's 7 tiles
LONG_FRAMES_PAST_SIZE = (136, 128, 128)  # one past the frames kernel's 128
# the mid backward's headline: the long_wide stage-2 step's level-0 cond call
MID_BWD_HEADLINE = "long_wide level0 cond (ref KV) d320"
# each kernel's headline case in the kernels line: its first, unless named here
HEADLINES = {"flash_bwd_mid": MID_BWD_HEADLINE}


def head_width_cases():
    """Kernel A's forward at the widths 5-head configs give (d = 64 at
    level 0 and 128 at level 1 of the 768x512 main path, with the batched
    CFG bias), d = 96 and 112 (the own-width kernel's 32- and 16-column
    boxes), d = 36 through the zero pad to 40, and d = 192 (the mid
    kernel); ragged cases with the bias: (name, B, Lq, Lk, heads, d, bias
    rows)."""
    return [
        ("heads64 level0 cond (ref KV) d64", 24, 6144, 12288, 5, 64, 0),
        ("heads64 level0 batched CFG bias d64", 48, 6144, 12288, 5, 64, 24),
        ("heads64 level1 cond (ref KV) d128", 24, 1536, 3072, 5, 128, 0),
        ("heads64 level1 batched CFG bias d128", 48, 1536, 3072, 5, 128, 24),
        ("ragged d128 with the bias", 2, 300, 700, 5, 128, 1),
        ("ragged d96 with the bias", 2, 300, 700, 4, 96, 1),
        ("level1-size d96", 24, 1536, 3072, 4, 96, 0),
        ("ragged d112 with the bias", 2, 300, 700, 4, 112, 1),
        ("pad d36 to 40, ragged with the bias", 2, 300, 700, 5, 36, 1),
        ("pad d36 to 40, level0-size", 24, 6144, 12288, 5, 36, 0),
        ("d192 (mid kernel), ragged with the bias", 2, 300, 700, 2, 192, 1),
        ("d192 (mid kernel), level1-size", 24, 1536, 3072, 5, 192, 0),
    ]


def head_width_bwd_cases():
    """Kernel A's backward at the heads64 stage-2 shapes (896x512x24f:
    level 0 d = 64 with and without the CFG-dropout bias, level 1 d = 128),
    ragged with the bias at d = 128, 96, 112, 36 (padded to 40) and 192 (the
    mid backward), and d = 96 and 192 at a level-1 size: (name, B, Lq, Lk,
    heads, d, bias rows)."""
    return [
        ("heads64 level0 cond (ref KV) d64", 24, 7168, 14336, 5, 64, 0),
        ("heads64 level0 uncond (CFG dropout bias) d64", 24, 7168, 14336, 5, 64, 24),
        ("heads64 level1 uncond (CFG dropout bias) d128", 24, 1792, 3584, 5, 128, 24),
        ("heads64 level1 cond (ref KV) d128", 24, 1792, 3584, 5, 128, 0),
        ("ragged d128 with the bias", 2, 300, 700, 5, 128, 1),
        ("ragged d96 with the bias", 2, 300, 700, 4, 96, 1),
        ("level1-size d96", 24, 1792, 3584, 4, 96, 0),
        ("ragged d112 with the bias", 2, 300, 700, 4, 112, 1),
        ("pad d36 to 40, ragged with the bias", 2, 300, 700, 5, 36, 1),
        ("d192 (mid backward), ragged with the bias", 2, 300, 700, 2, 192, 1),
        ("d192 (mid backward), level1-size", 8, 1792, 3584, 5, 192, 0),
    ]


def temporal_width_cases():
    """Kernel B's forward at the heads64 motion modules' shapes (768x512:
    d = 64, 128 and 256 at levels 0-3, the camera encoder's d = 64) and at
    d = 320, 640 and 1280 (column slices: the split kernel), 36 (padded to
    40), at f = 24 and one frame: (name, b, f, l, c, heads)."""
    return [
        ("heads64 motion level0 d64", 1, 24, 6144, 320, 5),
        ("heads64 motion level1 d128", 1, 24, 1536, 640, 5),
        ("heads64 motion level2 d256", 1, 24, 384, 1280, 5),
        ("heads64 motion level3/mid d256", 1, 24, 96, 1280, 5),
        ("heads64 camera encoder d64", 1, 24, 6144, 320, 5),
        ("d320 (2 slices)", 1, 24, 384, 1280, 4),
        ("d640 (4 slices)", 1, 24, 384, 1280, 2),
        ("d1280 (8 slices)", 1, 24, 384, 1280, 1),
        ("d1280 one frame", 8, 1, 384, 1280, 1),
        ("d256 one frame", 8, 1, 448, 1280, 5),
        ("pad d36 to 40", 1, 24, 1536, 180, 5),
    ]


def temporal_width_bwd_cases():
    """Kernel B's backward at the heads64 stage-2 shapes (896x512x24f)
    and at the other widths, f = 24 and one frame: (name, b, f, l, c,
    heads)."""
    return [
        ("heads64 motion level0 d64", 1, 24, 7168, 320, 5),
        ("heads64 motion level1 d128", 1, 24, 1792, 640, 5),
        ("heads64 motion level2 d256", 1, 24, 448, 1280, 5),
        ("heads64 motion level3/mid d256", 1, 24, 112, 1280, 5),
        ("heads64 camera encoder d64", 1, 24, 7168, 320, 5),
        ("d320 (2 slices)", 1, 24, 448, 1280, 4),
        ("d640 (4 slices)", 1, 24, 448, 1280, 2),
        ("d1280 (8 slices)", 1, 24, 448, 1280, 1),
        ("d1280 one frame", 8, 1, 448, 1280, 1),
        ("d256 one frame", 8, 1, 448, 1280, 5),
        ("pad d36 to 40", 1, 24, 1792, 180, 5),
    ]


def heads64_config():
    """``CamAnimateConfig`` with 5 attention heads wherever the default
    has 8: the spatial heads 64 wide at level 0 and 128 at level 1 (256
    at levels 2-3), the motion modules' 64, 128, 256 and 256, the camera
    encoder's 64; the same 2.568 B parameters."""
    from humanvid_tpu_torch.models.configs import CameraEncoderConfig, UNetConfig
    from humanvid_tpu_torch.pipelines import CamAnimateConfig

    return CamAnimateConfig(
        reference_unet=UNetConfig(attention_heads=5),
        denoising_unet=UNetConfig(use_motion_module=True, attention_heads=5, motion_num_heads=5),
        camera_encoder=CameraEncoderConfig(position_encoding_max_len=24, num_heads=5))


@contextlib.contextmanager
def _plain_attention_calls():
    """Counts the plain attention versions' calls on CUDA tensors while
    the block runs: ``{"kernel fallbacks": n, "short sequences": n}``. The
    wrappers of kernels A, B and C never call them on a card (a fallback
    would count under "kernel fallbacks"); ``packed_attention`` takes the
    plain matmul + softmax for Lq < FLASH_MIN_QLEN by design, as the JAX
    package takes XLA there ("short sequences"; every such call is
    checked to be below that length)."""
    from humanvid_tpu_torch.ops import attention as attn
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta

    counts = {"kernel fallbacks": 0, "short sequences": 0, "long sequences": 0}

    def counted(fn, key):
        def wrapper(*args, **kw):
            if args[0].device.type == "cuda":
                if key == "route":
                    short = args[0].shape[1] < attn.FLASH_MIN_QLEN
                    counts["short sequences" if short else "long sequences"] += 1
                else:
                    counts[key] += 1
            return fn(*args, **kw)
        return wrapper

    patched = [(attn, "flash_attention_plain", "route")] + [
        (mod, name, "kernel fallbacks") for mod, name in (
            (fa, "flash_attention_plain"), (fa, "flash_attention_backward_plain"),
            (ta, "temporal_attention_plain"), (ta, "temporal_attention_backward_plain"),
            (gn, "group_norm_act_plain"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, key in patched:
        setattr(mod, name, counted(getattr(mod, name), key))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _launches_by_width():
    """Kernel A's and B's launches since the last reset, forward and
    backward, by the caller's head width (and kernel B's by frame count);
    kernel A's that ran through the zero pad to 512, by the same width, and
    kernel A's by width and configuration."""
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import temporal_attention as ta

    return {"flash forward_launches_by_d": dict(sorted(fa.forward_launches_by_d.items())),
            "flash backward_launches_by_d": dict(sorted(fa.backward_launches_by_d.items())),
            "flash forward_pad_launches_by_d": dict(sorted(fa.forward_pad_launches_by_d.items())),
            "flash backward_pad_launches_by_d":
                dict(sorted(fa.backward_pad_launches_by_d.items())),
            "temporal forward_launches_by_d": dict(sorted(ta.forward_launches_by_d.items())),
            "temporal backward_launches_by_d": dict(sorted(ta.backward_launches_by_d.items())),
            "temporal forward_launches_by_f": dict(sorted(ta.forward_launches_by_f.items())),
            "temporal backward_launches_by_f": dict(sorted(ta.backward_launches_by_f.items())),
            "flash forward_launches_by_config":
                {f"{d} {c}": n for (d, c), n in sorted(fa.forward_launches_by_config.items())},
            "flash backward_launches_by_config":
                {f"{d} {c}": n for (d, c), n in sorted(fa.backward_launches_by_config.items())}}


def _own_launches_only(direction):
    """Whether kernel A's launches at d = 64 and 128 since the last reset
    (forward or backward) all ran in the own-width configurations, and
    some did at each width."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    counts = (fa.forward_launches_by_config if direction == "forward"
              else fa.backward_launches_by_config)
    prefix = "Own<" if direction == "forward" else "DkvOwn<"
    return all(any(w == d for w, _ in counts) for d in (64, 128)) and all(
        c.startswith(prefix) for (w, c) in counts if w in (64, 128))


def phase_heads64(torch, np, dev, card):
    """The heads64 path: ``heads64_config()`` at full width with seeded
    random weights, bf16: Pose2VideoPipeline at 768x512x24f, one window,
    CFG 3.5, HEADS64_STEPS DDIM steps, once sequential and once batched
    CFG (the reference-KV bias through kernel A at d = 64), then one
    stage-2 step at 896x512x24f, bs 1, grad checkpointing, forced uncond
    (the CFG-dropout bias in kernel A's backward). Checks finite outputs,
    kernel A's launches at d = 64 and 128 (forward; backward in the step),
    every one of them in the own-width configurations,
    kernel B's at 64, 128 and 256 (forward and backward), and no plain
    attention on CUDA tensors but the short-sequence route. Returns (ok,
    {run: launches})."""
    from humanvid_tpu_torch.pipelines import CamAnimate
    from humanvid_tpu_torch.train import (
        OptimizerConfig, TrainConfig, TrainState, sample_draws, stage2_trainable,
        stage_config, train_step)

    F, H, W = MAIN_SIZE
    ok, runs = True, {}
    t0 = time.perf_counter()
    system, pipe, inputs = _pipeline(torch, np, dev, heads64_config(), MAIN_SIZE)
    n_params = sum(p.numel() for m in system.components().values() for p in m.parameters())
    print(f"[heads64] {card}: CamAnimate with 5 heads, {n_params / 1e9:.3f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    for mode in ("sequential", "batched"):
        torch.cuda.synchronize()
        _reset_launches()
        with _plain_attention_calls() as plain:
            out = pipe(**inputs, num_inference_steps=HEADS64_STEPS, guidance_scale=3.5,
                       context_frames=24, cfg_mode=mode, decode_chunk=8,
                       generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
        launches, by_d = _launch_counts(), _launches_by_width()
        v, sec = out.videos, out.seconds
        run_ok = (v.shape == (1, F, H, W, 3) and bool(np.isfinite(v).all())
                  and float(v.min()) >= 0.0 and float(v.max()) <= 1.0
                  and all(by_d["flash forward_launches_by_d"].get(d, 0) > 0 for d in (64, 128))
                  and _own_launches_only("forward")
                  and all(by_d["temporal forward_launches_by_d"].get(d, 0) > 0
                          for d in (64, 128, 256))
                  and plain["kernel fallbacks"] == 0 and plain["long sequences"] == 0)
        ok = ok and run_ok
        runs[f"heads64_{mode}"] = launches
        print(f"[heads64] pose2vid {H}x{W}x{F}f, {HEADS64_STEPS} DDIM steps, CFG 3.5 {mode}: "
              f"denoise steps {[round(x, 3) for x in sec['denoise_steps']]} s, decode "
              f"{sec['decode']:.3f} s; video min {float(v.min()):.4f} max {float(v.max()):.4f}; "
              f"launches {launches}; {by_d}; plain attention on CUDA tensors {plain} "
              f"{'ok' if run_ok else 'FAIL'}")
    del pipe, system, out
    gc.collect()
    torch.cuda.empty_cache()

    F, H, W = TRAIN_SIZE
    system = CamAnimate(stage_config(2, heads64_config(), gradient_checkpointing=True),
                        device=dev, dtype=torch.bfloat16).init_random(0)
    _unzero_(torch, system, 1)
    state = TrainState(system, stage2_trainable, OptimizerConfig(warmup_steps=1))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    batch = _train_batch(np, 1, F, H, W, system.config.clip.image_size, 10)
    draws = sample_draws(torch.Generator(device=dev).manual_seed(11), 1, F, H, W,
                         sched.num_train_timesteps, 0.0)._replace(uncond=True)
    torch.cuda.synchronize()
    _reset_launches()
    with _plain_attention_calls() as plain:
        t0 = time.perf_counter()
        out = train_step(system, state, sched, TrainConfig(), batch, draws=draws)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, by_d = _launch_counts(), _launches_by_width()
    loss, norm = out["loss"].item(), out["grad_norm"].item()
    finite = np.isfinite(loss) and np.isfinite(norm) and all(
        bool(torch.isfinite(m).all()) for m in state.masters)
    step_ok = (finite
               and all(by_d["flash backward_launches_by_d"].get(d, 0) > 0 for d in (64, 128))
               and _own_launches_only("forward") and _own_launches_only("backward")
               and all(by_d[f"temporal {k}_launches_by_d"].get(d, 0) > 0
                       for k in ("forward", "backward") for d in (64, 128, 256))
               and plain["kernel fallbacks"] == 0 and plain["long sequences"] == 0)
    ok = ok and step_ok
    runs["heads64_train"] = launches
    print(f"[heads64] stage-2 step {H}x{W}x{F}f bs 1 (uncond: the CFG-dropout bias), grad "
          f"checkpointing: {seconds:.3f} s (first step, with the kernels' first launches), "
          f"loss {loss:.5f}, grad norm {norm:.4f}, finite {finite}; launches {launches}; "
          f"{by_d}; plain attention on CUDA tensors {plain} {'ok' if step_ok else 'FAIL'}")
    del system, state, batch, out
    gc.collect()
    torch.cuda.empty_cache()
    return ok, runs


# ---- the last shapes: kernel A past 512 columns, kernel B past 32 frames ----


def long_wide_flash_cases():
    """Kernel A's xwide forward at the long_wide path's level-1 shapes
    (768x512: one 640-wide head, Lk doubled by the reference KV; sequential
    cond and uncond, the batched-CFG bias; the stage-2 step's forward at
    896x512, uncond with the CFG-dropout bias) and at d = 520 and 1280:
    (name, B, Lq, Lk, heads, d, bias rows)."""
    return [
        ("long_wide level1 cond (ref KV) d640", 48, 1536, 3072, 1, 640, 0),
        ("long_wide level1 batched CFG bias d640", 96, 1536, 3072, 1, 640, 48),
        ("long_wide level1 uncond d640", 48, 1536, 1536, 1, 640, 0),
        ("long_wide stage-2 uncond (CFG dropout bias) d640", 48, 1792, 3584, 1, 640, 48),
        ("ragged d520 with the bias", 2, 300, 700, 1, 520, 1),
        ("d520 2 heads level1-size", 8, 1536, 3072, 2, 520, 0),
        ("ragged d1280 with the bias", 2, 300, 700, 1, 1280, 1),
        ("d1280 level1-size", 8, 1536, 3072, 1, 1280, 0),
    ]


def long_wide_flash_bwd_cases():
    """Kernel A's xwide backward at the long_wide stage-2 step's level-1
    shapes (896x512x48f: uncond with the CFG-dropout bias on every row, and
    cond) and ragged with the bias at d = 520 and 1280; its mid backward at
    the step's level-0 shapes (d = 320, cond, and uncond with the bias on
    every row): (name, B, Lq, Lk, heads, d, bias rows)."""
    return [
        ("long_wide level1 uncond (CFG dropout bias) d640", 48, 1792, 3584, 1, 640, 48),
        ("long_wide level1 cond (ref KV) d640", 48, 1792, 3584, 1, 640, 0),
        ("ragged d520 with the bias", 2, 300, 700, 1, 520, 1),
        ("ragged d1280 with the bias", 2, 300, 700, 1, 1280, 1),
        (MID_BWD_HEADLINE, 48, 7168, 14336, 1, 320, 0),
        ("long_wide level0 uncond (CFG dropout bias) d320", 48, 7168, 14336, 1, 320, 48),
    ]



def long_wide_temporal_cases():
    """Kernel B's long forward at the long_wide path's motion levels
    (768x512x48f: d = 40, 80, 160, 160; the camera encoder's is level 0's
    shape), at f = 33, 64 and 96 (d = 40, 160, 256), and at f = 200 and 256
    (d = 40 at the 128x128 step's level-0 size, and 160 in streamed
    panels): (name, b, f, l, c, heads)."""
    return [
        ("long_wide motion level0 f48", 1, 48, 6144, 320, 8),
        ("long_wide motion level1 f48", 1, 48, 1536, 640, 8),
        ("long_wide motion level2 f48", 1, 48, 384, 1280, 8),
        ("long_wide motion level3/mid f48", 1, 48, 96, 1280, 8),
        ("long_wide batched CFG level0 f48", 2, 48, 6144, 320, 8),
        ("f33 d40", 1, 33, 6144, 320, 8),
        ("f64 d160", 1, 64, 384, 1280, 8),
        ("f96 d256", 1, 96, 384, 1280, 5),
        ("f200 d40", 1, 200, 256, 320, 8),
        ("f256 d160", 1, 256, 64, 1280, 8),
    ]


def long_wide_temporal_bwd_cases():
    """Kernel B's backward past 32 frames: the frames kernel at the
    long_wide stage-2 step's motion levels (896x512x48f) and at f = 33, 64,
    96, 100 and 128, the long kernel at f = 136, past the frames kernel's
    reach, and at f = 200 and 256 (d = 40 at the 128x128 step's level-0
    size, 160 in streamed panels; the frames kernel's first shape is its
    headline, the long kernel's f = 136): (name, b, f, l, c, heads)."""
    return [
        ("long_wide motion level0 f48", 1, 48, 7168, 320, 8),
        ("long_wide motion level1 f48", 1, 48, 1792, 640, 8),
        ("long_wide motion level2 f48", 1, 48, 448, 1280, 8),
        ("long_wide motion level3/mid f48", 1, 48, 112, 1280, 8),
        ("f33 d40", 1, 33, 7168, 320, 8),
        ("f64 d160", 1, 64, 448, 1280, 8),
        ("f96 d256", 1, 96, 448, 1280, 5),
        ("f100 d40", 1, 100, 7168, 320, 8),
        ("f128 level0-size d40", 1, 128, 7168, 320, 8),
        ("f128 level2-size d160", 1, 128, 448, 1280, 8),
        ("f136 d40 (long kernel)", 1, 136, 7168, 320, 8),
        ("f200 d40 (long kernel)", 1, 200, 256, 320, 8),
        ("f256 d160 (long kernel, streamed)", 1, 256, 64, 1280, 8),
    ]


def long_wide_config():
    """``CamAnimateConfig`` with one attention head in both UNets (spatial
    heads 320, 640 and 1280 wide: level 0 in kernel A's mid forward and
    its backward through the zero pad to 512, level 1 in the xwide kernels
    at Lq >= 1024, level 2 on the short-sequence route) and motion and camera position tables of 48
    frames (motion heads stay 8: d = 40, 80, 160; kernel B's long kernels
    at f = 48)."""
    from humanvid_tpu_torch.models.configs import CameraEncoderConfig, UNetConfig
    from humanvid_tpu_torch.pipelines import CamAnimateConfig

    return CamAnimateConfig(
        reference_unet=UNetConfig(attention_heads=1),
        denoising_unet=UNetConfig(use_motion_module=True, attention_heads=1, motion_max_len=48),
        camera_encoder=CameraEncoderConfig(position_encoding_max_len=48))


def _pipeline(torch, np, dev, config, size):
    """``config`` at full width, seeded random weights, bf16: (system, its
    Pose2VideoPipeline, seeded inputs of ``size`` (frames, height, width))."""
    from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline

    F, H, W = size
    system = CamAnimate(config, device=dev, dtype=torch.bfloat16).init_random(0)
    return system, Pose2VideoPipeline(system), _inputs(np, F, H, W,
                                                       system.config.clip.image_size, 0)


def _stage2_step_setup(torch, np, dev, config, size):
    """A stage-2 system of ``config`` at full width (grad checkpointing,
    seeded random weights, the zero-initialized layers made non-zero), its
    state and schedule, a seeded bs-1 batch of ``size`` (frames, height,
    width) and step 0's draws forced uncond (the CFG-dropout bias):
    (system, state, sched, batch, draws)."""
    from humanvid_tpu_torch.pipelines import CamAnimate
    from humanvid_tpu_torch.train import (
        OptimizerConfig, TrainState, sample_draws, stage2_trainable, stage_config)

    F, H, W = size
    system = CamAnimate(stage_config(2, config, gradient_checkpointing=True, camera_frames=F),
                        device=dev, dtype=torch.bfloat16).init_random(0)
    _unzero_(torch, system, 1)
    state = TrainState(system, stage2_trainable, OptimizerConfig(warmup_steps=1))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    batch = _train_batch(np, 1, F, H, W, system.config.clip.image_size, 10)
    draws = sample_draws(torch.Generator(device=dev).manual_seed(11), 1, F, H, W,
                         sched.num_train_timesteps, 0.0)._replace(uncond=True)
    return system, state, sched, batch, draws


def _timed_stage2_step(torch, np, system, state, sched, batch, draws):
    """One stage-2 step with the launch and plain-attention counts reset
    just before it: (seconds, launches, by width, plain counts, peak GiB,
    loss, grad norm, finite)."""
    from humanvid_tpu_torch.train import TrainConfig, train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _plain_attention_calls() as plain:
        t0 = time.perf_counter()
        out = train_step(system, state, sched, TrainConfig(), batch, draws=draws)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, by_d = _launch_counts(), _launches_by_width()
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, norm = out["loss"].item(), out["grad_norm"].item()
    finite = np.isfinite(loss) and np.isfinite(norm) and all(
        bool(torch.isfinite(m).all()) for m in state.masters)
    return seconds, launches, by_d, dict(plain), peak, loss, norm, finite


def long_frames_config(F=LONG_FRAMES_TRAIN_SIZE[0]):
    """``CamAnimateConfig`` with motion and camera position tables of F
    frames (motion heads d = 40, 80 and 160): kernel B's backward runs in
    the frames kernel up to 128 frames and in the long kernel past them."""
    from humanvid_tpu_torch.models.configs import CameraEncoderConfig, UNetConfig
    from humanvid_tpu_torch.pipelines import CamAnimateConfig

    return CamAnimateConfig(
        denoising_unet=UNetConfig(use_motion_module=True, motion_max_len=F),
        camera_encoder=CameraEncoderConfig(position_encoding_max_len=F))


def phase_long_wide(torch, np, dev, card):
    """The long_wide path: ``long_wide_config()`` at full width with seeded
    random weights, bf16: Pose2VideoPipeline at 768x512x48f in one 48-frame
    window, CFG 3.5, LONG_WIDE_STEPS DDIM steps, once sequential and once
    batched CFG (the reference-KV bias through the xwide forward), then one
    stage-2 step at 896x512x48f, bs 1, grad checkpointing, step 0 forced
    uncond (the CFG-dropout bias in both of kernel A's backward entry
    points). Checks finite outputs, the mid kernels' launches at d = 320
    (forward; the backward in the step) and none through the zero pad, the
    xwide kernels' at d = 640 and the long kernels' at f = 48 (forward;
    backward in the step: the frames kernel), and no plain attention on
    CUDA tensors but the short-sequence route. Then one stage-2 step of
    ``long_frames_config()`` at LONG_FRAMES_TRAIN_SIZE (100 frames at
    256x256), whose backward runs in the frames kernel and never in the
    long kernel, and one at LONG_FRAMES_PAST_SIZE (136 frames at 128x128),
    past the frames kernel's reach, in the long kernel only.
    Returns (ok, {run: launches})."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    F, H, W = LONG_WIDE_SIZE
    ok, runs = True, {}
    t0 = time.perf_counter()
    system, pipe, inputs = _pipeline(torch, np, dev, long_wide_config(), LONG_WIDE_SIZE)
    n_params = sum(p.numel() for m in system.components().values() for p in m.parameters())
    print(f"[long_wide] {card}: CamAnimate with one spatial head and {F}-frame tables, "
          f"{n_params / 1e9:.3f} B params, built in {time.perf_counter() - t0:.1f} s")
    for mode in ("sequential", "batched"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with _plain_attention_calls() as plain:
            t0 = time.perf_counter()
            out = pipe(**inputs, num_inference_steps=LONG_WIDE_STEPS, guidance_scale=3.5,
                       context_frames=F, cfg_mode=mode, decode_chunk=8,
                       generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches, by_d = _launch_counts(), _launches_by_width()
        peak = torch.cuda.max_memory_allocated() / 2**30
        v, sec = out.videos, out.seconds
        run_ok = (v.shape == (1, F, H, W, 3) and bool(np.isfinite(v).all())
                  and float(v.min()) >= 0.0 and float(v.max()) <= 1.0
                  and launches["flash_fwd_xwide"] > 0 and launches["temporal_fwd_long"] > 0
                  and launches["flash_fwd_mid"] > 0
                  and not by_d["flash forward_pad_launches_by_d"]
                  and all(by_d["flash forward_launches_by_d"].get(d, 0) > 0 for d in (320, 640))
                  and by_d["temporal forward_launches_by_f"].get(F, 0) > 0
                  and set(by_d["temporal forward_launches_by_f"]) == {F}
                  and plain["kernel fallbacks"] == 0 and plain["long sequences"] == 0)
        ok = ok and run_ok
        runs[f"long_wide_{mode}"] = launches
        print(f"[long_wide] pose2vid {H}x{W}x{F}f, one {F}-frame window, {LONG_WIDE_STEPS} DDIM "
              f"steps, CFG 3.5 {mode}: {seconds:.3f} s; denoise steps "
              f"{[round(x, 3) for x in sec['denoise_steps']]} s, decode {sec['decode']:.3f} s; "
              f"peak {peak:.2f} GiB; video min {float(v.min()):.4f} max {float(v.max()):.4f}")
        print(f"[long_wide]   launches {launches}; {by_d}; plain attention on CUDA tensors "
              f"{plain} (kernel fallbacks must be 0) {'ok' if run_ok else 'FAIL'}")
    del pipe, system, out
    gc.collect()
    torch.cuda.empty_cache()

    for run, config, size in (("long_wide_train", long_wide_config(), LONG_WIDE_TRAIN_SIZE),
                              ("long_frames_train", long_frames_config(),
                               LONG_FRAMES_TRAIN_SIZE),
                              ("long_frames_past_train",
                               long_frames_config(LONG_FRAMES_PAST_SIZE[0]),
                               LONG_FRAMES_PAST_SIZE)):
        F, H, W = size
        setup = _stage2_step_setup(torch, np, dev, config, size)
        seconds, launches, by_d, plain, peak, loss, norm, finite = _timed_stage2_step(
            torch, np, *setup)
        step_ok = (finite and all(by_d[f"temporal {k}_launches_by_f"].get(F, 0) > 0
                                  for k in ("forward", "backward"))
                   and plain["kernel fallbacks"] == 0 and plain["long sequences"] == 0)
        if run == "long_wide_train":
            step_ok = (step_ok and launches["flash_bwd_xwide"] > 0
                       and launches["temporal_bwd_frames"] > 0 and launches["flash_fwd_mid"] > 0
                       and launches["flash_bwd_mid"] > 0 and launches["flash_bwd_d512"] == 0
                       and launches["temporal_bwd_long"] == 0
                       and not by_d["flash forward_pad_launches_by_d"]
                       and not by_d["flash backward_pad_launches_by_d"]
                       and all(by_d["flash backward_launches_by_d"].get(d, 0) > 0
                               for d in (320, 640)))
            what = "one spatial head"
        else:
            past = F > ta.FRAMES_KERNEL_FRAMES  # the long kernel's, else the frames kernel's
            step_ok = (step_ok and (launches["temporal_bwd_long"] > 0) == past
                       and (launches["temporal_bwd_frames"] > 0) != past
                       and set(by_d["temporal backward_launches_by_f"]) == {F})
            what = f"{F}-frame tables"
        ok = ok and step_ok
        runs[run] = launches
        print(f"[long_wide] stage-2 step, {what}, {H}x{W}x{F}f bs 1 (step 0, uncond: the "
              f"CFG-dropout bias), grad checkpointing: {seconds:.3f} s (with the kernels' first "
              f"launches at these shapes), peak {peak:.2f} GiB, loss {loss:.5f}, grad norm "
              f"{norm:.4f}, finite {finite}")
        print(f"[long_wide]   launches {launches}; {by_d}; plain attention on CUDA tensors "
              f"{plain} (kernel fallbacks must be 0) {'ok' if step_ok else 'FAIL'}")
        del setup
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[long_wide] {card}")
    return ok, runs


def long_wide_steps(tree, path="long_wide"):
    """The long_wide path end to end with the port of the checkout at
    ``tree``: pose2vid at 768x512x48f, 3 DDIM steps in each CFG mode, and 3
    uncond stage-2 steps at 896x512x48f (the first of each cold), then one
    more under torch.profiler; prints one JSON line: the steps' seconds,
    the peaks and the stage-2 step's device ms by kernel. With ``path``
    "heads64" the same of the heads64 path (``heads64_config()``, pose2vid
    at 768x512x24f, the stage-2 step at 896x512x24f). Returns 0."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from humanvid_tpu_torch.train import TrainConfig, train_step

    dev = torch.device("cuda")
    rec = {"tree": tree, "path": path}
    if path == "heads64":
        config, size, train_size = heads64_config(), MAIN_SIZE, TRAIN_SIZE
    else:
        config, size, train_size = long_wide_config(), LONG_WIDE_SIZE, LONG_WIDE_TRAIN_SIZE
    system, pipe, inputs = _pipeline(torch, np, dev, config, size)
    for mode in ("sequential", "batched"):
        torch.cuda.reset_peak_memory_stats()
        out = pipe(**inputs, num_inference_steps=3, guidance_scale=3.5,
                   context_frames=size[0], cfg_mode=mode, decode_chunk=8,
                   generator=torch.Generator(device=dev).manual_seed(0))
        rec[f"{mode}_steps"] = [round(x, 4) for x in out.seconds["denoise_steps"]]
        rec[f"{mode}_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    del pipe, system, out
    gc.collect()
    torch.cuda.empty_cache()
    setup = _stage2_step_setup(torch, np, dev, config, train_size)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(*setup[:3], TrainConfig(), setup[3], draws=setup[4])
        torch.cuda.synchronize()
        steps.append(round(time.perf_counter() - t0, 4))
    rec["stage2_steps"] = steps
    rec["stage2_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_step(*setup[:3], TrainConfig(), setup[3], draws=setup[4])
        torch.cuda.synchronize()
    by_kernel = {e.key[:90]: round(e.self_device_time_total / 1e3, 3)
                 for e in prof.key_averages() if e.self_device_time_total > 0}
    rec["stage2_device_ms"] = round(sum(by_kernel.values()), 1)
    rec["stage2_device_ms_by_kernel"] = dict(
        sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20])
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec), flush=True)
    return 0


def group_norm_cases():
    """Kernel C at the paths' shapes: (name, (N, C, H, W), eps). 32 groups.
    Besides the headline shapes, one shape of every plan of the size rule
    that the decode, the UNet at 768x512 (pose2vid) and at 896x512 (the
    training steps) reach (a CPU test holds the list to the rule)."""
    return [
        ("decode 768x512", (8, 128, 768, 512), 1e-6),
        ("decode 384x256", (8, 256, 384, 256), 1e-6),
        ("decode 192x128", (8, 512, 192, 128), 1e-6),
        ("decode 96x64", (8, 512, 96, 64), 1e-6),
        ("UNet level 0 768x512", (24, 320, 96, 64), 1e-5),
        ("UNet level 0 concat 960", (24, 960, 96, 64), 1e-5),
        ("UNet level 1 768x512", (24, 640, 48, 32), 1e-5),
        ("UNet level 1 concat 1920", (24, 1920, 48, 32), 1e-5),
        ("UNet level 2 768x512", (24, 1280, 24, 16), 1e-5),
        ("UNet level 2 concat 1920", (24, 1920, 24, 16), 1e-5),
        ("UNet level 3 concat", (24, 2560, 12, 8), 1e-5),
        ("stage-2 level 0 896x512", (24, 320, 112, 64), 1e-5),
        ("stage-2 level 0 concat 960", (24, 960, 112, 64), 1e-5),
        ("stage-2 level 1", (24, 640, 56, 32), 1e-5),
        ("stage-2 level 1 concat 1920", (24, 1920, 56, 32), 1e-5),
        ("stage-2 level 2", (24, 1280, 28, 16), 1e-5),
        ("stage-2 level 2 concat 1920", (24, 1920, 28, 16), 1e-5),
        ("stage-2 level 3 concat", (24, 2560, 14, 8), 1e-5),
        ("cli decode 896x512", (8, 128, 896, 512), 1e-6),
        ("cli level 0 batched CFG 896x512", (48, 320, 112, 64), 1e-5),
        ("ragged rows 37x29", (3, 320, 37, 29), 1e-6),
    ]


GN_ONE_PASS_HEADLINE = "UNet level 0 768x512 channels_last act=silu"


def phase_group_norm(torch, results, dev, cases):
    """Kernel C against its plain version for act None and SiLU, in both
    layouts it takes, with the path the size rule takes (the one-pass
    cluster kernel's plan, or the two-pass kernels), the bits of a repeat
    launch, its device time (torch.profiler) and the event time through the
    wrapper, the plain version's time, the library's (``F.group_norm`` +
    ``F.silu``, which the port does not call) and the byte bound (x read
    once, y written once)."""
    import torch.nn.functional as F

    from humanvid_tpu_torch.ops import group_norm as gn

    print(f"[kernel C] GroupNorm(+SiLU) vs plain (bf16; tol: rel L2 {GN_TOL[0]}, "
          f"max err {GN_TOL[1]} x rms(plain); a repeat launch the same bits)")
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, shape, eps in cases:
        c = shape[1]
        base = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        weight = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        for layout, fmt in (("channels_last", torch.channels_last),
                            ("contiguous", torch.contiguous_format)):
            x = base.contiguous(memory_format=fmt)
            plan = gn.cluster_plan(c, shape[2] * shape[3], 32) \
                if x.is_contiguous(memory_format=torch.channels_last) else None
            path = "two-pass" if plan is None else "one-pass " + str(list(plan))
            for act in ("silu", None):
                def kernel():
                    return gn.group_norm_act_cuda(x, weight, bias, 32, eps, act)

                def library():
                    y = F.group_norm(x, 32, weight, bias, eps)
                    return F.silu(y) if act else y

                y = kernel()
                again = kernel()
                ref = gn.group_norm_act_plain(x, weight, bias, 32, eps, act)
                torch.cuda.synchronize()
                err, rel, close = agreement(y, ref, GN_TOL)
                ratio = err / ref.float().pow(2).mean().sqrt().item()
                same = torch.equal(y, again)
                ok = close and same and y.is_contiguous(memory_format=fmt)
                del y, again, ref
                event_ms = time_ms(torch, kernel, 20)
                label = f"{name} {layout} act={act}"
                headline = _is_headline(results, "group_norm", label)
                ms, ms_from = _device_ms(torch, kernel, "gn_", event_ms, headline)
                ok = ok and ms > 0 and (ms_from == "profiler" or not headline)
                plain_ms = time_ms(torch, lambda: gn.group_norm_act_plain(
                    x, weight, bias, 32, eps, act), 3)
                lib = library_ms(torch, library, 20)
                b_ms, b_by = bound(x.numel() * (5.0 + 4.0 * (act == "silu")),
                                   2.0 * 2 * x.numel() + 2 * 2 * 2 * c, H100_FP32_FLOPS)
                print(f"  {label}: {tuple(shape)} {path} max_abs_err={err:.3e} "
                      f"max_err/rms={ratio:.3e} rel_l2={rel:.3e} same_bits={same} "
                      f"device_ms={ms:.4f} ({ms_from}) event_ms={event_ms:.4f} "
                      f"plain_ms={plain_ms:.3f} "
                      f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
                results.append(dict(kernel="group_norm", shape=label, path=path, max_abs_err=err,
                                    rel_l2=rel, same_bits=same, ms=ms, event_ms=event_ms,
                                    device_ms=ms, device_ms_from=ms_from, plain_ms=plain_ms,
                                    library_ms=lib,
                                    bound_ms=b_ms, bound_by=b_by, ok=ok))
        del base, x
        torch.cuda.empty_cache()


def phase_group_norm_grad(torch, dev):
    """The autograd Function's dx, dgamma and dbeta on the card (kernel C
    forward, F.group_norm recompute in the backward, bf16) against plain
    autograd through the plain version on fp32 copies, at the stage-2
    level-0 shape."""
    from humanvid_tpu_torch.ops import group_norm as gn

    shape, eps = (24, 320, 112, 64), 1e-5
    gen = torch.Generator(device=dev).manual_seed(5)
    x, g = ((torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for _ in range(2))
    weight = (1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(shape[1], generator=gen, device=dev)).to(torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, weight, bias)]
    grads = torch.autograd.grad(gn.group_norm_act(*leaves, 32, eps, "silu"), leaves, g)
    plain = [t.detach().float().requires_grad_() for t in leaves]
    refs = torch.autograd.grad(gn.group_norm_act_plain(*plain, 32, eps, "silu"), plain,
                               g.float())
    torch.cuda.synchronize()
    errs = [agreement(a, r, GN_GRAD_TOL) for a, r in zip(grads, refs)]
    ok = all(e[2] for e in errs) and all(a.dtype == t.dtype for a, t in zip(grads, leaves))
    ratios = "/".join(f"{e[0] / r.float().pow(2).mean().sqrt().item():.3e}"
                      for e, r in zip(errs, refs))
    print(f"[kernel C grad] Function vs plain autograd at {shape} (tol: rel L2 "
          f"{GN_GRAD_TOL[0]}, max err {GN_GRAD_TOL[1]} x rms): rel_l2 dx/dgamma/dbeta="
          f"{errs[0][1]:.3e}/{errs[1][1]:.3e}/{errs[2][1]:.3e} max_err/rms={ratios} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_probes(torch, results, dev):
    """Kernels 8-10 against their plain versions at the microbench probes'
    shapes, with ms, plain ms, library ms (one PyTorch call: the cuBLAS
    batched product, SDPA, ``torch.add``) and the bound. Kernel 9's ms is
    CUDA events over back-to-back calls, as everywhere here; kernels 8 and
    10 record ``ms`` as the device time (torch.profiler), with the events'
    time through the wrapper beside it as ``event_ms``, since their device
    times come near a Python call's."""
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.tools import probe_kernels as pk

    print(f"[probes] kernels 8-10 vs plain (bf16; kernel 8 tol: rel L2 {DMAJOR_TOL[0]}, max err "
          f"{DMAJOR_TOL[1]} x rms(plain); kernel 9: kernel A's; kernel 10: exact)")
    gen = torch.Generator(device=dev).manual_seed(20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # kernel 8: every arm at G = 64, 1024 x 2048, d = 40, and the d = 128 control
    G, lq, lk = 64, 1024, 2048
    for tag, arm, d in (("qk_d_on_lanes", "qk_d_on_lanes", 40),
                        ("qk_d_on_sublanes", "qk_d_on_sublanes", 40),
                        ("pv_d_on_lanes", "pv_d_on_lanes", 40),
                        ("pv_dmajor_out", "pv_dmajor_out", 40),
                        ("qk_d128_lanes", "qk_d_on_lanes", 128)):
        shapes = {"qk_d_on_lanes": ((lq, d), (lk, d)), "qk_d_on_sublanes": ((d, lq), (d, lk)),
                  "pv_d_on_lanes": ((lq, lk), (lk, d)),
                  "pv_dmajor_out": ((d, lk), (lq, lk))}[arm]
        a, b = (randn(G, *sh) for sh in shapes)
        out = pk.dmajor_cuda(arm, a, b)
        ref = pk.dmajor_plain(arm, a, b)
        torch.cuda.synchronize()
        err, rel, ok = agreement(out, ref, DMAJOR_TOL)
        if arm == "pv_d_on_lanes":
            ok = ok and bool((out[:, :, d:] == 0).all())
        ms = time_ms(torch, lambda: pk.dmajor_cuda(arm, a, b), 50)
        # device time alone (the wrapper's host time is near the kernel's)
        dev_ms = _profile_split(torch, lambda: pk.dmajor_cuda(arm, a, b),
                                ("probe_dmajor",))["probe_dmajor"]
        extra = {}
        if arm.startswith("qk"):
            # the products of the unstored columns are computed: half the
            # keys take about half the device time
            half = b[:, :lk // 2].contiguous() if arm == "qk_d_on_lanes" else \
                b[:, :, :lk // 2].contiguous()
            extra["device_ms_half_lk"] = _profile_split(
                torch, lambda: pk.dmajor_cuda(arm, a, half), ("probe_dmajor",))["probe_dmajor"]
            ok = ok and 0 < extra["device_ms_half_lk"] < 0.8 * dev_ms
        plain_ms = time_ms(torch, lambda: pk.dmajor_plain(arm, a, b), 3)
        # cuBLAS's batched product of the same operands (the whole product:
        # the probe computes it all and stores a slice)
        lib_fn = {"qk_d_on_lanes": lambda: torch.bmm(a, b.transpose(1, 2)),
                  "qk_d_on_sublanes": lambda: torch.bmm(a.transpose(1, 2), b),
                  "pv_d_on_lanes": lambda: torch.bmm(a, b),
                  "pv_dmajor_out": lambda: torch.bmm(a, b.transpose(1, 2))}[arm]
        lib = library_ms(torch, lib_fn, 20)
        b_ms, b_by = bound(2.0 * G * lq * lk * d, 2.0 * (a.numel() + b.numel() + out.numel()))
        print(f"  dmajor {tag}: G={G} lq={lq} lk={lk} d={d} max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} event_ms={ms:.4f} device_ms={dev_ms:.4f} "
              f"{'' if not extra else 'device_ms_half_lk=%.4f ' % extra['device_ms_half_lk']}"
              f"plain_ms={plain_ms:.3f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) "
              f"TFLOP/s={2.0 * G * lq * lk * d / dev_ms / 1e9:.1f} {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="probe_dmajor", shape=f"{tag} G={G} {lq}x{lk} d={d}",
                            max_abs_err=err, rel_l2=rel, ms=dev_ms, event_ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                            bound_ms=b_ms, bound_by=b_by,
                            tflops=2.0 * G * lq * lk * d / dev_ms / 1e9, ok=ok, **extra))
        del a, b, out, ref
        torch.cuda.empty_cache()
    by_tag = {r["shape"].split()[0]: r["device_ms"] for r in results
              if r["kernel"] == "probe_dmajor"}
    print(f"  dmajor orientation: qk_d_on_sublanes / qk_d_on_lanes device time = "
          f"{by_tag['qk_d_on_sublanes'] / by_tag['qk_d_on_lanes']:.3f}, pv_dmajor_out / "
          f"pv_d_on_lanes = {by_tag['pv_dmajor_out'] / by_tag['pv_d_on_lanes']:.3f}")

    # kernel 9: UNet level 0 with the reference KV (beside kernel A and the
    # kernel's un-transposed variant, O = P V, built from the same source by
    # flash_variants), and the JAX probe's numerics shape with every 7th key
    # hidden
    import ctypes

    from humanvid_tpu_torch.ops import cuda_build
    from humanvid_tpu_torch.tools import flash_variants as fv

    untransposed = fv._build({"pv_untransposed": fv.variant_source(
        "pv_untransposed", fv.PVT_VARIANTS, "probe_pvt.cu")}, "probe_pvt_variant")
    untransposed = untransposed["pv_untransposed"].hv_probe_pvt
    untransposed.restype = ctypes.c_int
    untransposed.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    heads, d = 8, 40
    for name, B, lq, lk, with_bias in (("level0 cond 24x(6144x12288)", 24, 6144, 12288, False),
                                       ("every 7th key hidden 2x(1024x2048)", 2, 1024, 2048,
                                        True)):
        c = heads * d
        q, k, v = randn(B, lq, c), randn(B, lk, c), randn(B, lk, c)
        bias = None
        if with_bias:
            bias = torch.where(torch.arange(lk, device=dev) % 7 == 0, -1e9, 0.0)
            bias = bias.expand(B, lk).contiguous()
        out, lse = pk.pvt_cuda(q, k, v, heads, bias)
        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = pk.pvt_plain(q[:, rows], k, v, heads, bias)
        torch.cuda.synchronize()
        err, rel, close = agreement(out[:, rows], ref, FLASH_TOL)
        lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
        ok = close and lse_err <= 1e-3
        ms = time_ms(torch, lambda: pk.pvt_cuda(q, k, v, heads, bias), 5)
        ms_a = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, heads, bias), 5)
        qs, out_u, lse_u = pk._prescale(q, heads), torch.empty_like(q), torch.empty_like(lse)

        def call_untransposed():
            cuda_build.check(untransposed(
                qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out_u.data_ptr(), lse_u.data_ptr(),
                B, lq, lk, heads, d, cuda_build.stream_handle(dev)), "pv_untransposed launch")

        call_untransposed()
        torch.cuda.synchronize()
        _, _, close_u = agreement(out_u[:, rows], ref, FLASH_TOL)
        ok = ok and close_u and (lse_u[:, :, rows] - ref_lse).abs().max().item() <= 1e-3
        ms_u = time_ms(torch, call_untransposed, 5)
        del qs, out_u, lse_u
        chunk = max(1, (2 << 30) // (B * heads * lk * 4))

        def plain_full():
            for i in range(0, lq, chunk):
                pk.pvt_plain(q[:, i:i + chunk], k, v, heads, bias)

        plain_ms = time_ms(torch, plain_full, 1)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        lib = library_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 5)
        unmasked = B * lk if bias is None else int((bias == 0).sum().item())
        flops = 4.0 * heads * lq * unmasked * d
        b_ms, b_by = bound(flops, 2 * (q.numel() + 2 * k.numel() + out.numel())
                           + 4 * lse.numel() + (0 if bias is None else 4 * bias.numel()))
        print(f"  pvt {name}: B={B} Lq={lq} Lk={lk} heads={heads} d={d} max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} lse_err={lse_err:.3e} ms={ms:.3f} kernel_A_ms={ms_a:.3f} "
              f"untransposed_ms={ms_u:.3f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib} bound_ms={b_ms:.3f} ({b_by}) "
              f"TFLOP/s={flops / ms / 1e9:.1f} {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="probe_pvt", shape=name, max_abs_err=err, rel_l2=rel, ms=ms,
                            kernel_a_ms=ms_a, untransposed_ms=ms_u, plain_ms=plain_ms,
                            library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by, ok=ok))
        del q, k, v, out, lse, ref
        torch.cuda.empty_cache()

    # kernel 10: the streaming map at the decode's and the UNet's shapes
    for name, shape in (("vae_hi (8,768,512,128)", (8, 768, 512, 128)),
                        ("vae_mid (8,384,256,256)", (8, 384, 256, 256)),
                        ("unet_l0 (24,96,64,320)", (24, 96, 64, 320))):
        x = (torch.randn(shape, generator=gen, device=dev) * 4).to(torch.bfloat16)
        y = pk.hbm_map_cuda(x)
        ref = pk.hbm_map_plain(x)
        out = torch.empty_like(x)
        torch.cuda.synchronize()
        ok = torch.equal(y, ref) and torch.equal(y, torch.add(x, 0.5))
        err = (y.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: pk.hbm_map_cuda(x), 20)
        headline = _is_headline(results, "probe_hbm", name)
        dev_ms, ms_from = _device_ms(torch, lambda: pk.hbm_map_cuda(x), "probe_hbm", ms, headline)
        ok = ok and dev_ms > 0 and (ms_from == "profiler" or not headline)
        plain_ms = time_ms(torch, lambda: pk.hbm_map_plain(x), 5)
        lib = library_ms(torch, lambda: torch.add(x, 0.5, out=out), 20)
        copy_ms = time_ms(torch, lambda: out.copy_(x), 20)
        nbytes = 2.0 * 2 * x.numel()
        b_ms, b_by = bound(2.0 * x.numel(), nbytes)
        print(f"  hbm {name}: exact={ok} event_ms={ms:.4f} device_ms={dev_ms:.4f} ({ms_from}) "
              f"({nbytes / dev_ms / 1e6:.1f} GB/s) "
              f"plain_ms={plain_ms:.3f} library_ms={lib:.4f} ({nbytes / lib / 1e6:.1f} GB/s) "
              f"copy_ms={copy_ms:.4f} ({nbytes / copy_ms / 1e6:.1f} GB/s) bound_ms={b_ms:.4f} "
              f"({b_by}) {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="probe_hbm", shape=name, max_abs_err=err, rel_l2=0.0,
                            ms=dev_ms, event_ms=ms, device_ms=dev_ms, device_ms_from=ms_from,
                            plain_ms=plain_ms, library_ms=lib, copy_ms=copy_ms,
                            gbs=nbytes / dev_ms / 1e6,
                            bound_ms=b_ms, bound_by=b_by, ok=ok))
        del x, y, ref, out
        torch.cuda.empty_cache()


MICROBENCH_PROBES = ("flash", "temporal", "dmajor", "conv", "gn", "vaeattn", "flash_bwd",
                     "hbm", "gnstats", "pvt")  # all but unet and vae


def phase_microbench(torch):
    """The port's microbench entry point with every probe but ``unet`` and
    ``vae``, which the main phase already times. Returns (ok, launches, the
    phase's name with what failed in it)."""
    from humanvid_tpu_torch.tools import microbench

    print(f"[microbench] humanvid_tpu_torch.tools.microbench {' '.join(MICROBENCH_PROBES)}")
    _reset_launches()
    t0 = time.perf_counter()
    failed = microbench.run(MICROBENCH_PROBES)
    torch.cuda.synchronize()
    launches = _launch_counts()
    need = ("probe_dmajor", "probe_pvt", "probe_hbm", "flash_bwd_d512", "flash_fwd",
            "flash_fwd_d512", "temporal_fwd", "flash_bwd", "group_norm")
    unlaunched = [k for k in need if launches[k] == 0]
    ok = not failed and not unlaunched
    print(f"[microbench] {time.perf_counter() - t0:.1f} s; failed probes {failed}; launches "
          f"{launches} {'ok' if ok else 'FAIL'}")
    # what failed goes into the phase's name, which the last line of standard
    # error repeats
    name = "microbench" + (f" (failed probes {failed}, not launched {unlaunched})"
                           if not ok else "")
    return ok, launches, name


def _inputs(np, F, H, W, clip_size, seed):
    from humanvid_tpu_torch.data.camera import (
        get_relative_pose, intrinsics_vector, ray_condition, static_camera)

    rng = np.random.default_rng(seed)
    cams = static_camera((W, H), F)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    return dict(ref_image=rng.random((H, W, 3), dtype=np.float32),
                pose_video=rng.random((F, H, W, 3), dtype=np.float32),
                plucker=plucker,
                clip_image=rng.random((clip_size, clip_size, 3), dtype=np.float32))


def phase_tiny_reference(torch, np, dev):
    """The tiny config on the card (bf16, kernels) against the CPU (fp32,
    plain versions), with the same weights and initial latents. At 256x256
    the UNet's level 0 and the VAE's mid block have 1024 tokens, so kernel A
    runs as well as kernel B. A random-weight net in bf16 drifts from fp32
    by itself (changing only where attention rounds its probabilities moves
    the video by ~0.1), so the card must come within twice the distance
    (plus 1e-2) that the CPU's own bf16 run, plain versions only, lands from
    fp32. The tiny pose2img (one frame, batched CFG) is held the same way,
    and so is one more pose2vid with the sampler options: latent
    interpolation at rate 2 (slerp), the "leading" spacing, and a schedule
    made with ``set_alpha_to_one=False`` set as the pipeline's."""
    import dataclasses

    from humanvid_tpu_torch.diffusion.schedule import make_noise_schedule
    from humanvid_tpu_torch.pipelines import (
        CamAnimate, Pose2ImagePipeline, Pose2VideoPipeline, tiny_config)

    F, H, W = 4, 256, 256
    cfg = tiny_config()
    opt_cfg = dataclasses.replace(cfg, timestep_spacing="leading")
    sched = make_noise_schedule(
        num_train_timesteps=cfg.num_train_timesteps, beta_start=cfg.beta_start,
        beta_end=cfg.beta_end, beta_schedule=cfg.beta_schedule,
        rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        prediction_type=cfg.prediction_type, set_alpha_to_one=False)
    cpu = CamAnimate(cfg, device="cpu").init_random(3)
    inputs = _inputs(np, F, H, W, cfg.clip.image_size, 4)
    rng = np.random.default_rng(5)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    init_img = rng.normal(size=(1, H // 8, W // 8, 4)).astype(np.float32)
    runs, images, options = {}, {}, {}
    for key, device in (("cpu_fp32", "cpu"), ("cpu_bf16", "cpu"), ("card_bf16", dev)):
        dtype = torch.float32 if key == "cpu_fp32" else torch.bfloat16
        system, opt_system = (CamAnimate(c, device=device, dtype=dtype) for c in (cfg, opt_cfg))
        for name, module in system.components().items():
            module.load_state_dict(getattr(cpu, name).state_dict(), strict=True)
            getattr(opt_system, name).load_state_dict(module.state_dict(), strict=True)
        runs[key] = Pose2VideoPipeline(system)(
            **inputs, num_inference_steps=2, guidance_scale=3.5, cfg_mode="sequential",
            init_latents=init)
        images[key] = Pose2ImagePipeline(system)(
            inputs["ref_image"], inputs["pose_video"][0], inputs["plucker"][0],
            inputs["clip_image"], num_inference_steps=2, guidance_scale=3.5,
            init_latents=init_img)
        pipe = Pose2VideoPipeline(opt_system)
        pipe.sched = sched
        options[key] = pipe(**inputs, num_inference_steps=2, guidance_scale=3.5,
                            cfg_mode="sequential", init_latents=init, interpolation_rate=2,
                            interpolation_mode="slerp")
    ok = options["card_bf16"].videos.shape == (1, 2 * F - 1, H, W, 3)
    for label, outs, field in (("pose2vid", runs, "videos"), ("pose2img", images, "images"),
                               ("pose2vid interpolated x2 slerp, leading, final alpha "
                                "alphas_cumprod[0]", options, "videos")):
        ref = outs["cpu_fp32"]

        def errs(key):
            return (float(np.abs(getattr(outs[key], field) - getattr(ref, field)).max()),
                    float(np.abs(outs[key].latents - ref.latents).max()))

        (v16, l16), (vc, lc) = errs("cpu_bf16"), errs("card_bf16")
        good = (bool(np.isfinite(getattr(outs["card_bf16"], field)).all())
                and vc <= 2 * v16 + 1e-2 and lc <= 2 * l16 + 1e-2)
        ok = ok and good
        frames = "" if label == "pose2img" else f"x{getattr(ref, field).shape[1]}f"
        print(f"[tiny reference] {label} {H}x{W}{frames}, max_abs_err vs CPU fp32: card bf16 "
              f"{field} {vc:.3e} latents {lc:.3e}; CPU bf16 {field} {v16:.3e} latents "
              f"{l16:.3e} {'ok' if good else 'FAIL'}")
    return ok


def _unzero_(torch, system, seed):
    """Seeded non-zero values for the layers the reference initializes to
    zero (the motion modules' proj_out, the pose guider's conv_out, the
    camera encoder's zero convs): at zero, the gradient reaching every
    frame-axis attention would be exactly zero and a broken backward
    kernel would pass."""
    zero_init = {"pose_guider": "conv_out.weight", "camera_encoder": "zero_conv_layers.",
                 "denoising_unet": ".temporal_transformer.proj_out.weight"}
    gen = torch.Generator(device=system.device).manual_seed(seed)
    with torch.no_grad():
        for component, key in zero_init.items():
            for name, p in getattr(system, component).named_parameters():
                if key in name:
                    p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                            * p[0].numel() ** -0.5)


def _train_batch(np, b, F, H, W, clip_size, seed):
    """A seeded synthetic stage-2 batch of the real layout (channel-last)."""
    rng = np.random.default_rng(seed)
    plucker = _inputs(np, F, H, W, clip_size, seed)["plucker"]
    f32 = np.float32
    return {"tgt": rng.uniform(-1, 1, (b, F, H, W, 3)).astype(f32),
            "ref": rng.uniform(-1, 1, (b, H, W, 3)).astype(f32),
            "clip": rng.normal(size=(b, clip_size, clip_size, 3)).astype(f32),
            "pose": rng.random((b, F, H, W, 3), dtype=f32),
            "plucker": np.broadcast_to(plucker, (b,) + plucker.shape).copy()}


# the kernels of the model paths: inference runs the forward ones
MODEL_FWD_KERNELS = ("flash_fwd", "flash_fwd_d512", "temporal_fwd", "group_norm")
MODEL_KERNELS = MODEL_FWD_KERNELS + ("flash_bwd", "temporal_bwd")


def _launch_counts():
    """Launches of every kernel since the last reset: the six of the model
    paths, the wide-head backward, the five of the last shapes (kernel A
    past 512 columns; kernel B past 32 frames: the long forward, the
    backward's frames kernel up to 128 frames and its long kernel past
    that), kernel A's mid forward and backward (128 < d < 512), its forward
    and backward at the head's own width (d = 64 and 80 < d <= 128; also
    counted in kernel A's d <= 128 counts) and the three probe kernels."""
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta
    from humanvid_tpu_torch.tools import probe_kernels as pk

    return {"flash_fwd": fa.launches["d<=128"], "flash_fwd_d512": fa.launches["d>128"],
            "temporal_fwd": ta.launches["temporal"],
            "flash_bwd": min(fa.launches["bwd_dkv"], fa.launches["bwd_dq"]),
            "temporal_bwd": ta.launches["temporal_bwd"],
            "group_norm": gn.launches["group_norm"],
            "flash_bwd_d512": min(fa.launches["bwd_dkv_d>128"], fa.launches["bwd_dq_d>128"]),
            "flash_fwd_xwide": fa.launches["d>512"],
            "flash_bwd_xwide": min(fa.launches["bwd_dkv_d>512"], fa.launches["bwd_dq_d>512"]),
            "temporal_fwd_long": ta.launches["temporal_long"],
            "temporal_bwd_frames": ta.launches["temporal_bwd_frames"],
            "temporal_bwd_long": ta.launches["temporal_bwd_long"],
            "flash_fwd_mid": fa.launches["128<d<512"],
            "flash_fwd_own": fa.launches["own"],
            "flash_bwd_own": min(fa.launches["bwd_dkv_own"], fa.launches["bwd_dq_own"]),
            "flash_bwd_mid": min(fa.launches["bwd_dkv_128<d<512"],
                                 fa.launches["bwd_dq_128<d<512"]),
            **pk.launches}


def _reset_launches():
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta

    from humanvid_tpu_torch.tools import probe_kernels as pk

    fa.reset_launches()
    gn.reset_launches()
    ta.reset_launches()
    pk.reset_launches()


def phase_tiny_train(torch, np, dev):
    """One stage-2 step of the tiny config (grad checkpointing on) on the
    card (bf16, kernels) and on the CPU (fp32, plain versions) from the same
    weights, batch and draws, for an uncond and a cond step. At 256x256x4f
    the UNet's level 0 has 1024 tokens, so kernel A and its backward run as
    well as kernel B's. The loss and the trainable gradients must come
    within twice the distance that the CPU's own bf16 run lands from fp32,
    plus 1e-2 (relative, over all trainable gradients at once)."""
    from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
    from humanvid_tpu_torch.train import (
        OptimizerConfig, TrainConfig, TrainState, loss_from_draws, sample_draws,
        stage2_trainable, stage_config)

    F, H, W = 4, 256, 256
    cfg = stage_config(2, tiny_config(), gradient_checkpointing=True)
    cpu = CamAnimate(cfg, device="cpu").init_random(6)
    _unzero_(torch, cpu, 7)
    batch = _train_batch(np, 1, F, H, W, cfg.clip.image_size, 8)
    gen = torch.Generator().manual_seed(9)
    draws = sample_draws(gen, 1, F, H, W, 1000, 0.0)
    draws = [draws._replace(uncond=True), draws]
    systems = {"cpu_fp32": cpu}
    for key, device in (("cpu_bf16", "cpu"), ("card_bf16", dev)):
        systems[key] = CamAnimate(cfg, device=device, dtype=torch.bfloat16)
        for name, module in systems[key].components().items():
            module.load_state_dict(getattr(cpu, name).state_dict(), strict=True)
    runs = {}
    for key, system in systems.items():
        if key == "card_bf16":
            _reset_launches()
        # warmup 1: step 0 has lr 0, so both steps see the same weights
        state = TrainState(system, stage2_trainable, OptimizerConfig(warmup_steps=1))
        sched = system.make_schedule(beta_schedule="scaled_linear")
        runs[key] = []
        for d in draws:
            loss, _ = loss_from_draws(system, sched, TrainConfig(), batch, d)
            loss.backward()
            grads = torch.cat([g.flatten().cpu() for g in state.grads()])
            state.apply_gradients()
            runs[key].append((loss.item(), grads))
        if key == "card_bf16":
            torch.cuda.synchronize()
            launches = _launch_counts()
    # the tiny VAE's single head is 16 wide: no d = 512 launch at this config
    ok = all(launches[k] > 0 for k in MODEL_KERNELS if k != "flash_fwd_d512")
    for i, label in enumerate(("uncond", "cond")):
        ref_loss, ref_g = runs["cpu_fp32"][i]

        def dist(key):
            loss, g = runs[key][i]
            return abs(loss - ref_loss) / abs(ref_loss), ((g - ref_g).norm() / ref_g.norm()).item()

        (l16, g16), (lc, gc) = dist("cpu_bf16"), dist("card_bf16")
        finite = bool(torch.isfinite(runs["card_bf16"][i][1]).all())
        step_ok = finite and lc <= 2 * l16 + 1e-2 and gc <= 2 * g16 + 1e-2
        ok = ok and step_ok
        print(f"[tiny train] {H}x{W}x{F}f stage 2 {label} step, relative error vs CPU fp32: "
              f"card bf16 loss {lc:.3e} grads {gc:.3e}; CPU bf16 loss {l16:.3e} grads "
              f"{g16:.3e} {'ok' if step_ok else 'FAIL'}")
    print(f"[tiny train] card launches {launches} {'ok' if ok else 'FAIL'}")
    return ok


def phase_train(torch, np, dev):
    """The training path: full-width stage 2 (CamAnimateConfig through
    stage_config(2): grad checkpointing, FF chunks of 1024), bf16 modules
    with fp32 masters of the motion modules and the camera encoder, AdamW
    at the recipe's settings (lr 1e-5, warmup 1, wd 1e-2, clip 1.0), a
    seeded synthetic batch of 896x512x24f, TRAIN_STEPS steps: step 0
    forced uncond (the reference-KV bias in both backward kernels), the rest
    cond. Returns (ok, launches, system, state, batch)."""
    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig
    from humanvid_tpu_torch.train import (
        OptimizerConfig, TrainConfig, TrainState, sample_draws, stage2_trainable,
        stage_config, train_step)

    F, H, W = TRAIN_SIZE
    t0 = time.perf_counter()
    system = CamAnimate(stage_config(2, CamAnimateConfig(), gradient_checkpointing=True),
                        device=dev, dtype=torch.bfloat16).init_random(0)
    _unzero_(torch, system, 1)
    state = TrainState(system, stage2_trainable, OptimizerConfig(warmup_steps=1))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    frozen = {f"{c}/{k}": p.detach().clone() for c, m in system.components().items()
              for k, p in m.named_parameters() if not p.requires_grad}
    n_train = sum(m.numel() for m in state.masters)
    print(f"[train] stage 2, full width: {n_train / 1e6:.1f} M trainable params in "
          f"{len(state.names)} leaves, {sum(p.numel() for p in frozen.values()) / 1e9:.3f} B "
          f"frozen; built in {time.perf_counter() - t0:.1f} s")
    batch = _train_batch(np, 1, F, H, W, system.config.clip.image_size, 10)
    gen = torch.Generator(device=dev).manual_seed(11)
    start = [m.clone() for m in state.masters]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    ok, seconds, after = True, [], []
    for i in range(TRAIN_STEPS):
        draws = sample_draws(gen, 1, F, H, W, sched.num_train_timesteps, 0.0)
        draws = draws._replace(uncond=i == 0)
        t0 = time.perf_counter()
        out = train_step(system, state, sched, TrainConfig(), batch, draws=draws)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        loss, norm = out["loss"].item(), out["grad_norm"].item()
        ok = ok and np.isfinite(loss) and np.isfinite(norm)
        if i < 2:
            after.append([m.clone() for m in state.masters])
        print(f"[train] step {i} ({'uncond' if draws.uncond else 'cond'}): "
              f"{seconds[-1]:.3f} s, loss {loss:.5f}, grad norm {norm:.4f}, t {draws.t.tolist()}")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step0_still = all(torch.equal(a, b) for a, b in zip(start, after[0]))
    moved = sum(not torch.equal(a, b) for a, b in zip(after[0], after[1]))
    finite = all(bool(torch.isfinite(m).all()) for m in state.masters)
    frozen_same = all(torch.equal(p, frozen[f"{c}/{k}"]) for c, m in system.components().items()
                      for k, p in m.named_parameters() if not p.requires_grad)
    ok = (ok and finite and step0_still and moved == len(state.names) and frozen_same
          and all(launches[k] > 0 for k in MODEL_KERNELS))
    del frozen
    print(f"[train] {H}x{W}x{F}f bs 1: s/step (steady, mean of steps 1..) "
          f"{sum(seconds[1:]) / max(1, len(seconds) - 1):.3f}; peak memory {peak:.2f} GiB")
    print(f"[train] launches over {TRAIN_STEPS} steps (with checkpointing each forward "
          f"kernel runs again in the backward's recompute; GroupNorm's backward recomputes "
          f"through F.group_norm) {launches}")
    print(f"[train] finite {finite}; step 0 (lr 0) left the masters unchanged "
          f"{step0_still}; step 1 moved {moved}/{len(state.names)} trainable leaves; frozen "
          f"leaves unchanged bit for bit {frozen_same} {'ok' if ok else 'FAIL'}")
    return ok, launches, system, state, batch


def phase_main(torch, np, dev):
    """Returns (ok, launches by kernel, the pipeline, its inputs)."""
    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig, Pose2VideoPipeline

    F, H, W = MAIN_SIZE
    steps = MAIN_STEPS
    t0 = time.perf_counter()
    system = CamAnimate(CamAnimateConfig(), device=dev, dtype=torch.bfloat16).init_random(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in system.components().values() for p in m.parameters())
    print(f"[main] full-width CamAnimate: {n_params / 1e9:.3f} B params, built and "
          f"initialized in {time.perf_counter() - t0:.1f} s")
    pipe = Pose2VideoPipeline(system)
    inputs = _inputs(np, F, H, W, system.config.clip.image_size, 0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = pipe(**inputs, num_inference_steps=steps, guidance_scale=3.5, context_frames=24,
               cfg_mode="sequential", decode_chunk=8,
               generator=torch.Generator(device=dev).manual_seed(0))
    launches = _launch_counts()
    v = out.videos
    s = out.seconds
    print(f"[main] {H}x{W}x{F}f, {steps} DDIM steps (the flagship runs 30), CFG 3.5 "
          f"sequential: prepare {s['prepare']:.3f} s, denoise steps "
          f"{[round(x, 3) for x in s['denoise_steps']]} s, decode {s['decode']:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[main] s/denoise step (steady, mean of steps 2..) "
          f"{sum(s['denoise_steps'][1:]) / max(1, len(s['denoise_steps']) - 1):.3f}; "
          f"s/decode {s['decode']:.3f}; launches {launches}")
    ok = (v.shape == (1, F, H, W, 3) and bool(np.isfinite(v).all())
          and float(v.min()) >= 0.0 and float(v.max()) <= 1.0
          and all(launches[k] > 0 for k in MODEL_FWD_KERNELS))
    print(f"[main] video shape {v.shape} min {float(v.min()):.4f} max {float(v.max()):.4f} "
          f"mean {float(v.mean()):.4f} {'ok' if ok else 'FAIL'}")
    return ok, launches, pipe, inputs


KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("kernel A (flash_fwd)", ("flash_fwd_kernel",)),
    ("kernel B (temporal_fwd)", ("temporal_fwd_kernel", "temporal_fwd_split_kernel")),
    ("kernel A bwd (flash_bwd)", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("kernel B bwd (temporal_bwd)", ("temporal_bwd_kernel", "temporal_bwd_split_kernel")),
    # ahead of the cuDNN group ("nhwc") and the norm group ("norm")
    ("kernel C (group_norm)", ("gn_cluster_", "gn_stats_", "gn_finalize", "gn_apply_")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "nchw",
                             "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")),
    ("normalization / reductions", ("norm", "reduce", "welford", "softmax")),
)


def _group_device_time(torch, prof):
    """Self device time (ms) of every CUDA kernel in a profile, by group."""
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "elementwise / copies / other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:90]))
    return groups, sorted(kernels, reverse=True)


def phase_profile(torch, dev, pipe, inputs):
    """torch.profiler over one denoise step (the two UNet passes of
    sequential CFG) and one 24-frame decode of the main path's model: device
    time by kernel group, the top kernels, and the device's idle share of
    the host-clock window. Returns the launch counts of one denoise step and
    one decode."""
    from humanvid_tpu_torch.models.clip_vision import clip_preprocess
    from humanvid_tpu_torch.pipelines.pose2vid import _nchw

    F, H, W = MAIN_SIZE
    system = pipe.system
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        ref_img = _nchw(inputs["ref_image"][None] * 2.0 - 1.0, dev, torch.bfloat16)
        clip_img = clip_preprocess(torch.as_tensor(inputs["clip_image"], device=dev)).to(
            torch.bfloat16)[None].permute(0, 3, 1, 2).contiguous()
        ctx, feats = pipe.encode_reference(ref_img, clip_img)
        x = torch.randn((F, 4, H // 8, W // 8), generator=gen, device=dev).to(torch.bfloat16)
        cond = torch.randn((F, 320, H // 8, W // 8), generator=gen,
                           device=dev).to(torch.bfloat16)
        t = torch.full((1,), 499.0, device=dev)

        def step():
            system.denoising_unet(x, t, torch.zeros_like(ctx), cond_fea=cond, frames=F)
            system.denoising_unet(x, t, ctx, cond_fea=cond, ref_features=feats, frames=F)

        def decode():
            pipe.decode(x, 8)

        counts = {}
        for label, fn in (("denoise step", step), ("decode", decode)):
            _reset_launches()
            fn()
            torch.cuda.synchronize()
            counts[label] = _launch_counts()
            print(f"[profile] launches per {label}: {counts[label]}")
            _profile_print(torch, label, fn)
    return counts


def _profile_print(torch, label, fn):
    """torch.profiler over one call of ``fn``: device time by kernel group,
    the top kernels and the device's idle share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):  # again if the session holds no device record
        if attempt:
            time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups, kernels = _group_device_time(torch, prof)
        busy = sum(groups.values())
        if busy > 0:
            break
        print(f"[profile] {label}: the profiler captured no device record: profiling again")
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {ms:.1f} ms ({ms / busy:.1%})")
    for ms, count, name in kernels[:8]:
        print(f"    {ms:8.1f} ms  x{count:<5d} {name}")


def phase_profile_train(torch, dev, system, state, batch):
    """torch.profiler over one more cond stage-2 step of the training path."""
    from humanvid_tpu_torch.train import TrainConfig, sample_draws, train_step

    F, H, W = TRAIN_SIZE
    sched = system.make_schedule(beta_schedule="scaled_linear")
    draws = sample_draws(torch.Generator(device=dev).manual_seed(12), 1, F, H, W,
                         sched.num_train_timesteps, 0.0)
    _profile_print(torch, "train step (stage 2, cond)",
                   lambda: train_step(system, state, sched, TrainConfig(), batch, draws=draws))


def _checksums(torch, tensors):
    """Per-tensor fp64 (sum, sum of |x|), as one (n, 2) CPU tensor: a leaf
    that changes changes its row, and no copy of the leaves is kept."""
    return torch.stack([torch.stack([t.sum(dtype=torch.float64),
                                     t.abs().sum(dtype=torch.float64)])
                        for t in tensors]).cpu()


def phase_stage1(torch, np, dev):
    """The stage-1 path on one full-width system (CamAnimateConfig through
    stage_config(1): the denoising UNet with the ReferenceNet's topology and
    no motion modules, camera position table 16, grad checkpointing), bf16
    modules with fp32 masters of the trained leaves. First pose2img at
    896x512 (MAIN_STEPS DDIM steps, batched CFG 3.5), then STAGE1_STEPS steps
    of the stage-1 recipe (AdamW lr 1e-5, warmup 1, wd 1e-2, clip 1.0, min-SNR
    5, noise offset 0.05, v-prediction on the zero-SNR schedule) on a seeded
    synthetic batch of 8 single frames: step 0 uncond (lr 0), the rest cond.
    Returns (ok, {"pose2img": launches, "stage1": launches of step 1})."""
    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig, Pose2ImagePipeline
    from humanvid_tpu_torch.train import (
        OptimizerConfig, TrainConfig, TrainState, sample_draws, stage1_trainable,
        stage_config, train_step)

    b, H, W = STAGE1_SIZE
    t0 = time.perf_counter()
    system = CamAnimate(stage_config(1, CamAnimateConfig(), gradient_checkpointing=True),
                        device=dev, dtype=torch.bfloat16).init_random(0)
    _unzero_(torch, system, 1)
    # The reference zero-initializes every bias, and some get no gradient at
    # all: the norm2 of each transformer block feeds only the queries of a
    # cross-attention over one CLIP token, whose softmax is 1 whatever the
    # query. Such a leaf could not move, so the zero leaves of the trained
    # components get small seeded values and AdamW's decay moves them too.
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for name in ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder"):
            for p in getattr(system, name).parameters():
                if not p.any():
                    p.normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    print(f"[stage 1] full-width stage-1 system built in {time.perf_counter() - t0:.1f} s")

    inputs = _inputs(np, 1, H, W, system.config.clip.image_size, 13)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = Pose2ImagePipeline(system)(
        inputs["ref_image"], inputs["pose_video"][0], inputs["plucker"][0],
        inputs["clip_image"], num_inference_steps=MAIN_STEPS, guidance_scale=3.5,
        generator=torch.Generator(device=dev).manual_seed(14))
    img_launches = _launch_counts()
    img, s = out.images, out.seconds
    img_ok = (img.shape == (1, H, W, 3) and bool(np.isfinite(img).all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
              and all(img_launches[k] > 0 for k in ("flash_fwd", "temporal_fwd", "group_norm")))
    print(f"[stage 1] pose2img {H}x{W}, {MAIN_STEPS} DDIM steps, batched CFG 3.5: prepare "
          f"{s['prepare']:.3f} s, denoise steps {[round(x, 4) for x in s['denoise_steps']]} s, "
          f"decode {s['decode']:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {img_launches}")
    print(f"[stage 1] image shape {img.shape} min {float(img.min()):.4f} max "
          f"{float(img.max()):.4f} mean {float(img.mean()):.4f} {'ok' if img_ok else 'FAIL'}")
    del out

    state = TrainState(system, stage1_trainable, OptimizerConfig(warmup_steps=1))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    frozen = [p for m in system.components().values() for p in m.parameters()
              if not p.requires_grad]
    frozen_before = _checksums(torch, frozen)
    print(f"[stage 1] {sum(m.numel() for m in state.masters) / 1e9:.3f} B trainable params in "
          f"{len(state.names)} leaves, {sum(p.numel() for p in frozen) / 1e9:.3f} B frozen")
    batch = _train_batch(np, b, 1, H, W, system.config.clip.image_size, 15)
    gen = torch.Generator(device=dev).manual_seed(16)
    sums = [_checksums(torch, state.masters)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ok, seconds, launches = img_ok, [], []
    for i in range(STAGE1_STEPS):
        draws = sample_draws(gen, b, 1, H, W, sched.num_train_timesteps, 0.0)
        draws = draws._replace(uncond=i == 0)
        _reset_launches()
        t0 = time.perf_counter()
        res = train_step(system, state, sched, TrainConfig(), batch, draws=draws)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(_launch_counts())
        loss, norm = res["loss"].item(), res["grad_norm"].item()
        ok = ok and np.isfinite(loss) and np.isfinite(norm)
        sums.append(_checksums(torch, state.masters))
        print(f"[stage 1] step {i} ({'uncond' if draws.uncond else 'cond'}): "
              f"{seconds[-1]:.3f} s, loss {loss:.5f}, grad norm {norm:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(sums[-1]).all())
    step0_still = torch.equal(sums[0], sums[1])
    moved = int((sums[1] != sums[2]).any(dim=1).sum())
    frozen_same = torch.equal(frozen_before, _checksums(torch, frozen))
    launched = all(c["flash_bwd"] > 0 and c["group_norm"] > 0 for c in launches)
    ok = ok and finite and step0_still and moved == len(state.names) and frozen_same and launched
    print(f"[stage 1] {H}x{W} bs {b}: s/step (steady, mean of steps 1..) "
          f"{sum(seconds[1:]) / max(1, len(seconds) - 1):.3f}; peak memory {peak:.2f} GiB")
    print(f"[stage 1] launches per step {launches}")
    print(f"[stage 1] finite {finite}; step 0 (lr 0) left the masters unchanged {step0_still}; "
          f"step 1 moved {moved}/{len(state.names)} trainable leaves; frozen leaves unchanged "
          f"{frozen_same} {'ok' if ok else 'FAIL'}")
    draws = sample_draws(gen, b, 1, H, W, sched.num_train_timesteps, 0.0)
    _profile_print(torch, "train step (stage 1, cond)",
                   lambda: train_step(system, state, sched, TrainConfig(), batch, draws=draws))
    return ok, {"pose2img": img_launches, "stage1": launches[min(1, len(launches) - 1)]}


MOTION_KEY = ".motion_modules."  # in the keys of the motion modules' tensors


def _write_release(torch, system, root):
    """Every component of ``system`` in the released layouts under ``root``,
    in fp16, and a ``.py`` prompt config naming them with one test case
    (``ref_images/ref.png`` against ``pose_videos/pexels_pan.mp4``, which
    are not written) and a TUM camera file for that pose path: a pan and a
    dolly over 48 lines with the scale column. Returns (the config's path,
    the pose path, bytes written)."""
    import math
    import os

    def half(name, keep=lambda key: True):
        return {k: v.to(torch.float16).cpu()
                for k, v in getattr(system, name).state_dict().items() if keep(k)}

    old_names = ((".to_q.", ".query."), (".to_k.", ".key."), (".to_v.", ".value."),
                 (".to_out.0.", ".proj_attn."))
    vae = {}
    for k, v in {**half("vae_encoder"), **half("vae_decoder")}.items():
        for new, old in old_names:
            k = k.replace(new, old)
        vae[k] = v
    files = {
        "stable-diffusion-v1-5/unet/diffusion_pytorch_model.bin": half("reference_unet"),
        "sd-vae-ft-mse/diffusion_pytorch_model.bin": vae,
        "image_encoder/pytorch_model.bin": half("clip"),
        "pose_guider.pth": half("pose_guider"),
        "camera_pose_encoder.pth": {"pose_encoder_state_dict": half("camera_encoder")},
        "denoising_unet.pth": half("denoising_unet", lambda k: MOTION_KEY not in k),
        "motion_module.pth": half("denoising_unet", lambda k: MOTION_KEY in k),
    }
    for rel, sd in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(sd, path)
    pose_path = os.path.join(root, "pose_videos", "pexels_pan.mp4")
    os.makedirs(os.path.join(root, "camera"))
    with open(os.path.join(root, "camera", "pexels_pan.txt"), "w") as f:
        for i in range(CLI_CLIP[0]):
            yaw = 0.02 * i  # pan
            f.write(f"{i / 24:.6f} 0.0 0.0 {-0.05 * i:.6f} 0.0 {math.sin(yaw / 2):.8f} 0.0 "
                    f"{math.cos(yaw / 2):.8f} 1.788079 1.0 1.5\n")
    cfg = {"base_model_path": os.path.join(root, "stable-diffusion-v1-5"),
           "vae_model_path": os.path.join(root, "sd-vae-ft-mse"),
           "image_encoder_path": os.path.join(root, "image_encoder"),
           "pose_guider_path": os.path.join(root, "pose_guider.pth"),
           "camera_pose_encoder_path": os.path.join(root, "camera_pose_encoder.pth"),
           "denoising_unet_path": os.path.join(root, "denoising_unet.pth"),
           "motion_module_path": os.path.join(root, "motion_module.pth"),
           "test_cases": {os.path.join(root, "ref_images", "ref.png"): [pose_path]}}
    cfg_path = os.path.join(root, "prompt.py")
    with open(cfg_path, "w") as f:
        f.write(f"cfg = {cfg!r}\n")
    nbytes = sum(os.path.getsize(os.path.join(root, rel)) for rel in files)
    return cfg_path, pose_path, nbytes


def phase_cli(torch, np, dev, card):
    """The pose2vid command line's path at its defaults on one full-width
    system: CamAnimateConfig() with seeded weights (fp32) written in the
    released layouts in fp16; the CLI's own ``build_system`` (a bf16 system,
    seeded, then ``load_pretrained`` from the ``.py`` prompt config), whose
    every tensor must equal the saved fp16 tensor cast to bf16; then
    ``cli.pose2vid.run_case`` at -W 512 -H 896 -L 24, batched CFG 3.5, bf16,
    CLI_STEPS DDIM steps, on a seeded portrait clip of CLI_CLIP (stride 2)
    and a reference image of the same orientation. The video must be (24,
    896, 512, 3), finite and in [0, 1], the camera input the trajectory's
    and not the static camera's, and kernels A (d = 40, 80 and 512), B and
    C must have launched. Returns (ok, launches)."""
    import tempfile

    from humanvid_tpu_torch.cli import pose2vid as cli
    from humanvid_tpu_torch.data.camera import (
        W2C_SOURCES, get_relative_pose, intrinsics_vector, ray_condition, static_camera)
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig, Pose2VideoPipeline
    from humanvid_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    src = CamAnimate(CamAnimateConfig(), device=dev).init_random(1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in src.components().values() for p in m.parameters())
    print(f"[cli] {card}: seeded fp32 CamAnimate, {n_params / 1e9:.3f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="hv_release_") as root:
        # the camera convention comes from words in the whole path: none of
        # the world-to-camera words may stand in it
        bad = [w for w in W2C_SOURCES if w in root.lower()]
        if bad:
            raise RuntimeError(f"the temporary path {root} holds {bad}")
        t0 = time.perf_counter()
        cfg_path, pose_path, nbytes = _write_release(torch, src, root)
        print(f"[cli] {card}: wrote the released layouts in fp16, {nbytes / 2**30:.3f} GiB, "
              f"in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        system = cli.build_system(load_config(cfg_path), torch.bfloat16, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        differ, compared = _differ_from_saved(torch, src, system)
        del src
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[cli] {card}: load (config, build, seeded init, load_pretrained) {load_s:.1f} s; "
              f"tensors equal to the saved fp16 cast to bf16: {compared - len(differ)}/"
              f"{compared} {'ok' if not differ else 'FAIL ' + str(differ[:5])}")
        args = cli.parse_args(["--config", cfg_path, "--steps", str(CLI_STEPS)])
        rng = np.random.default_rng(21)
        nf, ch, cw = CLI_CLIP
        frames = rng.integers(0, 256, (nf, ch, cw, 3), dtype=np.uint8)
        ref = rng.integers(0, 256, (ch, cw, 3), dtype=np.uint8)
        pipe = Pose2VideoPipeline(system)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        case = cli.run_case(pipe, ref, frames, pose_path, args,
                            torch.Generator(device=dev).manual_seed(args.seed))
        total_s = time.perf_counter() - t0
    launches = _launch_counts()
    by_d = dict(fa.forward_launches_by_d)
    peak = torch.cuda.max_memory_allocated() / 2**30
    v, s = case.video, case.seconds
    L, H, W = args.L, args.H, args.W
    steps = s["denoise_steps"]
    print(f"[cli] {card}: pose2vid -W {W} -H {H} -L {L}, {args.steps} DDIM steps (the CLI "
          f"runs 30), batched CFG {args.cfg}, {args.dtype}: prepare {s['prepare']:.3f} s, "
          f"denoise steps {[round(x, 3) for x in steps]} s (steady mean of steps 2.. "
          f"{sum(steps[1:]) / max(1, len(steps) - 1):.3f} s/step), decode {s['decode']:.3f} s, "
          f"run_case {total_s:.3f} s (with the host resizes and camera rays), peak memory "
          f"{peak:.2f} GiB")
    cams = static_camera((W, H), L)
    static = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    moved = float(np.abs(case.plucker - static).max())
    launched = (all(by_d.get(d, 0) > 0 for d in (40, 80, 512))
                and all(launches[k] > 0 for k in MODEL_FWD_KERNELS))
    ok = (not differ and v.shape == (L, H, W, 3) and bool(np.isfinite(v).all())
          and float(v.min()) >= 0.0 and float(v.max()) <= 1.0 and case.stride == 2
          and moved > 1e-3 and launched)
    print(f"[cli] frames {case.indices[:3]}..{case.indices[-1]} stride {case.stride}; camera "
          f"input's largest distance from the static camera's {moved:.4f}; kernel A launches "
          f"by head width {by_d}; launches {launches}")
    print(f"[cli] video shape {v.shape} min {float(v.min()):.4f} max {float(v.max()):.4f} "
          f"mean {float(v.mean()):.4f} {'ok' if ok else 'FAIL'}")
    return ok, launches


def _differ_from_saved(torch, src, system):
    """(names of the tensors of ``system`` that differ from ``src``'s cast to
    fp16, then bf16; the number compared)."""
    differ, compared = [], 0
    for name, module in src.components().items():
        loaded = getattr(system, name).state_dict()
        for key, value in module.state_dict().items():
            compared += 1
            if not torch.equal(loaded[key], value.to(torch.float16).to(torch.bfloat16)):
                differ.append(f"{name}.{key}")
    return differ, compared


TRAIN_CLI_CLIP = (96, 1024, 576)  # frames, height, width of the train_cli phase's clips
TRAIN_CLI_KERNELS = ("flash_fwd", "flash_fwd_d512", "flash_bwd", "temporal_fwd", "temporal_bwd",
                     "group_norm")


def _train_cli_data(np, root, write=True):
    """Two seeded portrait clips of TRAIN_CLI_CLIP and their pose clips, in
    memory, under the names ``root/pexels/{videos,dwpose}/clip{i}.mp4`` (not
    written), their moving TUM camera files under ``root/pexels/camera``
    (the dataset's substitution finds them), the stage-2 meta JSON of the
    two clips and a stage-1 one of sixteen segments of them (two batches of
    8 an epoch); with ``write`` False, the frames alone (the files exist).
    Returns (frames by path, stage-2 meta, stage-1 meta)."""
    import math
    import os

    nf, h, w = TRAIN_CLI_CLIP
    rng = np.random.default_rng(31)
    base = os.path.join(root, "pexels")
    for sub in ("videos", "dwpose", "camera"):
        os.makedirs(os.path.join(base, sub), exist_ok=not write)
    frames, clips, segments = {}, [], []
    for i in range(2):
        video = os.path.join(base, "videos", f"clip{i}.mp4")
        pose = os.path.join(base, "dwpose", f"clip{i}.mp4")
        frames[video] = rng.integers(0, 256, (nf, h, w, 3), dtype=np.uint8)
        frames[pose] = rng.integers(0, 256, (nf, h, w, 3), dtype=np.uint8)
        if write:
            with open(os.path.join(base, "camera", f"clip{i}.txt"), "w") as f:
                for j in range(nf):  # t tx ty tz qx qy qz qw fx fy scale: a pan and a dolly
                    yaw = 0.01 * j * (1 + i)
                    f.write(f"{j} {0.01 * j} 0 {-0.02 * j} 0 {math.sin(yaw / 2)} 0 "
                            f"{math.cos(yaw / 2)} 1.0 1.788 1.0\n")
        entry = {"video_path": video, "kps_path": pose}
        clips.append(dict(entry, start_frame=0, end_frame=nf))
        segments += [dict(entry, start_frame=a, end_frame=a + n)
                     for n in (nf, 64, 48, 40) for a in (0, nf - n)]
    metas = []
    for name, entries in (("stage2.json", clips), ("stage1.json", segments)):
        metas.append(os.path.join(root, name))
        if write:
            with open(metas[-1], "w") as f:
                json.dump(entries, f)
    return frames, metas[0], metas[1]


def _train_cli_config(root, name, stage, meta, **over):
    """A ``.py`` train config with ``configs/train/stage{stage}.yaml``'s
    values, empty weight paths (the weights are seeded) and ``over``."""
    import os

    solver = dict(gradient_accumulation_steps=1, enable_gradient_checkpointing=True,
                  max_train_steps=4, max_grad_norm=1.0, learning_rate=1.0e-5,
                  lr_warmup_steps=1, lr_scheduler="constant", adam_beta1=0.9,
                  adam_beta2=0.999, adam_weight_decay=1.0e-2, adam_epsilon=1.0e-8,
                  shard_optimizer_states=True)
    data = dict(train_bs=1, train_size_small=512, train_size_large=896, horizontal_meta=[],
                vertical_meta=[meta], sample_rate=4, n_sample_frames=24, num_workers=4)
    if stage == 1:
        data = dict(train_bs=8, train_size_small=512, train_size_large=896, horizontal_meta=[],
                    vertical_meta=[meta], sample_margin=30, num_workers=8)
    cfg = dict(data=data, solver=solver, val=dict(validation_steps=0), uncond_ratio=0.1,
               noise_offset=0.05, snr_gamma=5.0, enable_zero_snr=True, base_model_path="",
               vae_model_path="", image_encoder_path="", motion_module_path="", seed=12580,
               resume_from_checkpoint="", resume_step=0, checkpointing_steps=2,
               exp_name=f"stage{stage}_camera", output_dir=os.path.join(root, "out"))
    for key, value in over.items():
        (solver if key in solver else cfg)[key] = value
    path = os.path.join(root, f"{name}.py")
    with open(path, "w") as f:
        f.write(f"cfg = {cfg!r}\n")
    return path


@contextlib.contextmanager
def _device_step_times(torch, drv):
    """The driver's ``train_step`` between two CUDA events, recorded without
    a synchronize; yields the list of (start, end) pairs, read after the run."""
    real, pairs = drv.train_step, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    drv.train_step = timed
    try:
        yield pairs
    finally:
        drv.train_step = real


def _seconds(pairs):
    return [start.elapsed_time(end) / 1e3 for start, end in pairs]


def _finite_logs(np, out):
    return bool(out["logged"]) and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                       for r in out["logged"])


def phase_train_cli(torch, np, dev, card):
    """The training command lines' path: ``cli.train_stage_1``'s loop
    (``setup`` and ``train``, which ``run_training`` chains) from ``.py``
    configs with the shipped recipes' values, on two seeded portrait clips
    of TRAIN_CLI_CLIP served from memory in place of
    ``humanvid_tpu_torch.data.datasets.read_frames`` (the card's machine has
    no OpenCV; the only stand-in: the crop and resize, CLIP crop, Plücker
    rays, sampler, loader with its pinned uploads, step, checkpoints and
    tracker are the driver's own):

    1. stage 2 at full width, bf16, 896x512x24f, bs 1, grad checkpointing,
       4 steps, checkpoints every 2: the logged losses and grad norms finite,
       ``motion_module``/``camera_encoder``/``opt_state`` files at steps 2 and
       4 and no ``reference_unet`` file, the masters finite, kernels A
       (forward at d <= 80 and 512, backward), B (both) and C launched;
    2. a resume of that directory at step 2 for ``max_train_steps`` 3:
       before its step the state holds step 2 and the saved masters and
       moments bit for bit; it takes one step and writes step 3's files;
    3. stage 1 at full width (stage1.yaml's bs 8 at 896x512, with grad
       checkpointing on), 2 steps and its final save, whose files are not
       written (`_unwritten_saves`: the ~19 GiB of fp32 masters and moments
       took ~27 s to write; stage 2 writes the same kind of files): the
       seconds to gather it and the bytes it would write, then the
       directory goes.

    Returns (ok, {"train_cli": stage-2 launches, "train_cli_stage1": ...})."""
    import os
    import shutil
    import tempfile

    from humanvid_tpu_torch.cli import train_stage_1 as drv
    from humanvid_tpu_torch.data import datasets
    from humanvid_tpu_torch.data.camera import W2C_SOURCES

    ok, launches = True, {}
    with tempfile.TemporaryDirectory(prefix="hv_train_") as root:
        bad = [w for w in W2C_SOURCES if w in root.lower()]
        if bad:
            raise RuntimeError(f"the temporary path {root} holds {bad}")
        t0 = time.perf_counter()
        frames, meta2, meta1 = _train_cli_data(np, root)
        print(f"[train_cli] {card}: two seeded {TRAIN_CLI_CLIP[0]}-frame "
              f"{TRAIN_CLI_CLIP[1]}x{TRAIN_CLI_CLIP[2]} clips with pose clips and moving "
              f"cameras in {time.perf_counter() - t0:.1f} s; datasets.read_frames serves them "
              f"from memory (the only stand-in)")

        def read_frames(path, indices=None, max_frames=None):
            clip = frames[path]
            return clip[list(indices)] if indices is not None else clip[:max_frames].copy()

        real_read = datasets.read_frames
        datasets.read_frames = read_frames
        try:
            cfg2 = _train_cli_config(root, "stage2", 2, meta2)
            t0 = time.perf_counter()
            run = drv.setup(2, ["--config", cfg2])
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            with _device_step_times(torch, drv) as pairs:
                out = drv.train(run)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            device_s = _seconds(pairs)
            launches["train_cli"] = _launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            save_dir = run.save_dir
            finite = all(bool(torch.isfinite(m).all()) for m in run.state.masters)
            n_train = sum(m.numel() for m in run.state.masters)
            del run
            gc.collect()
            torch.cuda.empty_cache()
            files = set(os.listdir(save_dir))
            want = {f"{p}-{s}.pt" for p in ("motion_module", "camera_encoder", "opt_state")
                    for s in (2, 4)}
            files_ok = want <= files and not any(f.startswith("reference_unet") for f in files)
            launched = all(launches["train_cli"][k] > 0 for k in TRAIN_CLI_KERNELS)
            step_ok = (_finite_logs(np, out) and finite and files_ok and launched
                       and len(out["step_seconds"]) == 4)
            ok = ok and step_ok
            steps, waits = out["step_seconds"], out["data_seconds"]
            print(f"[train_cli] {card}: stage 2, CamAnimateConfig(), bf16, 896x512x24f, bs 1, "
                  f"grad checkpointing, {n_train / 1e6:.1f} M trainable; setup (build, seeded "
                  f"init, load_pretrained, train state, dataset) {setup_s:.1f} s; 4 steps in "
                  f"{total_s:.2f} s with 2 checkpoints")
            print(f"[train_cli] {card}: s/step (steady: the step segment, mean of steps 2..4) "
                  f"{sum(steps[1:]) / max(1, len(steps) - 1):.3f}; step segments "
                  f"{[round(x, 3) for x in steps]} s; data wait (the data segment) per step "
                  f"{[round(x, 3) for x in waits]} s, steady mean of steps 2..4 "
                  f"{sum(waits[1:]) / max(1, len(waits) - 1):.3f} s; peak memory {peak:.2f} GiB")
            print(f"[train_cli] {card}: device time a step (CUDA events around train_step, no "
                  f"synchronize) {[round(x, 3) for x in device_s]} s, steady mean of steps 2..4 "
                  f"{sum(device_s[1:]) / max(1, len(device_s) - 1):.3f}")
            for j, c in enumerate(out["checkpoints"]):
                what = "final save" if j == len(out["checkpoints"]) - 1 else "checkpoint"
                print(f"[train_cli] {card}: {what} at step {c['step']} (with the wait for the "
                      f"device): {c['seconds']:.2f} s, {c['bytes'] / 2**30:.3f} GiB")
            print(f"[train_cli] logged {out['logged']}; files {sorted(files)}; launches "
                  f"{launches['train_cli']} {'ok' if step_ok else 'FAIL'}")

            cfg2r = _train_cli_config(root, "stage2_resume", 2, meta2, max_train_steps=3,
                                      resume_from_checkpoint=save_dir, resume_step=2)
            run = drv.setup(2, ["--config", cfg2r])
            held = _holds_saved(torch, run.state, save_dir, 2)
            out = drv.train(run)
            del run
            gc.collect()
            torch.cuda.empty_cache()
            files = set(os.listdir(save_dir))
            resumed = ({f"{p}-3.pt" for p in ("motion_module", "camera_encoder", "opt_state")}
                       <= files and len(out["step_seconds"]) == 1 and _finite_logs(np, out))
            ok = ok and held and resumed
            print(f"[train_cli] resume at step 2: step counter, masters and moments equal to "
                  f"the saved files bit for bit {held}; one step and step 3's files "
                  f"{resumed} {'ok' if held and resumed else 'FAIL'}")

            cfg1 = _train_cli_config(root, "stage1", 1, meta1, max_train_steps=2,
                                     checkpointing_steps=5000,
                                     val=dict(validation_steps=200000))
            run = drv.setup(1, ["--config", cfg1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            with _device_step_times(torch, drv) as pairs, _unwritten_saves() as would:
                out = drv.train(run)
            torch.cuda.synchronize()
            device_s = _seconds(pairs)
            launches["train_cli_stage1"] = _launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            n_train = sum(m.numel() for m in run.state.masters)
            save_dir = run.save_dir
            del run
            gc.collect()
            torch.cuda.empty_cache()
            save = out["checkpoints"][-1]
            shutil.rmtree(save_dir)
            s1_ok = (_finite_logs(np, out) and len(out["step_seconds"]) == 2
                     and all(launches["train_cli_stage1"][k] > 0 for k in TRAIN_CLI_KERNELS))
            ok = ok and s1_ok
            print(f"[train_cli] {card}: stage 1, CamAnimateConfig(), bf16, 896x512, bs 8, "
                  f"enable_gradient_checkpointing: true (stage1.yaml ships it off), "
                  f"{n_train / 1e9:.3f} B trainable: step segments "
                  f"{[round(x, 3) for x in out['step_seconds']]} s, device time a step "
                  f"{[round(x, 3) for x in device_s]} s, data waits "
                  f"{[round(x, 3) for x in out['data_seconds']]} s, peak memory {peak:.2f} GiB; "
                  f"final save gathered in {save['seconds']:.1f} s, its files not written "
                  f"({sum(would) / 2**30:.2f} GiB of tensors in {len(would)} files)")
            print(f"[train_cli] stage 1 logged {out['logged']}; launches "
                  f"{launches['train_cli_stage1']} {'ok' if s1_ok else 'FAIL'}")
        finally:
            datasets.read_frames = real_read
    return ok, launches


@contextlib.contextmanager
def _unwritten_saves():
    """``train.checkpoint.save_checkpoint`` writes an empty file in place
    of each checkpoint while the block runs; yields the list of the bytes
    of tensors each would have held."""
    from humanvid_tpu_torch.train import checkpoint as ckpt

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size() if hasattr(tree, "element_size") else 0

    real, would = ckpt.save_checkpoint, []

    def unwritten(save_dir, prefix, tree, step, total_limit=None):
        import os

        would.append(nbytes(tree))
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, f"{prefix}-{step}.pt")
        open(path, "wb").close()
        return path

    ckpt.save_checkpoint = unwritten
    try:
        yield would
    finally:
        ckpt.save_checkpoint = real


def _holds_saved(torch, state, save_dir, step):
    """Whether ``state`` holds what the step's stage-2 files hold: its step
    counter, moments and masters, bit for bit."""
    import os

    def load(prefix):
        return torch.load(os.path.join(save_dir, f"{prefix}-{step}.pt"), map_location="cpu",
                          weights_only=True)

    opt = load("opt_state")
    modules = {"denoising_unet": load("motion_module"), "camera_encoder": load("camera_encoder")}
    same = state.step == opt["step"] == step
    for i, name in enumerate(state.names):
        component, _, key = name.partition("/")
        same = (same and torch.equal(state.masters[i].cpu(), modules[component][key])
                and torch.equal(state.mu[i].cpu(), opt["mu"][name])
                and torch.equal(state.nu[i].cpu(), opt["nu"][name]))
    return same


DP_STEPS = 3               # global steps of the dp_train phase's runs (batch 2)
DP_SAVE_STEP = 2           # the world-2 run's steps and save, where its resume starts
FANOUT_SIZE = (48, 768, 512)  # frames, height, width: 3 windows of 24, overlap 4
FANOUT_STEPS = 2           # DDIM steps of the fanout phase (the sampler runs 30)
BENCH_STEPS = 1            # DDIM steps of its bench_configs runs (the op-points run 20 or 30)
RANK_TIMEOUT = 600         # seconds a torchrun launch of the dp phases may take
# Largest relative L2 distance of the 2-rank run's gathered moments from the
# one-rank run's over the same global batch. The ranks' bf16 forward and
# backward at batch 1 round where the one-rank run's at batch 2 round
# elsewhere, which moves the moments by bf16 noise: 2.2e-3 (mu) and 5.7e-3
# (nu) on an H100 at step 3. The limit is 3.5 times the larger; a wrong
# reduction (the sum for the mean: 100%) or wrong rows (other clips: ~100%)
# lands far above.
DP_MOMENT_TOL = 0.02
DP_KERNELS = ("flash_fwd", "flash_bwd", "temporal_fwd", "temporal_bwd", "group_norm")


def _torchrun(kind, nproc, spec_path, timeout=RANK_TIMEOUT):
    """This script as ``nproc`` ranks of ``torch.distributed.run``
    (``--rank-worker kind spec``); True when every rank ended well. The
    ranks' own output goes to this script's; a launch past ``timeout`` is
    killed with every process it started."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--rank-worker", kind,
           spec_path]
    sys.stdout.flush()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        print(f"[{kind}] {nproc} ranks past {timeout} s: killed", flush=True)
        return False
    if rc:
        print(f"[{kind}] torchrun of {nproc} rank(s) exited {rc}", flush=True)
    return rc == 0


def _digest(torch, tensors):
    """Each fp32 tensor's bit patterns summed as integers: equal lists mean
    equal bits but for a cancelling pair."""
    return torch.stack([t.view(torch.int32).sum(dtype=torch.int64) for t in tensors]).tolist()


def _dp_train_worker(spec):
    """One rank of a dp_train run: ``cli.train_stage_1``'s setup and loop
    for stage 2 from the spec's configs, the frames served from memory and
    each sample's crop generator seeded alike (so that runs at two world
    sizes read the same samples); with a resume config, a second run from
    the first one's step-2 files. Writes the rank's record to the spec's
    directory."""
    import os
    import random
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from humanvid_tpu_torch.cli import train_stage_1 as drv
    from humanvid_tpu_torch.data import datasets
    from humanvid_tpu_torch.parallel import CommStats

    frames, _, _ = _train_cli_data(np, spec["root"], write=False)

    def read_frames(path, indices=None, max_frames=None):
        clip = frames[path]
        return clip[list(indices)] if indices is not None else clip[:max_frames].copy()

    datasets.read_frames = read_frames
    datasets.random = types.SimpleNamespace(Random=lambda *a: random.Random(a[0] if a else 5))
    argv = ["--dist_backend", spec["backend"]]
    run = drv.setup(2, ["--config", spec["config"]] + argv)
    rank, state = dist.get_rank(), run.state
    digests, pairs, real = [], [], drv.train_step

    def step(system, st, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(system, st, *args, **kwargs)
        end.record()
        pairs.append((start, end))
        if st.micro == 0:
            digests.append(_digest(torch, st.masters))
        return out

    drv.train_step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    state.comm = CommStats()  # times the collectives of this run
    t0 = time.perf_counter()
    out = drv.train(run)
    torch.cuda.synchronize()
    rec = {"rank": rank, "world": dist.get_world_size(), "seconds": time.perf_counter() - t0,
           "launches": _launch_counts(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "step_seconds": out["step_seconds"], "device_seconds": _seconds(pairs),
           "logged": out["logged"], "checkpoints": out["checkpoints"],
           "comm_bytes": dict(state.comm.bytes), "comm_seconds": state.comm.seconds(),
           "digests": digests, "zero1_leaves": sum(state.sharded),
           "finite": all(bool(torch.isfinite(m).all()) for m in state.masters)}
    save_dir = run.save_dir
    del run, state, out
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("resume_config"):
        drv.train_step = real
        run = drv.setup(2, ["--config", spec["resume_config"]] + argv)
        rec["resume_held"] = _holds_saved_dp(torch, dist, run.state, save_dir, DP_SAVE_STEP)
        out = drv.train(run)
        rec["resume_logged"] = out["logged"]
        rec["resume_digest"] = _digest(torch, run.state.masters)
        del run
    with open(os.path.join(spec["out"], f"{spec['leg']}-rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _holds_saved_dp(torch, dist, state, save_dir, step):
    """Whether a (ZeRO-1) train state holds the step's stage-2 files: step
    counter and masters on every rank, and on rank 0 the gathered moments,
    bit for bit."""
    import os

    def load(prefix):
        return torch.load(os.path.join(save_dir, f"{prefix}-{step}.pt"), map_location="cpu",
                          weights_only=True)

    opt = state.state_dict()
    modules = {"denoising_unet": load("motion_module"), "camera_encoder": load("camera_encoder")}
    same = state.step == step
    for i, name in enumerate(state.names):
        component, _, key = name.partition("/")
        same = same and torch.equal(state.masters[i].cpu(), modules[component][key])
    if dist.get_rank() == 0:
        saved = load("opt_state")
        same = same and opt["step"] == saved["step"] == step and all(
            torch.equal(opt[k][n], saved[k][n]) for k in ("mu", "nu") for n in state.names)
    return same


def phase_dp_train(torch, np, card):
    """Data-parallel stage 2 at full width through ``cli.train_stage_2``'s
    setup and loop under ``torch.distributed.run``, on the train_cli
    phase's seeded clips (served from memory; each sample's crop generator
    seeded alike), 896x512x24f, grad checkpointing, 1 clip a rank,
    ``shard_optimizer_states: true``, one launch after the other:

    1. world 1 on NCCL, global batch 2 (the one-rank run of leg 2's
       batches), DP_STEPS steps, the final save;
    2. world 2 on gloo, the two ranks sharing the card (NCCL refuses two
       ranks on one device), global batch 2, DP_SAVE_STEP steps, ZeRO-1
       over the 2 ranks, its final save; then a resume from that save up to
       DP_STEPS.

    Checks: finite losses and masters; the two ranks' masters the same bits
    after each update, the resumed ones too; leg 2's gathered moments
    after the resume within DP_MOMENT_TOL of leg 1's at DP_STEPS (and how
    many leaves are the same bits); the resumed state
    equal to the step-DP_SAVE_STEP files bit for bit; kernels A, A bwd, B,
    B bwd and C launched. Prints, per rank, s/step, the all-reduce's
    seconds and bytes a step and the peak memory. Returns (ok, launches
    summed over every rank of both legs)."""
    import os
    import tempfile

    ok, total = True, {}
    with tempfile.TemporaryDirectory(prefix="hv_dp_") as root:
        _train_cli_data(np, root)
        out = os.path.join(root, "records")
        os.makedirs(out)
        _, meta2, _ = _train_cli_data(np, root, write=False)
        data = dict(train_bs=2, train_size_small=512, train_size_large=896, horizontal_meta=[],
                    vertical_meta=[meta2], sample_rate=4, n_sample_frames=24, num_workers=2)
        legs = {}
        for leg, world, backend in (("world1_nccl", 1, "nccl"), ("world2_gloo", 2, "gloo")):
            # leg 1 saves once, at its end (the moments leg 2's resume is
            # held to); leg 2 ends with its save at DP_SAVE_STEP
            over = dict(max_train_steps=DP_STEPS if world == 1 else DP_SAVE_STEP,
                        checkpointing_steps=5000, data=data)
            spec = dict(root=root, out=out, leg=leg, backend=backend,
                        config=_train_cli_config(root, leg, 2, meta2, exp_name=leg, **over))
            if world == 2:
                spec["resume_config"] = _train_cli_config(
                    root, leg + "_resume", 2, meta2, exp_name=leg + "_resume",
                    resume_from_checkpoint=os.path.join(root, "out", leg),
                    resume_step=DP_SAVE_STEP, **dict(over, max_train_steps=DP_STEPS))
            spec_path = os.path.join(root, f"{leg}.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            t0 = time.perf_counter()
            ran = _torchrun("dp_train", world, spec_path)
            print(f"[dp_train] {leg}: {world} rank(s) in {time.perf_counter() - t0:.1f} s "
                  f"(torchrun, setup, "
                  f"{DP_STEPS if world == 1 else DP_SAVE_STEP} steps, saves"
                  f"{', resume to step %d' % DP_STEPS if world == 2 else ''})")
            recs = []
            for r in range(world):
                path = os.path.join(out, f"{leg}-rank{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        recs.append(json.load(f))
            ok = ok and ran and len(recs) == world
            legs[leg] = recs
            for rec in recs:
                n = len(rec["step_seconds"])
                red = rec["comm_bytes"].get("all_reduce", 0)
                red_s = rec["comm_seconds"].get("all_reduce", 0.0)
                gat = rec["comm_bytes"].get("all_gather", 0)
                print(f"[dp_train] {card}: {leg} rank {rec['rank']}: s/step (steady, steps "
                      f"2..) {sum(rec['step_seconds'][1:]) / max(1, n - 1):.3f}, step segments "
                      f"{[round(x, 3) for x in rec['step_seconds']]}, device time a step "
                      f"{[round(x, 3) for x in rec['device_seconds']]}; gradient all-reduce "
                      f"{red_s / max(1, n):.3f} s and {red / max(1, n) / 1e9:.3f} GB a step; "
                      f"ZeRO-1 master all-gather {gat / max(1, n) / 1e9:.3f} GB a step "
                      f"({rec['zero1_leaves']} leaves sharded); peak memory "
                      f"{rec['peak_gib']:.2f} GiB; logged {rec['logged']}")
                for k, v in rec["launches"].items():
                    total[k] = total.get(k, 0) + v
                ok = ok and rec["finite"] and all(
                    np.isfinite(x["loss"]) for x in rec["logged"])
        two = legs.get("world2_gloo", [])
        if len(two) == 2:
            same = two[0]["digests"] == two[1]["digests"]
            same_resume = two[0]["resume_digest"] == two[1]["resume_digest"]
            held = all(r["resume_held"] for r in two)
            ok = (ok and same and same_resume and held
                  and len(two[0]["digests"]) == DP_SAVE_STEP)
            print(f"[dp_train] world 2: the ranks' masters the same bits after each of "
                  f"{len(two[0]['digests'])} updates {same}, after the resumed steps "
                  f"{same_resume}; the resumed state equal to the step-{DP_SAVE_STEP} files bit "
                  f"for bit {held}; resumed run logged {two[0]['resume_logged']}")
        if ok:
            def load(leg, step):
                return torch.load(os.path.join(root, "out", leg, f"opt_state-{step}.pt"),
                                  map_location="cpu", weights_only=True)

            a, b = load("world1_nccl", DP_STEPS), load("world2_gloo_resume", DP_STEPS)
            for key in ("mu", "nu"):
                names = sorted(a[key])
                x = torch.cat([a[key][n].flatten().float() for n in names])
                y = torch.cat([b[key][n].flatten().float() for n in names])
                dist = ((y - x).norm() / x.norm()).item()
                bits = sum(torch.equal(a[key][n], b[key][n]) for n in names)
                good = dist <= DP_MOMENT_TOL and b["step"] == a["step"] == DP_STEPS
                ok = ok and good
                print(f"[dp_train] {key}: world 2 (ZeRO-1, gathered, resumed) against world 1 "
                      f"at step {DP_STEPS}: relative L2 {dist:.3e} (limit {DP_MOMENT_TOL}), "
                      f"{bits}/{len(names)} leaves the same bits {'ok' if good else 'FAIL'}")
    launched = all(total.get(k, 0) > 0 for k in DP_KERNELS)
    ok = ok and launched
    print(f"[dp_train] launches over every rank {total} {'ok' if ok else 'FAIL'}")
    return ok, total


def _fanout_worker(spec):
    """One rank of the fanout run: the full-width system (seeded, bf16) and
    Pose2VideoPipeline over a flat mesh of the ranks; writes the rank's
    latents and record to the spec's directory."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from humanvid_tpu_torch.parallel import init_distributed, make_mesh
    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig, Pose2VideoPipeline

    dev = init_distributed("cuda", spec["backend"])
    rank = dist.get_rank()
    system = CamAnimate(CamAnimateConfig(), device=dev, dtype=torch.bfloat16).init_random(0)
    f, h, w = FANOUT_SIZE
    inputs = _inputs(np, f, h, w, system.config.clip.image_size, 5)
    pipe = Pose2VideoPipeline(system, mesh=make_mesh())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = pipe(**inputs, num_inference_steps=FANOUT_STEPS, guidance_scale=3.5,
               context_frames=24, context_overlap=4, decode_chunk=8,
               generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    np.save(os.path.join(spec["out"], f"latents{rank}.npy"), out.latents)
    rec = {"rank": rank, "launches": _launch_counts(), "seconds": out.seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "videos": None if out.videos is None else list(out.videos.shape),
           "finite": bool(np.isfinite(out.latents).all()) and (
               out.videos is None or bool(np.isfinite(out.videos).all()))}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def phase_fanout(torch, np, dev, card):
    """The window x CFG fan-out at full width: ``CamAnimateConfig()``
    (seeded, bf16), 768x512x48f, context 24, overlap 4 (3 windows x CFG = 6
    rows), FANOUT_STEPS DDIM steps, over 2 ranks of ``torch.distributed.run``
    on gloo sharing the card (3 rows a rank; eps all-gathered). Checks: the
    ranks' latents the same bits; rank 0 alone decodes; the latents within
    twice the distance two one-process batchings land apart (batched CFG
    against sequential CFG, same weights and initial latents) plus 1e-3,
    relative L2, of the one-process batched run; kernels A, B and C
    launched. Then ``tools.bench_configs`` at every op-point, BENCH_STEPS
    steps, one run: every line finite. Returns (ok, launches summed over
    the ranks)."""
    import os
    import tempfile

    from humanvid_tpu_torch.pipelines import CamAnimate, CamAnimateConfig, Pose2VideoPipeline

    total = {}
    with tempfile.TemporaryDirectory(prefix="hv_fanout_") as root:
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"out": root, "backend": "gloo"}, f)
        t0 = time.perf_counter()
        ok = _torchrun("fanout", 2, spec_path)
        print(f"[fanout] 2 ranks in {time.perf_counter() - t0:.1f} s (torchrun, build, "
              f"sampling)")
        recs, lat = [], []
        for r in range(2):
            path = os.path.join(root, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
                lat.append(np.load(os.path.join(root, f"latents{r}.npy")))
        ok = ok and len(recs) == 2
        for rec in recs:
            s = rec["seconds"]
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
            print(f"[fanout] {card}: rank {rec['rank']}: prepare {s['prepare']:.3f} s, denoise "
                  f"steps {[round(x, 3) for x in s['denoise_steps']]} s, decode "
                  f"{s['decode'] if 'decode' in s else 'none (not rank 0)'}, peak memory "
                  f"{rec['peak_gib']:.2f} GiB, videos {rec['videos']}")
            ok = ok and rec["finite"] and (rec["videos"] is not None) == (rec["rank"] == 0)
    if len(lat) == 2:
        f, h, w = FANOUT_SIZE
        system = CamAnimate(CamAnimateConfig(), device=dev, dtype=torch.bfloat16).init_random(0)
        inputs = _inputs(np, f, h, w, system.config.clip.image_size, 5)
        pipe = Pose2VideoPipeline(system)
        runs = {}
        for mode in ("batched", "sequential"):
            torch.cuda.reset_peak_memory_stats()
            out = pipe(**inputs, num_inference_steps=FANOUT_STEPS, guidance_scale=3.5,
                       context_frames=24, context_overlap=4, decode_chunk=8, cfg_mode=mode,
                       generator=torch.Generator(device=dev).manual_seed(0))
            runs[mode] = out
            print(f"[fanout] {card}: one process, {mode} CFG: denoise steps "
                  f"{[round(x, 3) for x in out.seconds['denoise_steps']]} s, decode "
                  f"{out.seconds['decode']:.3f} s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del pipe, system
        gc.collect()
        torch.cuda.empty_cache()
        ref = runs["batched"].latents

        def rel(x):
            return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))

        same = bool(np.array_equal(lat[0], lat[1]))
        d_fan, d_ref = rel(lat[0]), rel(runs["sequential"].latents)
        good = same and d_fan <= 2 * d_ref + 1e-3
        ok = ok and good
        print(f"[fanout] the ranks' latents the same bits {same}; relative L2 from the "
              f"one-process batched run: fan-out {d_fan:.3e}, one-process sequential CFG "
              f"{d_ref:.3e} (limit {2 * d_ref + 1e-3:.3e}) {'ok' if good else 'FAIL'}")
    ok = ok and all(total.get(k, 0) > 0 for k in MODEL_FWD_KERNELS)
    print(f"[fanout] launches over both ranks {total} {'ok' if ok else 'FAIL'}")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "humanvid_tpu_torch.tools.bench_configs",
                          "c1", "c2", "c4h", "c4v", "--steps", str(BENCH_STEPS), "--runs", "1"],
                         capture_output=True, text=True, timeout=RANK_TIMEOUT,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    bench_ok = (res.returncode == 0 and len(lines) == 4
                and all(np.isfinite(x["value"]) and x["value"] > 0 for x in lines))
    for x in lines:
        print(f"[fanout] bench_configs {x['config']}: {x['metric']} = {x['value']:.4f} "
              f"{x['unit']} at {x['ddim_steps']} DDIM steps ({x['seconds']:.3f} s, one run), "
              f"{x['card']}")
    if not bench_ok:
        print(res.stderr[-3000:])
    print(f"[fanout] bench_configs in {time.perf_counter() - t0:.1f} s "
          f"{'ok' if bench_ok else 'FAIL'}")
    return ok and bench_ok, total


def rank_worker(kind, spec_path):
    """A rank of a dp phase, as ``torch.distributed.run`` starts it."""
    with open(spec_path) as f:
        spec = json.load(f)
    {"dp_train": _dp_train_worker, "fanout": _fanout_worker}[kind](spec)
    return 0


EVAL_CLIPS = 4             # test clips of the eval phase (the reference's test set has 71)
EVAL_CLIP = (72, 768, 512)  # frames, height, width: 24 frames at stride 3
EVAL_STEPS = 3             # DDIM steps of its generation (the command line runs 30)
# largest relative difference of a metric network's features, card (TF32
# off) against the CPU (both float32); about 10x the largest reading of
# TF32-off cuDNN/cuBLAS against oneDNN expected at these depths
METRIC_NET_TOL = 1e-3


def _eval_data(np, root):
    """EVAL_CLIPS seeded portrait clips of EVAL_CLIP (smooth content, as
    ``tools/eval_gate.stage_data`` makes) and their pose clips (the same,
    flipped), in memory under ``root/pexels/{videos,dwpose}/clip{i}.mp4``
    (not written), with moving TUM cameras at ``root/pexels/camera`` (the
    evaluation's path substitution finds them); the meta JSON of all clips
    and one of the first two. Returns (frames by path, meta, 2-clip meta)."""
    import math
    import os

    nf, h, w = EVAL_CLIP
    rng = np.random.default_rng(41)
    base = os.path.join(root, "pexels")
    for sub in ("videos", "dwpose", "camera"):
        os.makedirs(os.path.join(base, sub))
    frames, meta = {}, []
    for i in range(EVAL_CLIPS):
        low = rng.random((4, h // 32, w // 32, 3)).astype(np.float32)
        up = low.repeat(32, axis=1).repeat(32, axis=2)
        gain = 0.5 + 0.5 * np.sin(np.arange(nf) / 5 + i)
        clip = (up[np.arange(nf) % 4] * gain[:, None, None, None] * 255).astype(np.uint8)
        video = os.path.join(base, "videos", f"clip{i}.mp4")
        pose = os.path.join(base, "dwpose", f"clip{i}.mp4")
        frames[video], frames[pose] = clip, np.ascontiguousarray(clip[:, ::-1])
        with open(os.path.join(base, "camera", f"clip{i}.txt"), "w") as f:
            for j in range(nf):  # t tx ty tz qx qy qz qw fx fy scale: a pan and a dolly
                yaw = 0.01 * j * (1 + i)
                f.write(f"{j} {0.01 * j} 0 {-0.02 * j} 0 {math.sin(yaw / 2)} 0 "
                        f"{math.cos(yaw / 2)} 1.0 1.788 1.0\n")
        meta.append({"video_path": video, "kps_path": pose, "start_frame": 0, "end_frame": nf})
    paths = []
    for name, entries in (("test_meta.json", meta), ("test_meta_img.json", meta[:2])):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(entries, f)
    return frames, paths[0], paths[1]


def _msgpack_bytes(np, obj) -> bytes:
    """flax's msgpack encoding (``flax.serialization.msgpack_serialize``) of
    a tree of str-keyed dicts, lists, ints and numpy arrays (ExtType 1: the
    shape, the dtype's name and the C-order bytes)."""
    import struct

    if isinstance(obj, dict):
        return b"".join([b"\xdf" + struct.pack(">I", len(obj))]
                        + [_msgpack_bytes(np, k) + _msgpack_bytes(np, v) for k, v in obj.items()])
    if isinstance(obj, (list, tuple)):
        return b"".join([b"\xdd" + struct.pack(">I", len(obj))]
                        + [_msgpack_bytes(np, v) for v in obj])
    if isinstance(obj, str):
        data = obj.encode()
        return b"\xdb" + struct.pack(">I", len(data)) + data
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, int):
        return b"\xd3" + struct.pack(">q", obj)
    if isinstance(obj, np.ndarray):
        payload = _msgpack_bytes(np, [[int(n) for n in obj.shape], obj.dtype.name,
                                      np.ascontiguousarray(obj).tobytes()])
        return b"\xc9" + struct.pack(">Ib", len(payload), 1) + payload
    raise TypeError(type(obj))


def _lpips_flax_tree(np, weights_dir):
    """The JAX ``LPIPS`` variables of the LPIPS files in ``weights_dir``
    (the JAX ``load_torch_weights``' layout)."""
    import os

    from humanvid_tpu_torch.metrics import weights as mw

    vgg = mw.torch_load(os.path.join(weights_dir, mw.LPIPS_VGG))
    lins = mw.torch_load(os.path.join(weights_dir, mw.LPIPS_LINS))
    params = {"vgg": {}}
    for key, value in vgg.items():
        idx, leaf = key.split(".")
        v = value.numpy()
        params["vgg"].setdefault(f"conv_{idx}", {})[
            "kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(v.transpose(2, 3, 1, 0)) if leaf == "weight" else v)
    for i in range(5):
        params[f"lin_{i}"] = lins[f"lin{i}.model.1.weight"].numpy().reshape(-1)
    return {"params": params}


def _metric_nets_card_vs_cpu(torch, np, dev, weights_dir, gen, gt):
    """Each metric network on the card (float32, TF32 off: the metrics'
    setting; and TF32 on) against the same network on the CPU, on the same
    weights and generated frames: LPIPS on 2 frame pairs at 768x512,
    InceptionV3 on 4 frames, I3D on one 24-frame clip, CLIP-L/14 on 2
    frames. Returns ok (every TF32-off difference within METRIC_NET_TOL)."""
    from humanvid_tpu_torch.metrics.i3d import preprocess_video
    from humanvid_tpu_torch.metrics.nets import tf32_mode
    from humanvid_tpu_torch.metrics.weights import load_metric_nets

    nets = {d: load_metric_nets(weights_dir, d) for d in ("cpu", dev)}

    def cases(n):
        return {
            "lpips": (lambda x, y: n["lpips_model"](x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)),
                      (gen[:2], gt[:2])),
            "inception": (lambda x: n["inception_model"](x.permute(0, 3, 1, 2)), (gen[:4],)),
            "i3d": (lambda v: n["i3d_model"](v.permute(0, 4, 1, 2, 3)),
                    (preprocess_video(gen)[None],)),
            "clip": (n["clip_apply"].embed, (n["clip_apply"].crops(gen[:2]),)),
        }

    def run(fn, arrays, dev, tf32):
        with torch.inference_mode(), tf32_mode(tf32):
            out = fn(*[torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
                       for a in arrays])
        return out.float().cpu().numpy()

    ok = True
    card_cases = cases(nets[dev])
    for name, (fn, arrays) in cases(nets["cpu"]).items():
        t0 = time.perf_counter()
        ref = run(fn, arrays, "cpu", False)
        cpu_s = time.perf_counter() - t0
        card_fn = card_cases[name][0]
        strict = run(card_fn, arrays, dev, False)
        tf32 = run(card_fn, arrays, dev, True)
        scale = float(np.abs(ref).max())
        err = float(np.abs(strict - ref).max()) / scale
        err_tf32 = float(np.abs(tf32 - ref).max()) / scale
        good = bool(np.isfinite(strict).all()) and err <= METRIC_NET_TOL
        ok = ok and good
        print(f"[eval] metric net {name} {tuple(ref.shape)}: card against CPU, largest "
              f"relative difference TF32 off {err:.3e} (tolerance {METRIC_NET_TOL:g}), TF32 on "
              f"{err_tf32:.3e}; CPU {cpu_s:.1f} s {'ok' if good else 'FAIL'}")
    return ok


def phase_eval(torch, np, dev, card):
    """The evaluation command lines' path at full width (``CamAnimateConfig()``,
    2.568 B parameters, seeded weights from a ``.py`` config with no weight
    paths, bf16), on EVAL_CLIPS seeded portrait clips of EVAL_CLIP with pose
    clips and moving TUM cameras. Video and image file IO is served from
    memory (the only stand-in: the card's machine has no OpenCV):
    ``read_frames``, ``save_video`` (which leaves an empty file, so that the
    runner pairs the directories) and ``write_image`` of the eval modules
    and the metric runner.

    1. ``tools.make_random_metric_weights`` writes the five metric files
       (CLIP-L/14 included);
    2. ``cli.eval_pose2vid.main`` generates the clips at -W 512 -H 768 -L 24
       --stride 3, EVAL_STEPS DDIM steps, batched CFG 3.5: each video
       (24, 768, 512, 3), finite, in [0, 1], the camera input the
       trajectory's; kernels A (d = 40, 80, 512), B and C launched; then
       ``--run_metrics --metrics_only --metrics_subset`` for each group of
       ``tools/eval_gate.py``, merged into one ``metrics.json``: all seven
       metrics present and finite, no kernel launched by the metric
       networks;
    3. ``cli.eval_pose2img.main`` at its defaults (896x512, 30 steps) on 2
       of the clips with LPIPS from a seeded flax ``.msgpack``;
    4. every metric network on the card against the CPU
       (``_metric_nets_card_vs_cpu``).

    Prints the seconds per clip, per metric group, the peaks and the gate
    record. Returns (ok, {"eval": launches, "eval_pose2img": launches})."""
    import os
    import tempfile
    from unittest import mock

    from humanvid_tpu_torch.cli import eval_pose2img, eval_pose2vid
    from humanvid_tpu_torch.data.camera import (
        W2C_SOURCES, get_relative_pose, intrinsics_vector, ray_condition, static_camera)
    from humanvid_tpu_torch.data.video_io import _uint8
    from humanvid_tpu_torch.metrics import runner
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.tools import eval_gate
    from humanvid_tpu_torch.tools import make_random_metric_weights as mk

    ok, launches = True, {}
    with tempfile.TemporaryDirectory(prefix="hv_eval_") as root, contextlib.ExitStack() as stack:
        bad = [w for w in W2C_SOURCES if w in root.lower()]
        if bad:
            raise RuntimeError(f"the temporary path {root} holds {bad}")
        t0 = time.perf_counter()
        store, meta, meta_img = _eval_data(np, root)
        print(f"[eval] {card}: {EVAL_CLIPS} seeded {EVAL_CLIP[0]}-frame {EVAL_CLIP[1]}x"
              f"{EVAL_CLIP[2]} clips with pose clips and moving cameras in "
              f"{time.perf_counter() - t0:.1f} s; read_frames, save_video and write_image "
              f"serve them from memory (the only stand-in)")
        saved = {"finite": True, "in_range": True}
        images = {}

        def read_frames(path, indices=None, max_frames=None):
            clip = store[path]
            return clip[list(indices)] if indices is not None else clip[:max_frames].copy()

        def save_video(frames, path, fps=24.0):
            frames = np.asarray(frames)
            if frames.dtype != np.uint8:
                saved["finite"] &= bool(np.isfinite(frames).all())
                saved["in_range"] &= float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0
            store[path] = _uint8(frames)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            open(path, "w").close()

        def write_image(path, image):
            images[path] = _uint8(np.asarray(image))

        for module, name, fn in ((eval_pose2vid, "read_frames", read_frames),
                                 (eval_pose2vid, "save_video", save_video),
                                 (runner, "read_frames", read_frames),
                                 (eval_pose2img, "read_frames", read_frames),
                                 (eval_pose2img, "write_image", write_image)):
            stack.enter_context(mock.patch.object(module, name, fn))

        weights = os.path.join(root, "metric_weights")
        t0 = time.perf_counter()
        mk.main([weights])
        nbytes = sum(os.path.getsize(os.path.join(weights, f)) for f in os.listdir(weights))
        weights_s = time.perf_counter() - t0
        print(f"[eval] {card}: make_random_metric_weights: {len(os.listdir(weights))} files, "
              f"{nbytes / 2**30:.3f} GiB in {weights_s:.1f} s")
        cfg = os.path.join(root, "seeded.py")
        with open(cfg, "w") as f:
            f.write("cfg = {}\n")  # CamAnimateConfig(), seeded weights, no checkpoint
        out = os.path.join(root, "eval_out")
        W, H = EVAL_CLIP[2], EVAL_CLIP[1]
        argv = ["--config", cfg, "--test_meta", meta, "-W", str(W), "-H", str(H), "-L", "24",
                "--stride", "3", "--steps", str(EVAL_STEPS), "--output_dir", out,
                "--metric_weights", weights, "--device", str(dev)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        done = eval_pose2vid.main(argv)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches["eval"] = _launch_counts()
        by_d = dict(fa.forward_launches_by_d)
        gen_peak = torch.cuda.max_memory_allocated() / 2**30
        for c in done["clips"]:
            s = c["seconds"]
            print(f"[eval] {card}: {c['name']}: prepare {s['prepare']:.3f} s, denoise steps "
                  f"{[round(x, 3) for x in s['denoise_steps']]} s, decode {s['decode']:.3f} s")
        gens = [store[os.path.join(out, "gen", f"clip{i}.mp4")] for i in range(EVAL_CLIPS)]
        shapes_ok = all(v.shape == (24,) + EVAL_CLIP[1:] + (3,) for v in gens)
        args = eval_pose2vid.parse_args(argv)
        with open(meta) as f:
            clip0 = eval_pose2vid.prepare_clip(json.load(f)[0], args, 224)
        cams = static_camera((W, H), 24)
        static = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
        moved = float(np.abs(clip0.plucker - static).max())
        launched = (all(by_d.get(d, 0) > 0 for d in (40, 80, 512))
                    and all(launches["eval"][k] > 0 for k in MODEL_FWD_KERNELS))
        gen_ok = (len(done["clips"]) == EVAL_CLIPS and shapes_ok and saved["finite"]
                  and saved["in_range"] and clip0.stride == 3 and moved > 1e-3 and launched)
        ok = ok and gen_ok
        print(f"[eval] {card}: eval_pose2vid generation, CamAnimateConfig() seeded, bf16, -W "
              f"{W} -H {H} -L 24 --stride 3, {EVAL_STEPS} of 30 DDIM steps, batched CFG 3.5: "
              f"{EVAL_CLIPS} clips in {gen_s:.2f} s ({gen_s / EVAL_CLIPS:.2f} s a clip with "
              f"set-up), peak memory {gen_peak:.2f} GiB")
        print(f"[eval] clip0 frames {clip0.tgt_idx[:3]}..{clip0.tgt_idx[-1]} stride "
              f"{clip0.stride}, reference frame {clip0.ref_idx}; camera input's largest "
              f"distance from the static camera's {moved:.4f}; kernel A launches by head width "
              f"{by_d}; launches {launches['eval']}; videos {[v.shape for v in gens]} finite "
              f"{saved['finite']} in [0, 1] {saved['in_range']} {'ok' if gen_ok else 'FAIL'}")

        timings = {"make_metric_weights_s": round(weights_s, 1), "generate_s": round(gen_s, 1)}
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        for group in eval_gate.GROUP_KEYS:
            t0 = time.perf_counter()
            eval_pose2vid.main(argv + ["--run_metrics", "--metrics_only", "--metrics_subset",
                                       group])
            torch.cuda.synchronize()
            timings[f"metrics[{group}]_s"] = round(time.perf_counter() - t0, 3)
        metric_launches = _launch_counts()
        metric_peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out, "metrics.json")) as f:
            summary = json.load(f)
        skipped = eval_gate.skipped_metrics(summary)
        metrics_ok = not skipped and summary.get("num_videos") == EVAL_CLIPS and not any(
            metric_launches.values())
        ok = ok and metrics_ok
        print(f"[eval] {card}: metric groups (load, decode from memory, networks, Frechet) "
              f"{ {k: v for k, v in timings.items() if k.startswith('metrics')} } s, peak "
              f"memory {metric_peak:.2f} GiB; kernel launches by the metric networks "
              f"{sum(metric_launches.values())}")
        print(f"[eval] metrics {summary}; skipped {skipped} {'ok' if metrics_ok else 'FAIL'}")

        lpips_path = os.path.join(root, "lpips.msgpack")
        with open(lpips_path, "wb") as f:
            f.write(_msgpack_bytes(np, _lpips_flax_tree(np, weights)))
        img_out = os.path.join(root, "eval_img")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eval_pose2img.main(["--config", cfg, "--test_meta", meta_img, "--output_dir",
                                  img_out, "--lpips_weights", lpips_path, "--device", str(dev)])
        torch.cuda.synchronize()
        img_s = time.perf_counter() - t0
        launches["eval_pose2img"] = _launch_counts()
        img_peak = torch.cuda.max_memory_allocated() / 2**30
        summ = res["summary"]
        img_ok = (summ["num_videos"] == 2 and not eval_gate.skipped_metrics(
            summ, ("ssim", "psnr", "l1", "lpips"))
            and sorted(v.shape for v in images.values()) == [(896, 4 * 512, 3)] * 2
            and all(launches["eval_pose2img"][k] > 0 for k in MODEL_FWD_KERNELS))
        ok = ok and img_ok
        print(f"[eval] {card}: eval_pose2img at its defaults (896x512, 30 DDIM steps, batched "
              f"CFG 3.5, LPIPS from a flax .msgpack) on 2 clips: {img_s:.2f} s, peak memory "
              f"{img_peak:.2f} GiB; summary {summ}; launches {launches['eval_pose2img']} "
              f"{'ok' if img_ok else 'FAIL'}")

        gt = store[os.path.join(out, "gt", "clip0.mp4")].astype(np.float32) / 255.0
        nets_ok = _metric_nets_card_vs_cpu(torch, np, dev, weights,
                                           gens[0].astype(np.float32) / 255.0, gt)
        ok = ok and nets_ok
        record = {"note": "chip_smoke.py eval phase: CamAnimateConfig() with seeded weights, "
                          "RANDOM metric weights with the real key sets; the values mean nothing",
                  "command": "python -m humanvid_tpu_torch.cli.eval_pose2vid " + " ".join(
                      argv + ["--run_metrics"]),
                  "clips": EVAL_CLIPS, "resolution": "512x768x24f", "device": card,
                  "metrics": summary, "skipped_metrics": skipped, "timings_s": timings,
                  "phase_attempts": {"generate": 1, **{f"metrics[{g}]": 1
                                                       for g in eval_gate.GROUP_KEYS}}}
        print(f"[eval] gate record {json.dumps(record)}")
    return ok, launches


POSE_CLIPS = {"landscape.mp4": (24, 1080, 1920), "portrait.mp4": (24, 1920, 1080)}
POSE_SMPLX_FRAMES = 24
# The card against the CPU, both in IEEE fp32 (only the order of sums
# differs): boxes in pixels; SimCC logits relative to the largest CPU logit;
# the share of a canvas's pixels that may differ, each on a stroke's edge
# in the CPU canvas (a keypoint on an integer pixel coordinate may
# truncate the other way).
POSE_TOL = {"box_px": 0.5, "logit_rel": 1e-3, "canvas_share": 0.005}


def _pose_clip(torch, f, h, w, seed):
    """A seeded (f, h, w, 3) uint8 clip: coarse blocks, blurred, and noise."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.rand((f, 3, 6, 8) if w > h else (f, 3, 8, 6), generator=g, device="cuda") * 255
    x = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    x = x + torch.randn((f, 3, h, w), generator=g, device="cuda") * 12
    return x.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def _stroke_edges(np, canvas):
    """Pixels of a canvas that differ from one of their 4 neighbours."""
    c = np.pad(canvas.astype(np.int16), ((1, 1), (1, 1), (0, 0)), mode="edge")
    mid = c[1:-1, 1:-1]
    return ((mid != c[:-2, 1:-1]) | (mid != c[2:, 1:-1]) | (mid != c[1:-1, :-2])
            | (mid != c[1:-1, 2:])).any(-1)


def _pose_card_vs_cpu(torch, np, det_card, det_cpu, frames):
    """The card's detector against the CPU's on ``frames``: boxes, the
    logits of each CPU box's crop, the keypoints and the canvases. Returns
    (ok, the readings)."""
    from humanvid_tpu_torch.metrics.nets import strict_fp32
    from humanvid_tpu_torch.pose import rtmpose

    def logits(det, frame, boxes):
        bgr = torch.as_tensor(np.ascontiguousarray(frame), device=det.device).flip(-1)
        crops = [rtmpose.normalize_crop(rtmpose.crop_affine(
            bgr, *rtmpose.bbox_to_center_scale(b))[0]) for b in boxes]
        with torch.inference_mode(), strict_fp32():
            return [t.float().cpu().numpy() for t in det.pose_model(torch.stack(crops))]

    r = {"box_px": 0.0, "logit_rel": 0.0, "moved": 0, "moved_ok": True, "canvas_share": 0.0,
         "on_edges": True, "same_count": True}
    for frame in frames:
        bc, bg = det_cpu.detect_boxes(frame), det_card.detect_boxes(frame)
        r["same_count"] &= bc.shape == bg.shape and len(bc) > 0
        if bc.shape == bg.shape:
            r["box_px"] = max(r["box_px"], float(np.abs(bc[:, :4] - bg[:, :4]).max()))
        if len(bc):
            lc, lg = logits(det_cpu, frame, bc), logits(det_card, frame, bc)
            for c, g in zip(lc, lg):
                delta = float(np.abs(c - g).max())
                r["logit_rel"] = max(r["logit_rel"], delta / float(np.abs(c).max()))
                moved = c.argmax(-1) != g.argmax(-1)
                gap = c.max(-1) - np.take_along_axis(c, g.argmax(-1)[..., None], -1)[..., 0]
                r["moved"] += int(moved.sum())
                r["moved_ok"] &= bool((gap[moved] <= 2 * delta).all())
        cc, cg = det_cpu(frame)[0], det_card(frame)[0]
        differ = (cc != cg).any(-1)
        r["canvas_share"] = max(r["canvas_share"], float(differ.mean()))
        r["on_edges"] &= bool(_stroke_edges(np, cc)[differ].all())
    ok = (r["same_count"] and r["box_px"] <= POSE_TOL["box_px"] and r["moved_ok"]
          and r["logit_rel"] <= POSE_TOL["logit_rel"] and r["on_edges"]
          and r["canvas_share"] <= POSE_TOL["canvas_share"])
    return ok, r


def phase_pose(torch, np, dev, card):
    """The data-preparation path at full width: ``tools.prepare_videos`` on
    the card over the POSE_CLIPS clips with seeded weights, then its
    ``--smplx`` branch, then the card against the CPU on the first frame
    of each clip (see the module's docstring). Returns (ok, {"pose":
    launches, "pose_smplx": launches})."""
    import os
    import tempfile
    from unittest import mock

    import humanvid_tpu_torch.pose as pose_pkg
    from humanvid_tpu_torch import native
    from humanvid_tpu_torch.data import video_io
    from humanvid_tpu_torch.pose import detector as pdet
    from humanvid_tpu_torch.tools import make_random_pose_weights as mk
    from humanvid_tpu_torch.tools import prepare_videos

    ok, launches = True, {}
    with tempfile.TemporaryDirectory(prefix="hv_pose_") as root, contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        weights = mk.write(os.path.join(root, "weights"), seed=0)
        t1 = time.perf_counter()
        clips = {rel: _pose_clip(torch, *shape, seed=i) for i, (rel, shape)
                 in enumerate(POSE_CLIPS.items())}
        print(f"[pose] seeded weights (YOLOX-L .pth, DWPose .onnx) written in {t1 - t0:.1f} s; "
              f"clips {[c.shape for c in clips.values()]} made in {time.perf_counter() - t1:.1f} s")
        videos = os.path.join(root, "videos")
        saved, store = {}, {}
        if native.available():
            t0 = time.perf_counter()
            for rel, frames in clips.items():
                video_io.save_video(frames, os.path.join(videos, rel), fps=24.0)
            print(f"[pose] the native libav core builds here: the tool decodes and encodes "
                  f"through it (the clips encoded in {time.perf_counter() - t0:.1f} s)")
            write = video_io.save_video
        else:
            try:
                native.load_library()
            except RuntimeError as err:
                lines = str(err).splitlines()
                reason = next((ln.strip() for ln in lines if "error" in ln), lines[-1])[:300]
            print(f"[pose] the native libav core does not build here ({reason}); read_frames, "
                  f"get_fps and save_video serve the clips from memory")
            for rel, frames in clips.items():
                path = os.path.join(videos, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                open(path, "w").close()
                store[path] = frames

            def write(frames, path, fps=24.0):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                open(path, "w").close()

            stack.enter_context(mock.patch.object(
                video_io, "read_frames", lambda path, indices=None, max_frames=None: store[path]))
            stack.enter_context(mock.patch.object(video_io, "get_fps", lambda path: 24.0))

        def save(frames, path, fps=24.0):
            saved[path] = np.asarray(frames)
            write(frames, path, fps)

        times = {"detect": 0.0, "pose": 0.0, "draw": 0.0}
        persons, detectors = [], []

        def timed(key, fn, count=False):
            def run(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                times[key] += time.perf_counter() - t
                if count:
                    persons.append(len(out))
                return out
            return run

        def load(*args, **kwargs):
            detectors.append(pdet.load_detector(*args, **kwargs))
            return detectors[-1]

        stack.enter_context(mock.patch.object(video_io, "save_video", save))
        stack.enter_context(mock.patch.object(pose_pkg, "load_detector", load))
        stack.enter_context(mock.patch.object(pdet.DWposeDetector, "detect_boxes", timed(
            "detect", pdet.DWposeDetector.detect_boxes, count=True)))
        stack.enter_context(mock.patch.object(pdet.DWposeDetector, "estimate_poses", timed(
            "pose", pdet.DWposeDetector.estimate_poses)))
        stack.enter_context(mock.patch.object(pdet, "draw_pose", timed("draw", pdet.draw_pose)))

        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prepare_videos.main(["--videos_dir", videos, "--yolox", weights["yolox"],
                             "--dwpose", weights["dwpose"], "--device", str(dev)])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches["pose"] = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = sum(f for f, _, _ in POSE_CLIPS.values())
        outs = {os.path.relpath(p, os.path.join(root, "dwpose")): v for p, v in saved.items()}
        drawn = [int((c.max(-1) > 0).sum()) for v in outs.values() for c in v]
        run_ok = (sorted(outs) == sorted(POSE_CLIPS)
                  and all(outs[rel].shape == (f, h, w, 3) and outs[rel].dtype == np.uint8
                          for rel, (f, h, w) in POSE_CLIPS.items())
                  and len(persons) == n and min(persons) >= 1 and min(drawn) > 100
                  and not any(launches["pose"].values()))
        ok = ok and run_ok
        ms = {k: 1e3 * v / n for k, v in times.items()}
        rest = 1e3 * total / n - sum(ms.values())
        print(f"[pose] {card}: tools.prepare_videos at full width (YOLOX-L at 640x640, DWPose-L "
              f"at 384x288, IEEE fp32) on {len(POSE_CLIPS)} clips of "
              f"{[f'{f}x{h}x{w}' for f, h, w in POSE_CLIPS.values()]}: {total:.2f} s with the "
              f"detector's load, {1e3 * total / n:.1f} ms a frame: detection "
              f"{ms['detect']:.1f}, pose {ms['pose']:.1f}, drawing {ms['draw']:.1f}, decode, "
              f"encode and the rest {rest:.1f} ms a frame; persons a frame {min(persons)}-"
              f"{max(persons)} (mean {sum(persons) / len(persons):.2f}); drawn pixels a canvas "
              f"{min(drawn)}-{max(drawn)}; peak memory {peak:.2f} GiB; hand-kernel launches "
              f"{sum(launches['pose'].values())} {launches['pose']} "
              f"{'ok' if run_ok else 'FAIL'}")

        det_cpu = pdet.load_detector(weights["yolox"], weights["dwpose"], device="cpu")
        t0 = time.perf_counter()
        cmp_ok, r = _pose_card_vs_cpu(torch, np, detectors[0], det_cpu,
                                      [c[0] for c in clips.values()])
        ok = ok and cmp_ok
        print(f"[pose] card against the CPU on the first frame of each clip ({time.perf_counter() - t0:.1f} s): "
              f"box count equal {r['same_count']}, boxes max |d| {r['box_px']:.2e} px (limit "
              f"{POSE_TOL['box_px']}), SimCC logits max |d| {r['logit_rel']:.2e} of the largest "
              f"(limit {POSE_TOL['logit_rel']}), keypoints moved {r['moved']} (each where the "
              f"CPU's top two are within twice the logits' difference: {r['moved_ok']}), canvas "
              f"pixels differing {r['canvas_share']:.2e} (limit {POSE_TOL['canvas_share']}, on "
              f"stroke edges: {r['on_edges']}) {'ok' if cmp_ok else 'FAIL'}")

        ue = os.path.join(root, "ue", "videos")
        os.makedirs(ue)
        rng = np.random.default_rng(7)
        center = np.array([960.0, 540.0]) + rng.normal(0, 40, (POSE_SMPLX_FRAMES, 1, 2))
        np.savez(os.path.join(ue, "take.npz"),
                 keypoints=(center + rng.normal(0, 180, (POSE_SMPLX_FRAMES, 144, 2))).astype(
                     np.float32),
                 confidence=rng.uniform(0, 1, (POSE_SMPLX_FRAMES, 144)).astype(np.float32))
        saved.clear()
        _reset_launches()
        t0 = time.perf_counter()
        prepare_videos.main(["--videos_dir", ue, "--smplx", "--device", str(dev)])
        smplx_s = time.perf_counter() - t0
        launches["pose_smplx"] = _launch_counts()
        out = saved.get(os.path.join(root, "ue", "dwpose", "take.mp4"))
        smplx_ok = (out is not None and out.shape == (POSE_SMPLX_FRAMES, 1080, 1920, 3)
                    and all((c.max(-1) > 0).sum() > 100 for c in out)
                    and not any(launches["pose_smplx"].values()))
        ok = ok and smplx_ok
        print(f"[pose] {card}: --smplx on a {POSE_SMPLX_FRAMES}-frame .npz at 1920x1080: "
              f"{smplx_s:.2f} s, {1e3 * smplx_s / POSE_SMPLX_FRAMES:.1f} ms a frame; hand-kernel "
              f"launches {sum(launches['pose_smplx'].values())} {'ok' if smplx_ok else 'FAIL'}")
    return ok, launches


PHASE_SECONDS = {}  # wall seconds of each phase of main(), in order


def _timed(name, fn, *args):
    """fn(*args), its wall seconds added to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


# the kernels whose ms in the kernels line is their device time (torch.profiler)
DEVICE_MS_KERNELS = ("probe_dmajor", "probe_hbm", "temporal_fwd", "temporal_bwd",
                     "temporal_fwd_long", "temporal_bwd_frames", "temporal_bwd_long",
                     "group_norm")


def kernel_line(results, launches):
    """The per-kernel JSON line. ``launches`` is each kernel's count in the
    run of its path (the forward kernels and kernel C: pose2vid; the
    backward kernels: the stage-2 training path; the wide-head backward and
    the probe kernels, which no model path runs: the microbench run; the
    last shapes' kernels and the mid forward: long_wide's sequential
    pose2vid and its stage-2 steps, the 100-frame one for the long
    backward; kernel A at the head's own width: heads64's sequential
    pose2vid and its stage-2 step); ``launches_by_path`` has every run's
    counts, and kernel A's rows the configurations their cases ran in."""
    paths = {"flash_bwd": "train", "temporal_bwd": "train", "flash_bwd_d512": "microbench",
             "probe_dmajor": "microbench", "probe_pvt": "microbench",
             "probe_hbm": "microbench", "flash_fwd_xwide": "long_wide_sequential",
             "temporal_fwd_long": "long_wide_sequential", "flash_bwd_xwide": "long_wide_train",
             "temporal_bwd_frames": "long_wide_train",
             "temporal_bwd_long": "long_frames_past_train",
             "flash_fwd_mid": "long_wide_sequential", "flash_bwd_mid": "long_wide_train",
             "flash_fwd_own": "heads64_sequential", "flash_bwd_own": "heads64_train"}
    replaces = {
        "flash_fwd": ("humanvid_tpu/ops/flash_attention.py:172", FLASH_SRC),
        "flash_fwd_d512": ("humanvid_tpu/ops/flash_attention.py:96", FLASH_SRC),
        "temporal_fwd": ("humanvid_tpu/ops/temporal_attention.py:81", TEMPORAL_SRC),
        # _dkv_kernel_t (:415) and _dq_kernel_t (:479), one kernel each
        "flash_bwd": ("humanvid_tpu/ops/flash_attention.py:415", FLASH_BWD_SRC),
        "temporal_bwd": ("humanvid_tpu/ops/temporal_attention.py:116", TEMPORAL_BWD_SRC),
        "group_norm": ("humanvid_tpu/ops/group_norm.py:52", GN_SRC),
        # _dkv_kernel (:354) and _dq_kernel (:537), taken for d > 128
        "flash_bwd_d512": ("humanvid_tpu/ops/flash_attention.py:354", FLASH_BWD_SRC),
        "probe_dmajor": ("tools/microbench.py:220", DMAJOR_SRC),
        "probe_pvt": ("tools/microbench.py:405", PVT_SRC),
        "probe_hbm": ("tools/microbench.py:636", HBM_SRC),
        # the same Pallas kernels at the shapes the kernels above do not take
        "flash_fwd_xwide": ("humanvid_tpu/ops/flash_attention.py:96", FLASH_SRC),
        "flash_bwd_xwide": ("humanvid_tpu/ops/flash_attention.py:354", FLASH_BWD_SRC),
        "temporal_fwd_long": ("humanvid_tpu/ops/temporal_attention.py:81", TEMPORAL_SRC),
        "temporal_bwd_long": ("humanvid_tpu/ops/temporal_attention.py:116", TEMPORAL_BWD_SRC),
        # kernel B's backward from 33 to 128 frames (the long kernel's past that)
        "temporal_bwd_frames": ("humanvid_tpu/ops/temporal_attention.py:116",
                                TEMPORAL_BWD_SRC),
        # _fwd_kernel at the widths between 128 and 512 (the VAE's 512 is
        # flash_fwd_d512's)
        "flash_fwd_mid": ("humanvid_tpu/ops/flash_attention.py:96", FLASH_SRC),
        # _dkv_kernel (:354) and _dq_kernel (:537) at the same widths
        "flash_bwd_mid": ("humanvid_tpu/ops/flash_attention.py:354", MID_BWD_SRC),
        # _fwd_kernel_t, _dkv_kernel_t and _dq_kernel_t at d = 64 and 80 < d <=
        # 128, at the head's own width
        "flash_fwd_own": ("humanvid_tpu/ops/flash_attention.py:172", FLASH_SRC),
        "flash_bwd_own": ("humanvid_tpu/ops/flash_attention.py:415", FLASH_BWD_SRC),
    }
    kernels = []
    for name, (rep, src) in replaces.items():
        rows = [r for r in results if r["kernel"] == name]
        # the first case of each kernel is its headline shape, unless named
        head = next(r for r in rows if r["shape"] == HEADLINES.get(name, rows[0]["shape"]))
        path = paths.get(name, "pose2vid")
        extra = {}
        if name in ("flash_bwd", "flash_bwd_own"):
            extra = dict(also_replaces="humanvid_tpu/ops/flash_attention.py:479",
                         dkv_ms=head["dkv_ms"], dq_ms=head["dq_ms"])
        elif name == "flash_bwd_d512":
            extra = dict(also_replaces="humanvid_tpu/ops/flash_attention.py:537",
                         dkv_ms=head["dkv_ms"], dv_ms=head["dv_ms"], dk_ms=head["dk_ms"],
                         dq_ms=head["dq_ms"], library_backends=head["library_backends"])
        elif name in ("flash_bwd_xwide", "flash_bwd_mid"):  # the dK/dV and dQ kernels
            extra = dict(also_replaces="humanvid_tpu/ops/flash_attention.py:537",
                         dkv_ms=head["dkv_ms"], dq_ms=head["dq_ms"],
                         library_backends=head["library_backends"], plan=head["plan"])
        elif name == "probe_pvt":
            extra = dict(kernel_a_ms=head["kernel_a_ms"],
                         untransposed_ms=head["untransposed_ms"])
        elif name in DEVICE_MS_KERNELS and name != "group_norm":
            # ms is the device time (torch.profiler): the run fails where a
            # headline's reading is not; a case in ``shapes`` whose
            # ``device_ms_from`` is "events" holds the CUDA-event time there
            extra = dict(event_ms=head["event_ms"])
        elif name in ("flash_fwd_xwide", "flash_fwd_mid"):
            # ms is the event time, as kernel A's other rows
            extra = dict(event_ms=head["event_ms"], device_ms=head["device_ms"],
                         plan=head["plan"])
        elif name == "group_norm":  # the statistics kernel and the folded apply
            # the headline is the two-pass decode; the one-pass kernel's is
            # the UNet's level 0
            one = next(r for r in rows if r["shape"] == GN_ONE_PASS_HEADLINE)
            extra = dict(also_replaces="humanvid_tpu/ops/group_norm.py:145",
                         event_ms=head["event_ms"], one_pass_shape=one["shape"],
                         one_pass_ms=one["ms"], one_pass_event_ms=one["event_ms"],
                         one_pass_plain_ms=one["plain_ms"], one_pass_bound_ms=one["bound_ms"],
                         one_pass_library_ms=one["library_ms"])
        # where ms came from: the profiler's device time, or the CUDA events'
        # time through the wrapper (kernel A's rows and kernel 9's)
        ms_from = head.get("device_ms_from", "profiler") if name in DEVICE_MS_KERNELS \
            else "events"
        if "config" in head:  # kernel A: the configurations its cases ran in
            extra["configs"] = sorted({r["config"] for r in rows})
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, path=path, ms_from=ms_from,
            **extra,
            launches=launches[path][name],
            launches_by_path={p: counts.get(name, 0) for p, counts in launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"],
            shapes=[{k: v for k, v in r.items() if k not in ("kernel", "ok")} for r in rows]))
    return json.dumps({"kernels": kernels})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--long-wide-steps"]:
        return long_wide_steps(sys.argv[2])
    if sys.argv[1:2] == ["--heads64-steps"]:
        return long_wide_steps(sys.argv[2], "heads64")
    try:
        import humanvid_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}", file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(*sys.argv[2:4])
    dev = torch.device("cuda")
    card = _timed("card", phase_card)
    _timed("build", phase_build)
    results = []
    _timed("flash", phase_flash, torch, results, dev, flash_cases())
    isolation_fwd = _timed("flash_isolation", phase_flash_isolation, torch, dev, "forward")
    _timed("temporal", phase_temporal, torch, results, dev, temporal_cases())
    _timed("flash_bwd", phase_flash_bwd, torch, results, dev, flash_bwd_cases())
    isolation_bwd = _timed("flash_isolation_bwd", phase_flash_isolation, torch, dev,
                           "backward")
    _timed("temporal_bwd", phase_temporal_bwd, torch, results, dev, temporal_bwd_cases())
    _timed("group_norm", phase_group_norm, torch, results, dev, group_norm_cases())
    _timed("probes", phase_probes, torch, results, dev)
    print("[head widths] kernels A and B at the widths other head counts give, and through "
          "the zero pad")
    _timed("widths flash", phase_flash, torch, results, dev, head_width_cases())
    _timed("widths flash_bwd", phase_flash_bwd, torch, results, dev,
           head_width_bwd_cases())
    _timed("widths temporal", phase_temporal, torch, results, dev, temporal_width_cases())
    _timed("widths temporal_bwd", phase_temporal_bwd, torch, results, dev,
           temporal_width_bwd_cases())
    print("[long and wide] kernel A past 512 columns, kernel B past 32 frames")
    _timed("long flash", phase_flash, torch, results, dev, long_wide_flash_cases())
    _timed("long flash_bwd", phase_flash_bwd, torch, results, dev,
           long_wide_flash_bwd_cases())
    _timed("long temporal", phase_temporal, torch, results, dev, long_wide_temporal_cases())
    _timed("long temporal_bwd", phase_temporal_bwd, torch, results, dev,
           long_wide_temporal_bwd_cases())
    isolation_long = _timed("temporal_isolation", phase_temporal_isolation, torch, dev)
    failed = [f"{r['kernel']} {r['shape']}" for r in results if not r["ok"]]

    def check(name, good):
        if not good:
            failed.append(name)

    check("kernel A forward head isolation", isolation_fwd)
    check("kernel A backward head isolation", isolation_bwd)
    check("kernel B backward head isolation past 32 frames", isolation_long)
    check("kernel C grad", _timed("group_norm_grad", phase_group_norm_grad, torch, dev))
    check("tiny reference", _timed("tiny_reference", phase_tiny_reference, torch, np, dev))
    check("tiny train", _timed("tiny_train", phase_tiny_train, torch, np, dev))
    main_ok, main_launches, pipe, inputs = _timed("main", phase_main, torch, np, dev)
    check("main", main_ok)
    per_call = _timed("profile", phase_profile, torch, dev, pipe, inputs)
    del pipe
    torch.cuda.empty_cache()
    train_ok, train_launches, system, state, batch = _timed("train", phase_train, torch, np,
                                                            dev)
    check("train", train_ok)
    _timed("profile_train", phase_profile_train, torch, dev, system, state, batch)
    # stage 1 needs the card's memory to itself
    del system, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    heads64_ok, heads64_launches = _timed("heads64", phase_heads64, torch, np, dev, card)
    check("heads64", heads64_ok)
    long_wide_ok, long_wide_launches = _timed("long_wide", phase_long_wide, torch, np, dev,
                                              card)
    check("long_wide", long_wide_ok)
    stage1_ok, stage1_launches = _timed("stage1", phase_stage1, torch, np, dev)
    check("stage 1", stage1_ok)
    gc.collect()
    torch.cuda.empty_cache()
    cli_ok, cli_launches = _timed("cli", phase_cli, torch, np, dev, card)
    check("cli", cli_ok)
    gc.collect()
    torch.cuda.empty_cache()
    train_cli_ok, train_cli_launches = _timed("train_cli", phase_train_cli, torch, np, dev,
                                              card)
    check("train_cli", train_cli_ok)
    gc.collect()
    torch.cuda.empty_cache()
    bench_ok, bench_launches, bench_name = _timed("microbench", phase_microbench, torch)
    check(bench_name, bench_ok)
    gc.collect()
    torch.cuda.empty_cache()
    # last: when the microbench ran after this phase, its torch.profiler
    # sessions found no device record
    eval_ok, eval_launches = _timed("eval", phase_eval, torch, np, dev, card)
    check("eval", eval_ok)
    gc.collect()
    torch.cuda.empty_cache()
    # the ranks of the data-parallel phases are processes of their own: the
    # card's memory goes to them
    dp_ok, dp_launches = _timed("dp_train", phase_dp_train, torch, np, card)
    check("dp_train", dp_ok)
    fanout_ok, fanout_launches = _timed("fanout", phase_fanout, torch, np, dev, card)
    check("fanout", fanout_ok)
    gc.collect()
    torch.cuda.empty_cache()
    pose_ok, pose_launches = _timed("pose", phase_pose, torch, np, dev, card)
    check("pose", pose_ok)
    print(kernel_line(results, {"pose2vid": main_launches, "train": train_launches,
                                **stage1_launches, **heads64_launches, **long_wide_launches,
                                "cli": cli_launches,
                                **train_cli_launches,
                                **eval_launches, "dp_train": dp_launches,
                                "fanout": fanout_launches, **pose_launches,
                                "denoise_step": per_call["denoise step"],
                                "decode": per_call["decode"], "microbench": bench_launches}))
    # each phase's wall seconds (a phase run more than once: the sum)
    print("[phase seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
          + f"; total {sum(PHASE_SECONDS.values()):.1f}")
    print(card)
    if failed:
        # on standard error too, whose end is what a caller often keeps
        print(f"chip_smoke: a phase failed: {'; '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
