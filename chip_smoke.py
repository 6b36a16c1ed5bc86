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
   temporal shapes of the main path;
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
- kernel B bwd: the frame-axis backward at the five stage-2 temporal shapes;
- tiny train: one uncond and one cond stage-2 step of the tiny config on the
  card (bf16, kernels) and on the CPU (fp32, plain versions), compared;
- train: full-width stage 2 (grad checkpointing, FF chunks of 1024, fp32
  masters of the motion modules and the camera encoder), 896x512x24f, bs 1,
  TRAIN_STEPS steps; checks finite values, that the trainable leaves move
  and the frozen ones do not, and that its kernels launched;
- profile: one more train step, device time by kernel group.

GroupNorm and stage 1 (pose2img and the stage-1 step) add:

- kernel C: GroupNorm(+SiLU) against its plain version at the decode's, the
  UNet's and a ragged shape, act None and SiLU, channels_last and
  contiguous, with ms, plain ms, library ms (``F.group_norm`` + ``F.silu``)
  and bound ms; and the autograd Function's dx, dgamma and dbeta against
  plain autograd at the stage-2 level-0 shape;
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

Every main-path run (pose2vid, the stage-2 steps, pose2img, the stage-1
steps, the denoise step and decode of the profile phase, and the microbench
run) sets every launch count to 0 just before it and reads the counts just
after.

Then one JSON line of per-kernel numbers, the card line, and the last line
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits 2 without one.

Each kernel is held to its plain version (bf16 in, fp32 softmax) by two
limits, each about 3x the largest reading of a sound kernel at the main
path's shapes on an H100: the relative L2 error ||out - plain|| / ||plain||,
which a systematic fault (a wrong scale, a lost bias) exceeds, and the
largest elementwise error over rms(plain), which a fault in a few rows or
columns (a ragged tile, a masked key) exceeds.
"""

from __future__ import annotations

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

FLASH_SRC = "humanvid_tpu_torch/csrc/flash_attention.cu"
TEMPORAL_SRC = "humanvid_tpu_torch/csrc/temporal_attention.cu"
FLASH_BWD_SRC = "humanvid_tpu_torch/csrc/flash_attention_bwd.cu"
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
    its plain version, under tol = (relative L2 limit, max error / rms limit)."""
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.norm()).item()
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
        ok = close and lse_err <= 1e-3
        share = None if lib is None else ms / lib  # < 1: faster than SDPA
        print(f"  {name}: B={B} Lq={lq} Lk={lk} heads={heads} d={d} max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} lse_err={lse_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms={lib} sdpa_share={share if share is None else round(share, 3)} "
              f"bound_ms={b_ms:.3f} ({b_by}) TFLOP/s={flops / ms / 1e9:.1f} "
              f"{'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="flash_fwd_d512" if d > 128 else "flash_fwd", shape=name,
                            max_abs_err=err, rel_l2=rel, ms=ms, plain_ms=plain_ms, library_ms=lib,
                            sdpa_share=share, bound_ms=b_ms, bound_by=b_by, ok=ok))
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()


def temporal_cases():
    """Kernel B at the main path's shapes: (name, b, f, l, c, heads)."""
    return [
        ("motion level0", 1, 24, 6144, 320, 8),
        ("motion level1", 1, 24, 1536, 640, 8),
        ("motion level2", 1, 24, 384, 1280, 8),
        ("motion level3/mid", 1, 24, 96, 1280, 8),
        ("camera encoder", 1, 24, 6144, 320, 8),
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
        ms = time_ms(torch, lambda: ta.temporal_attention_cuda(q, k, v, heads), 10)
        plain_ms = time_ms(torch, lambda: ta.temporal_attention_plain(q, k, v, heads), 3)

        def split(t):
            return t.view(b, f, l, heads, d).permute(0, 2, 3, 1, 4)

        lib = library_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)), 10)
        flops = 4.0 * b * l * heads * f * f * d
        b_ms, b_by = bound(flops, 2.0 * 4 * q.numel())
        print(f"  {name}: b={b} f={f} l={l} c={c} heads={heads} max_abs_err={err:.3e} "
              f"rel_l2={rel:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib} "
              f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="temporal_fwd", shape=name, max_abs_err=err, rel_l2=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                            ok=ok))


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


def _profile_split(torch, fn, keys):
    """Device ms per call of ``fn`` summed over the CUDA kernels whose names
    contain each key (each launched once a call), from torch.profiler over 3
    calls. A kernel's time is its captured total over its captured launches:
    the profiler can miss a launch, and a total over the 3 calls then reads a
    third low (kernel 8's QK arms read 2/3 of their CUDA-event time so)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {key: 0.0 for key in keys}
    for evt in prof.key_averages():
        for key in keys:
            if key in evt.key and evt.count:
                out[key] += evt.self_device_time_total / 1e3 / evt.count
    return out


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
        wide = d > 128
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
        # d = 512: the dk/dv entry point launches a dV and a dK kernel
        keys = (("flash_bwd_dv_wide_kernel", "flash_bwd_dk_wide_kernel",
                 "flash_bwd_dq_wide_kernel") if wide
                else ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"))
        split = _profile_split(torch, lambda: fa.flash_attention_backward_cuda(*args), keys)
        split = dict(zip(("dv", "dk", "dq") if wide else ("dkv", "dq"), split.values()))
        if wide:
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
        print(f"  {name}: B={B} Lq={lq} Lk={lk} heads={heads} d={d} "
              f"rel_l2 dq/dk/dv={errs[0][1]:.3e}/{errs[1][1]:.3e}/{errs[2][1]:.3e} "
              f"max_err/rms dq/dk/dv={ratios} "
              f"hidden keys zero={hidden_zero} repeat same bits={repeat_same} "
              f"passed-over tiles same bits={skip_same} ms={ms:.3f} (dkv {split['dkv']:.3f}"
              + (f" = dv {split['dv']:.3f} + dk {split['dk']:.3f}" if wide else "")
              + f" + dq {split['dq']:.3f}) plain_ms={plain_ms:.3f} "
              f"library_ms={lib} bound_ms={b_ms:.3f} ({b_by}) "
              f"TFLOP/s={flops / ms / 1e9:.1f} {'ok' if ok else 'FAIL'}")
        extra = dict(library_backends=backends, dv_ms=split["dv"], dk_ms=split["dk"]) \
            if wide else {}
        results.append(dict(kernel="flash_bwd_d512" if wide else "flash_bwd", shape=name,
                            max_abs_err=err, rel_l2=rel, ms=ms, dkv_ms=split["dkv"],
                            dq_ms=split["dq"], plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by, ok=ok, **extra))
        del q, k, v, g, out, lse, delta, grads, args
        torch.cuda.empty_cache()


def temporal_bwd_cases():
    """Kernel B's backward at the stage-2 training shapes (896x512x24f):
    (name, b, f, l, c, heads)."""
    return [
        ("motion level0", 1, 24, 7168, 320, 8),
        ("motion level1", 1, 24, 1792, 640, 8),
        ("motion level2", 1, 24, 448, 1280, 8),
        ("motion level3/mid", 1, 24, 112, 1280, 8),
        ("camera encoder", 1, 24, 7168, 320, 8),
    ]


def phase_temporal_bwd(torch, results, dev, cases):
    from humanvid_tpu_torch.ops import temporal_attention as ta

    print(f"[kernel B bwd] frame-axis attention backward vs plain (bf16; tol: rel L2 "
          f"{TEMPORAL_BWD_TOL[0]}, max err {TEMPORAL_BWD_TOL[1]} x rms(plain))")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, b, f, l, c, heads in cases:
        d = c // heads
        q, k, v, g = (torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
        refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
        torch.cuda.synchronize()
        errs = [agreement(o, r, TEMPORAL_BWD_TOL) for o, r in zip(grads, refs)]
        ratios = "/".join(f"{e[0] / r.float().pow(2).mean().sqrt().item():.3e}"
                          for e, r in zip(errs, refs))
        ok = all(e[2] for e in errs)
        ms = time_ms(torch, lambda: ta.temporal_attention_backward_cuda(q, k, v, g, heads), 10)
        plain_ms = time_ms(
            torch, lambda: ta.temporal_attention_backward_plain(q, k, v, g, heads), 3)

        def split(t):  # (b, f, l, c) -> (b*l, heads, f, d), contiguous
            return t.view(b, f, l, heads, d).permute(0, 2, 3, 1, 4).reshape(b * l, heads, f, d)

        lib = _sdpa_backward_ms(torch, [split(t) for t in (q, k, v)], split(g), None, 10)
        flops = 10.0 * b * l * heads * f * f * d
        b_ms, b_by = bound(flops, 2.0 * 7 * q.numel())
        print(f"  {name}: b={b} f={f} l={l} c={c} heads={heads} "
              f"rel_l2 dq/dk/dv={errs[0][1]:.3e}/{errs[1][1]:.3e}/{errs[2][1]:.3e} "
              f"max_err/rms dq/dk/dv={ratios} "
              f"ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib} "
              f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="temporal_bwd", shape=name, max_abs_err=max(e[0] for e in errs),
                            rel_l2=max(e[1] for e in errs), ms=ms, plain_ms=plain_ms,
                            library_ms=lib, bound_ms=b_ms, bound_by=b_by, ok=ok))
        del q, k, v, g, grads, refs
        torch.cuda.empty_cache()


def group_norm_cases():
    """Kernel C at the paths' shapes: (name, (N, C, H, W), eps). 32 groups."""
    return [
        ("decode 768x512", (8, 128, 768, 512), 1e-6),
        ("decode 384x256", (8, 256, 384, 256), 1e-6),
        ("decode 192x128", (8, 512, 192, 128), 1e-6),
        ("UNet level 0 768x512", (24, 320, 96, 64), 1e-5),
        ("UNet level 2 768x512", (24, 1280, 24, 16), 1e-5),
        ("stage-2 level 0 896x512", (24, 320, 112, 64), 1e-5),
        ("UNet level 3 concat", (24, 2560, 12, 8), 1e-5),
        ("ragged rows 37x29", (3, 320, 37, 29), 1e-6),
    ]


def phase_group_norm(torch, results, dev, cases):
    """Kernel C against its plain version for act None and SiLU, in both
    layouts it takes, with its time, the plain version's, the library's
    (``F.group_norm`` + ``F.silu``, which the port does not call) and the
    byte bound (x read once, y written once)."""
    import torch.nn.functional as F

    from humanvid_tpu_torch.ops import group_norm as gn

    print(f"[kernel C] GroupNorm(+SiLU) vs plain (bf16; tol: rel L2 {GN_TOL[0]}, "
          f"max err {GN_TOL[1]} x rms(plain))")
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, shape, eps in cases:
        c = shape[1]
        base = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        weight = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        for layout, fmt in (("channels_last", torch.channels_last),
                            ("contiguous", torch.contiguous_format)):
            x = base.contiguous(memory_format=fmt)
            for act in ("silu", None):
                def kernel():
                    return gn.group_norm_act_cuda(x, weight, bias, 32, eps, act)

                def library():
                    y = F.group_norm(x, 32, weight, bias, eps)
                    return F.silu(y) if act else y

                y = kernel()
                ref = gn.group_norm_act_plain(x, weight, bias, 32, eps, act)
                torch.cuda.synchronize()
                err, rel, close = agreement(y, ref, GN_TOL)
                ratio = err / ref.float().pow(2).mean().sqrt().item()
                ok = close and y.is_contiguous(memory_format=fmt)
                del y, ref
                ms = time_ms(torch, kernel, 20)
                plain_ms = time_ms(torch, lambda: gn.group_norm_act_plain(
                    x, weight, bias, 32, eps, act), 3)
                lib = library_ms(torch, library, 20)
                b_ms, b_by = bound(x.numel() * (5.0 + 4.0 * (act == "silu")),
                                   2.0 * 2 * x.numel() + 2 * 2 * 2 * c, H100_FP32_FLOPS)
                label = f"{name} {layout} act={act}"
                print(f"  {label}: {tuple(shape)} max_abs_err={err:.3e} max_err/rms={ratio:.3e} "
                      f"rel_l2={rel:.3e} ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib} "
                      f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
                results.append(dict(kernel="group_norm", shape=label, max_abs_err=err,
                                    rel_l2=rel, ms=ms, plain_ms=plain_ms, library_ms=lib,
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
        dev_ms = _profile_split(torch, lambda: pk.hbm_map_cuda(x), ("probe_hbm",))["probe_hbm"]
        ok = ok and dev_ms > 0
        plain_ms = time_ms(torch, lambda: pk.hbm_map_plain(x), 5)
        lib = library_ms(torch, lambda: torch.add(x, 0.5, out=out), 20)
        copy_ms = time_ms(torch, lambda: out.copy_(x), 20)
        nbytes = 2.0 * 2 * x.numel()
        b_ms, b_by = bound(2.0 * x.numel(), nbytes)
        print(f"  hbm {name}: exact={ok} event_ms={ms:.4f} device_ms={dev_ms:.4f} "
              f"({nbytes / dev_ms / 1e6:.1f} GB/s) "
              f"plain_ms={plain_ms:.3f} library_ms={lib:.4f} ({nbytes / lib / 1e6:.1f} GB/s) "
              f"copy_ms={copy_ms:.4f} ({nbytes / copy_ms / 1e6:.1f} GB/s) bound_ms={b_ms:.4f} "
              f"({b_by}) {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="probe_hbm", shape=name, max_abs_err=err, rel_l2=0.0,
                            ms=dev_ms, event_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=lib, copy_ms=copy_ms, gbs=nbytes / dev_ms / 1e6,
                            bound_ms=b_ms, bound_by=b_by, ok=ok))
        del x, y, ref, out
        torch.cuda.empty_cache()


MICROBENCH_PROBES = ("flash", "temporal", "dmajor", "conv", "gn", "vaeattn", "flash_bwd",
                     "hbm", "gnstats", "pvt")  # all but unet and vae


def phase_microbench(torch):
    """The port's microbench entry point with every probe but ``unet`` and
    ``vae``, which the main phase already times. Returns (ok, launches)."""
    from humanvid_tpu_torch.tools import microbench

    print(f"[microbench] humanvid_tpu_torch.tools.microbench {' '.join(MICROBENCH_PROBES)}")
    _reset_launches()
    t0 = time.perf_counter()
    failed = microbench.run(MICROBENCH_PROBES)
    torch.cuda.synchronize()
    launches = _launch_counts()
    need = ("probe_dmajor", "probe_pvt", "probe_hbm", "flash_bwd_d512", "flash_fwd",
            "flash_fwd_d512", "temporal_fwd", "flash_bwd", "group_norm")
    ok = not failed and all(launches[k] > 0 for k in need)
    print(f"[microbench] {time.perf_counter() - t0:.1f} s; failed probes {failed}; launches "
          f"{launches} {'ok' if ok else 'FAIL'}")
    return ok, launches


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
    fp32. The tiny pose2img (one frame, batched CFG) is held the same way."""
    from humanvid_tpu_torch.pipelines import (
        CamAnimate, Pose2ImagePipeline, Pose2VideoPipeline, tiny_config)

    F, H, W = 4, 256, 256
    cfg = tiny_config()
    cpu = CamAnimate(cfg, device="cpu").init_random(3)
    inputs = _inputs(np, F, H, W, cfg.clip.image_size, 4)
    rng = np.random.default_rng(5)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    init_img = rng.normal(size=(1, H // 8, W // 8, 4)).astype(np.float32)
    runs, images = {}, {}
    for key, device in (("cpu_fp32", "cpu"), ("cpu_bf16", "cpu"), ("card_bf16", dev)):
        system = cpu
        if key != "cpu_fp32":
            system = CamAnimate(cfg, device=device, dtype=torch.bfloat16)
            for name, module in system.components().items():
                module.load_state_dict(getattr(cpu, name).state_dict(), strict=True)
        runs[key] = Pose2VideoPipeline(system)(
            **inputs, num_inference_steps=2, guidance_scale=3.5, cfg_mode="sequential",
            init_latents=init)
        images[key] = Pose2ImagePipeline(system)(
            inputs["ref_image"], inputs["pose_video"][0], inputs["plucker"][0],
            inputs["clip_image"], num_inference_steps=2, guidance_scale=3.5,
            init_latents=init_img)
    ok = True
    for label, outs, field in (("pose2vid", runs, "videos"), ("pose2img", images, "images")):
        ref = outs["cpu_fp32"]

        def errs(key):
            return (float(np.abs(getattr(outs[key], field) - getattr(ref, field)).max()),
                    float(np.abs(outs[key].latents - ref.latents).max()))

        (v16, l16), (vc, lc) = errs("cpu_bf16"), errs("card_bf16")
        good = (bool(np.isfinite(getattr(outs["card_bf16"], field)).all())
                and vc <= 2 * v16 + 1e-2 and lc <= 2 * l16 + 1e-2)
        ok = ok and good
        frames = f"x{F}f" if label == "pose2vid" else ""
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
    paths, the wide-head backward and the three probe kernels."""
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
    cfg = stage_config(2, tiny_config())
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
    system = CamAnimate(stage_config(2, CamAnimateConfig()), device=dev,
                        dtype=torch.bfloat16).init_random(0)
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
    ("kernel B (temporal_fwd)", ("temporal_fwd_kernel",)),
    ("kernel A bwd (flash_bwd)", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("kernel B bwd (temporal_bwd)", ("temporal_bwd_kernel",)),
    # ahead of the cuDNN group ("nhwc") and the norm group ("norm")
    ("kernel C (group_norm)", ("gn_stats_", "gn_finalize", "gn_apply_")),
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = _group_device_time(torch, prof)
    busy = sum(groups.values())
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
    system = CamAnimate(stage_config(1, CamAnimateConfig()), device=dev,
                        dtype=torch.bfloat16).init_random(0)
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


def kernel_line(results, launches):
    """The per-kernel JSON line. ``launches`` is each kernel's count in the
    run of its path (the forward kernels and kernel C: pose2vid; the
    backward kernels: the stage-2 training path; the wide-head backward and
    the probe kernels, which no model path runs: the microbench run);
    ``launches_by_path`` has every run's counts."""
    paths = {"flash_bwd": "train", "temporal_bwd": "train", "flash_bwd_d512": "microbench",
             "probe_dmajor": "microbench", "probe_pvt": "microbench",
             "probe_hbm": "microbench"}
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
        "probe_hbm": ("tools/microbench.py:633", HBM_SRC),
    }
    kernels = []
    for name, (rep, src) in replaces.items():
        rows = [r for r in results if r["kernel"] == name]
        head = rows[0]  # the first case of each kernel is its headline shape
        path = paths.get(name, "pose2vid")
        extra = {}
        if name == "flash_bwd":
            extra = dict(also_replaces="humanvid_tpu/ops/flash_attention.py:479",
                         dkv_ms=head["dkv_ms"], dq_ms=head["dq_ms"])
        elif name == "flash_bwd_d512":
            extra = dict(also_replaces="humanvid_tpu/ops/flash_attention.py:537",
                         dkv_ms=head["dkv_ms"], dv_ms=head["dv_ms"], dk_ms=head["dk_ms"],
                         dq_ms=head["dq_ms"], library_backends=head["library_backends"])
        elif name == "probe_pvt":
            extra = dict(kernel_a_ms=head["kernel_a_ms"],
                         untransposed_ms=head["untransposed_ms"])
        elif name in ("probe_dmajor", "probe_hbm"):  # ms is the device time
            extra = dict(event_ms=head["event_ms"])
        elif name == "group_norm":  # the statistics kernel and the folded apply
            extra = dict(also_replaces="humanvid_tpu/ops/group_norm.py:145")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, path=path, **extra,
            launches=launches[path][name],
            launches_by_path={p: counts[name] for p, counts in launches.items()},
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
    try:
        import humanvid_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = phase_card()
    phase_build()
    results = []
    phase_flash(torch, results, dev, flash_cases())
    phase_temporal(torch, results, dev, temporal_cases())
    phase_flash_bwd(torch, results, dev, flash_bwd_cases())
    phase_temporal_bwd(torch, results, dev, temporal_bwd_cases())
    phase_group_norm(torch, results, dev, group_norm_cases())
    phase_probes(torch, results, dev)
    ok = all(r["ok"] for r in results)
    ok = phase_group_norm_grad(torch, dev) and ok
    ok = phase_tiny_reference(torch, np, dev) and ok
    ok = phase_tiny_train(torch, np, dev) and ok
    main_ok, main_launches, pipe, inputs = phase_main(torch, np, dev)
    ok = ok and main_ok
    per_call = phase_profile(torch, dev, pipe, inputs)
    del pipe
    torch.cuda.empty_cache()
    train_ok, train_launches, system, state, batch = phase_train(torch, np, dev)
    ok = ok and train_ok
    phase_profile_train(torch, dev, system, state, batch)
    # stage 1 needs the card's memory to itself
    del system, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    stage1_ok, stage1_launches = phase_stage1(torch, np, dev)
    ok = ok and stage1_ok
    gc.collect()
    torch.cuda.empty_cache()
    bench_ok, bench_launches = phase_microbench(torch)
    ok = ok and bench_ok
    print(kernel_line(results, {"pose2vid": main_launches, "train": train_launches,
                                **stage1_launches, "denoise_step": per_call["denoise step"],
                                "decode": per_call["decode"], "microbench": bench_launches}))
    print(card)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
