"""Kernel-level measurements of the port on the CUDA card.

    python -m humanvid_tpu_torch.tools.microbench [--iters N] [probe ...]

The counterpart of the JAX package's ``tools/microbench.py``: the same probes
under the same names, at the same shapes, printing one JSON line per
measurement with the same record (``probe``, ``seconds``, ``spread`` and
extras such as ``tflops``, ``hbm_gbs``, ``gbs``), plus the ``device`` it ran
on, so that the two tools' lines can be set side by side. Where the JAX
probe timed a Pallas kernel, this one times the port's CUDA kernel in its
place, keeping the record's name (``temporal_pallas_*`` is kernel B,
``hbm_pallas_map_*`` is kernel 10, ``gnstats_*_pallas`` is kernel C).
Without probe names it runs ``flash temporal unet vae``.

Timing: one warm-up call, then ``--iters`` samples (default 5); a sample
is a chain of n back-to-back calls between two CUDA events, where n is the
JAX probe's chain length (1 where it did not chain), and ``seconds`` is the
median sample over n. Inputs are made on the card from seeds; back-to-back
calls find inputs smaller than the 50 MB L2 cache already there.

The tool runs on the card only: without one it raises. A probe that fails
prints ``# probe <name> failed: ...`` on stderr and the tool exits 1 after
running the rest.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops import group_norm as gn
from ..ops import temporal_attention as ta
from . import probe_kernels as pk

DEFAULT_PROBES = ("flash", "temporal", "unet", "vae")
# The JAX tool's block-size sweep over environment variables; kernel A has
# one tiling per head width, so there is nothing to sweep.
LEFT_BEHIND = ("flash_sweep",)
NEG_INF = -1e9
# query x key tiles: kernel A at d <= 80 and at d = 512; kernel 9 (192
# queries, 3 consumer warpgroups, over 128-key tiles)
TILE = "192x128"
TILE_D512 = "64x32"
PVT_TILE = "192x128"


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the microbench tool measures the CUDA card, and none is available")
    return torch.device("cuda")


_PROFILE_TRIES = 4  # torch.profiler sessions a device-time reading takes before CUDA events


def _time(fn: Callable[[], object], iters: int, n: int = 1):
    """(median seconds per call, per-call seconds of every sample)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dts = []
    for _ in range(iters):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        dts.append(start.elapsed_time(end) / 1e3 / n)
    return statistics.median(dts), dts


def _device_seconds(fn: Callable[[], object], key: str, calls: int = 20):
    """(device seconds per launch of the probe kernel ``key``, where the
    reading came from). torch.profiler over ``calls`` calls gives the
    kernels whose names contain ``key``: their captured time over their
    captured launches. A session that holds no device record of them (now
    and then one does, often a few in a row) is taken again after a pause
    that grows, up to _PROFILE_TRIES sessions; after that the reading falls
    back to CUDA events around ``calls`` calls over the launches that
    ``probe_kernels`` counted in them, which also holds the gaps between
    launches, and says so on stderr."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(_PROFILE_TRIES):
        if attempt:
            time.sleep(0.5 * attempt)  # misses come in runs: let the profiler settle
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if key in evt.key:
                total += evt.self_device_time_total
                count += evt.count
        if count:
            return total / count / 1e6, "profiler"
    print(f"# the profiler captured no kernel named like {key!r} in {_PROFILE_TRIES} "
          f"sessions; timing it with CUDA events", file=sys.stderr, flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = pk.launches[key]
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    count = pk.launches[key] - before
    if not count:
        raise RuntimeError(f"{calls} calls launched no {key!r} kernel")
    return start.elapsed_time(end) / 1e3 / count, "events"


def _emit(name: str, seconds: float, dts: Sequence[float], **extra) -> None:
    rec = {"probe": name, "seconds": seconds, "spread": [min(dts), max(dts)], **extra,
           "device": torch.cuda.get_device_name()}
    print(json.dumps(rec), flush=True)


def _randn(gen, shape, dev, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


def probe_flash(dev, iters):
    """Kernel A at UNet level 0 with the reference KV (24 frames x 8 heads,
    Lq 6144, Lk 12288, d 40), with a zero key bias as the JAX probe."""
    b, h, lq, lk, d = 24, 8, 6144, 12288, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, (b, n, h * d), dev) for n in (lq, lk, lk))
    bias = torch.zeros((b, lk), device=dev)
    sec, dts = _time(lambda: fa.flash_attention_packed(q, k, v, h, bias), iters, 10)
    _emit("flash_l0_6144x12288_d40", sec, dts, tflops=4 * b * h * lq * lk * d / sec / 1e12)


def probe_temporal(dev, iters):
    """Kernel B at each motion-module level (1, 24, l, c), and its plain
    version in place of the JAX probe's XLA arm."""
    f, heads = 24, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    for l, c in ((6144, 320), (1536, 640), (384, 1280), (96, 1280)):
        q, k, v = (_randn(gen, (1, f, l, c), dev) for _ in range(3))
        sec, dts = _time(lambda: ta.temporal_attention(q, k, v, heads), iters, 20)
        _emit(f"temporal_pallas_l{l}_c{c}", sec, dts, hbm_gbs=4 * f * l * c * 2 / sec / 1e9)
        sec, dts = _time(lambda: ta.temporal_attention_plain(q, k, v, heads), iters, 20)
        _emit(f"temporal_xla_l{l}_c{c}", sec, dts)


def _system(dev):
    from ..pipelines import CamAnimate, CamAnimateConfig

    return CamAnimate(CamAnimateConfig(), device=dev, dtype=torch.bfloat16).init_random(0)


def probe_unet(dev, iters):
    """One full-width video-UNet pass (24 frames, 96x64 latents, reference
    features, pose condition): half a CFG denoise step."""
    frames, h8, w8 = 24, 96, 64
    system = _system(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        ctx = _randn(gen, (1, 1, system.config.denoising_unet.cross_attention_dim), dev)
        ref = _randn(gen, (1, 4, h8, w8), dev).contiguous(memory_format=torch.channels_last)
        _, feats = system.reference_unet(ref, torch.zeros(1, device=dev), ctx,
                                         collect_ref_features=True)
        x = _randn(gen, (frames, 4, h8, w8), dev).contiguous(memory_format=torch.channels_last)
        cond = _randn(gen, (frames, 320, h8, w8), dev).contiguous(
            memory_format=torch.channels_last)
        t = torch.full((1,), 500.0, device=dev)
        sec, dts = _time(lambda: system.denoising_unet(x, t, ctx, cond_fea=cond,
                                                       ref_features=feats, frames=frames),
                         iters)
    _emit("unet_pass_24f_96x64", sec, dts)


def probe_vae(dev, iters):
    """The 24-frame decode at 768x512 in chunks of 4, 8 and 24 frames, as
    the pipeline decodes."""
    from ..pipelines import Pose2VideoPipeline

    pipe = Pose2VideoPipeline(_system(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    lat = _randn(gen, (24, 4, 96, 64), dev).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        for chunk in (4, 8, 24):
            sec, dts = _time(lambda: pipe.decode(lat, chunk), iters)
            _emit(f"vae_decode_24f_768x512_chunk{chunk}", sec, dts)


def probe_dmajor(dev, iters):
    """Kernel 8: one (1024 x 2048 x d) product per problem, 64 problems, in
    each orientation, and the QK control at d = 128; ``device_seconds`` is
    the kernel's own time (torch.profiler, CUDA events where it captures
    nothing: ``device_seconds_from`` says which) and ``device_tflops`` its rate."""
    G, lq, lk, d = 64, 1024, 2048, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    arms = (("qk_d_on_lanes", "qk_d_on_lanes", ((lq, d), (lk, d)), d),
            ("qk_d_on_sublanes", "qk_d_on_sublanes", ((d, lq), (d, lk)), d),
            ("pv_d_on_lanes", "pv_d_on_lanes", ((lq, lk), (lk, d)), d),
            ("pv_dmajor_out", "pv_dmajor_out", ((d, lk), (lq, lk)), d),
            ("qk_d128_lanes", "qk_d_on_lanes", ((lq, 128), (lk, 128)), 128))
    for tag, arm, shapes, width in arms:
        a, b = (_randn(gen, (G,) + s, dev) for s in shapes)
        sec, dts = _time(lambda: pk.dmajor(arm, a, b), iters, 300)
        dev_sec, source = _device_seconds(lambda: pk.dmajor(arm, a, b), "probe_dmajor")
        flops = 2 * G * lq * lk * width
        _emit(f"dmajor_{tag}", sec, dts, tflops=flops / sec / 1e12, device_seconds=dev_sec,
              device_tflops=flops / dev_sec / 1e12, device_seconds_from=source)
        del a, b


CONV_SHAPES = (  # (tag, n, h, w, cin, cout)
    ("unet_l0", 24, 96, 64, 320, 320),
    ("unet_l0_upcat", 24, 96, 64, 640, 320),
    ("unet_l1", 24, 48, 32, 640, 640),
    ("unet_l2", 24, 24, 16, 1280, 1280),
    ("unet_l3", 24, 12, 8, 1280, 1280),
    ("vae_hi", 8, 768, 512, 128, 128),
    ("vae_mid", 8, 384, 256, 256, 256),
    ("vae_lo", 8, 192, 128, 512, 512),
)


def probe_conv(dev, iters):
    """3x3 convs at the UNet's and the VAE's shapes: ``F.conv2d`` on
    ``channels_last`` tensors (cuDNN) against the 9-shift matmul form
    (cuBLAS), both plain PyTorch. Where cin != cout, as in the JAX probe, a
    conv and the conv back are timed together and counted twice."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def conv(x, w):
        return F.conv2d(x, w, padding=1)

    def shiftmm(x, w):  # x (n, h, w, ci) NHWC, w (3, 3, ci, co)
        n, h, ww, ci = x.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((n * h * ww, w.shape[-1]), device=x.device)
        for dy in range(3):
            for dx in range(3):
                acc += xp[:, dy:dy + h, dx:dx + ww].reshape(-1, ci) @ w[dy, dx]
        return acc.to(x.dtype)

    for tag, n, h, w_, ci, co in CONV_SHAPES:
        x = _randn(gen, (n, h, w_, ci), dev)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        wt = _randn(gen, (co, ci, 3, 3), dev, 0.02).contiguous(memory_format=torch.channels_last)
        flops = 2 * 9 * n * h * w_ * ci * co
        chain = 10 if n * h * w_ * ci > 2 ** 24 else 40
        if ci != co:
            back = _randn(gen, (ci, co, 3, 3), dev, 0.02).contiguous(
                memory_format=torch.channels_last)
            sec, dts = _time(lambda: conv(conv(x_cl, wt), back), iters, chain)
            _emit(f"conv_{tag}_conv", sec, dts, tflops=2 * flops / sec / 1e12)
            continue
        sec, dts = _time(lambda: conv(x_cl, wt), iters, chain)
        _emit(f"conv_{tag}_conv", sec, dts, tflops=flops / sec / 1e12)
        w_hwio = wt.permute(2, 3, 1, 0).contiguous()
        sec, dts = _time(lambda: shiftmm(x, w_hwio), iters, chain)
        _emit(f"conv_{tag}_shiftmm", sec, dts, tflops=flops / sec / 1e12)
        del x, x_cl, wt


def _nhwc_as_nchw(x):
    return x.permute(0, 3, 1, 2)  # channels_last in memory, as the models keep it


def probe_gn(dev, iters):
    """Kernel C, GroupNorm(32) + SiLU, at the decode's and the UNet's shapes;
    ``hbm_gbs`` counts two reads and one write, as the JAX probe."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, n, h, w_, c in (("vae_hi", 8, 768, 512, 128), ("vae_mid", 8, 384, 256, 256),
                             ("vae_l0", 24, 96, 64, 320)):
        x = _nhwc_as_nchw(_randn(gen, (n, h, w_, c), dev))
        ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        sec, dts = _time(lambda: gn.group_norm_act(x, ones, zeros, 32, 1e-6, "silu"), iters, 40)
        _emit(f"gn_silu_{tag}", sec, dts, hbm_gbs=3 * x.numel() * 2 / sec / 1e9)


def probe_gnstats(dev, iters):
    """GroupNorm(32) + SiLU three ways at the hot shapes: the plain version,
    kernel C (in place of the JAX Pallas arm) and ``F.group_norm`` +
    ``F.silu``; ``gbs`` counts one read and one write."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, shape in (("vae_hi", (8, 768, 512, 128)), ("vae_mid", (8, 384, 256, 256)),
                       ("vae_lo", (8, 192, 128, 512)), ("unet_l0", (24, 96, 64, 320)),
                       ("unet_l3", (24, 24, 16, 1280))):
        c = shape[-1]
        x = _nhwc_as_nchw(_randn(gen, shape, dev))
        scale = torch.randn(c, generator=gen, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        scale16, bias16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        arms = {
            "plain": lambda: gn.group_norm_act_plain(x, scale, bias, 32, 1e-6, "silu"),
            "pallas": lambda: gn.group_norm_act(x, scale, bias, 32, 1e-6, "silu"),
            "torch": lambda: F.silu(F.group_norm(x, 32, scale16, bias16, 1e-6)),
        }
        for arm, op in arms.items():
            sec, dts = _time(op, iters, 40)
            _emit(f"gnstats_{tag}_{arm}", sec, dts, gbs=2 * x.numel() * 2 / sec / 1e9)


def probe_hbm(dev, iters):
    """Streaming at the decode's and the UNet's tensor shapes: kernel 10 (in
    place of the JAX Pallas map) and the plain-PyTorch yardsticks, one ATen
    kernel each: ``hbm_map`` is ``torch.add(x, 0.5)``, the same function as
    kernel 10 to the bit (the constant rounds to 1.0 in bf16), ``hbm_copy``
    a device-to-device copy, ``hbm_add`` x + y, ``hbm_reduce`` the JAX
    probe's x + mean(x) * 1e-6 + y * 0 (an fp32 spatial mean fed back into
    a full map). ``gbs`` counts each input read once and each output written
    once, except ``hbm_reduce``, counted as two passes as the JAX probe counts
    it. ``hbm_pallas_map`` adds kernel 10's own time (``device_seconds``,
    torch.profiler, or CUDA events: ``device_seconds_from``) and its rate
    (``device_gbs``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, shape in (("vae_hi", (8, 768, 512, 128)), ("vae_mid", (8, 384, 256, 256)),
                       ("unet_l0", (24, 96, 64, 320))):
        x, y = (_randn(gen, shape, dev) for _ in range(2))
        out = torch.empty_like(x)
        size = x.numel() * 2
        arms = (("map", lambda: torch.add(x, 0.5, out=out), 2),
                ("copy", lambda: out.copy_(x), 2),
                ("add", lambda: torch.add(x, y, out=out), 3),
                ("reduce", lambda: x + torch.mean(x, dim=(1, 2), keepdim=True,
                                                  dtype=torch.float32).to(x.dtype) * 1e-6
                 + y * 0, 2),
                ("pallas_map", lambda: pk.hbm_map(x), 2))
        for arm, op, passes in arms:
            sec, dts = _time(op, iters, 40)
            extra = {}
            if arm == "pallas_map":
                dev_sec, source = _device_seconds(op, "probe_hbm")
                extra = dict(device_seconds=dev_sec, device_gbs=passes * size / dev_sec / 1e9,
                             device_seconds_from=source)
            _emit(f"hbm_{arm}_{tag}", sec, dts, gbs=passes * size / sec / 1e9, **extra)
        del x, y, out


def probe_vaeattn(dev, iters):
    """The VAE mid block's single-head attention at the decode's shape (8
    frames, 6144 tokens, d 512): the plain version in query chunks, in place
    of the JAX probe's chunked XLA arm, and kernel A."""
    b, l, d = 8, 6144, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, (b, l, d), dev) for _ in range(3))
    flops = 4 * b * l * l * d
    chunk = 1024

    def plain():
        for i in range(0, l, chunk):
            fa.flash_attention_plain(q[:, i:i + chunk], k, v, 1)

    sec, dts = _time(plain, iters, 4)
    _emit("vaeattn_chunked_xla", sec, dts, tflops=flops / sec / 1e12)
    sec, dts = _time(lambda: fa.flash_attention_packed(q, k, v, 1), iters, 4)
    _emit(f"vaeattn_flash_{TILE_D512}", sec, dts, tflops=flops / sec / 1e12)


def probe_flash_bwd(dev, iters):
    """Kernel A forward + backward through autograd at the stage-2 training
    shape (24 frames x 8 heads, Lq 7168, Lk 14336, d 40, zero key bias), and
    at the VAE mid block's 512-wide head (8 x 6144 x 6144), which no
    training stage differentiates. ``tflops`` counts 10 * Lq * Lk * d per
    head, the JAX probe's count."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, b, h, lq, lk, d, with_bias in (
            (f"flash_fwdbwd_{TILE}", 24, 8, 7168, 14336, 40, True),
            (f"flash_fwdbwd_vae_d512_{TILE_D512}", 8, 1, 6144, 6144, 512, False)):
        q, k, v = (_randn(gen, (b, n, h * d), dev).requires_grad_() for n in (lq, lk, lk))
        g = _randn(gen, (b, lq, h * d), dev)
        bias = torch.zeros((b, lk), device=dev) if with_bias else None

        def step():
            with torch.enable_grad():
                out, _ = fa.flash_attention_packed(q, k, v, h, bias)
                return torch.autograd.grad(out, (q, k, v), g)

        sec, dts = _time(step, iters, 3)
        _emit(name, sec, dts, tflops=10 * b * h * lq * lk * d / sec / 1e12)
        del q, k, v, g


def probe_pvt(dev, iters):
    """Kernel 9, the transposed flash forward: first its numerics against
    kernel A's plain version at the JAX probe's small shape (2 x 1024 x
    2048, 8 heads, d 40, every 7th key hidden), then its time beside kernel
    A (``pvt_cur``) at UNet level 0 with the reference KV."""
    heads, d = 8, 40
    c = heads * d
    gen = torch.Generator(device=dev).manual_seed(0)
    b0, lq0, lk0 = 2, 1024, 2048
    q0 = _randn(gen, (b0, lq0, c), dev)
    k0, v0 = (_randn(gen, (b0, lk0, c), dev) for _ in range(2))
    bias0 = torch.where(torch.arange(lk0, device=dev) % 7 == 0, NEG_INF, 0.0)
    bias0 = bias0.expand(b0, lk0).contiguous()
    want, want_lse = fa.flash_attention_plain(q0, k0, v0, heads, bias0)
    got, got_lse = pk.pvt(q0, k0, v0, heads, bias0)
    err = (want.float() - got.float()).abs().max().item()
    lse_err = (want_lse * pk.LOG2E - got_lse).abs().max().item()
    print(f"# pvt numerics max|delta| = {err:.5f} (bf16 tolerance ~0.02), lse (log2) "
          f"max|delta| = {lse_err:.3e}", file=sys.stderr, flush=True)
    if not (err < 0.05 and lse_err < 1e-2):
        raise AssertionError(f"pvt numerics: max|delta| {err}, lse {lse_err}")

    b1, lq1, lk1 = 24, 6144, 12288
    q1 = _randn(gen, (b1, lq1, c), dev)
    k1, v1 = (_randn(gen, (b1, lk1, c), dev) for _ in range(2))
    flops = 4 * b1 * heads * lq1 * lk1 * d
    for name, op in ((f"cur_{TILE}", lambda: fa.flash_attention_packed(q1, k1, v1, heads)),
                     (f"pvt_{PVT_TILE}", lambda: pk.pvt(q1, k1, v1, heads))):
        sec, dts = _time(op, iters, 10)
        _emit(f"pvt_{name}", sec, dts, tflops=flops / sec / 1e12)


PROBES: Dict[str, Callable] = {
    "flash": probe_flash, "temporal": probe_temporal, "unet": probe_unet, "vae": probe_vae,
    "dmajor": probe_dmajor, "conv": probe_conv, "gn": probe_gn, "vaeattn": probe_vaeattn,
    "flash_bwd": probe_flash_bwd, "hbm": probe_hbm, "gnstats": probe_gnstats, "pvt": probe_pvt}


def run(names: Sequence[str], iters: int = 5) -> List[str]:
    """Run the named probes on the card; returns the names of those that
    failed (each also reported on stderr). Raises without a card."""
    dev = _device()
    failed = []
    for name in names:
        try:
            with torch.no_grad():
                PROBES[name](dev, iters)
        except Exception as err:  # noqa: BLE001 -- the probes are independent
            print(f"# probe {name} failed: {type(err).__name__}: {str(err)[:300]}",
                  file=sys.stderr, flush=True)
            failed.append(name)
        torch.cuda.empty_cache()
    return failed


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probes", nargs="*", metavar="probe",
                        help=f"probes to run (default: {' '.join(DEFAULT_PROBES)}); any of "
                             f"{', '.join(PROBES)}")
    parser.add_argument("--iters", type=int, default=5, help="timed samples per measurement")
    args = parser.parse_args(argv)
    names = args.probes or list(DEFAULT_PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        parser.error(f"unknown probes {unknown}; the probes are {', '.join(PROBES)}")
    _device()
    print(f"# device: {torch.cuda.get_device_name()}", file=sys.stderr, flush=True)
    return 1 if run(names, args.iters) else 0


if __name__ == "__main__":
    sys.exit(main())
