"""Kernel A's design alternatives, timed on the CUDA card beside the kernel.

    python -m humanvid_tpu_torch.tools.flash_variants [variant ...] [--iters N]

Each variant is ``csrc/flash_attention.cu`` with a few named text edits
(``VARIANTS``), built by nvcc with the port's flags into ``build/`` and
called through the same C entry point; ``kernel`` is the source unchanged.
At each of kernel A's main-path shapes (``SHAPES``, those of
``chip_smoke.py``) every variant that computes the same function is first
held to the plain version on 128 query rows (``chip_smoke.py``'s limits);
the ablations, which drop work and so compute something else, are only
timed. Then all are timed by CUDA events in turns (the list, then the list
reversed; ``ms`` is the better turn), with SDPA on the same inputs. One JSON
line per (shape, variant). Without a card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import cuda_build
from ..ops import flash_attention as fa

FLASH_TOL = (1e-2, 0.2)  # chip_smoke.py's limits: rel L2, max err / rms(plain)
LSE_TOL = 1e-3
# (name, B, Lq, Lk, heads, d, rows whose second half of keys the bias hides)
SHAPES = (("level0 cond", 24, 6144, 12288, 8, 40, 0),
          ("level0 uncond", 24, 6144, 6144, 8, 40, 0),
          ("level0 batched CFG bias", 48, 6144, 12288, 8, 40, 24),
          ("level1 cond", 24, 1536, 3072, 8, 80, 0),
          ("VAE mid", 8, 6144, 6144, 1, 512, 0))

_EXP = "sc[i] = fast_exp2(fmaf(sc[i], mul, -m_use[(i >> 1) & 1]));"
_HELPERS = "// Byte offset of the 16-deep step kk"
_EXP2_POLY = r'''// 2^x for x <= 0 on the FMA pipe: x = j + f, j = rint(x), |f| <= 1/2, 2^f
// by its degree-4 Taylor polynomial, 2^j added to the exponent field.
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: j in the low mantissa bits
  const float f = x - (t - 12582912.f);
  float p = fmaf(0.009618129f, f, 0.05550411f);
  p = fmaf(p, f, 0.2402265f);
  p = fmaf(p, f, 0.6931472f);
  p = fmaf(p, f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

'''
_PACK_INT = r'''// bf16 pair by integer rounding (half up; p >= 0) and a byte permute
__device__ __forceinline__ uint32_t pack_bf16x2_int(float lo, float hi) {
  const uint32_t a = __float_as_uint(lo) + 0x8000u, b = __float_as_uint(hi) + 0x8000u;
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x7632;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

'''
_NO_SOFTMAX = ("    // online softmax, log2 domain, in place", "    // P as bf16",
               "    float alpha[2] = {1.f, 1.f};\n")
_NO_LOADS = (("    if (warp != 0) return;\n", None, "    return;\n"),
             ("  mbar_wait(full_q, 0);\n", None, ""),
             ("    mbar_wait(&full_k[s], parity);\n", None, ""),
             ("    mbar_wait(&full_v[s], parity);\n", None, ""))

# name -> (edits, ablation); an edit (start, end, new) replaces the text from
# `start` up to `end` (just `start` when end is None), each found exactly once
Edit = Tuple[str, Optional[str], str]
VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # 2 consumer warpgroups (BQ = 128) at d <= 80 instead of 3
    "two_consumers": ((("Cfg<48, 40, false, 3>", None, "Cfg<48, 40, false, 2>"),
                       ("Cfg<80, 80, false, 3>", None, "Cfg<80, 80, false, 2>")), False),
    # one p in 8 by a polynomial on the FMA pipe instead of the SFU's ex2
    "exp2_poly_1in8": (((_HELPERS, None, _EXP2_POLY + _HELPERS),
                        (_EXP, None, "sc[i] = (i / 8) % 8 == 7 ? exp2_poly(fmaf(sc[i], mul, "
                                     "-m_use[(i >> 1) & 1])) : fast_exp2(fmaf(sc[i], mul, "
                                     "-m_use[(i >> 1) & 1]));")), False),
    # P's bf16 pack by integer rounding and a byte permute instead of F2FP
    "pack_int": (((_HELPERS, None, _PACK_INT + _HELPERS),
                  ("p[t][i] = pack_bf16x2(", None, "p[t][i] = pack_bf16x2_int(")), False),
    # ablations: each removes one part of the work
    "no_exp2": (((_EXP, None, "sc[i] = fmaf(sc[i], mul, -m_use[(i >> 1) & 1]);"),), True),
    "no_softmax": ((_NO_SOFTMAX,), True),
    "no_loads": (_NO_LOADS, True),
    "no_loads_no_softmax": (_NO_LOADS + (_NO_SOFTMAX,), True),
}


def variant_source(name: str) -> str:
    """The kernel source with the variant's edits; raises if an edit's text
    is not found exactly once."""
    text = (cuda_build.CSRC / "flash_attention.cu").read_text()
    for start, end, new in VARIANTS[name][0]:
        if text.count(start) != 1 or (end is not None and text.count(end) != 1):
            raise ValueError(f"variant {name}: edit anchor {start!r} not found exactly once")
        a = text.index(start)
        b = a + len(start) if end is None else text.index(end, a)
        text = text[:a] + new + text[b:]
    return text


def _build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build every variant with one nvcc each, all started together."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = variant_source(name)
        digest = hashlib.sha1((text + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:12]
        src = cuda_build.BUILD_DIR / f"flash_variant_{name}-{digest}.cu"
        lib = src.with_suffix(".so")
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).hv_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        libs[name] = fn
    return libs


def _time_ms(fn, iters: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(names: Sequence[str], iters: int = 5) -> List[dict]:
    """Check and time the named variants at every shape; returns the records
    (also printed, one JSON line each). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    fns = _build(names)
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []
    for shape, B, lq, lk, heads, d, bias_rows in SHAPES:
        q, k, v = (torch.randn((B, n, heads * d), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (lq, lk, lk))
        bias, unmasked = None, B * lk
        if bias_rows:
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked -= bias_rows * (lk // 2)
        out, lse = torch.empty_like(q), torch.empty((B, heads, lq), device=dev)

        def call(name):
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if bias is None else bias.data_ptr(), out.data_ptr(),
                            lse.data_ptr(), B, lq, lk, heads, d, stream)
            cuda_build.check(err, f"variant {name}")

        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = fa.flash_attention_plain(q[:, rows], k, v, heads, bias)
        checks = {}
        for name in names:
            if VARIANTS[name][1]:
                checks[name] = (None, None, None)
                continue
            call(name)
            torch.cuda.synchronize()
            diff = out[:, rows].float() - ref.float()
            rel = (diff.norm() / ref.float().norm()).item()
            lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
            ok = (rel <= FLASH_TOL[0] and lse_err <= LSE_TOL and diff.abs().max().item()
                  <= FLASH_TOL[1] * ref.float().pow(2).mean().sqrt().item())
            checks[name] = (ok, rel, lse_err)
        turns = {name: [] for name in names}
        for name in list(names) + list(names)[::-1]:
            turns[name].append(_time_ms(lambda: call(name), iters))
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), iters)
        flops = 4.0 * heads * lq * unmasked * d
        for name in names:
            ms = min(turns[name])
            ok, rel, lse_err = checks[name]
            rec = dict(variant=name, shape=shape, ms=ms, turns=turns[name],
                       tflops=flops / ms / 1e9, sdpa_ms=sdpa_ms, ablation=VARIANTS[name][1],
                       ok=ok, rel_l2=rel, lse_err=lse_err, device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return records


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help=f"variants to run (default: all): {', '.join(VARIANTS)}")
    parser.add_argument("--iters", type=int, default=5, help="launches per timed turn")
    args = parser.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; the variants are {', '.join(VARIANTS)}")
    if "kernel" not in names:
        names = ["kernel", *names]
    records = run(names, args.iters)
    return 0 if all(r["ok"] is not False for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
