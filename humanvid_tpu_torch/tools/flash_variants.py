"""Kernel A's design alternatives, timed on the CUDA card beside the kernel.

    python -m humanvid_tpu_torch.tools.flash_variants [variant ...] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --bwd [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --pvt [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --dmajor [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --hbm [variant ...]
        [--against FILE] [--iters N]

Each variant is ``csrc/flash_attention.cu`` with a few named text edits
(``VARIANTS``), built by nvcc with the port's flags into ``build/`` and
called through the same C entry point; ``kernel`` is the source unchanged.
With ``--bwd`` the variants are those of the backward's source
``csrc/flash_attention_bwd.cu`` at d <= 80 (``BWD_VARIANTS``, at
``BWD_SHAPES``): each is held to the plain backward, its dk/dv and dq
entry points are timed apart in turns, and SDPA's backward beside them;
``--against FILE`` adds another backward source with the same entry points
(an earlier commit's, unpacked by ``git archive``) as the variant
``against``. The ablations drop work, so they are only timed.
With ``--pvt`` the variants are those of kernel 9, the transposed flash
forward ``csrc/probe_pvt.cu`` (``PVT_VARIANTS``, at ``PVT_SHAPES``), among
them the product O = P V un-transposed; each is held to
``probe_kernels.pvt_plain`` and timed beside kernel A and SDPA on the same
inputs, which is what the transposed orientation costs; ``--against FILE``
adds another kernel-9 source the same way.
With ``--dmajor`` the variants are those of kernel 8, the orientation
probe ``csrc/probe_dmajor.cu`` (``DMAJOR_VARIANTS``: consumer counts, key
tile, ring depths, block rows, V's layout, and ablations of the QK arms
without K's loads, without the products or without the stores), at the
microbench probe's five arms and the d-major control at d = 128
(``DMAJOR_CASES``), each but the ablations held to
``probe_kernels.dmajor_plain``, all timed beside ``torch.bmm`` on the same
operands; with ``--hbm`` those of kernel 10, the streaming map
``csrc/probe_hbm.cu`` (``HBM_VARIANTS``: 4 loads a thread, the grids of one
wave, the bulk ring), at the microbench probe's three shapes
(``HBM_SHAPES``), each equal to ``hbm_map_plain`` to the bit and timed
beside ``torch.add(x, 0.5, out=out)`` and ``out.copy_(x)``. In both modes a
timed turn is 20 x ``--iters`` launches, and ``--against FILE`` adds
another source with the same C entry point (kernel 10's ``against`` is
given the grid an earlier source took as its ``blocks``: ``hbm_blocks``
capped at 8 blocks an SM).
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
from pathlib import Path
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

FLASH_BWD_TOL = (1e-3, 0.2)  # chip_smoke.py's limits for each of dq, dk, dv
# (name, B, Lq, Lk, heads, d, rows whose second half of keys the bias hides):
# the stage-2 shapes (896x512x24f) and the stage-1 ReferenceNet's
BWD_SHAPES = (("level0 cond", 24, 7168, 14336, 8, 40, 0),
              ("level0 uncond", 24, 7168, 14336, 8, 40, 24),
              ("level1 cond", 24, 1792, 3584, 8, 80, 0),
              ("refnet level0 self", 8, 7168, 7168, 8, 40, 0),
              ("VAE mid d512", 8, 6144, 6144, 1, 512, 0))
_DKV48 = "using DkvCfg48 = BwdCfg<48, 40, 8, 3, 64, 3>;"
_DKV80 = "using DkvCfg80 = BwdCfg<80, 80, 8, 2, 64, 3>;"
_DKV80S = "using DkvCfg80s = BwdCfg<80, 80, 16, 2, 64, 3>;"
_DQ48 = "using DqCfg48 = BwdCfg<48, 40, 8, 3, 128, 3, 64>;"
_DQ80 = "using DqCfg80 = BwdCfg<80, 80, 8, 2, 128, 3>;"
_DQ80S = "using DqCfg80s = BwdCfg<80, 80, 16, 2, 128, 3>;"


def _cfg_edits(new: Dict[str, str]) -> Tuple[Edit, ...]:
    """Edits that replace the named configurations' parameters."""
    cfgs = {"DkvCfg48": _DKV48, "DkvCfg80": _DKV80, "DkvCfg80s": _DKV80S, "DqCfg48": _DQ48,
            "DqCfg80": _DQ80, "DqCfg80s": _DQ80S}
    return tuple((cfgs[n], None, f"using {n} = BwdCfg<{p}>;") for n, p in new.items())


BWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # dk/dv at d <= 40: 2 consumer warpgroups (128-key blocks) instead of 3
    "dkv_two_consumers": (_cfg_edits({"DkvCfg48": "48, 40, 8, 2, 64, 3"}), False),
    # dq at d <= 40: 2 consumer warpgroups, dp over all 128 keys at once
    "dq_two_consumers": (_cfg_edits({"DqCfg48": "48, 40, 8, 2, 128, 3"}), False),
    # dq: 3 consumer warpgroups (192-row blocks) on 64-key tiles
    "dq_three_consumers_64_keys": (_cfg_edits({"DqCfg48": "48, 40, 8, 3, 64, 3",
                                               "DqCfg80": "80, 80, 8, 3, 64, 3",
                                               "DqCfg80s": "80, 80, 16, 3, 64, 3"}), False),
    # dq: 2 consumer warpgroups on 64-key tiles
    "dq_64_keys": (_cfg_edits({"DqCfg48": "48, 40, 8, 2, 64, 3",
                               "DqCfg80": "80, 80, 8, 2, 64, 3",
                               "DqCfg80s": "80, 80, 16, 2, 64, 3"}), False),
    # rings of 2 or 4 stages instead of 3
    "two_stages": (_cfg_edits({"DkvCfg48": "48, 40, 8, 3, 64, 2",
                               "DkvCfg80": "80, 80, 8, 2, 64, 2",
                               "DkvCfg80s": "80, 80, 16, 2, 64, 2",
                               "DqCfg48": "48, 40, 8, 3, 128, 2, 64",
                               "DqCfg80": "80, 80, 8, 2, 128, 2",
                               "DqCfg80s": "80, 80, 16, 2, 128, 2"}), False),
    "four_stages": (_cfg_edits({"DkvCfg48": "48, 40, 8, 3, 64, 4",
                                "DkvCfg80": "80, 80, 8, 2, 64, 4",
                                "DkvCfg80s": "80, 80, 16, 2, 64, 4",
                                "DqCfg48": "48, 40, 8, 3, 128, 4, 64",
                                "DqCfg80": "80, 80, 8, 2, 128, 4",
                                "DqCfg80s": "80, 80, 16, 2, 128, 4"}), False),
    # d = 48, 64, 80 on 8-column boxes without swizzle instead of 16-column
    # boxes in the 32-byte swizzle
    "no_swizzle_d80": (_cfg_edits({"DkvCfg80s": "80, 80, 8, 2, 64, 3",
                                   "DqCfg80s": "80, 80, 8, 2, 128, 3"}), False),
    # hidden key tiles computed instead of passed over
    "no_skip": ((("constexpr float kHiddenBias = -1e9f;", None,
                  "constexpr float kHiddenBias = -INFINITY;"),), False),
    # d = 512: dV's ring of one 32-row stage instead of two
    "wide_dv_one_stage": ((("using WideDv = WideCfg<kDv, 32, 2>;", None,
                            "using WideDv = WideCfg<kDv, 32, 1>;"),), False),
    # d = 512: dK's and dQ's steps of 16 rows in a 2-stage ring instead of
    # 32 rows in one stage
    "wide_dk_dq_16_rows": ((("using WideDk = WideCfg<kDk, 32, 1>;", None,
                             "using WideDk = WideCfg<kDk, 16, 2>;"),
                            ("using WideDq = WideCfg<kDq, 32, 1>;", None,
                             "using WideDq = WideCfg<kDq, 16, 2>;")), False),
    # ablations: the streamed tiles never loaded (the ring still turns), or
    # p = s without exp2
    "no_stream_loads": ((("      if (skip) {\n", None, "      if (true) {\n"),), True),
    "no_exp2": ((('#include "hopper.cuh"\n', None,
                  '#include "hopper.cuh"\n#define fast_exp2(x) (x)\n'),), True),
    "no_stream_loads_no_exp2": ((("      if (skip) {\n", None, "      if (true) {\n"),
                                 ('#include "hopper.cuh"\n', None,
                                  '#include "hopper.cuh"\n#define fast_exp2(x) (x)\n')),
                                True),
}


# kernel 9 (csrc/probe_pvt.cu) at the microbench probe's shapes: (name, B,
# Lq, Lk, heads, d, every 7th key hidden)
PVT_SHAPES = (("level0 cond", 24, 6144, 12288, 8, 40, False),
              ("every 7th key hidden", 2, 1024, 2048, 8, 40, True))
_PVT_CFG48 = "PvtCfg<48, 1, 48, 3>"
PVT_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # O (queries x [V | 1]) += P V with A = P from shared memory (N = 48 at
    # d = 40) instead of O^T += V^T P^T (M = 64)
    "pv_untransposed": ((("constexpr bool kTransposedPV = true;", None,
                          "constexpr bool kTransposedPV = false;"),), False),
    # 2 consumer warpgroups (128-query blocks) at d <= 40 instead of 3
    "two_consumers": (((_PVT_CFG48, None, "PvtCfg<48, 1, 48, 2>"),), False),
    # ablation: each warp takes its own column max, without the exchange
    # between the 4 warps of a warpgroup (and its named barrier)
    "no_max_exchange": ((("    named_bar_sync(bar_id, 128);\n    float m_use_l[2]", None,
                          "    float m_use_l[2]"),
                         ("float x = fmaxf(fmaxf(red[", "const float m_new",
                          "float x = v1[e];\n      "),), True),
}


# kernel 8 (csrc/probe_dmajor.cu) at the microbench probe's arms: (tag, arm,
# d), each at G = 64, lq = 1024, lk = 2048
DMAJOR_CASES = (("qk_d_on_lanes", "qk_d_on_lanes", 40),
                ("qk_d_on_sublanes", "qk_d_on_sublanes", 40),
                ("pv_d_on_lanes", "pv_d_on_lanes", 40),
                ("pv_dmajor_out", "pv_dmajor_out", 40),
                ("qk_d128_lanes", "qk_d_on_lanes", 128),
                ("qk_d128_sublanes", "qk_d_on_sublanes", 128))
DMAJOR_SIZES = (64, 1024, 2048)  # G, lq, lk
DMAJOR_TOL = (4e-3, 0.05)  # chip_smoke.py's limits: rel L2, max err / rms(plain)


def _set_const(name: str, old: int, new: int) -> Edit:
    """An edit of the source's ``constexpr int name = old;``."""
    return (f"constexpr int {name} = {old};", None, f"constexpr int {name} = {new};")


_PV_V_8_COLUMNS = ("constexpr bool kPvVSwizzled = true;", None,
                   "constexpr bool kPvVSwizzled = false;")
_QK_K_LOADS = "      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);\n      if constexpr (DMAJOR) {"
_QK_PRODUCTS = "#pragma unroll\n    for (int kk = 0; kk < C::KSTEPS; ++kk)\n      WgmmaSSt<BK>"
DMAJOR_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # QK: 2 consumer warpgroups (128-row blocks, K read from L2 twice as
    # often) on 256-key (2 stages at d = 128) or 128-key stages, or 3
    # (192-row blocks)
    "qk_consumers_2_keys_256": ((_set_const("kQkConsumers", 4, 2),
                                 _set_const("kQkKeys", 128, 256),
                                 _set_const("kQkStagesWide", 3, 2)), False),
    "qk_consumers_2": ((_set_const("kQkConsumers", 4, 2),), False),
    "qk_consumers_3": ((_set_const("kQkConsumers", 4, 3),), False),
    # QK: rings of 2 stages instead of 4 (d <= 48) and 3 (d = 128)
    "qk_stages_2": ((_set_const("kQkStagesNarrow", 4, 2),
                     _set_const("kQkStagesWide", 3, 2)), False),
    # QK: rings of 8 stages at d <= 48 (d = 128 has no room for a fourth)
    "qk_stages_8": ((_set_const("kQkStagesNarrow", 4, 8),), False),
    # PV: rings of 4 stages (two blocks an SM) or 3 (three) instead of 6
    "pv_stages_4": ((_set_const("kPvStages", 6, 4),), False),
    "pv_stages_3": ((_set_const("kPvStages", 6, 3),), False),
    # pv_d_on_lanes: V from d / 8 8-column boxes without swizzle, as kernel
    # A takes V, instead of one 64-column box; with 4 stages, the first design
    "pv_v_8_columns": ((_PV_V_8_COLUMNS,), False),
    "pv_stages_4_v_8_columns": ((_PV_V_8_COLUMNS, _set_const("kPvStages", 6, 4)), False),
    # PV: blocks of 64 rows (queries), or 256 on 4 stages, instead of 128
    "pv_rows_64": ((_set_const("kPvRows", 128, 64),), False),
    "pv_rows_256_stages_4": ((_set_const("kPvRows", 128, 256),
                              _set_const("kPvStages", 6, 4)), False),
    # ablations of the QK arms: K never loaded (the ring still turns, the
    # products read stale tiles), no products (the loads alone), or nothing
    # stored
    "qk_no_k_loads": (((_QK_K_LOADS, None, "      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);"
                        "\n      mbar_arrive(&full[s]);\n      continue;\n"
                        "      if constexpr (DMAJOR) {"),), True),
    "qk_no_products": (((_QK_PRODUCTS, None, "    for (int kk = 0; kk < 0; ++kk)\n"
                         "      WgmmaSSt<BK>"),), True),
    "qk_no_store": ((("    if (kt == 0) {\n      // the stored columns", None,
                      "    if (false) {\n      // the stored columns"),), True),
}

# kernel 10 (csrc/probe_hbm.cu) at the microbench probe's shapes
HBM_SHAPES = (("vae_hi", (8, 768, 512, 128)), ("vae_mid", (8, 384, 256, 256)),
              ("unet_l0", (24, 96, 64, 320)))
_RING = ("constexpr bool kBulkRing = false;", None, "constexpr bool kBulkRing = true;")
HBM_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # the unrolled design with 4 independent 16-byte loads a thread
    "hbm_unroll4": ((_set_const("kUnroll", 1, 4),), False),
    # the same on a grid of one wave of resident blocks, in a grid-stride
    # loop, with 4 loads a thread (design (a)) or 1
    "hbm_one_wave_unroll4": ((_set_const("kUnroll", 1, 4), _set_const("kWaves", 0, 1)), False),
    "hbm_one_wave": ((_set_const("kWaves", 0, 1),), False),
    # the bulk ring (design (b)): 4 stages of 32 KB (one block an SM), 3
    # stages (two blocks an SM), 8 stages of 16 KB
    "hbm_bulk_ring": ((_RING,), False),
    "hbm_ring_3_stages": ((_RING, _set_const("kStages", 4, 3)), False),
    "hbm_ring_16k_8_stages": ((_RING, _set_const("kChunk", 32768, 16384),
                               _set_const("kStages", 4, 8)), False),
}


def variant_source(name: str, variants=None, source: str = "flash_attention.cu") -> str:
    """The kernel source with the variant's edits; raises if an edit's text
    is not found exactly once."""
    variants = VARIANTS if variants is None else variants
    text = (cuda_build.CSRC / source).read_text()
    for start, end, new in variants[name][0]:
        if text.count(start) != 1 or (end is not None and text.count(end) != 1):
            raise ValueError(f"variant {name}: edit anchor {start!r} not found exactly once")
        a = text.index(start)
        b = a + len(start) if end is None else text.index(end, a)
        text = text[:a] + new + text[b:]
    return text


def _build(texts: Dict[str, str], prefix: str = "flash_variant") -> Dict[str, ctypes.CDLL]:
    """Build every variant's source with one nvcc each, all started together."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        digest = hashlib.sha1((text + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:12]
        src = cuda_build.BUILD_DIR / f"{prefix}_{name}-{digest}.cu"
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
        for line in log.splitlines():  # ptxas's registers, spills and wgmma notes
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[{name}] {line.strip()}", file=sys.stderr)
        libs[name] = ctypes.CDLL(str(lib))
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
    fns = {}
    for name, lib in _build({n: variant_source(n) for n in names}).items():
        fn = fns[name] = lib.hv_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def _sdpa_backward_ms(q, k, v, g, heads, bias, iters: int) -> Optional[float]:
    """SDPA's backward through autograd on head-split copies; None where
    the card's memory does not hold it."""
    b, d = q.shape[0], q.shape[2] // heads

    def split(t):
        return t.view(b, t.shape[1], heads, d).transpose(1, 2).contiguous()

    mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
    try:
        leaves = [split(t).requires_grad_() for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)
        gh = split(g)
        return _time_ms(lambda: torch.autograd.grad(out, leaves, gh, retain_graph=True), iters)
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def run_bwd(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """The backward's variants at every shape of ``BWD_SHAPES``: each held to
    the plain backward (``chip_smoke.py``'s limits per gradient, and whether
    its bits equal ``kernel``'s), its dk/dv and dq entry points timed apart
    in turns. Returns the records (also printed, one JSON line each)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts = {n: variant_source(n, BWD_VARIANTS, "flash_attention_bwd.cu") for n in names}
    if against:
        texts["against"] = Path(against).read_text()
    fns = {}
    for name, lib in _build(texts, "flash_bwd_variant").items():
        dkv, dq = lib.hv_flash_bwd_dkv, lib.hv_flash_bwd_dq
        dkv.restype = dq.restype = ctypes.c_int
        dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[name] = (dkv, dq)
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    records = []
    for shape, B, lq, lk, heads, d, bias_rows in BWD_SHAPES:
        c = heads * d
        q, g = (torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((B, lk, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias, unmasked = None, B * lk
        if bias_rows:
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked -= bias_rows * (lk // 2)
        out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        delta = fa.attention_delta(g, out, heads)
        refs = fa.flash_attention_backward_plain(q, k, v, bias, g, lse, delta, heads)
        del out
        grads = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())

        def call_dkv(name):
            cuda_build.check(fns[name][0](*common, grads[1].data_ptr(), grads[2].data_ptr(),
                                          B, lq, lk, heads, d, stream), f"variant {name} dk/dv")

        def call_dq(name):
            cuda_build.check(fns[name][1](*common, grads[0].data_ptr(), B, lq, lk, heads, d,
                                          stream), f"variant {name} dq")

        checks, first = {}, None
        for name in fns:
            if name in BWD_VARIANTS and BWD_VARIANTS[name][1]:
                checks[name] = (None, None, None)
                continue
            call_dkv(name)
            call_dq(name)
            torch.cuda.synchronize()
            rels, ok = [], True
            for got, ref in zip(grads, refs):
                diff = got.float() - ref.float()
                rels.append((diff.norm() / ref.float().norm()).item())
                ok = ok and rels[-1] <= FLASH_BWD_TOL[0] and diff.abs().max().item() <= \
                    FLASH_BWD_TOL[1] * ref.float().pow(2).mean().sqrt().item()
            if first is None:
                first = [t.clone() for t in grads]
            same = all(torch.equal(a, b) for a, b in zip(grads, first))
            checks[name] = (ok, max(rels), same)
        del first
        turns = {name: ([], []) for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            turns[name][0].append(_time_ms(lambda: call_dkv(name), iters))
            turns[name][1].append(_time_ms(lambda: call_dq(name), iters))
        del refs
        torch.cuda.empty_cache()
        sdpa_ms = _sdpa_backward_ms(q, k, v, g, heads, bias, iters)
        flops = 10.0 * heads * lq * unmasked * d
        for name in fns:
            dkv_ms, dq_ms = min(turns[name][0]), min(turns[name][1])
            ok, rel, same = checks[name]
            rec = dict(variant=name, shape=shape, ms=dkv_ms + dq_ms, dkv_ms=dkv_ms, dq_ms=dq_ms,
                       dkv_turns=turns[name][0], dq_turns=turns[name][1],
                       tflops=flops / (dkv_ms + dq_ms) / 1e9, sdpa_ms=sdpa_ms,
                       ablation=name in BWD_VARIANTS and BWD_VARIANTS[name][1], ok=ok,
                       rel_l2=rel, same_bits_as_first=same,
                       device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, g, lse, delta, grads
        torch.cuda.empty_cache()
    return records


def run_pvt(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """Kernel 9's variants at every shape of ``PVT_SHAPES``: each held to
    ``pvt_plain`` on 128 query rows (``chip_smoke.py``'s limits, lse in log2
    units), then timed in turns beside kernel A (``flash_attention_cuda``)
    and SDPA on the same inputs. Returns the records (also printed)."""
    from . import probe_kernels as pk

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts = {n: variant_source(n, PVT_VARIANTS, "probe_pvt.cu") for n in names}
    if against:
        texts["against"] = Path(against).read_text()
    fns = {}
    for name, lib in _build(texts, "probe_pvt_variant").items():
        fn = fns[name] = lib.hv_probe_pvt
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    records = []
    for shape, B, lq, lk, heads, d, every7 in PVT_SHAPES:
        q, k, v = (torch.randn((B, n, heads * d), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (lq, lk, lk))
        bias = None
        if every7:
            bias = torch.where(torch.arange(lk, device=dev) % 7 == 0, -1e9, 0.0)
            bias = bias.expand(B, lk).contiguous()
        qs = pk._prescale(q, heads)
        out, lse = torch.empty_like(q), torch.empty((B, heads, lq), device=dev)

        def call(name):
            cuda_build.check(fns[name](qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       None if bias is None else bias.data_ptr(),
                                       out.data_ptr(), lse.data_ptr(), B, lq, lk, heads, d,
                                       stream), f"variant {name}")

        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = pk.pvt_plain(q[:, rows], k, v, heads, bias)
        checks = {}
        for name in fns:
            if name in PVT_VARIANTS and PVT_VARIANTS[name][1]:
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
        turns = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            turns[name].append(_time_ms(lambda: call(name), iters))
        kernel_a_ms = _time_ms(lambda: fa.flash_attention_cuda(q, k, v, heads, bias), iters)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), iters)
        unmasked = B * lk if bias is None else int((bias == 0).sum().item())
        flops = 4.0 * heads * lq * unmasked * d
        for name in fns:
            ms = min(turns[name])
            ok, rel, lse_err = checks[name]
            rec = dict(variant=name, shape=shape, ms=ms, turns=turns[name],
                       tflops=flops / ms / 1e9, kernel_a_ms=kernel_a_ms, sdpa_ms=sdpa_ms,
                       ablation=name in PVT_VARIANTS and PVT_VARIANTS[name][1], ok=ok,
                       rel_l2=rel, lse_err=lse_err, device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, qs, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return records


def _named_sources(names, variants, source, against):
    texts = {n: variant_source(n, variants, source) for n in names}
    if against:
        texts["against"] = Path(against).read_text()
    return texts


def _turns(calls: Dict[str, object], reps: int) -> Dict[str, List[float]]:
    """ms per launch of each call, timed in turns: the list, then reversed."""
    turns = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        turns[name].append(_time_ms(calls[name], reps))
    return turns


def run_dmajor(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """Kernel 8's variants at every arm of ``DMAJOR_CASES``: each held to
    ``dmajor_plain`` (``chip_smoke.py``'s limits; ``pv_d_on_lanes``'
    padding exactly zero), then timed in turns beside ``torch.bmm`` of the
    same operands. Returns the records (also printed, one JSON line each)."""
    from . import probe_kernels as pk

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    fns = {}
    for name, lib in _build(_named_sources(names, DMAJOR_VARIANTS, "probe_dmajor.cu", against),
                            "probe_dmajor_variant").items():
        fn = fns[name] = lib.hv_probe_dmajor
        fn.restype = ctypes.c_int
        fn.argtypes = pk.DMAJOR_ARGTYPES
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    G, lq, lk = DMAJOR_SIZES
    records = []
    for tag, arm, d in DMAJOR_CASES:
        shapes = {"qk_d_on_lanes": ((lq, d), (lk, d)), "qk_d_on_sublanes": ((d, lq), (d, lk)),
                  "pv_d_on_lanes": ((lq, lk), (lk, d)),
                  "pv_dmajor_out": ((d, lk), (lq, lk))}[arm]
        a, b = (torch.randn((G,) + s, generator=gen, device=dev).to(torch.bfloat16)
                for s in shapes)
        ref = pk.dmajor_plain(arm, a, b).float()
        out = torch.empty(ref.shape, dtype=torch.bfloat16, device=dev)
        args = (pk.DMAJOR_ARMS[arm], a.data_ptr(), b.data_ptr(), out.data_ptr(), None, G, lq,
                lk, d, stream)
        calls = {name: (lambda fn=fns[name], name=name:
                        cuda_build.check(fn(*args), f"variant {name}")) for name in fns}
        checks = {}
        for name in fns:
            if name in DMAJOR_VARIANTS and DMAJOR_VARIANTS[name][1]:
                checks[name] = (None, None)  # an ablation computes something else
                continue
            out.zero_()
            calls[name]()
            torch.cuda.synchronize()
            diff = out.float() - ref
            rel = (diff.norm() / ref.norm()).item()
            ok = (rel <= DMAJOR_TOL[0] and diff.abs().max().item()
                  <= DMAJOR_TOL[1] * ref.pow(2).mean().sqrt().item())
            if arm == "pv_d_on_lanes":
                out.fill_(1.0)
                calls[name]()
                torch.cuda.synchronize()
                ok = ok and bool((out[:, :, d:] == 0).all())
            checks[name] = (ok, rel)
        turns = _turns(calls, 20 * iters)
        lib_fn = {"qk_d_on_lanes": lambda: torch.bmm(a, b.transpose(1, 2)),
                  "qk_d_on_sublanes": lambda: torch.bmm(a.transpose(1, 2), b),
                  "pv_d_on_lanes": lambda: torch.bmm(a, b),
                  "pv_dmajor_out": lambda: torch.bmm(a, b.transpose(1, 2))}[arm]
        library_ms = _time_ms(lib_fn, 20 * iters)
        flops = 2.0 * G * lq * lk * d
        nbytes = 2.0 * (a.numel() + b.numel() + out.numel())
        bound_ms = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        for name in fns:
            ms = min(turns[name])
            ok, rel = checks[name]
            rec = dict(variant=name, shape=f"{tag} G={G} {lq}x{lk} d={d}", ms=ms,
                       turns=turns[name], tflops=flops / ms / 1e9, gbs=nbytes / ms / 1e6,
                       library_ms=library_ms, bound_ms=bound_ms,
                       ablation=name in DMAJOR_VARIANTS and DMAJOR_VARIANTS[name][1], ok=ok,
                       rel_l2=rel, device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del a, b, ref, out
        torch.cuda.empty_cache()
    return records


def run_hbm(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """Kernel 10's variants at every shape of ``HBM_SHAPES``: each equal to
    ``hbm_map_plain`` to the bit, then timed in turns beside ``torch.add(x,
    0.5, out=out)`` (the same function to the bit) and ``out.copy_(x)``.
    Returns the records (also printed, one JSON line each)."""
    from . import probe_kernels as pk

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    fns = {}
    for name, lib in _build(_named_sources(names, HBM_VARIANTS, "probe_hbm.cu", against),
                            "probe_hbm_variant").items():
        fn = fns[name] = lib.hv_probe_hbm
        fn.restype = ctypes.c_int
        fn.argtypes = pk.HBM_ARGTYPES
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    records = []
    for tag, shape in HBM_SHAPES:
        x = (torch.randn(shape, generator=gen, device=dev) * 4).to(torch.bfloat16)
        ref = pk.hbm_map_plain(x)
        out = torch.empty_like(x)
        n = x.numel()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        calls = {}
        for name, fn in fns.items():
            blocks = pk.hbm_blocks(n) if name != "against" else min(8 * sms, pk.hbm_blocks(n))
            args = (x.data_ptr(), out.data_ptr(), n, pk.HBM_SCALE_BF16, blocks, stream)
            calls[name] = (lambda fn=fn, name=name, args=args:
                           cuda_build.check(fn(*args), f"variant {name}"))
        checks = {}
        for name in fns:
            out.zero_()
            calls[name]()
            torch.cuda.synchronize()
            checks[name] = torch.equal(out, ref)
        turns = _turns(calls, 20 * iters)
        add_ms = _time_ms(lambda: torch.add(x, 0.5, out=out), 20 * iters)
        copy_ms = _time_ms(lambda: out.copy_(x), 20 * iters)
        nbytes = 4.0 * n
        for name in fns:
            ms = min(turns[name])
            rec = dict(variant=name, shape=f"{tag} {shape}", ms=ms, turns=turns[name],
                       gbs=nbytes / ms / 1e6, library_ms=add_ms, copy_ms=copy_ms,
                       bound_ms=nbytes / 3.35e12 * 1e3, ok=checks[name],
                       device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del x, ref, out
        torch.cuda.empty_cache()
    return records


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help=f"variants to run (default: all): {', '.join(VARIANTS)}; with "
                             f"--bwd: {', '.join(BWD_VARIANTS)}; with --pvt: "
                             f"{', '.join(PVT_VARIANTS)}; with --dmajor: "
                             f"{', '.join(DMAJOR_VARIANTS)}; with --hbm: {', '.join(HBM_VARIANTS)}")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--bwd", action="store_true", help="the backward's variants")
    mode.add_argument("--pvt", action="store_true", help="kernel 9's variants")
    mode.add_argument("--dmajor", action="store_true", help="kernel 8's variants")
    mode.add_argument("--hbm", action="store_true", help="kernel 10's variants")
    parser.add_argument("--against", metavar="FILE",
                        help="with --bwd, --pvt, --dmajor or --hbm: another source of the same "
                             "kernels, timed as 'against'")
    parser.add_argument("--iters", type=int, default=5,
                        help="launches per timed turn (20 times as many with --dmajor, --hbm)")
    args = parser.parse_args(argv)
    modes = {"bwd": (BWD_VARIANTS, run_bwd), "pvt": (PVT_VARIANTS, run_pvt),
             "dmajor": (DMAJOR_VARIANTS, run_dmajor), "hbm": (HBM_VARIANTS, run_hbm)}
    mode_name = next((m for m in modes if getattr(args, m)), None)
    table = modes[mode_name][0] if mode_name else VARIANTS
    names = args.variants or list(table)
    unknown = [n for n in names if n not in table]
    if unknown:
        parser.error(f"unknown variants {unknown}; the variants are {', '.join(table)}")
    if args.against and not mode_name:
        parser.error("--against needs --bwd, --pvt, --dmajor or --hbm")
    if "kernel" not in names:
        names = ["kernel", *names]
    if mode_name:
        records = modes[mode_name][1](names, args.iters, args.against)
    else:
        records = run(names, args.iters)
    return 0 if all(r["ok"] is not False for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
