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
    python -m humanvid_tpu_torch.tools.flash_variants --gn [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --temporal [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --temporal-bwd [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --xwide [variant ...]
        [--against FWD_FILE] [--against BWD_FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --mid [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --mid-bwd [variant ...]
        [--against FILE] [--iters N]
    python -m humanvid_tpu_torch.tools.flash_variants --own [variant ...]
        [--against FWD_FILE] [--against BWD_FILE] [--iters N]

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
With ``--gn`` the variants are those of kernel C, ``csrc/group_norm.cu``
(``GN_VARIANTS``: the two-pass kernels forced, the size rule's cluster
size, block size and slab floor moved, registers for 2 or 4 blocks an SM,
8 re-read rows in flight a thread, and ablations without the exchange over
the cluster, the TMA stores or the TMA loads), at ``chip_smoke.py``'s
channels_last shapes with SiLU (``GN_SHAPES``), each but the ablations
held to ``group_norm_act_plain`` and to its own bits on a repeat, with the
clusters of its one-pass kernel the card holds at once (a query the tool
appends to each source it builds), beside
``F.group_norm`` + ``F.silu``; ``against`` is another source's two-pass
entry point ``hv_group_norm_fwd``. With ``--temporal`` those of kernel B's
forward, ``csrc/temporal_attention.cu`` (``TEMPORAL_VARIANTS``: positions
per item, ring depth, consumer warps, and ablations without the loads, the
products or the stores), at the motion modules' four shapes, and those
of its split kernel (``SPLIT_VARIANTS``, ``SPLIT_FWD_VARIANTS``: half or
one position an item, slices of 80 columns, 2 ring slots, 4 consumer
warps, O stored by each consumer, ablations without the loads, the
exchange, the products or the stores) at the wide heads' shapes and one
frame (``TEMPORAL_SHAPES``), and past 32 frames those of its long kernel
(``LONG_VARIANTS``: the ring's depth and the heads an item through the
plan, the streamed panels where whole items fit, 32-frame panels, four
consumer warps) at ``chip_smoke.py``'s long cases
(``TEMPORAL_LONG_SHAPES``), beside SDPA on the head-split permuted views;
``against`` may be an earlier design with the earlier entry point (past 32
frames the earlier long kernel, whose per-warp cp.async copies are the
comparison the TMA items answer; at the wide heads, an earlier source
without the split kernel runs its column-chunk kernels). With
``--temporal-bwd`` those of kernel B's backward,
``csrc/temporal_attention_bwd.cu`` (``TEMPORAL_BWD_VARIANTS``: ring depth,
consumer warps, gradients in tiles of their own against over dead inputs,
P^T and dS^T through shared memory against ``movmatrix``, 32-row tiles at
f <= 16, and ablations without the loads, the products or the stores), at
the five stage-2 shapes and the stage-1 camera encoder's, and those of its
split kernel (``SPLIT_VARIANTS``, ``SPLIT_BWD_VARIANTS``: also the item
kept or q, k and g loaded again against the plan's choice, slices of 160
columns, the gradients stored by a store warp) at the wide heads' shapes
and one frame (``TEMPORAL_BWD_SHAPES``), and past 32 frames those of its
frames kernel (``FRAMES_BWD_VARIANTS``: ring depth and chunk width
through the plan, other numbers of consumer groups, registers for two
blocks an SM) at the
long_wide stage-2 shapes and f = 33, 64, 96, 100 and 128
(``TEMPORAL_BWD_LONG_SHAPES``, each variant up to its own frame count),
and past 128 frames those of its long kernel (``LONG_VARIANTS``) at
``chip_smoke.py``'s cases there (``TEMPORAL_BWD_PAST_SHAPES``), where
``long_at_frames`` also runs the long kernel at the frames kernel's
shapes; beside SDPA's backward; ``against`` may be an earlier design with
its entry point (past 32 frames, or past its own frames kernel's reach, an
earlier source runs its long kernel). A timed turn of both is 20 x
``--iters`` launches.
With ``--xwide`` those of kernel A past 512 columns, the xwide forward and
backward (``XWIDE_VARIANTS``: the plan's slice width, ring stages and
exchange buffers, which the same build takes as arguments, and hidden key
tiles computed instead of passed over, an edit of both sources), the
forward at the long_wide path's level-1 shapes (``XWIDE_SHAPES``) and the
backward's dk/dv and dq entry points timed apart at its stage-2 shapes
(``XWIDE_BWD_SHAPES``), each held to its plain version and to the bits of
``kernel``, beside SDPA; ``--against`` takes a forward source and a
backward source (an earlier commit's, called with its own entry points).
With ``--mid`` those of kernel A's forward between 128 and 512 columns, the
mid kernel (``MID_VARIANTS``: the other layout at d = 320, d rounded up to
128 instead of 64, hidden key tiles computed instead of passed over), at
d = 192 and the long_wide path's level-0 shapes at d = 320
(``MID_SHAPES``), each held to the plain version on 128 query rows and to
the bits of ``kernel``, timed in turns beside SDPA; ``--against`` takes an
earlier forward source, which runs these widths through the zero pad to
512: it is called on inputs padded beforehand (the pad copies, timed
apart, are ``pad_ms``).
With ``--mid-bwd`` those of kernel A's backward between 128 and 512
columns, ``csrc/flash_attention_mid_bwd.cu`` (``MID_BWD_VARIANTS``: a dV and
a dK kernel against the merged dk/dv kernel, dq by columns against dq by
role, ring depth, 32-row dk/dv and dq steps at d = 192, hidden key tiles
computed instead of passed over, and an ablation without the streamed
tiles' loads), at d = 192 and
the long_wide stage-2 step's level-0 shapes at d = 320 (``MID_BWD_SHAPES``),
each held to the plain backward on two batch rows and to the bits of
``kernel``, its dk/dv and dq entry points timed apart in turns, beside SDPA's
backward under each backend that runs the shape; ``--against`` takes an
earlier backward source, which runs these widths through the zero pad to
512: it is called on inputs padded beforehand (the four pad copies in and
the three slices out, timed apart, are ``pad_ms``; its ``ms`` adds them).
With ``--own`` those of kernel A at the head's own width (d = 64 and 80 < d
<= 128: ``flash_fwd_own_kernel`` and the backward's ``DkvOwn``/``DqOwn``;
``OWN_VARIANTS``: the pad on as before the own width, consumer counts, d =
128 without the ping-pong or the overlap, the overlap at every width, ring
depths, the backward's consumer counts and ring depth, hidden key tiles
computed instead of passed over, and the bias path on zero-bias tiles), the
forward at the smoke's heads64 and head-width shapes (``OWN_SHAPES``) and
the backward's dk/dv and dq entry points timed apart at its stage-2 shapes
(``OWN_BWD_SHAPES``), each held to its plain version and to the bits of
``kernel``, beside SDPA; ``--against`` takes a forward source and a
backward source (the parent commit's).
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
import contextlib
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


# kernel A past 512 columns (the xwide kernels) at the long_wide path's
# level-1 shapes: the forward's (name, B, Lq, Lk, heads, d, bias rows) and
# the backward's, the bias hiding the second half of the keys of its rows
XWIDE_SHAPES = (("long_wide level1 cond (ref KV) d640", 48, 1536, 3072, 1, 640, 0),
                ("long_wide level1 batched CFG bias d640", 96, 1536, 3072, 1, 640, 48),
                ("long_wide level1 uncond d640", 48, 1536, 1536, 1, 640, 0),
                ("d1280 level1-size", 8, 1536, 3072, 1, 1280, 0))
XWIDE_BWD_SHAPES = (("long_wide level1 uncond (CFG dropout bias) d640", 48, 1792, 3584, 1, 640,
                     48),
                    ("long_wide level1 cond (ref KV) d640", 48, 1792, 3584, 1, 640, 0))
_NO_SKIP = (("constexpr float kHiddenBias = -1e9f;", None,
             "constexpr float kHiddenBias = -INFINITY;"),)
_X_REMOTE_LOADS = "        for (int k = 0; k < 4; ++k) v[k] = ld_dsmem_f4(peer + k * 128 * 16);"
_X_OWN = ("        for (int k = 0; k < 4; ++k) v[k] = make_float4(x[16 * half + 4 * k], "
          "x[16 * half + 4 * k + 1], x[16 * half + 4 * k + 2], x[16 * half + 4 * k + 3]);")
# name: (edits of both sources, edits of csrc/xwide.cuh (inlined into both),
# the plan's slice, fields of the plan replaced, ablation)
XWIDE_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Tuple[Edit, ...], int, Dict[str, int],
                                bool]] = {
    "kernel": ((), (), fa.XWIDE_SLICE, {}, False),
    # slices of 128 columns: d = 640 in 5 blocks a cluster, balanced
    "slice_128": ((), (), 128, {}, False),
    # rings of other depths
    "fwd_stages_3": ((), (), fa.XWIDE_SLICE, {"fwd_stages": 3}, False),
    "bwd_stages_3": ((), (), fa.XWIDE_SLICE, {"bwd_stages": 3}, False),
    # the forward's exchange in one buffer (the next tile's partial waits
    # for the cluster's reads)
    "fwd_single_exchange": ((), (), fa.XWIDE_SLICE, {"fwd_exchange": 1}, False),
    # hidden key tiles loaded and multiplied
    "no_skip": (_NO_SKIP, (), fa.XWIDE_SLICE, {}, False),
    # ablations of the exchange: the other blocks' partials not read (each
    # block sums its own n times), or neither read nor waited for
    "no_remote_loads": ((), ((_X_REMOTE_LOADS, None, _X_OWN),), fa.XWIDE_SLICE, {}, True),
    "no_exchange": ((), (("  if (xbufs == 1 && use > 0) mbar_wait(empty, (use - 1) & 1);", None,
                          "  return;"),
                         ("  mbar_wait(empty, use & 1);\n}", None, "  (void)empty, (void)use;\n}"),
                         ("  if (uses == 0) return;", None, "  return;")),
                    fa.XWIDE_SLICE, {}, True),
}


def xwide_variant_plan(name: str, d: int) -> "fa.XwidePlan":
    """The plan the variant runs a d-wide head on."""
    _, _, slice_, fields, _ = XWIDE_VARIANTS[name]
    return fa.xwide_plan(d, slice_)._replace(**fields)


def xwide_variant_sources(name: str) -> Tuple[str, str]:
    """The forward's and the backward's source with the variant's edits;
    the edits of the shared header are made in a copy inlined in place of
    its #include."""
    edits, header_edits = XWIDE_VARIANTS[name][:2]
    if header_edits:
        header = variant_source(name, {name: (header_edits, False)}, "xwide.cuh")
        edits = edits + (('#include "xwide.cuh"\n', None, header),)
    table = {name: (edits, False)}
    return (variant_source(name, table, "flash_attention.cu"),
            variant_source(name, table, "flash_attention_bwd.cu"))

# kernel A at the head's own width (d = 64 and 80 < d <= 128: the forward's
# `flash_fwd_own_kernel`, the backward's `DkvOwn`/`DqOwn`) at the smoke's
# heads64 and head-width shapes: the forward's (name, B, Lq, Lk, heads, d,
# bias rows) and the backward's
OWN_SHAPES = (("heads64 level0 cond (ref KV) d64", 24, 6144, 12288, 5, 64, 0),
              ("heads64 level0 batched CFG bias d64", 48, 6144, 12288, 5, 64, 24),
              ("heads64 level1 cond (ref KV) d128", 24, 1536, 3072, 5, 128, 0),
              ("heads64 level1 batched CFG bias d128", 48, 1536, 3072, 5, 128, 24),
              ("level1-size d96", 24, 1536, 3072, 4, 96, 0),
              ("level1-size d112", 24, 1536, 3072, 4, 112, 0))
OWN_BWD_SHAPES = (("heads64 level0 cond (ref KV) d64", 24, 7168, 14336, 5, 64, 0),
                  ("heads64 level0 uncond (CFG dropout bias) d64", 24, 7168, 14336, 5, 64, 24),
                  ("heads64 level1 cond (ref KV) d128", 24, 1792, 3584, 5, 128, 0),
                  ("heads64 level1 uncond (CFG dropout bias) d128", 24, 1792, 3584, 5, 128, 24),
                  ("level1-size d96", 24, 1792, 3584, 4, 96, 0),
                  ("level1-size d112", 24, 1792, 3584, 4, 112, 0))
_OWN_ALIAS = "using Own = OwnCfg<W, CW, W <= 96 ? 3 : 2, W == 64 ? 4 : 3, W == 128, W == 128>;"
_DKV_OWN = "using DkvOwn = BwdCfg<W, W, CW, 2, 64, 3>;"
_DQ_OWN = "using DqOwn = BwdCfg<W, W, CW, W == 64 ? 3 : 2, 128, W <= 96 ? 3 : 2, 64>;"


def _own_alias(nc: str, stages: str, overlap: str, pp: str) -> Edit:
    return (_OWN_ALIAS, None, f"using Own = OwnCfg<W, CW, {nc}, {stages}, {overlap}, {pp}>;")


# name: (edits of the forward's source, edits of the backward's, ablation)
OWN_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Tuple[Edit, ...], bool]] = {
    "kernel": ((), (), False),
    # the pad on: d = 64 in d <= 80's tiles (depth and N 80), 96 and 112 in
    # the 128-wide tiles on 8-column boxes, as before the own width
    "pad_on": ((("  if (d == 64) return OWN(64, 64);\n", None, ""),
                ("return d == 96 ? OWN(96, 32) : OWN(96, 8);", None, "return OWN(128, 8);"),
                ("return d == 112 ? OWN(112, 16) : OWN(112, 8);", None, "return OWN(128, 8);")),
               (("  if (d == 64) return DKV(DkvOwn<64, 64>);\n", None, ""),
                ("  if (d == 64) return DQ(DqOwn<64, 64>);\n", None, ""),
                ("d == 96 ? DKV(DkvOwn<96, 32>) : DKV(DkvOwn<96, 8>)", None,
                 "DKV(DkvOwn<128, 8>)"),
                ("d == 112 ? DKV(DkvOwn<112, 16>) : DKV(DkvOwn<112, 8>)", None,
                 "DKV(DkvOwn<128, 8>)"),
                ("d == 96 ? DQ(DqOwn<96, 32>) : DQ(DqOwn<96, 8>)", None, "DQ(DqOwn<128, 8>)"),
                ("d == 112 ? DQ(DqOwn<112, 16>) : DQ(DqOwn<112, 8>)", None,
                 "DQ(DqOwn<128, 8>)")), False),
    # consumer counts: 2 consumer warpgroups (BQ = 128) at 64 and 96
    "two_consumers": ((_own_alias("2", "W == 64 ? 4 : 3", "W == 128", "W == 128"),), (), False),
    # d = 128 without the ping-pong, or without the overlap either; the
    # overlap at every width
    "no_pingpong": ((_own_alias("W <= 96 ? 3 : 2", "W == 64 ? 4 : 3", "W == 128", "false"),),
                    (), False),
    "no_overlap": ((_own_alias("W <= 96 ? 3 : 2", "W == 64 ? 4 : 3", "false", "false"),),
                   (), False),
    "overlap_all": ((_own_alias("W <= 96 ? 3 : 2", "W == 64 ? 4 : 3", "true", "W == 128"),),
                    (), False),
    # rings: 3 stages at 64, 2 at 128
    "fewer_stages": ((_own_alias("W <= 96 ? 3 : 2", "W == 128 ? 2 : 3", "W == 128",
                                 "W == 128"),), (), False),
    # the backward: dk/dv on 3 consumer warpgroups (192 keys) at 64; dk/dv
    # on a ring of 4
    "dkv_three_consumers": ((), ((_DKV_OWN, None,
                                  "using DkvOwn = BwdCfg<W, W, CW, W == 64 ? 3 : 2, 64, 3>;"),),
                            False),
    # dq at 64 on 2 consumer warpgroups, dP over all 128 keys at once
    "dq_two_consumers": ((), ((_DQ_OWN, None, "using DqOwn = BwdCfg<W, W, CW, 2, 128, "
                                              "W <= 96 ? 3 : 2, W == 64 ? 128 : 64>;"),), False),
    "dkv_four_stages": ((), ((_DKV_OWN, None, "using DkvOwn = BwdCfg<W, W, CW, 2, 64, 4>;"),),
                        False),
    # hidden key tiles loaded and multiplied
    "no_skip": (_NO_SKIP, _NO_SKIP, False),
    # the forward's bias path on every tile (zero-bias tiles too)
    "bias_every_tile": ((("return !reinterpret_cast<const int*>(bt)[BK + 1]; };", None,
                          "return bt != nullptr; };"),), (), False),
}


# kernel A's forward between 128 and 512 columns (the mid kernel) at the
# aim shapes: (name, B, Lq, Lk, heads, d, bias rows)
MID_SHAPES = (("d192 level1-size 5 heads", 24, 1536, 3072, 5, 192, 0),
              ("long_wide level0 cond (ref KV) d320", 48, 6144, 12288, 1, 320, 0),
              ("long_wide level0 uncond d320", 48, 6144, 6144, 1, 320, 0),
              ("long_wide level0 batched CFG bias d320", 96, 6144, 12288, 1, 320, 48))
_ROWS_320 = "    if (x_cluster == 1 && x_slice == 320) return MID(320, true);"
# name: (edits of csrc/flash_attention.cu, the plan's width: None for d
# rounded up to 64, "128" for d rounded up to 128; the only plan width the
# variant runs at, or None for every width; ablation). A variant whose plan
# the kernel is not built for at a width skips that shape.
MID_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Optional[str], Optional[int], bool]] = {
    "kernel": ((), None, None, False),
    # the other layout at 320: one 64-row tile, O's columns split between
    # the two warpgroups (S computed by both), built in place of the rows
    # layout at 320 (the plan's ints still name the rows layout)
    "columns": (((_ROWS_320, None, _ROWS_320.replace("true", "false")),), None, 320, False),
    # the products' depth rounded up to 128: 192 at 256 (rows), 320 at 384
    # (columns)
    "width_128": ((), "128", None, False),
    # hidden key tiles loaded and multiplied
    "no_skip": (_NO_SKIP, None, None, False),
}


def mid_variant_plan(name: str, d: int) -> Optional["fa.MidPlan"]:
    """The plan the variant runs a d-wide head on; None where the variant
    does not run or the mid kernel is not built for it."""
    _, width, only, _ = MID_VARIANTS[name]
    plan = fa.mid_plan(d)
    if width == "128":
        w = -(-d // 128) * 128
        plan = fa.MidPlan(w, fa.MID_LAYOUTS[w]) if w in fa.MID_LAYOUTS else None
    return None if plan is None or only not in (None, plan.width) else plan


# kernel A's backward between 128 and 512 columns (the mid backward) at the
# aim shapes: (name, B, Lq, Lk, heads, d, rows whose second half of keys the
# bias hides): d = 192 at a level-1 size, and the long_wide stage-2 step's
# level 0 (896x512x48f, one 320-wide head), cond and uncond
MID_BWD_SHAPES = (("d192 8x(1792x3584) 5 heads", 8, 1792, 3584, 5, 192, 0),
                  ("long_wide level0 cond (ref KV) d320", 48, 7168, 14336, 1, 320, 0),
                  ("long_wide level0 uncond (CFG dropout bias) d320", 48, 7168, 14336, 1, 320,
                   48))
_SPLIT_384 = "    if (x_slice == 384) SPLIT(384, 32)"
_MERGED_192 = "    if (x_slice == 192 && x_key_tile == 64) return MERGED(192, 64);"
_DQ_192 = "    if (x_slice == 192 && x_key_tile == 64) return ROLES(192, 64);"
_COLUMNS_384 = "    if (x_slice == 384 && x_key_tile == 32) return COLUMNS(384, 32);"
# name: (edits of csrc/flash_attention_mid_bwd.cu, arguments of
# ``mid_backward_plan`` (with "widths", the plan widths they apply at; the
# kernel's plan elsewhere), ablation)
MID_BWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Dict[str, object], bool]] = {
    "kernel": ((), {}, False),
    # a dV and a dK kernel (S^T twice, 5 products) instead of the merged
    # dk/dv kernel at d <= 320
    "split": (((_SPLIT_384, None, "".join(f"    if (x_slice == {w}) SPLIT({w}, 32)\n"
                                           for w in (192, 256, 320)) + _SPLIT_384),),
              {"layout": "split"}, False),
    # rings of at most 1 or 2 stages (as deep as fit up to 4 by default)
    "stages_1": ((), {"max_stages": 1}, False),
    "stages_2": ((), {"max_stages": 2}, False),
    # 32-row dk/dv steps at d = 192 and 256 (64 by default)
    "rows_32": (((_MERGED_192, None, _MERGED_192 + "\n    if (x_slice == 192 && x_key_tile == "
                  "32) return MERGED(192, 32);\n    if (x_slice == 256 && x_key_tile == 32) "
                  "return MERGED(256, 32);"),), {"rows": 32, "widths": (192, 256)}, False),
    # dq by role in 32-key steps at d = 192 (64 by default)
    "dq_rows_32": (((_DQ_192, None, _DQ_192 + "\n    if (x_slice == 192 && x_key_tile == 32) "
                     "return ROLES(192, 32);"),), {"dq_rows": 32, "widths": (192,)}, False),
    # dq by columns at d <= 320 (both warpgroups form dS and take half of
    # dQ's columns, in lockstep) instead of by role
    "dq_columns": (((_COLUMNS_384, None, "".join(
        f"    if (x_slice == {w} && x_key_tile == 32) return COLUMNS({w}, 32);\n"
        for w in (192, 256, 320)) + _COLUMNS_384),),
                   {"dq_layout": "columns", "widths": (192, 256, 320)}, False),
    # hidden key tiles loaded and multiplied
    "no_skip": (_NO_SKIP, {}, False),
    # ablation: the streamed tiles never loaded (the ring still turns, the
    # products read stale tiles)
    "no_stream_loads": ((("        if (skip) {  // nothing loaded", None,
                          "        if (true) {  // nothing loaded"),), {}, True),
}


def mid_bwd_variant_plan(name: str, d: int) -> "fa.MidBackwardPlan":
    """The mid backward's plan the variant runs a d-wide head on."""
    overrides = dict(MID_BWD_VARIANTS[name][1])
    widths = overrides.pop("widths", None)
    if widths is not None and fa.mid_backward_plan(d).width not in widths:
        overrides = {}
    return fa.mid_backward_plan(d, **overrides)


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


# kernel C (csrc/group_norm.cu) at chip_smoke.py's channels_last shapes,
# SiLU: (name, (N, C, H, W), eps), 32 groups
GN_SHAPES = (("decode 768x512", (8, 128, 768, 512), 1e-6),
             ("decode 192x128", (8, 512, 192, 128), 1e-6),
             ("decode 96x64", (8, 512, 96, 64), 1e-6),
             ("UNet level 0 768x512", (24, 320, 96, 64), 1e-5),
             ("UNet level 0 concat 960", (24, 960, 96, 64), 1e-5),
             ("stage-2 level 0 concat 960", (24, 960, 112, 64), 1e-5),
             ("UNet level 2 768x512", (24, 1280, 24, 16), 1e-5),
             ("UNet level 3 concat", (24, 2560, 12, 8), 1e-5))
GN_TOL = (1.5e-4, 0.1)  # chip_smoke.py's limits: rel L2, max err / rms(plain)
_GN_TMA_LOAD = ("      mbar_arrive_expect_tx(&bars[j], (uint32_t)R * S * 2);\n"
                "      tma_load_3d(data + (size_t)j * R * S, &x_map, &bars[j], c0, r0 + j * R, n);",
                None, "      mbar_arrive(&bars[j]);")
# name -> (edits, ablation, plan): plan is None (the wrapper's cluster_plan),
# "two_pass" (the two-pass kernels), or the size rule's module constants
# that the variant replaces (`gn_variant_plan`)
GN_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool, object]] = {
    "kernel": ((), False, None),
    # the two-pass kernels (statistics, finalize, apply) at every shape
    "two_pass": ((), False, "two_pass"),
    # clusters of at most 8 blocks (portable sizes) or 4: wider blocks that
    # re-read more from L2, or the two-pass kernels where nothing fits
    "cluster_8": ((), False, {"MAX_CLUSTER": 8}),
    "cluster_4": ((), False, {"MAX_CLUSTER": 4}),
    # blocks holding at most 90 KB (two an SM), with at most a quarter more
    # re-read from L2, or 16 KB, re-reading up to 7 times as much
    "cta_90k": ((_set_const("kMinBlocks", 3, 2),), False, {"CTA_BYTES": 90 * 1024,
                                                           "REREAD": 0.25}),
    "cta_16k": ((), False, {"CTA_BYTES": 16 * 1024, "REREAD": 7.0}),
    # registers for 2 or 4 blocks an SM instead of 3
    "min_blocks_2": ((_set_const("kMinBlocks", 3, 2),), False, None),
    "min_blocks_4": ((_set_const("kMinBlocks", 3, 4),), False, None),
    # 8 rows in flight a thread on the rows re-read from L2 instead of 4,
    # with registers for 3 or 2 blocks an SM
    "unroll_8": ((_set_const("kClusterUnroll", 4, 8),), False, None),
    "unroll_8_min_blocks_2": ((_set_const("kClusterUnroll", 4, 8),
                               _set_const("kMinBlocks", 3, 2)), False, None),
    # slabs down to 32 channels (64-byte rows) where the 64-channel floor
    # leaves a shape to the two-pass kernels, alone or with clusters of at
    # most 8 (narrower slabs on fewer blocks)
    "slab_32": ((), False, {"MIN_SLAB": 32}),
    "cluster_8_slab_32": ((), False, {"MAX_CLUSTER": 8, "MIN_SLAB": 32}),
    # ablations: no exchange over the cluster (each block normalizes by its
    # own rows), no TMA stores, no TMA loads (the statistics read stale
    # shared memory)
    "no_exchange": ((("      if (k < K) rp[k] = ld_dsmem_f2(dsmem_addr(&part[c], (uint32_t)k));",
                      None, "      if (k < K) rp[k] = part[c];"),), True, None),
    "no_stores": ((("      tma_store_3d(&y_map, data + (size_t)j * R * S, c0, r0 + j * R, n);\n",
                    None, "      (void)j;\n"),), True, None),
    "no_loads": ((_GN_TMA_LOAD,), True, None),
}

# Appended to each kernel-C source the tool builds: how many clusters of the
# one-pass kernel the card holds at once for a plan (0: none, and the launch
# would be refused). It goes through the source's own launch cache, so the
# shared memory limit it sets never falls under one a launch relies on.
_GN_OCCUPANCY = r"""
extern "C" int hv_variant_gn_occupancy(int S, int K, int resident, int* clusters) {
  auto kernel = gn_cluster_nhwc<true>;
  const int smem = (int)cluster_smem(S, resident);
  cudaError_t e = host_cache.reserve_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e == cudaSuccess && K > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}
"""


def gn_variant_plan(c: int, hw: int, groups: int, rule):
    """A kernel-C variant's plan: None for "two_pass", else the wrapper's
    size rule (``group_norm.cluster_plan``) with the module constants in
    ``rule`` (a dict, or None for none) replaced while it runs."""
    from ..ops import group_norm as gn

    if rule == "two_pass":
        return None
    rule = rule or {}
    kept = {name: getattr(gn, name) for name in rule}
    try:
        for name, value in rule.items():
            setattr(gn, name, value)
        return gn.cluster_plan(c, hw, groups)
    finally:
        for name, value in kept.items():
            setattr(gn, name, value)


# kernel B's forward (csrc/temporal_attention.cu) at chip_smoke.py's motion
# module shapes: (name, b, f, l, c, heads)
TEMPORAL_SHAPES = (("motion level0", 1, 24, 6144, 320, 8),
                   ("motion level1", 1, 24, 1536, 640, 8),
                   ("motion level2", 1, 24, 384, 1280, 8),
                   ("motion level3/mid", 1, 24, 96, 1280, 8),
                   # heads wider than 160 columns (the split kernel): heads64's
                   # motion levels 2-3 (5 heads of 256), one 320-, 640- and
                   # 1280-wide head's shapes, and one frame
                   ("heads64 motion level2 d256", 1, 24, 384, 1280, 5),
                   ("heads64 motion level3/mid d256", 1, 24, 96, 1280, 5),
                   ("d320", 1, 24, 384, 1280, 4),
                   ("d640", 1, 24, 384, 1280, 2),
                   ("d1280", 1, 24, 384, 1280, 1),
                   ("d256 one frame", 8, 1, 448, 1280, 5),
                   ("d1280 one frame", 8, 1, 448, 1280, 1))
# and past 32 frames, chip_smoke.py's long cases (long_wide's motion levels
# at 768x512x48f, f = 33, 64, 96, 200 and 256)
TEMPORAL_LONG_SHAPES = (("long_wide motion level0 f48", 1, 48, 6144, 320, 8),
                        ("long_wide motion level1 f48", 1, 48, 1536, 640, 8),
                        ("long_wide motion level2 f48", 1, 48, 384, 1280, 8),
                        ("long_wide motion level3/mid f48", 1, 48, 96, 1280, 8),
                        ("long_wide batched CFG level0 f48", 2, 48, 6144, 320, 8),
                        ("f33 d40", 1, 33, 6144, 320, 8),
                        ("f64 d160", 1, 64, 384, 1280, 8),
                        ("f96 d256", 1, 96, 384, 1280, 5),
                        ("f200 d40", 1, 200, 256, 320, 8),
                        ("f256 d160", 1, 256, 64, 1280, 8))
TEMPORAL_TOL = (2e-4, 0.08)  # chip_smoke.py's limits
_TEMPORAL_LOADS = ("      mbar_arrive_expect_tx(&full[s], bytes);\n",
                   "      // every store but the one just issued",
                   "      mbar_arrive(&full[s]);\n")
TEMPORAL_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # items of 2 or 3 positions (2: frame rows 2 x 168 columns apart, a
    # 2-way bank conflict; 3: an odd number of 16-byte units again)
    "positions_2": ((_set_const("kPositions", 1, 2),), False),
    "positions_3": ((_set_const("kPositions", 1, 3), _set_const("kStages", 3, 2)), False),
    # rings of 2 or 4 stages (4: one block an SM) instead of 3
    "stages_2": ((_set_const("kStages", 3, 2),), False),
    "stages_4": ((_set_const("kStages", 3, 4),), False),
    # 2 or 8 consumer warps instead of 4
    "consumers_2": ((_set_const("kConsumers", 4, 2),), False),
    "consumers_8": ((_set_const("kConsumers", 4, 8),), False),
    # the box exactly the chunk's columns (no 16-byte units past it: the
    # frames of a head 320 bytes apart, a 4-way bank conflict at d = 40)
    "no_pad": ((("      cwp < CW + 8 || (cwp / 8) % 2 != 1 ||", None, "      cwp < CW ||"),), False),
    # ablations: no loads (the ring still turns, the products read stale
    # tiles), no products, no stores
    "no_loads": ((_TEMPORAL_LOADS,), True),
    "no_products": ((("      attend<DP>(tq + off, tq + TILE + off, tq + 2 * TILE + off,\n"
                      "                 to + (size_t)p * CW + (size_t)h * d, LDF, LDO, F, d, "
                      "scale_log2, lane);\n", None, "      (void)off;\n"),), True),
    "no_stores": ((("        tma_store_4d(&o_map, otiles + (size_t)((n - kStages) % kOTiles) * OTILE, "
                    "w.chunk * CW,\n                     w.pos0, 0, w.b);\n", None, ""),
                   ("      tma_store_4d(&o_map, otiles + (size_t)(m % kOTiles) * OTILE, w.chunk * CW, "
                    "w.pos0, 0, w.b);\n", None, "")), True),
}


# kernel B's split kernels (heads wider than 160 columns up to 32 frames):
# name -> (edits of csrc/temporal_split.cuh (inlined into the source where
# any), edits of the forward's source, of the backward's, arguments of
# ``_split_plan``, whether it drops work and so is only timed). "half"
# halves the positions an item (fewer working warps; none where one
# position takes them all). The ablations: no loads (the ring still turns,
# the products read stale tiles), no exchange of S's parts, no products,
# no stores.
SplitVariant = Tuple[Tuple[Tuple[str, str], ...], Tuple[Edit, ...], Tuple[Edit, ...],
                     Dict[str, object], bool]
_SPLIT_LOADS = ("        mbar_arrive_expect_tx(&m.full[s], slot_bytes);\n"
                "        for (int w = 0; w < warps; ++w) {",
                None,
                "        mbar_arrive(&m.full[s]);\n"
                "        for (int w = 0; w < warps && !slot_bytes; ++w) {")
SPLIT_VARIANTS: Dict[str, SplitVariant] = {
    # half the positions an item (4 working warps of 8 at d <= 320), or one
    # (more items: the last wave of a small call is shorter)
    "split_positions_half": ((), (), (), {"positions": "half"}, False),
    "split_positions_1": ((), (), (), {"positions": 1}, False),
    # rings of at most 2 tensor slots (as deep as fits by default)
    "split_stages_2": ((), (), (), {"max_stages": 2}, False),
    # 4 consumer warps a block instead of 8 (up to 4 slices: d <= 640)
    "split_warps_4": ((("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),), (), (),
                      {"warps": 4}, False),
    "split_no_loads": ((), (_SPLIT_LOADS,), (_SPLIT_LOADS,), {}, True),
    "split_no_exchange": ((("  hopper::named_bar_sync(bar, 32 * n);\n  zero<MT>(acc);\n",
                            "  return;\n  zero<MT>(acc);\n"),), (), (), {}, True),
    "split_no_products": ((("  for (int off = 0; off < w; off += kPiece) {",
                            "  for (int off = 0; off < w && !w; off += kPiece) {"),
                           ("    if (n0 >= w) break;", "    if (n0 >= w || w) break;")),
                          (), (), {}, True),
    "split_no_stores": ((("    if (l < L)\n      hopper::tma_store_5d(",
                          "    if (l < L && !L)\n      hopper::tma_store_5d("),), (),
                        (("      tma_store_5d(maps[o], t, 0,", None,
                          "      if (!L) tma_store_5d(maps[o], t, 0,"),), {}, True),
}
# the forward's alone: slices of at most 80 columns (twice the slices, half
# the positions; the backward's default where they cover the head)
SPLIT_FWD_VARIANTS: Dict[str, SplitVariant] = {
    "split_slices_80": ((), (), (), {"max_slice": 80}, False),
}
# the backward's alone: the second sweep's q, k and g loaded again where the
# item would be kept (f <= 16), the item kept with half the positions where
# it is not (f > 16), or where 4 slots hold it
SPLIT_BWD_VARIANTS: Dict[str, SplitVariant] = {
    "split_streamed": ((), (), (), {"mode": 5}, False),
    "split_resident_half": ((), (), (), {"positions": "half", "mode": 4}, False),
    "split_resident": ((), (), (), {"mode": 4}, False),
    # slices of at most 160 columns (at most 80 where 8 warps hold them by default)
    "split_slices_160": ((), (), (), {"max_slice": 160}, False),
}


def _split_table(backward: bool) -> Dict[str, SplitVariant]:
    return {**SPLIT_VARIANTS, **(SPLIT_BWD_VARIANTS if backward else SPLIT_FWD_VARIANTS)}


def split_variant_source(name: str, backward: bool) -> str:
    """Kernel B's source with the split variant's edits, its header inlined
    and edited where the variant edits it; raises if an edit's text is not
    found exactly once."""
    header_edits, fwd_edits, bwd_edits = _split_table(backward)[name][:3]
    source = "temporal_attention_bwd.cu" if backward else "temporal_attention.cu"
    edits = bwd_edits if backward else fwd_edits
    if header_edits:
        header = (cuda_build.CSRC / "temporal_split.cuh").read_text()
        for old, new in header_edits:
            if header.count(old) != 1:
                raise ValueError(f"variant {name}: header anchor {old!r} not found exactly once")
            header = header.replace(old, new)
        edits = (*edits, ('#include "temporal_split.cuh"\n', None, header))
    return variant_source(name, {name: (edits, True)}, source)


def split_variant_plan(name: str, d: int, f: int, backward: bool):
    """The split plan the variant runs a d-wide head over f frames on
    (``kernel``: the wrapper's); None where the variant does not apply
    there (no plan, or the same plan as the kernel's)."""
    from ..ops import temporal_attention as ta

    table = _split_table(backward)
    base = ta.split_plan(d, f, backward)
    if name not in table:
        return base
    kwargs = dict(table[name][3])
    if kwargs.get("positions") == "half":
        del kwargs["positions"]
        try:
            half = ta._split_plan(d, f, backward, **kwargs).positions // 2
        except ValueError:
            return None
        if half < 1:
            return None
        kwargs["positions"] = half
    try:
        p = ta._split_plan(d, f, backward, **kwargs)
    except ValueError:
        return None
    return None if p == base and not any(table[name][:3]) else p


def split_variant_sizes(plan, shape, heads: int) -> tuple:
    """The entry point's twelve size ints for a split plan."""
    b, f, l, c = shape
    d = c // heads
    return (b, f, l, heads, d, plan.positions, plan.padded, plan.slices, d, plan.mode,
            plan.stages, plan.smem)


# kernel B's long kernels (past 32 frames forward, past the frames kernel's
# reach backward): name -> (edits of both sources, arguments of their plans)
LONG_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Dict[str, int]]] = {
    # rings of at most 1 or 2 stages (at most 4 by default; the forward's
    # one stage lets two blocks share an SM at f = 200)
    "long_stages_1": ((), {"max_stages": 1}),
    "long_stages_2": ((), {"max_stages": 2}),
    # items of at most 80 or 40 columns (whole heads of at most 160 by default)
    "long_cols_80": ((), {"max_cols": 80}),
    "long_cols_40": ((), {"max_cols": 40}),
    # the streamed mode (64-frame panels, 64-column chunks) where whole
    # items fit the ring
    "long_streamed": ((), {"streamed": True}),
    # streamed panels of 32 frames (two warps a panel)
    "long_panel_32": ((_set_const("kPanel", 64, 32),), {"streamed": True, "panel": 32}),
    # four, twelve or sixteen consumer warps instead of eight
    "long_consumers_4": ((_set_const("kLongConsumers", 8, 4),), {"consumers": 4}),
    "long_consumers_12": ((_set_const("kLongConsumers", 8, 12),), {"consumers": 12}),
    "long_consumers_16": ((_set_const("kLongConsumers", 8, 16),), {"consumers": 16}),
}
# the forward's alone: a resident task's sweeps one tile at a time, or
# four, instead of two
LONG_FWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Dict[str, int]]] = {
    "long_unroll_1": ((_set_const("kLongUnroll", 2, 1),), {}),
    "long_unroll_4": ((_set_const("kLongUnroll", 2, 4),), {}),
}
# the backward's alone: the three-phase item (S and dP a third time for dQ)
# where the key panels of P and dS hold dQ in registers (d <= 64)
LONG_BWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Dict[str, int]]] = {
    "long_no_panels": ((_set_const("kPanelWidth", 64, 0),), {"panels": False}),
    # ablations of the key panels' item (d <= 64), which drop work and so
    # are only timed: no row sums (phase A's products), no P and dS, no dV
    # and dK, no dQ products
    "long_no_sums": ((("for (int kt = i * half; kt < (i ? QT : half); ++kt) {", None,
                       "for (int kt = i * half; kt < (i ? QT : half) && !QT; ++kt) {"),), {}),
    "long_no_pds": ((("for (int task = first(pairs * pt); task < pairs * pt; "
                      "task += kLongConsumers) {", None,
                      "for (int task = first(pairs * pt) + pairs * pt; task < pairs * pt; "
                      "task += kLongConsumers) {"),), {}),
    "long_no_dkdv": ((("if (warp < 2 * pt) {", None, "if (!QT && warp < 2 * pt) {"),), {}),
    "long_no_dq": ((("            for (int j = 0; j < pt; ++j) {", None,
                     "            for (int j = 0; j < pt && !QT; ++j) {"),), {}),
}
LONG_BWD_ABLATIONS = ("long_no_sums", "long_no_pds", "long_no_dkdv", "long_no_dq")
# the backward's long kernel at the frames kernel's shapes (33 to 128 frames)
LONG_AT_FRAMES = "long_at_frames"


def long_variant_sizes(name: str, shape, heads: int, backward: bool) -> tuple:
    """The entry point's twelve size ints for the long kernels' variant
    (``kernel``, and ``long_at_frames`` past 128 frames: the wrapper's
    own)."""
    from ..ops import temporal_attention as ta

    b, f, l, c = shape
    table = {**LONG_VARIANTS, **(LONG_BWD_VARIANTS if backward else LONG_FWD_VARIANTS)}
    if name not in table and name != LONG_AT_FRAMES:
        return (ta.backward_launch_sizes if backward else ta.forward_launch_sizes)(shape, heads)
    p = ta._long_plan(backward, c, heads, f, **table.get(name, ((), {}))[1])
    d = c // heads
    return (b, f, l, heads, d, p.heads, p.padded, p.chunks, d, p.mode, p.stages, p.smem)


def earlier_sizes(n_ints: int, shape, heads: int, backward: bool, reach: int = 32) -> tuple:
    """The size ints an earlier source's entry point of ``n_ints`` ints
    takes: 9 (the forward before the long plan), 11 (the backward with the
    frames kernel's ring, up to ``reach`` frames, past it zeros) or fewer;
    past 32 frames the earlier long kernels took one head an item in 64-column
    pieces, tiles 72 wide."""
    from ..ops import temporal_attention as ta

    b, f, l, c = shape
    d = c // heads
    if f > ta.ITEM_FRAMES:
        item = (b, f, l, heads, d, 1, 72, -(-d // 64), d)
    else:
        item = ta.launch_sizes(shape, heads)
    if n_ints == 11:
        if ta.ITEM_FRAMES < f <= reach:
            return ta.backward_launch_sizes(shape, heads)[:9] + \
                ta.backward_launch_sizes(shape, heads)[10:]
        return (*item, 0, 0)
    return item[:n_ints]


# kernel B's backward (csrc/temporal_attention_bwd.cu) at chip_smoke.py's
# stage-2 shapes and the stage-1 camera encoder's: (name, b, f, l, c, heads)
TEMPORAL_BWD_SHAPES = (("motion level0", 1, 24, 7168, 320, 8),
                       ("motion level1", 1, 24, 1792, 640, 8),
                       ("motion level2", 1, 24, 448, 1280, 8),
                       ("motion level3/mid", 1, 24, 112, 1280, 8),
                       ("camera encoder", 1, 24, 7168, 320, 8),
                       ("stage1 camera encoder", 8, 1, 7168, 320, 8),
                       # heads wider than 160 columns (the split kernel): the
                       # heads64 stage-2 step's levels 2-3 (5 heads of 256), one
                       # 320-, 640- and 1280-wide head's shapes, and one frame
                       ("heads64 motion level2 d256", 1, 24, 448, 1280, 5),
                       ("heads64 motion level3/mid d256", 1, 24, 112, 1280, 5),
                       ("d320", 1, 24, 448, 1280, 4),
                       ("d640", 1, 24, 448, 1280, 2),
                       ("d1280", 1, 24, 448, 1280, 1),
                       ("d256 one frame", 8, 1, 448, 1280, 5),
                       ("d1280 one frame", 8, 1, 448, 1280, 1))
# and past 32 frames, at the long_wide stage-2 step's motion levels
# (896x512x48f) and at f = 33, 64 and 96
TEMPORAL_BWD_LONG_SHAPES = (("long_wide motion level0 f48", 1, 48, 7168, 320, 8),
                            ("long_wide motion level1 f48", 1, 48, 1792, 640, 8),
                            ("long_wide motion level2 f48", 1, 48, 448, 1280, 8),
                            ("long_wide motion level3/mid f48", 1, 48, 112, 1280, 8),
                            ("f33 d40", 1, 33, 7168, 320, 8),
                            ("f64 d256", 1, 64, 448, 1280, 5),
                            ("f96 d256", 1, 96, 448, 1280, 5),
                            # past 96 frames: the 100-frame step's level 0, and 128
                            # frames at level-0 and level-2 sizes
                            ("f100 d40", 1, 100, 7168, 320, 8),
                            ("f128 level0-size d40", 1, 128, 7168, 320, 8),
                            ("f128 level2-size d160", 1, 128, 448, 1280, 8))
# and past the frames kernel's reach: chip_smoke.py's cases of the long kernel
TEMPORAL_BWD_PAST_SHAPES = (("f136 d40", 1, 136, 7168, 320, 8),
                            ("f200 d40", 1, 200, 256, 320, 8),
                            ("f256 d160", 1, 256, 64, 1280, 8))
TEMPORAL_BWD_TOL = (2e-4, 0.2)  # chip_smoke.py's limits, per gradient
TEMPORAL_BWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], bool]] = {
    "kernel": ((), False),
    # rings of 2 or 4 stages instead of 3 (4: one block an SM)
    "stages_2": ((_set_const("kStages", 3, 2),), False),
    "stages_4": ((_set_const("kStages", 3, 4),), False),
    # 2 or 8 consumer warps instead of 4
    "consumers_2": ((_set_const("kConsumers", 4, 2),), False),
    "consumers_8": ((_set_const("kConsumers", 4, 8),), False),
    # dQ, dK and dV in tiles of their own, one ring slot a stage, stored by
    # a 4-D TMA store each (one block an SM), instead of over dead inputs
    "out_tiles": ((("constexpr bool kInPlace = true;", None,
                    "constexpr bool kInPlace = false;"),), False),
    # P^T and dS^T through a transpose tile a warp (5 KB) and ldmatrix.trans
    "trans_smem": ((("constexpr bool kMovmatrix = true;", None,
                     "constexpr bool kMovmatrix = false;"),), False),
    # 2 stages, 3 blocks an SM (registers capped at 136 a thread)
    "stages_2_blocks_3": ((_set_const("kStages", 3, 2),
                           ("__global__ void __launch_bounds__(kThreads)", None,
                            "__global__ void __launch_bounds__(kThreads, 3)")), False),
    # 32-row mma tiles at f <= 16 too
    "tiles_32": ((("  if (F <= 16) return launch<DP, 1>", None,
                   "  if (F <= 0) return launch<DP, 1>"),), False),
    # ablations: no loads (the ring still turns, the products read stale
    # tiles), no products, no stores
    "no_loads": ((("      const Item w = item_of(it, chunks, L);\n      mbar_arrive_expect_tx",
                   "      if constexpr (!kInPlace) {\n        bulk_wait<0, true>();",
                   "      mbar_arrive(&full[s]);\n"),), True),
    "no_products": ((("      head_grad<DP, MT>(tq + off,",
                      "    }\n    fence_proxy_async();  // the gradients'", "      (void)off;\n"),),
                    True),
    "no_stores": ((("  if constexpr (kInPlace) {\n    const bf16* src[3]", None,
                    "  return;\n  if constexpr (kInPlace) {\n    const bf16* src[3]"),), True),
}


# the frames kernel's variants past 32 frames: name -> (edits of
# csrc/temporal_attention_bwd.cu, arguments of ``long_backward_plan``, the
# most frames it runs at)
def _groups_edit(rule: str) -> Tuple[Edit, ...]:
    head = "__host__ __device__ constexpr int frames_groups(int QT) "
    return ((head + "{ return QT <= 3 ? 3 : 1; }", None, head + f"{{ return {rule}; }}"),)


FRAMES_BWD_VARIANTS: Dict[str, Tuple[Tuple[Edit, ...], Dict[str, int], int]] = {
    # rings of at most 2 or 3 stages (at most 4 by default)
    "frames_stages_2": ((), {"max_stages": 2}, 128),
    "frames_stages_3": ((), {"max_stages": 3}, 128),
    # chunks of at most 80 or 40 columns (two 40-wide heads, one 80-wide
    # head; one 40-wide head)
    "frames_cols_80": ((), {"max_cols": 80}, 128),
    "frames_cols_40": ((), {"max_cols": 40}, 128),
    # one or two consumer groups a block up to 48 frames (three by default)
    "frames_one_group": (_groups_edit("1"), {"groups": 1}, 48),
    "frames_two_groups": (_groups_edit("QT <= 3 ? 2 : 1"), {"groups": 2}, 48),
    # two consumer groups up to 64 frames (one past 48 by default)
    "frames_two_groups_to_64": (_groups_edit("QT <= 4 ? 2 : 1"), {"groups": 2}, 64),
    # two blocks an SM: registers budgeted for two, items of at most 80
    # columns in 2 stages, two groups a block
    "frames_two_blocks": ((_set_const("kFramesBlocks", 1, 2),
                           *_groups_edit("QT <= 3 ? 2 : 1")),
                          {"max_cols": 80, "max_stages": 2, "groups": 2}, 48),
    # the gradients' bulk copies issued by all 32 lanes of the producer warp
    # (by its lane 0 by default)
    "frames_32_store_lanes": ((_set_const("kStoreLanes", 1, 32),), {}, 128),
    # dQ and dK over K and G as soon as computed, four barriers a head (two
    # up to 64 columns by default)
    "frames_four_barriers": ((_set_const("kFramesHeld", 64, 0),), {}, 128),
    # ablation: no gradient stores (the ring still turns)
    "frames_no_stores": ((_set_const("kStoreLanes", 1, 0),), {}, 128),
}


# the frames variants that drop work, and so are only timed
FRAMES_BWD_ABLATIONS = ("frames_no_stores",)


def frames_reach(text: str) -> int:
    """The most frames a backward source's frames kernel takes (16 x its
    ``kFramesTiles``; 32 before it had one)."""
    import re

    m = re.search(r"constexpr int kFramesTiles = (\d+);", text)
    return 16 * int(m.group(1)) if m else 32


def frames_variant_sizes(name: str, shape, heads: int) -> tuple:
    """The backward entry point's twelve size ints for the frames kernel's
    variant (``kernel``: the wrapper's own)."""
    from ..ops import temporal_attention as ta

    if name not in FRAMES_BWD_VARIANTS:
        return ta.backward_launch_sizes(shape, heads)
    b, f, l, c = shape
    p = ta.long_backward_plan(c, heads, f, **FRAMES_BWD_VARIANTS[name][1])
    d = c // heads
    return (b, f, l, heads, d, p.heads, p.padded, p.chunks, d, ta.MODE_FRAMES, p.stages, p.smem)


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


def _entry_ints(text: str) -> int:
    """The int parameters of a kernel-A source's C entry points: 13 since
    the xwide plan was passed in, 6 since the padded head widths (scale_d),
    5 before."""
    return 13 if "int x_slice" in text else (6 if "int scale_d" in text else 5)


def _entry_sizes(n_ints: int, sizes, scale_d: int, kernel: str,
                 plan: Optional["fa.XwidePlan"] = None) -> tuple:
    """``sizes`` (B, Lq, Lk, heads, d) with what an entry point of
    ``n_ints`` ints takes after them: scale_d, and the xwide plan's ints."""
    if n_ints == 5:
        return tuple(sizes)
    if n_ints == 6:
        return (*sizes, scale_d)
    return (*sizes, scale_d, *fa._plan_args(sizes[4], kernel, plan))


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
        fn.argtypes = fa._FWD_ARGTYPES
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
                            lse.data_ptr(), B, lq, lk, heads, d, d, *fa._plan_args(d, "fwd"),
                            stream)
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
    entry = {n: _entry_ints(t) for n, t in texts.items()}
    fns = {}
    for name, lib in _build(texts, "flash_bwd_variant").items():
        dkv, dq = lib.hv_flash_bwd_dkv, lib.hv_flash_bwd_dq
        dkv.restype = dq.restype = ctypes.c_int
        dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * entry[name] + [ctypes.c_void_p]
        dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * entry[name] + [ctypes.c_void_p]
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

        def sizes(name):
            return _entry_sizes(entry[name], (B, lq, lk, heads, d), d, "dkv")

        def call_dkv(name):
            cuda_build.check(fns[name][0](*common, grads[1].data_ptr(), grads[2].data_ptr(),
                                          *sizes(name), stream), f"variant {name} dk/dv")

        def call_dq(name):
            cuda_build.check(fns[name][1](*common, grads[0].data_ptr(), *sizes(name), stream),
                             f"variant {name} dq")

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


def run_xwide(names: Sequence[str], iters: int = 5,
              against: Sequence[str] = ()) -> List[dict]:
    """The xwide kernels' variants: the forward at ``XWIDE_SHAPES`` and the
    backward (dk/dv and dq entry points timed apart) at
    ``XWIDE_BWD_SHAPES``, each held to its plain version (the forward's
    limits on 128 q rows; the backward's per gradient, all rows) and to the
    bits of ``kernel``, timed by CUDA events in turns beside SDPA (its
    backward through autograd). ``against``: another forward source and/or
    backward source of the same entry points (the parent commit's, which
    takes its own design and no plan), timed as ``against``. Returns the
    records (also printed, one JSON line each)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    sources = {n: xwide_variant_sources(n) for n in names}
    texts = {}  # one build a distinct source
    for name, (fwd_text, bwd_text) in sources.items():
        texts.setdefault(("fwd", fwd_text), f"xwide_fwd_{name}")
        texts.setdefault(("bwd", bwd_text), f"xwide_bwd_{name}")
    for path in against:
        text = Path(path).read_text()
        kind = "bwd" if "hv_flash_bwd_dkv" in text else "fwd"
        texts[(kind, text)] = f"xwide_{kind}_against"
    libs = _build({label: text for (_, text), label in texts.items()}, "flash_xwide_variant")
    entry = {label: _entry_ints(text) for (_, text), label in texts.items()}
    calls = {}  # name -> (fwd lib label, bwd lib label)
    for name, (fwd_text, bwd_text) in sources.items():
        calls[name] = (texts[("fwd", fwd_text)], texts[("bwd", bwd_text)])
    if against:
        labels = [texts[k] for k in texts if texts[k].endswith("_against")]
        fwd_l = next((x for x in labels if x.startswith("xwide_fwd")), None)
        bwd_l = next((x for x in labels if x.startswith("xwide_bwd")), None)
        calls["against"] = (fwd_l, bwd_l)
    fns = {}
    for label, lib in libs.items():
        n = entry[label]
        if label.startswith("xwide_fwd"):
            fn = lib.hv_flash_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[label] = fn
        else:
            dkv, dq = lib.hv_flash_bwd_dkv, lib.hv_flash_bwd_dq
            dkv.restype = dq.restype = ctypes.c_int
            dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * n + [ctypes.c_void_p]
            dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n + [ctypes.c_void_p]
            fns[label] = (dkv, dq)
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    records = []
    card = torch.cuda.get_device_name()

    def plan_of(name, d):
        return xwide_variant_plan(name, d) if name in XWIDE_VARIANTS else None

    def inputs(B, lq, lk, c, bias_rows, with_g):
        q = torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, lk, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        g = torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16) \
            if with_g else None
        bias, unmasked = None, B * lk
        if bias_rows:
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked -= bias_rows * (lk // 2)
        return q, k, v, g, bias, unmasked

    for shape, B, lq, lk, heads, d, bias_rows in XWIDE_SHAPES:
        q, k, v, _, bias, unmasked = inputs(B, lq, lk, heads * d, bias_rows, False)
        out, lse = torch.empty_like(q), torch.empty((B, heads, lq), device=dev)
        runs = {n: c[0] for n, c in calls.items() if c[0] is not None}

        def call(name):
            label = runs[name]
            sizes = _entry_sizes(entry[label], (B, lq, lk, heads, d), d, "fwd", plan_of(name, d))
            cuda_build.check(fns[label](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        None if bias is None else bias.data_ptr(),
                                        out.data_ptr(), lse.data_ptr(), *sizes, stream),
                             f"xwide variant {name}")

        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = fa.flash_attention_plain(q[:, rows], k, v, heads, bias)
        checks, first = {}, None
        for name in runs:
            call(name)
            torch.cuda.synchronize()
            ok, rel = _agree(out[:, rows], ref, FLASH_TOL)
            lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
            if first is None:
                first = out.clone()
            checks[name] = (ok and lse_err <= LSE_TOL, rel, lse_err, torch.equal(out, first))
        del first, ref, ref_lse
        turns = _turns({name: (lambda name=name: call(name)) for name in runs}, iters)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), iters)
        flops = 4.0 * heads * lq * unmasked * d
        for name in runs:
            ms = min(turns[name])
            ok, rel, lse_err, same = checks[name]
            plan = plan_of(name, d)
            ablation = name in XWIDE_VARIANTS and XWIDE_VARIANTS[name][4]
            rec = dict(mode="xwide_fwd", variant=name, shape=shape, ms=ms, turns=turns[name],
                       tflops=flops / ms / 1e9, sdpa_ms=sdpa_ms, ablation=ablation,
                       ok=None if ablation else ok, rel_l2=rel,
                       lse_err=lse_err, same_bits_as_first=same,
                       plan=None if plan is None else plan._asdict(), device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, out, lse, qh, kh, vh
        torch.cuda.empty_cache()

    for shape, B, lq, lk, heads, d, bias_rows in XWIDE_BWD_SHAPES:
        q, k, v, g, bias, unmasked = inputs(B, lq, lk, heads * d, bias_rows, True)
        o, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        delta = fa.attention_delta(g, o, heads)
        del o
        refs = fa.flash_attention_backward_plain(q, k, v, bias, g, lse, delta, heads)
        grads = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())
        runs = {n: c[1] for n, c in calls.items() if c[1] is not None}

        def sizes(name):
            return _entry_sizes(entry[runs[name]], (B, lq, lk, heads, d), d, "dkv",
                                plan_of(name, d))

        def call_dkv(name):
            cuda_build.check(fns[runs[name]][0](*common, grads[1].data_ptr(), grads[2].data_ptr(),
                                                *sizes(name), stream),
                             f"xwide variant {name} dk/dv")

        def call_dq(name):
            cuda_build.check(fns[runs[name]][1](*common, grads[0].data_ptr(), *sizes(name),
                                                stream), f"xwide variant {name} dq")

        checks, first = {}, None
        for name in runs:
            call_dkv(name)
            call_dq(name)
            torch.cuda.synchronize()
            agreed = [_agree(got, ref, FLASH_BWD_TOL) for got, ref in zip(grads, refs)]
            hidden_zero = not bias_rows or all(
                bool((t[:bias_rows, lk // 2:] == 0).all()) for t in grads[1:])
            if first is None:
                first = [t.clone() for t in grads]
            checks[name] = (all(a[0] for a in agreed) and hidden_zero,
                            max(a[1] for a in agreed), hidden_zero,
                            all(torch.equal(a, b) for a, b in zip(grads, first)))
        del first, refs
        torch.cuda.empty_cache()
        turns_dkv = _turns({name: (lambda name=name: call_dkv(name)) for name in runs}, iters)
        turns_dq = _turns({name: (lambda name=name: call_dq(name)) for name in runs}, iters)
        sdpa_ms = _sdpa_backward_ms(q, k, v, g, heads, bias, iters)
        flops = 10.0 * heads * lq * unmasked * d
        for name in runs:
            dkv_ms, dq_ms = min(turns_dkv[name]), min(turns_dq[name])
            ok, rel, hidden_zero, same = checks[name]
            plan = plan_of(name, d)
            ablation = name in XWIDE_VARIANTS and XWIDE_VARIANTS[name][4]
            rec = dict(mode="xwide_bwd", variant=name, shape=shape, ms=dkv_ms + dq_ms,
                       dkv_ms=dkv_ms, dq_ms=dq_ms, dkv_turns=turns_dkv[name],
                       dq_turns=turns_dq[name], tflops=flops / (dkv_ms + dq_ms) / 1e9,
                       sdpa_ms=sdpa_ms, ablation=ablation, ok=None if ablation else ok,
                       rel_l2=rel, hidden_keys_zero=hidden_zero,
                       same_bits_as_first=same,
                       plan=None if plan is None else plan._asdict(), device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, g, lse, delta, grads
        torch.cuda.empty_cache()
    return records


def run_own(names: Sequence[str], iters: int = 5, against: Sequence[str] = ()) -> List[dict]:
    """Kernel A's variants at the head's own width: the forward at
    ``OWN_SHAPES`` and the backward (dk/dv and dq entry points timed apart)
    at ``OWN_BWD_SHAPES``, each held to its plain version (the forward's
    limits on 128 q rows; the backward's per gradient, all rows, hidden keys'
    dk and dv exactly zero) and to the bits of ``kernel``, timed by CUDA
    events in turns beside SDPA (its backward through autograd).
    ``against``: another forward source and/or backward source of the same
    entry points (the parent commit's), timed as ``against``. Returns the
    records (also printed, one JSON line each)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts, calls = {}, {}  # one build a distinct source; name -> (fwd label, bwd label)
    for name in names:
        fwd_edits, bwd_edits, _ = OWN_VARIANTS[name]
        labels = []
        for kind, edits, src in (("fwd", fwd_edits, "flash_attention.cu"),
                                 ("bwd", bwd_edits, "flash_attention_bwd.cu")):
            text = variant_source(name, {name: (edits, False)}, src)
            labels.append(texts.setdefault((kind, text), f"own_{kind}_{name}"))
        calls[name] = tuple(labels)
    against_labels = [None, None]
    for path in against:
        text = Path(path).read_text()
        kind = "bwd" if "hv_flash_bwd_dkv" in text else "fwd"
        against_labels[kind == "bwd"] = texts.setdefault((kind, text), f"own_{kind}_against")
    if against:
        calls["against"] = tuple(against_labels)
    libs = _build({label: text for (_, text), label in texts.items()}, "flash_own_variant")
    entry = {label: _entry_ints(text) for (_, text), label in texts.items()}
    fns = {}
    for label, lib in libs.items():
        n = entry[label]
        if label.startswith("own_fwd"):
            fn = lib.hv_flash_fwd
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[label] = fn
        else:
            dkv, dq = lib.hv_flash_bwd_dkv, lib.hv_flash_bwd_dq
            dkv.restype = dq.restype = ctypes.c_int
            dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * n + [ctypes.c_void_p]
            dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n + [ctypes.c_void_p]
            fns[label] = (dkv, dq)
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    card = torch.cuda.get_device_name()
    records = []

    def ablation(name):
        return name in OWN_VARIANTS and OWN_VARIANTS[name][2]

    def inputs(B, lq, lk, c, bias_rows, with_g):
        q = torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, lk, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        g = torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16) \
            if with_g else None
        bias, unmasked = None, B * lk
        if bias_rows:
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked -= bias_rows * (lk // 2)
        return q, k, v, g, bias, unmasked

    for shape, B, lq, lk, heads, d, bias_rows in OWN_SHAPES:
        q, k, v, _, bias, unmasked = inputs(B, lq, lk, heads * d, bias_rows, False)
        out, lse = torch.empty_like(q), torch.empty((B, heads, lq), device=dev)
        runs = {n: c[0] for n, c in calls.items() if c[0] is not None}

        def call(name):
            label = runs[name]
            sizes = _entry_sizes(entry[label], (B, lq, lk, heads, d), d, "fwd")
            cuda_build.check(fns[label](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        None if bias is None else bias.data_ptr(),
                                        out.data_ptr(), lse.data_ptr(), *sizes, stream),
                             f"own variant {name}")

        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = fa.flash_attention_plain(q[:, rows], k, v, heads, bias)
        checks, first = {}, None
        for name in runs:
            call(name)
            torch.cuda.synchronize()
            ok, rel = _agree(out[:, rows], ref, FLASH_TOL)
            lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
            if first is None:
                first = out.clone()
            checks[name] = (ok and lse_err <= LSE_TOL, rel, lse_err, torch.equal(out, first))
        del first, ref, ref_lse
        turns = _turns({name: (lambda name=name: call(name)) for name in runs}, iters)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), iters)
        flops = 4.0 * heads * lq * unmasked * d
        for name in runs:
            ms = min(turns[name])
            ok, rel, lse_err, same = checks[name]
            rec = dict(mode="own_fwd", variant=name, shape=shape, d=d, ms=ms,
                       turns=turns[name], tflops=flops / ms / 1e9, sdpa_ms=sdpa_ms,
                       ablation=ablation(name), ok=None if ablation(name) else ok, rel_l2=rel,
                       lse_err=lse_err, same_bits_as_first=same, device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, out, lse, qh, kh, vh
        torch.cuda.empty_cache()

    for shape, B, lq, lk, heads, d, bias_rows in OWN_BWD_SHAPES:
        q, k, v, g, bias, unmasked = inputs(B, lq, lk, heads * d, bias_rows, True)
        o, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        delta = fa.attention_delta(g, o, heads)
        del o
        refs = fa.flash_attention_backward_plain(q, k, v, bias, g, lse, delta, heads)
        grads = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), g.data_ptr(), lse.data_ptr(),
                  delta.data_ptr())
        runs = {n: c[1] for n, c in calls.items() if c[1] is not None}

        def sizes(name):
            return _entry_sizes(entry[runs[name]], (B, lq, lk, heads, d), d, "dkv")

        def call_dkv(name):
            cuda_build.check(fns[runs[name]][0](*common, grads[1].data_ptr(),
                                                grads[2].data_ptr(), *sizes(name), stream),
                             f"own variant {name} dk/dv")

        def call_dq(name):
            cuda_build.check(fns[runs[name]][1](*common, grads[0].data_ptr(), *sizes(name),
                                                stream), f"own variant {name} dq")

        checks, first = {}, None
        for name in runs:
            call_dkv(name)
            call_dq(name)
            torch.cuda.synchronize()
            agreed = [_agree(got, ref, FLASH_BWD_TOL) for got, ref in zip(grads, refs)]
            hidden_zero = not bias_rows or all(
                bool((t[:bias_rows, lk // 2:] == 0).all()) for t in grads[1:])
            if first is None:
                first = [t.clone() for t in grads]
            checks[name] = (all(a[0] for a in agreed) and hidden_zero,
                            max(a[1] for a in agreed), hidden_zero,
                            all(torch.equal(a, b) for a, b in zip(grads, first)))
        del first, refs
        torch.cuda.empty_cache()
        turns_dkv = _turns({name: (lambda name=name: call_dkv(name)) for name in runs}, iters)
        turns_dq = _turns({name: (lambda name=name: call_dq(name)) for name in runs}, iters)
        sdpa_ms = _sdpa_backward_ms(q, k, v, g, heads, bias, iters)
        flops = 10.0 * heads * lq * unmasked * d
        for name in runs:
            dkv_ms, dq_ms = min(turns_dkv[name]), min(turns_dq[name])
            ok, rel, hidden_zero, same = checks[name]
            rec = dict(mode="own_bwd", variant=name, shape=shape, d=d, ms=dkv_ms + dq_ms,
                       dkv_ms=dkv_ms, dq_ms=dq_ms, dkv_turns=turns_dkv[name],
                       dq_turns=turns_dq[name], tflops=flops / (dkv_ms + dq_ms) / 1e9,
                       sdpa_ms=sdpa_ms, ablation=ablation(name),
                       ok=None if ablation(name) else ok, rel_l2=rel,
                       hidden_keys_zero=hidden_zero, same_bits_as_first=same, device=card)
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


def _agree(out: torch.Tensor, ref: torch.Tensor, tol) -> Tuple[bool, float]:
    """(within tol, relative L2 error); a plain version that is exactly zero
    (dq and dk over one frame) takes an exactly zero output."""
    ref = ref.float()
    diff = out.float() - ref
    err, norm = diff.abs().max().item(), ref.norm().item()
    rel = diff.norm().item() / norm if norm else (0.0 if err == 0 else float("inf"))
    return rel <= tol[0] and err <= tol[1] * ref.pow(2).mean().sqrt().item(), rel


def run_gn(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """Kernel C's variants at every shape of ``GN_SHAPES`` (channels_last,
    SiLU): each but the ablations held to ``group_norm_act_plain``
    (``chip_smoke.py``'s limits) and to its own bits on a repeat launch,
    then timed in turns beside ``F.group_norm`` + ``F.silu`` on the same
    input. A variant's plan is the wrapper's rule with the rule's
    constants it replaces (:func:`gn_variant_plan`), or the two-pass
    kernels where the rule finds none; ``against`` (another
    source's ``hv_group_norm_fwd``, the two-pass entry point) takes the
    two-pass arguments. Returns the records (also printed, one JSON line
    each)."""
    import torch.nn.functional as F

    from ..ops import group_norm as gn

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts = _named_sources(names, {n: v[:2] for n, v in GN_VARIANTS.items()}, "group_norm.cu",
                           against)
    for name in names:
        texts[name] += _GN_OCCUPANCY
    fns, occupancy = {}, {}
    for name, lib in _build(texts, "group_norm_variant").items():
        two, one = lib.hv_group_norm_fwd, getattr(lib, "hv_group_norm_cluster", None)
        for fn, types in ((two, gn._TWO_PASS_ARGTYPES), (one, gn._CLUSTER_ARGTYPES)):
            if fn is not None:
                fn.restype, fn.argtypes = ctypes.c_int, types
        fns[name] = (two, one)
        if name in names:
            occupancy[name] = lib.hv_variant_gn_occupancy
            occupancy[name].restype = ctypes.c_int
            occupancy[name].argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    records = []
    for shape_name, shape, eps in GN_SHAPES:
        n, c, h, w = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        weight = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        y = torch.empty_like(x)
        head = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr())
        lanes = max(1, 256 // (c // 8))
        tiles, per_tile = gn._tiling(n, h * w, lanes)
        part = torch.empty((n, tiles, c, 2), device=dev)
        ab = torch.empty((n, c, 2), device=dev)
        two_args = (*head, part.data_ptr(), ab.data_ptr(), n, c, h * w, 32, 1, 1, 1, tiles,
                    per_tile, lanes, float(eps), stream)
        calls, plans = {}, {}
        for name, (two, one) in fns.items():
            rule = GN_VARIANTS[name][2] if name in GN_VARIANTS else "two_pass"
            plan = plans[name] = gn_variant_plan(c, h * w, 32, rule)
            if plan is None:
                calls[name] = (lambda two=two, name=name:
                               cuda_build.check(two(*two_args), f"variant {name}"))
            else:
                args = (*head, n, c, h * w, 32, *plan, 1, 1, float(eps), stream)
                calls[name] = (lambda one=one, args=args, name=name:
                               cuda_build.check(one(*args), f"variant {name}"))
        ref = gn.group_norm_act_plain(x, weight, bias, 32, eps, "silu")
        checks = {}
        for name in fns:
            if name in GN_VARIANTS and GN_VARIANTS[name][1]:
                checks[name] = (None, None, None)  # an ablation computes something else
                continue
            calls[name]()
            first = y.clone()
            calls[name]()
            torch.cuda.synchronize()
            ok, rel = _agree(y, ref, GN_TOL)
            checks[name] = (ok, rel, torch.equal(y, first))
            del first
        turns = _turns(calls, 20 * iters)

        def library():
            return F.silu(F.group_norm(x, 32, weight, bias, eps))

        library_ms = _time_ms(library, 20 * iters)
        bound_ms = 4.0 * x.numel() / 3.35e12 * 1e3
        for name in fns:
            ms = min(turns[name])
            ok, rel, same = checks[name]
            clusters = None
            if plans[name] is not None and name in occupancy:
                got = ctypes.c_int(0)
                plan = plans[name]
                cuda_build.check(occupancy[name](plan.slab, plan.cluster, plan.resident,
                                                 ctypes.byref(got)), "occupancy")
                clusters = got.value
            rec = dict(variant=name, shape=f"{shape_name} {shape}", ms=ms, turns=turns[name],
                       plan=None if plans[name] is None else list(plans[name]),
                       active_clusters=clusters,
                       library_ms=library_ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
                       ablation=name in GN_VARIANTS and GN_VARIANTS[name][1], ok=ok,
                       rel_l2=rel, same_bits=same, device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del x, y, ref, part, ab
        torch.cuda.empty_cache()
    return records


def _temporal_sizes_taken(text: str) -> int:
    """The size arguments a kernel B entry point of this source takes: 5
    (b, f, l, heads, d) in the first design, 7 with the item plan (heads
    an item, padded width), 9 with the column chunks and the softmax's
    width; :func:`~humanvid_tpu_torch.ops.temporal_attention.launch_sizes`
    gives them in that order. The backward's took 11 with its frames
    kernel (the ring's stages and shared memory); both take 12 since the
    long kernels' plans (the mode, then those two:
    :func:`~humanvid_tpu_torch.ops.temporal_attention.forward_launch_sizes`,
    :func:`~humanvid_tpu_torch.ops.temporal_attention.backward_launch_sizes`)."""
    if "int heads_per_item" not in text:
        return 5
    if "int mode, int stages, int smem" in text:
        return 12
    if "int stages, int smem" in text:
        return 11
    return 9 if "int scale_d" in text else 7


def _long_table(backward: bool) -> Dict[str, Tuple[Tuple[Edit, ...], bool]]:
    own = LONG_BWD_VARIANTS if backward else LONG_FWD_VARIANTS
    return {n: (v[0], False) for n, v in {**LONG_VARIANTS, **own}.items()}


def run_temporal(names: Sequence[str], iters: int = 5,
                 against: Optional[str] = None) -> List[dict]:
    """Kernel B's forward variants at every shape of ``TEMPORAL_SHAPES``
    (those of ``TEMPORAL_VARIANTS``) and of ``TEMPORAL_LONG_SHAPES`` (those
    of ``LONG_VARIANTS``), ``kernel`` and ``against`` at both: each but the
    ablations held to ``temporal_attention_plain`` (``chip_smoke.py``'s
    limits) and to its own bits on a repeat, then timed in turns beside
    SDPA on the head-split permuted views. ``against`` is another source of
    ``hv_temporal_fwd``; an earlier design's is called with the size
    arguments its entry point takes (:func:`_temporal_sizes_taken`,
    :func:`earlier_sizes`). Returns the records (also printed, one JSON
    line each)."""
    from ..ops import temporal_attention as ta

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    table = {**TEMPORAL_VARIANTS, **_long_table(False)}
    split_table = _split_table(False)
    texts = _named_sources([n for n in names if n not in split_table], table,
                           "temporal_attention.cu", against)
    texts.update({n: split_variant_source(n, False) for n in names if n in split_table})
    n_sizes = {n: _temporal_sizes_taken(t) for n, t in texts.items()}
    fns = {}
    for name, lib in _build(texts, "temporal_variant").items():
        fn = fns[name] = lib.hv_temporal_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_sizes[name] + [ctypes.c_void_p]
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = []
    for shape_name, b, f, l, c, heads in TEMPORAL_SHAPES + TEMPORAL_LONG_SHAPES:
        long = f > ta.ITEM_FRAMES
        d = c // heads
        wide = not long and d > ta.CHUNK_COLUMNS

        def runs_at(n):
            if n in ("kernel", "against"):
                return True
            if n in split_table:
                return wide and split_variant_plan(n, d, f, False) is not None
            return (n in LONG_VARIANTS or n in LONG_FWD_VARIANTS) == long and not wide

        runs = [n for n in fns if runs_at(n)]
        if runs == ["kernel"] and names != ["kernel"]:
            continue  # none of the named variants differs from the kernel here
        q, k, v = (torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out = torch.empty_like(q)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        calls = {}
        for name in runs:
            n = n_sizes[name]
            if wide and (name != "against" or "kModeSplit" in texts[name]):
                sizes = split_variant_sizes(split_variant_plan(name, d, f, False), q.shape, heads)
            elif wide and n == 12:  # an earlier source: its column chunks' kernel
                sizes = (*ta.launch_sizes(tuple(q.shape), heads), ta.MODE_ITEMS, 0, 0)
            elif n == 12:
                sizes = long_variant_sizes(name, q.shape, heads, False)
            elif name == "against":
                sizes = earlier_sizes(n, tuple(q.shape), heads, False)
            else:
                sizes = ta.launch_sizes(tuple(q.shape), heads)
                if name == "no_pad":
                    plan = ta.temporal_plan(c, heads)
                    sizes = (*sizes[:6], plan.cols, *sizes[7:])
            calls[name] = (lambda fn=fns[name], args=(*ptrs, *sizes[:n], stream), name=name:
                           cuda_build.check(fn(*args), f"variant {name}"))
        ref = ta.temporal_attention_plain(q, k, v, heads)
        checks = {}
        for name in runs:
            if (name in TEMPORAL_VARIANTS and TEMPORAL_VARIANTS[name][1]
                    or name in split_table and split_table[name][4]):
                checks[name] = (None, None, None)
                continue
            out.zero_()
            calls[name]()
            torch.cuda.synchronize()
            ok, rel = _agree(out, ref, TEMPORAL_TOL)
            first = out.clone()
            calls[name]()
            checks[name] = (ok, rel, torch.equal(out, first))
        turns = _turns(calls, 20 * iters)

        def split(t):
            return t.view(b, f, l, heads, d).permute(0, 2, 3, 1, 4)

        sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)), 20 * iters)
        bound_ms = 8.0 * q.numel() / 3.35e12 * 1e3
        for name in runs:
            ms = min(turns[name])
            ok, rel, same = checks[name]
            plan = None
            if long and name != "against":
                p = ta._long_plan(False, c, heads, f, **{**LONG_VARIANTS, **LONG_FWD_VARIANTS}
                                  .get(name, ((), {}))[1])
                plan = p._asdict()
            elif wide and name != "against":
                plan = split_variant_plan(name, d, f, False)._asdict()
            rec = dict(variant=name, shape=f"{shape_name} {(b, f, l, c)} heads={heads}", ms=ms,
                       turns=turns[name], library_ms=sdpa_ms, bound_ms=bound_ms,
                       share_of_bound=bound_ms / ms,
                       ablation=(name in TEMPORAL_VARIANTS and TEMPORAL_VARIANTS[name][1]
                                 or name in split_table and split_table[name][4]),
                       ok=ok, rel_l2=rel, same_bits_on_repeat=same, plan=plan,
                       device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return records


def run_temporal_bwd(names: Sequence[str], iters: int = 5,
                     against: Optional[str] = None) -> List[dict]:
    """Kernel B's backward variants at every shape of ``TEMPORAL_BWD_SHAPES``
    (those of ``TEMPORAL_BWD_VARIANTS``), of ``TEMPORAL_BWD_LONG_SHAPES``
    (those of ``FRAMES_BWD_VARIANTS``, and ``long_at_frames``) and of
    ``TEMPORAL_BWD_PAST_SHAPES`` (those of ``LONG_VARIANTS``), ``kernel``
    and ``against`` at all: each but the ablations held to
    ``temporal_attention_backward_plain`` (``chip_smoke.py``'s limits per
    gradient) and to its own bits on a repeat launch, then timed in turns
    beside SDPA's backward on head-split copies. ``against`` is another
    source of ``hv_temporal_bwd``; an earlier design's is called with the
    size arguments its entry point takes (:func:`_temporal_sizes_taken`,
    :func:`earlier_sizes`). Returns the records (also printed, one JSON
    line each)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ..ops import temporal_attention as ta

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    table = {**TEMPORAL_BWD_VARIANTS,
             **{n: (v[0], False) for n, v in FRAMES_BWD_VARIANTS.items()},
             **_long_table(True), LONG_AT_FRAMES: ((), False)}
    split_table = _split_table(True)
    texts = _named_sources([n for n in names if n not in split_table], table,
                           "temporal_attention_bwd.cu", against)
    texts.update({n: split_variant_source(n, True) for n in names if n in split_table})
    n_sizes = {n: _temporal_sizes_taken(t) for n, t in texts.items()}
    reach = frames_reach(texts["against"]) if "against" in texts else None
    fns = {}
    for name, lib in _build(texts, "temporal_bwd_variant").items():
        fn = fns[name] = lib.hv_temporal_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_sizes[name] + [ctypes.c_void_p]
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    records = []
    shapes = TEMPORAL_BWD_SHAPES + TEMPORAL_BWD_LONG_SHAPES + TEMPORAL_BWD_PAST_SHAPES
    for shape_name, b, f, l, c, heads in shapes:
        frames = ta.ITEM_FRAMES < f <= ta.FRAMES_KERNEL_FRAMES
        past = f > ta.FRAMES_KERNEL_FRAMES
        d = c // heads
        wide = f <= ta.ITEM_FRAMES and d > ta.CHUNK_COLUMNS

        def runs_at(n):
            if n in ("kernel", "against"):
                return True
            if n in split_table:
                return wide and split_variant_plan(n, d, f, True) is not None
            if n in FRAMES_BWD_VARIANTS:
                return frames and f <= FRAMES_BWD_VARIANTS[n][2]
            if n == LONG_AT_FRAMES:
                return frames
            if n in LONG_VARIANTS or n in LONG_BWD_VARIANTS:
                return past
            return not frames and not past and not wide

        runs = [n for n in fns if runs_at(n)]
        if runs == ["kernel"] and names != ["kernel"]:
            continue  # none of the named variants differs from the kernel here
        q, k, v, g = (torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        grads = [torch.empty_like(q) for _ in range(3)]
        ptrs = tuple(t.data_ptr() for t in (q, k, v, g, *grads))
        calls = {}
        for name in runs:
            n = n_sizes[name]
            if wide and (name != "against" or "kModeSplit" in texts[name]):
                sizes = split_variant_sizes(split_variant_plan(name, d, f, True), q.shape, heads)
            elif wide and n == 12:  # an earlier source: its column chunks' kernel
                sizes = (*ta.launch_sizes(tuple(q.shape), heads), ta.MODE_ITEMS, 0, 0)
            elif name == "against" and n != 12:
                sizes = earlier_sizes(n, tuple(q.shape), heads, True, reach)
            elif name in FRAMES_BWD_VARIANTS:
                sizes = frames_variant_sizes(name, q.shape, heads)
            else:
                sizes = long_variant_sizes(name, q.shape, heads, True)
            calls[name] = (lambda fn=fns[name], args=(*ptrs, *sizes[:n], stream), name=name:
                           cuda_build.check(fn(*args), f"variant {name}"))
        refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
        checks = {}
        for name in runs:
            if (name in TEMPORAL_BWD_VARIANTS and TEMPORAL_BWD_VARIANTS[name][1]
                    or name in FRAMES_BWD_ABLATIONS or name in LONG_BWD_ABLATIONS
                    or name in split_table and split_table[name][4]):
                checks[name] = (None, None, None)
                continue
            for t in grads:
                t.zero_()
            calls[name]()
            torch.cuda.synchronize()
            agree = [_agree(got, ref, TEMPORAL_BWD_TOL) for got, ref in zip(grads, refs)]
            first = [t.clone() for t in grads]
            calls[name]()
            same = all(torch.equal(a, b_) for a, b_ in zip(grads, first))
            checks[name] = (all(a[0] for a in agree), max(a[1] for a in agree), same)
        del refs
        torch.cuda.empty_cache()
        turns = _turns(calls, 20 * iters)

        def split(t):  # (b, f, l, c) -> (b*l, f, c), contiguous
            return t.permute(0, 2, 1, 3).reshape(b * l, f, c)

        # SDPA's default backend faults at one frame over 57344 x 8 heads
        with sdpa_kernel(SDPBackend.MATH) if f == 1 else contextlib.nullcontext():
            sdpa_ms = _sdpa_backward_ms(*(split(t) for t in (q, k, v, g)), heads, None,
                                        20 * iters)
        bound_ms = 14.0 * q.numel() / 3.35e12 * 1e3
        for name in runs:
            ms = min(turns[name])
            ok, rel, same = checks[name]
            plan = None
            if wide and name != "against":
                plan = split_variant_plan(name, d, f, True)._asdict()
            elif name in FRAMES_BWD_VARIANTS or (frames and name == "kernel"):
                plan = ta.long_backward_plan(
                    c, heads, f, **FRAMES_BWD_VARIANTS.get(name, ((), {}, 0))[1])._asdict()
            elif name != "against" and (past or name == LONG_AT_FRAMES):
                plan = ta._long_plan(True, c, heads, f, **{**LONG_VARIANTS, **LONG_BWD_VARIANTS}
                                     .get(name, ((), {}))[1])._asdict()
            rec = dict(variant=name, shape=f"{shape_name} {(b, f, l, c)} heads={heads}", ms=ms,
                       turns=turns[name], library_ms=sdpa_ms, bound_ms=bound_ms,
                       share_of_bound=bound_ms / ms,
                       ablation=(name in TEMPORAL_BWD_VARIANTS and TEMPORAL_BWD_VARIANTS[name][1]
                                 or name in FRAMES_BWD_ABLATIONS or name in LONG_BWD_ABLATIONS
                                 or name in split_table and split_table[name][4]),
                       ok=ok, rel_l2=rel, same_bits_on_repeat=same, plan=plan,
                       device=torch.cuda.get_device_name())
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, g, grads
        torch.cuda.empty_cache()
    return records


def run_mid(names: Sequence[str], iters: int = 5, against: Optional[str] = None) -> List[dict]:
    """The mid kernel's variants at every shape of ``MID_SHAPES`` where the
    kernel is built for their plan: each held to the plain version on 128
    query rows (``chip_smoke.py``'s limits) and to the bits of ``kernel``,
    timed by CUDA events in turns beside SDPA. ``against`` is an earlier
    forward source, called at width 512 on inputs zero-padded beforehand
    (its output cut back to d before the check); the pad copies of q, k and
    v are timed apart (``pad_ms``). Returns the records (also printed, one
    JSON line each)."""
    from ..ops.head_pad import resize_heads

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts = _named_sources(names, {n: (v[0], v[3]) for n, v in MID_VARIANTS.items()},
                           "flash_attention.cu", against)
    entry = {n: _entry_ints(t) for n, t in texts.items()}
    fns = {}
    for name, lib in _build(texts, "flash_mid_variant").items():
        fn = fns[name] = lib.hv_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * entry[name] + [ctypes.c_void_p]
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    card = torch.cuda.get_device_name()
    records = []
    for shape, B, lq, lk, heads, d, bias_rows in MID_SHAPES:
        c = heads * d
        q = torch.randn((B, lq, c), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, lk, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias, unmasked = None, B * lk
        if bias_rows:
            bias = torch.zeros((B, lk), device=dev)
            bias[:bias_rows, lk // 2:] = -1e9
            unmasked -= bias_rows * (lk // 2)
        bias_ptr = None if bias is None else bias.data_ptr()
        lse = torch.empty((B, heads, lq), device=dev)
        plans = {n: mid_variant_plan(n, d) for n in fns if n != "against"}
        runs = [n for n in fns if n == "against" or plans[n] is not None]
        outs, calls, pad_ms = {}, {}, None
        for name in runs:
            if name == "against":
                padded = [resize_heads(t, heads, fa.WIDE_HEAD_DIM) for t in (q, k, v)]
                out = outs[name] = torch.empty_like(padded[0])
                args = (*(t.data_ptr() for t in padded), bias_ptr, out.data_ptr(),
                        lse.data_ptr(), *_entry_sizes(entry[name], (B, lq, lk, heads,
                                                                    fa.WIDE_HEAD_DIM), d, "fwd"))
                pad_ms = _time_ms(lambda: [resize_heads(t, heads, fa.WIDE_HEAD_DIM)
                                           for t in (q, k, v)], iters)
            else:
                out = outs[name] = torch.empty_like(q)
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                        lse.data_ptr(), B, lq, lk, heads, d, d,
                        *fa._plan_args(d, "fwd", plans[name]))
            calls[name] = (lambda fn=fns[name], args=(*args, stream), name=name:
                           cuda_build.check(fn(*args), f"mid variant {name}"))
        rows = torch.cat([torch.arange(64, device=dev), torch.arange(lq - 64, lq, device=dev)])
        ref, ref_lse = fa.flash_attention_plain(q[:, rows], k, v, heads, bias)
        checks, first = {}, None
        for name in runs:
            calls[name]()
            torch.cuda.synchronize()
            got = resize_heads(outs[name], heads, d)
            ok, rel = _agree(got[:, rows], ref, FLASH_TOL)
            lse_err = (lse[:, :, rows] - ref_lse).abs().max().item()
            if first is None:
                first = got.clone()
            checks[name] = (ok and lse_err <= LSE_TOL, rel, lse_err, torch.equal(got, first))
        del first, ref, ref_lse
        turns = _turns(calls, iters)
        qh, kh, vh = (t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        try:
            sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), iters)
        except (torch.OutOfMemoryError, RuntimeError):
            sdpa_ms = None
            torch.cuda.empty_cache()
        flops = 4.0 * heads * lq * unmasked * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        bound_ms = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        for name in runs:
            ms = min(turns[name])
            ok, rel, lse_err, same = checks[name]
            plan = plans.get(name)
            rec = dict(mode="mid", variant=name, shape=shape, ms=ms, turns=turns[name],
                       tflops=flops / ms / 1e9, bound_ms=bound_ms, sdpa_ms=sdpa_ms, ok=ok,
                       rel_l2=rel, lse_err=lse_err, same_bits_as_first=same,
                       plan=None if plan is None else plan._asdict(),
                       pad_ms=pad_ms if name == "against" else None, device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, outs, lse, qh, kh, vh
        torch.cuda.empty_cache()
    return records


def _sdpa_backward_by_backend(q, k, v, g, heads, bias, iters: int) -> Dict[str, float]:
    """SDPA's backward under each backend that runs the shape: {name: ms}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                ms = _sdpa_backward_ms(q, k, v, g, heads, bias, iters)
        except RuntimeError:  # no kernel of this backend for the shape
            ms = None
        torch.cuda.empty_cache()
        if ms is not None:
            times[backend.name] = ms
    return times


def run_mid_bwd(names: Sequence[str], iters: int = 5,
                against: Optional[str] = None) -> List[dict]:
    """The mid backward's variants at every shape of ``MID_BWD_SHAPES``:
    each held to the plain backward on the first two batch rows
    (``chip_smoke.py``'s limits per gradient) and to the bits of
    ``kernel``, its dk/dv and dq entry points timed in turns beside SDPA's
    backward by backend. ``against`` is an earlier backward source, called
    at width 512 on inputs zero-padded beforehand (its gradients cut back
    to d before the check); the pad copies of q, k, v and g and the slices
    of dq, dk and dv back to d are timed apart (``pad_ms``) and added to its
    ``ms``. Returns the records (also printed, one JSON line each)."""
    from ..ops.head_pad import resize_heads

    if not torch.cuda.is_available():
        raise RuntimeError("the variants run on the CUDA card, and none is available")
    dev = torch.device("cuda")
    texts = _named_sources(names, {n: (v[0], v[2]) for n, v in MID_BWD_VARIANTS.items()},
                           "flash_attention_mid_bwd.cu", against)
    entry = {n: _entry_ints(t) for n, t in texts.items()}
    fns = {}
    for name, lib in _build(texts, "flash_mid_bwd_variant").items():
        mid = "" if name == "against" else "_mid"
        dkv, dq = getattr(lib, f"hv_flash_bwd{mid}_dkv"), getattr(lib, f"hv_flash_bwd{mid}_dq")
        dkv.restype = dq.restype = ctypes.c_int
        dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * entry[name] + [ctypes.c_void_p]
        dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * entry[name] + [ctypes.c_void_p]
        fns[name] = (dkv, dq)
    stream = cuda_build.stream_handle(dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    card = torch.cuda.get_device_name()
    wide = fa.WIDE_HEAD_DIM
    records = []
    for shape, B, lq, lk, heads, d, bias_rows in MID_BWD_SHAPES:
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
        del out
        bias_ptr = None if bias is None else bias.data_ptr()
        plans = {n: mid_bwd_variant_plan(n, d) for n in fns if n != "against"}
        grads, calls, pad_ms = {}, {}, None
        for name in fns:
            if name == "against":
                ins = [resize_heads(t, heads, wide) for t in (q, k, v, g)]
                width = wide
                pad_ms = _time_ms(lambda: ([resize_heads(t, heads, wide) for t in (q, k, v, g)],
                                           [resize_heads(t, heads, d) for t in ins[:3]]), iters)
            else:
                ins, width = [q, k, v, g], d
            grads[name] = [torch.empty_like(t) for t in ins[:3]]
            common = (ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(), bias_ptr,
                      ins[3].data_ptr(), lse.data_ptr(), delta.data_ptr())
            dq_, dk_, dv_ = (t.data_ptr() for t in grads[name])
            sizes = (B, lq, lk, heads, width, d)
            plan = plans.get(name)
            extra = entry[name] - 6  # the plan's ints the entry point takes
            dkv_args = (*common, dk_, dv_, *sizes, *fa._plan_args(width, "dkv", plan)[:extra],
                        stream)
            dq_args = (*common, dq_, *sizes, *fa._plan_args(width, "dq", plan)[:extra], stream)
            calls[name] = (
                lambda fn=fns[name][0], args=dkv_args, name=name:
                    cuda_build.check(fn(*args), f"mid bwd variant {name} dk/dv"),
                lambda fn=fns[name][1], args=dq_args, name=name:
                    cuda_build.check(fn(*args), f"mid bwd variant {name} dq"))
        n = min(2, B)  # the plain version on the first batch rows
        refs = fa.flash_attention_backward_plain(
            q[:n], k[:n], v[:n], None if bias is None else bias[:n], g[:n], lse[:n], delta[:n],
            heads)
        checks, first = {}, None
        for name in fns:
            if name in MID_BWD_VARIANTS and MID_BWD_VARIANTS[name][2]:
                checks[name] = (None, None, None)  # an ablation computes something else
                continue
            for call in calls[name]:
                call()
            torch.cuda.synchronize()
            got = [resize_heads(t, heads, d) for t in grads[name]]
            agree = [_agree(x[:n], r, FLASH_BWD_TOL) for x, r in zip(got, refs)]
            if first is None:
                first = [x.clone() for x in got]
            same = all(torch.equal(a, b_) for a, b_ in zip(got, first))
            checks[name] = (all(a[0] for a in agree), max(a[1] for a in agree), same)
        del refs, first
        torch.cuda.empty_cache()
        dkv_turns = _turns({n: calls[n][0] for n in fns}, iters)
        dq_turns = _turns({n: calls[n][1] for n in fns}, iters)
        del grads, calls
        torch.cuda.empty_cache()
        sdpa = _sdpa_backward_by_backend(q, k, v, g, heads, bias, iters)
        flops = 10.0 * heads * lq * unmasked * d
        nbytes = 2 * (3 * q.numel() + 4 * k.numel()) + 4 * (lse.numel() + delta.numel()) \
            + (0 if bias is None else 4 * bias.numel())
        bound_ms = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        for name in fns:
            dkv_ms, dq_ms = min(dkv_turns[name]), min(dq_turns[name])
            ms = dkv_ms + dq_ms + (pad_ms if name == "against" else 0.0)
            ok, rel, same = checks[name]
            plan = plans.get(name)
            rec = dict(mode="mid_bwd", variant=name, shape=shape, ms=ms, dkv_ms=dkv_ms,
                       dq_ms=dq_ms, dkv_turns=dkv_turns[name], dq_turns=dq_turns[name],
                       pad_ms=pad_ms if name == "against" else None, tflops=flops / ms / 1e9,
                       bound_ms=bound_ms, share_of_bound=bound_ms / ms, sdpa_ms=sdpa,
                       ok=ok, rel_l2=rel, same_bits_as_first=same,
                       plan=None if plan is None else plan._asdict(), device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del q, k, v, g, lse, delta
        torch.cuda.empty_cache()
    return records


def main(argv: Sequence[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help=f"variants to run (default: all): {', '.join(VARIANTS)}; with "
                             f"--bwd: {', '.join(BWD_VARIANTS)}; with --pvt: "
                             f"{', '.join(PVT_VARIANTS)}; with --dmajor: "
                             f"{', '.join(DMAJOR_VARIANTS)}; with --hbm: {', '.join(HBM_VARIANTS)}; "
                             f"with --gn: {', '.join(GN_VARIANTS)}; with --temporal: "
                             f"{', '.join([*TEMPORAL_VARIANTS, *LONG_VARIANTS])}, "
                             f"{', '.join([*LONG_FWD_VARIANTS, *SPLIT_VARIANTS])}, "
                             f"{', '.join(SPLIT_FWD_VARIANTS)}; with "
                             f"--temporal-bwd: "
                             f"{', '.join([*TEMPORAL_BWD_VARIANTS, *FRAMES_BWD_VARIANTS])}, "
                             f"{', '.join([*LONG_VARIANTS, *LONG_BWD_VARIANTS])}, "
                             f"{LONG_AT_FRAMES}, "
                             f"{', '.join([*SPLIT_VARIANTS, *SPLIT_BWD_VARIANTS])}; "
                             f"with --xwide: {', '.join(XWIDE_VARIANTS)}; with --mid: "
                             f"{', '.join(MID_VARIANTS)}; with --mid-bwd: "
                             f"{', '.join(MID_BWD_VARIANTS)}; with --own: "
                             f"{', '.join(OWN_VARIANTS)}")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--bwd", action="store_true", help="the backward's variants")
    mode.add_argument("--pvt", action="store_true", help="kernel 9's variants")
    mode.add_argument("--dmajor", action="store_true", help="kernel 8's variants")
    mode.add_argument("--hbm", action="store_true", help="kernel 10's variants")
    mode.add_argument("--gn", action="store_true", help="kernel C's variants")
    mode.add_argument("--temporal", action="store_true", help="kernel B's forward variants")
    mode.add_argument("--temporal-bwd", action="store_true",
                      help="kernel B's backward variants")
    mode.add_argument("--xwide", action="store_true",
                      help="kernel A's variants past 512 columns, forward and backward")
    mode.add_argument("--mid", action="store_true",
                      help="kernel A's forward variants between 128 and 512 columns")
    mode.add_argument("--mid-bwd", action="store_true",
                      help="kernel A's backward variants between 128 and 512 columns")
    mode.add_argument("--own", action="store_true",
                      help="kernel A's variants at the head's own width (d = 64, 80 < d <= "
                           "128), forward and backward")
    parser.add_argument("--against", metavar="FILE", action="append", default=[],
                        help="with any mode but the forward's: another source of the same "
                             "kernels, timed as 'against' (with --xwide or --own a forward "
                             "source, a backward source or one of each: give it twice)")
    parser.add_argument("--iters", type=int, default=5,
                        help="launches per timed turn (20 times as many with --dmajor, --hbm, "
                             "--gn, --temporal, --temporal-bwd)")
    args = parser.parse_args(argv)
    modes = {"bwd": (BWD_VARIANTS, run_bwd), "pvt": (PVT_VARIANTS, run_pvt),
             "dmajor": (DMAJOR_VARIANTS, run_dmajor), "hbm": (HBM_VARIANTS, run_hbm),
             "gn": (GN_VARIANTS, run_gn),
             "temporal": ({**TEMPORAL_VARIANTS, **LONG_VARIANTS, **LONG_FWD_VARIANTS,
                           **SPLIT_VARIANTS, **SPLIT_FWD_VARIANTS}, run_temporal),
             "temporal_bwd": ({**TEMPORAL_BWD_VARIANTS, **FRAMES_BWD_VARIANTS, **LONG_VARIANTS,
                               **LONG_BWD_VARIANTS, LONG_AT_FRAMES: None, **SPLIT_VARIANTS,
                               **SPLIT_BWD_VARIANTS}, run_temporal_bwd),
             "xwide": (XWIDE_VARIANTS, run_xwide), "mid": (MID_VARIANTS, run_mid),
             "mid_bwd": (MID_BWD_VARIANTS, run_mid_bwd), "own": (OWN_VARIANTS, run_own)}
    mode_name = next((m for m in modes if getattr(args, m)), None)
    table = modes[mode_name][0] if mode_name else VARIANTS
    names = args.variants or list(table)
    unknown = [n for n in names if n not in table]
    if unknown:
        parser.error(f"unknown variants {unknown}; the variants are {', '.join(table)}")
    if args.against and not mode_name:
        parser.error("--against needs --bwd, --pvt, --dmajor, --hbm, --gn, --temporal, "
                     "--temporal-bwd, --xwide, --mid, --mid-bwd or --own")
    if len(args.against) > (2 if mode_name in ("xwide", "own") else 1):
        parser.error("--against takes one source (with --xwide or --own two)")
    if "kernel" not in names:
        names = ["kernel", *names]
    if mode_name in ("xwide", "own"):
        records = modes[mode_name][1](names, args.iters, args.against)
    elif mode_name:
        records = modes[mode_name][1](names, args.iters,
                                      args.against[0] if args.against else None)
    else:
        records = run(names, args.iters)
    return 0 if all(r["ok"] is not False for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
