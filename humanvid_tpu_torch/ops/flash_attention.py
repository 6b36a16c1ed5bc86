"""Flash attention forward in the packed head layout (kernel A).

``flash_attention_packed(q, k, v, heads, key_bias)`` computes, for each batch
row and head h, ``softmax(q_h k_h^T * d^-1/2 + key_bias) v_h`` on q of shape
(B, Lq, heads*d) and k/v of shape (B, Lk, heads*d), heads side by side in the
channel axis, and returns the output (B, Lq, heads*d) in the input dtype and
the per-(row, head) log-sum-exp (B, heads, Lq) in fp32, natural-log units.

On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` (bf16 only) or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch.

The gradient (:class:`FlashAttention`, an autograd Function) recomputes the
probabilities from the forward's ``lse``: on a CUDA tensor through the
dk/dv and dq entry points of ``csrc/flash_attention_bwd.cu`` (at d = 512
the dk/dv entry point launches a dV and a dK kernel), on a CPU tensor
through :func:`flash_attention_backward_plain`.

Head widths (:func:`flash_plan`): the kernels hold d a multiple of 8 up to
128, and d = 512; d = 64 and every width from 88 to 128 run at the head's
own width (:func:`own_plan`: the products over d rounded up to 16, each
head in the widest TMA box that divides it). Any other d up to 512 runs
through a zero pad
(``head_pad.resize_heads``) to the next multiple of 8, with the softmax
scale of the true d; between 128 and 512 the forward runs at that width in
the mid kernel (its layout from :func:`mid_plan`), and so does the
backward, in ``csrc/flash_attention_mid_bwd.cu`` (its kernels and ring from
:func:`mid_backward_plan`; the LSE of the forward at the true width is the
LSE it needs). Past 512 every width runs in the xwide kernels (forward,
dK/dV and dQ), padded to the next multiple of 8: the head's depth split
over a thread-block cluster in slices of at most 256 columns, on the plan
:func:`xwide_plan` computes and the wrapper passes to the C entry points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .head_pad import resize_heads, round_up8

WIDE_HEAD_DIM = 512  # the 512-wide kernels' width; wider heads run in the xwide kernels

# pointers, the sizes (B, Lq, Lk, heads, d, scale_d), the xwide plan's seven
# ints (``_plan_args``), the stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]

# Launches of the CUDA kernels by the width they ran at, "d<=128" (the
# UNet's heads), "128<d<512" (the mid kernels), "d>128" (the 512-wide
# kernels: the VAE's single head) and "d>512" (the xwide kernels): the
# forward and the backward's two entry points.
launches = {"d<=128": 0, "128<d<512": 0, "d>128": 0, "d>512": 0, "bwd_dkv": 0, "bwd_dq": 0,
            "bwd_dkv_128<d<512": 0, "bwd_dq_128<d<512": 0, "bwd_dkv_d>128": 0,
            "bwd_dq_d>128": 0, "bwd_dkv_d>512": 0, "bwd_dq_d>512": 0,
            # of the "d<=128" ones, those at the head's own width (own_plan)
            "own": 0, "bwd_dkv_own": 0, "bwd_dq_own": 0}
# The forward's and the backward's launches by the caller's head width
# (before any pad): {d: count}; and those of them that ran through the zero
# pad past the next multiple of 8.
forward_launches_by_d: dict = {}
backward_launches_by_d: dict = {}
forward_pad_launches_by_d: dict = {}
backward_pad_launches_by_d: dict = {}
# The forward's and the backward's launches by the caller's head width and
# the configuration they ran in (``flash_plan``'s names): {(d, name): count}.
forward_launches_by_config: dict = {}
backward_launches_by_config: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for counts in (forward_launches_by_d, backward_launches_by_d, forward_pad_launches_by_d,
                   backward_pad_launches_by_d, forward_launches_by_config,
                   backward_launches_by_config):
        counts.clear()


def _count(by_d: dict, pad_by_d: dict, by_config: dict, d: int, width: int,
           config: str) -> None:
    by_d[d] = by_d.get(d, 0) + 1
    if width > round_up8(d):
        pad_by_d[d] = pad_by_d.get(d, 0) + 1
    by_config[d, config] = by_config.get((d, config), 0) + 1


class FlashPlan(NamedTuple):
    """How the kernels run a d-wide head: the forward at ``width`` columns
    (d, or d zero-padded to the next multiple of 8) through its
    configuration ``forward`` in ``csrc/flash_attention.cu``, the backward
    at ``backward_width`` columns (the same width) through ``backward``
    (dk/dv, dq) in ``csrc/flash_attention_bwd.cu``, or between 128 and 512
    in ``csrc/flash_attention_mid_bwd.cu``."""
    width: int
    forward: str
    backward: str
    backward_width: int


# The mid forward (128 < d < 512): the products' depth (d rounded up to 64)
# and its layout, "rows" (two 64-row query tiles, O whole in each
# warpgroup) or "columns" (one 64-row tile, O's columns split between the
# two warpgroups): the widths each layout is built for, and each width's
# layout.
MID_WIDTHS = {"rows": (192, 256, 320), "columns": (384, 448, 512)}
MID_LAYOUTS = {w: layout for layout, widths in MID_WIDTHS.items() for w in widths}


class MidPlan(NamedTuple):
    width: int
    layout: str


@functools.lru_cache(maxsize=None)
def mid_plan(d: int) -> MidPlan:
    """The mid forward's plan for 128 < d < 512 (d a multiple of 8): d
    rounded up to 64 in the layout MID_LAYOUTS names."""
    if not WIDE_HEAD_DIM // 4 < d < WIDE_HEAD_DIM or d % 8:
        raise ValueError(f"head width {d}: the mid forward takes 128 < d < 512, a multiple of 8")
    w = -(-d // 64) * 64
    return MidPlan(w, MID_LAYOUTS[w])


# The own-width kernels (``flash_fwd_own_kernel``, ``DkvOwn``/``DqOwn``):
# the TMA boxes a head may arrive in, the widest that divides it (64, 32
# and 16 columns in the 128-, 64- and 32-byte swizzles, 8 without).
OWN_BOXES = (64, 32, 16, 8)


class OwnPlan(NamedTuple):
    width: int  # the products' width: QK^T's depth, PV's N
    box: int    # columns of one TMA box


def is_own(width: int) -> bool:
    """Whether a head ``width`` wide (a multiple of 8) runs in the
    own-width kernels: 64, and 88 to 128."""
    return width == 64 or 80 < width <= 128


@functools.lru_cache(maxsize=None)
def own_plan(d: int) -> OwnPlan:
    """The own-width kernels' plan for d = 64 or 80 < d <= 128 (a multiple
    of 8): products over d rounded up to 16, boxes of the widest of
    OWN_BOXES that divides d where that rounding adds nothing, else 8."""
    if d % 8 or not is_own(d):
        raise ValueError(f"head width {d}: the own-width kernels take d = 64 or "
                         "80 < d <= 128, a multiple of 8")
    w = -(-d // 16) * 16
    return OwnPlan(w, next(c for c in OWN_BOXES if d % c == 0) if w == d else 8)


@functools.lru_cache(maxsize=None)
def flash_plan(d: int) -> FlashPlan:
    """The kernels' plan for a head of d columns (the C entry points pick
    the same configurations by width); raises for d < 1."""
    if d < 1:
        raise ValueError(f"head width {d} unsupported by kernel A: it takes d >= 1")
    w = round_up8(d)
    if d > WIDE_HEAD_DIM:
        return FlashPlan(w, "Xwide", "XwideDkv/XwideDq", w)
    if w <= 40:
        return FlashPlan(w, "Cfg<48, 40>", "DkvCfg48/DqCfg48", w)
    if is_own(w):
        own = f"<{own_plan(w).width}, {own_plan(w).box}>"
        return FlashPlan(w, f"Own{own}", f"DkvOwn{own}/DqOwn{own}", w)
    if w <= 80:
        return FlashPlan(w, "Cfg<80, 80>", "DkvCfg80s/DqCfg80s" if w % 16 == 0
                         else "DkvCfg80/DqCfg80", w)
    if w == WIDE_HEAD_DIM:
        return FlashPlan(w, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq", w)
    mid = mid_plan(w)
    bwd = mid_backward_plan(w)
    dkv = "MidDkv" if bwd.layout == "merged" else "MidDv+MidDk"
    return FlashPlan(w, f"Mid<{mid.width}, {mid.layout}>", f"{dkv}<{bwd.width}>/MidDq<{bwd.width}>",
                     w)


# The mid backward (128 < d < 512, csrc/flash_attention_mid_bwd.cu): the
# products' depth (d rounded up to 64); up to 320 one merged dk/dv kernel
# (dK and dV of 64 keys in registers, DQK / 2 fp32 a thread each) and dq by
# role (dQ of 64 q rows in one warpgroup's registers), past it a dV and a dK
# kernel and dq by columns; the rows of a step (64 where the ring still
# fits two stages or more, else 32), and rings as deep as shared memory
# holds up to MID_BWD_MAX_STAGES.
MID_BWD_MERGED_MAX = 320
MID_BWD_ROWS = {192: 64, 256: 64}  # dk/dv rows a step; 32 at the other widths
MID_BWD_DQ_ROWS = {192: 64}        # dq keys a step; 32 at the other widths
MID_BWD_MAX_STAGES = 4


class MidBackwardPlan(NamedTuple):
    """How the mid backward runs a head of 128 < d < 512 columns: products
    over ``width`` columns; ``layout`` "merged" (one dk/dv kernel) or
    "split" (a dV and a dK kernel); ``rows`` q rows a dk/dv step, in a ring
    of ``stages`` (merged, or dV's) and ``dk_stages`` (split: dK's; 0
    merged); the dq kernel's ``dq_layout``, "roles" (warpgroup 1 takes all
    of dQ) or "columns" (the two split its columns), ``dq_rows`` keys a
    step in ``dq_stages``."""
    width: int
    layout: str
    rows: int
    stages: int
    dk_stages: int
    dq_layout: str
    dq_rows: int
    dq_stages: int


def mid_bwd_smem(kernel: str, width: int, rows: int, stages: int) -> int:
    """Bytes of shared memory a block of the mid backward's ``kernel``
    ("dkv" merged, "dv", "dk", "dq" by columns or "dq_roles") lays out
    (``mid_smem`` in csrc/flash_attention_mid_bwd.cu): the owned 64-row
    tiles (one for dV), a stage's two streamed tiles and words, the
    exchange (64 x rows fp32: by role two slots of warpgroup 0's with a
    full and an empty barrier each, by columns both warpgroups' twice by
    step parity), the barriers and 1024 bytes of alignment."""
    if kernel not in ("dkv", "dv", "dk", "dq", "dq_roles"):
        raise ValueError(f"kernel {kernel!r}: 'dkv', 'dv', 'dk', 'dq' or 'dq_roles'")
    own = 1 if kernel == "dv" else 2
    roles = kernel in ("dkv", "dq_roles")
    return (own * 64 * width * 2 + stages * (2 * rows * width * 2 + 2 * rows * 4 + 16)
            + (2 if roles else 4) * 64 * rows * 4 + (3 * stages + 1 + (4 if roles else 0)) * 8
            + 1024)


def _mid_stages(kernel: str, width: int, rows: int, max_stages: int) -> int:
    stages = max((n for n in range(1, max_stages + 1)
                  if mid_bwd_smem(kernel, width, rows, n) <= SMEM_LIMIT), default=0)
    if not stages:
        raise ValueError(f"no stage of the mid backward's {kernel} fits at width {width}")
    return stages


@functools.lru_cache(maxsize=None)
def mid_backward_plan(d: int, layout: Optional[str] = None, rows: Optional[int] = None,
                      max_stages: int = MID_BWD_MAX_STAGES, dq_layout: Optional[str] = None,
                      dq_rows: Optional[int] = None) -> MidBackwardPlan:
    """The mid backward's plan for 128 < d < 512 (d a multiple of 8): d
    rounded up to 64, merged and dq by role up to MID_BWD_MERGED_MAX, the
    rings as deep as fit. Arguments other than d are the variants'
    ablations."""
    if not WIDE_HEAD_DIM // 4 < d < WIDE_HEAD_DIM or d % 8:
        raise ValueError(f"head width {d}: the mid backward takes 128 < d < 512, a multiple of 8")
    w = -(-d // 64) * 64
    small = w <= MID_BWD_MERGED_MAX
    layout = layout or ("merged" if small else "split")
    rows = rows or (MID_BWD_ROWS.get(w, 32) if layout == "merged" else 32)
    dq_layout = dq_layout or ("roles" if small else "columns")
    dq_rows = dq_rows or (MID_BWD_DQ_ROWS.get(w, 32) if dq_layout == "roles" else 32)
    first = "dkv" if layout == "merged" else "dv"
    dq = "dq_roles" if dq_layout == "roles" else "dq"
    return MidBackwardPlan(
        w, layout, rows, _mid_stages(first, w, rows, max_stages),
        0 if layout == "merged" else _mid_stages("dk", w, rows, max_stages),
        dq_layout, dq_rows, _mid_stages(dq, w, dq_rows, max_stages))


# The xwide kernels (csrc/xwide.cuh): slices of XWIDE_SLICE columns, one
# 64-row tile a cluster of at most XWIDE_MAX_CLUSTER blocks, shared memory
# reckoned as the kernels lay it out.
XWIDE_SLICE = 256
XWIDE_SLICES = (128, 256)  # the slice widths the kernels are built for
XWIDE_KEY_TILE = 64
XWIDE_MAX_CLUSTER = 8
XWIDE_INFO_SLOTS, XWIDE_INFO_BYTES = 3, 2 * 64 * 4 + 16
SMEM_LIMIT = 232448  # shared memory a block can use on the H100


class XwidePlan(NamedTuple):
    """How the xwide kernels run a head of d > 512 columns: slices of
    ``slice`` columns, ``cluster`` blocks a cluster (each one slice of the
    head's depth), ``groups`` clusters a tile (each writes ``cluster``
    slices of the output and computes S again), ``key_tile`` keys (or q
    rows) a streamed step, the ring's pieces of each direction, and the
    forward's exchange buffers (the backward's is one)."""
    slice: int
    cluster: int
    groups: int
    key_tile: int
    fwd_stages: int
    fwd_exchange: int
    bwd_stages: int


def xwide_smem(plan: XwidePlan, kernel: str) -> int:
    """Bytes of shared memory a block of the forward (``"fwd"``) or of the
    dk/dv and dq kernels (``"bwd"``) lays out for ``plan``: its two
    resident pieces (the Q slices of its two consumer warpgroups; or the
    two owned tiles), the ring, the exchange buffers (a partial of each
    consumer warpgroup a buffer), the words ring, the barriers and 1024
    bytes of alignment (``xwide::Layout``)."""
    fwd = kernel == "fwd"
    if not fwd and kernel != "bwd":
        raise ValueError(f"kernel {kernel!r}: 'fwd' or 'bwd'")
    stages = plan.fwd_stages if fwd else plan.bwd_stages
    xbufs = plan.fwd_exchange if fwd else 1
    piece = plan.key_tile * plan.slice * 2
    partial = plan.key_tile * plan.key_tile * 4
    bars = 2 * stages + 2 * XWIDE_INFO_SLOTS + 1 + 2 * xbufs * 2 * 4
    return ((2 + stages) * piece + 2 * xbufs * partial
            + XWIDE_INFO_SLOTS * XWIDE_INFO_BYTES + 8 * bars + 1024)


@functools.lru_cache(maxsize=None)
def xwide_plan(d: int, slice: int = XWIDE_SLICE) -> XwidePlan:
    """The xwide kernels' plan for a head of d > 512 columns (d a multiple
    of 8): ceil(d / slice) slices, at most XWIDE_MAX_CLUSTER a cluster and
    as many groups of clusters as that takes. The forward (two query tiles
    a block) double-buffers the exchange beside a ring of 2 pieces (3 fit,
    and were slower on the H100), 3 past one cluster, where a warpgroup
    holds both Q slices and K of a depth slice at once; the backward,
    whose steps hold two pieces each, takes a ring of 4 beside its two
    owned tiles and one exchange buffer a matrix, whose reuse waits on the
    cluster's reads."""
    if d <= WIDE_HEAD_DIM or d % 8:
        raise ValueError(f"head width {d}: the xwide kernels take d > {WIDE_HEAD_DIM}, "
                         "a multiple of 8")
    if slice not in XWIDE_SLICES:
        raise ValueError(f"slice {slice}: the xwide kernels are built for {XWIDE_SLICES}")
    slices = -(-d // slice)
    groups = -(-slices // XWIDE_MAX_CLUSTER)
    return XwidePlan(slice, -(-slices // groups), groups, XWIDE_KEY_TILE,
                     fwd_stages=2 if groups == 1 else 3, fwd_exchange=2, bwd_stages=4)


def _plan_args(width: int, kernel: str, plan=None) -> tuple:
    """The seven plan ints of the C entry points of the forward (``"fwd"``)
    or the backward's dk/dv (``"dkv"``) and dq (``"dq"``) kernels: past 512
    the xwide plan (slice, cluster, groups, key tile, stages, exchange
    buffers, shared-memory bytes); between 128 and 512 the mid forward's
    (its width, 1 for the rows layout or 2 for the columns layout, five
    zeros) and the mid backward's (its width, 1 merged or 2 split, the
    split dK kernel's bytes, rows a step, stages, the split dK kernel's
    stages, bytes; dq: its width, 1 by role or 2 by columns, 0, keys a
    step, stages, 0, bytes); zeros at the other widths."""
    if kernel not in ("fwd", "dkv", "dq"):
        raise ValueError(f"kernel {kernel!r}: 'fwd', 'dkv' or 'dq'")
    if 128 < width < WIDE_HEAD_DIM:
        if kernel == "fwd":
            mid = plan or mid_plan(width)
            return (mid.width, 1 if mid.layout == "rows" else 2, 0, 0, 0, 0, 0)
        p = plan or mid_backward_plan(width)
        if kernel == "dq":
            roles = p.dq_layout == "roles"
            return (p.width, 1 if roles else 2, 0, p.dq_rows, p.dq_stages, 0,
                    mid_bwd_smem("dq_roles" if roles else "dq", p.width, p.dq_rows, p.dq_stages))
        if p.layout == "merged":
            return (p.width, 1, 0, p.rows, p.stages, 0,
                    mid_bwd_smem("dkv", p.width, p.rows, p.stages))
        return (p.width, 2, mid_bwd_smem("dk", p.width, p.rows, p.dk_stages), p.rows, p.stages,
                p.dk_stages, mid_bwd_smem("dv", p.width, p.rows, p.stages))
    if width <= WIDE_HEAD_DIM:
        return (0,) * 7
    p = plan or xwide_plan(width)
    fwd = kernel == "fwd"
    return (p.slice, p.cluster, p.groups, p.key_tile, p.fwd_stages if fwd else p.bwd_stages,
            p.fwd_exchange if fwd else 1, xwide_smem(p, "fwd" if fwd else "bwd"))


def _width_key(width: int) -> str:
    """The launch counter of the forward or backward kernels that run a
    head ``width`` wide."""
    if width <= 128:
        return "d<=128"
    if width < WIDE_HEAD_DIM:
        return "128<d<512"
    return "d>128" if width == WIDE_HEAD_DIM else "d>512"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, key_bias: Optional[torch.Tensor] = None,
                          scale_d: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: fp32 logits and softmax, the
    probabilities rounded to the input dtype before the PV product (as the
    JAX kernel does). The logits are scaled by ``scale_d ** -0.5`` (the
    head width d by default; the true width of a zero-padded head)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, lk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * ((scale_d or d) ** -0.5)
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(p.float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, lq, c), lse


def _check(q, k, v, heads, key_bias):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, lq, c = q.shape
    if k.shape[0] != b or k.shape[2] != c or c % heads:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"for {heads} heads")
    if key_bias is not None and tuple(key_bias.shape) != (b, k.shape[1]):
        raise ValueError(f"key_bias {tuple(key_bias.shape)} != {(b, k.shape[1])}")


def _check_cuda(key_bias, **tensors):
    """Every tensor on the first one's (q's) CUDA device and bf16; the bias
    contiguous fp32 there."""
    q = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if key_bias is not None:
        if key_bias.device != q.device or key_bias.dtype != torch.float32 \
                or not key_bias.is_contiguous():
            raise ValueError("key_bias must be contiguous fp32 on q's device")


def _kernel_inputs(heads, width, **tensors):
    """The tensors the kernels read: each padded to ``width`` columns a
    head where the plan pads, and contiguous and 16-byte aligned."""
    out = []
    for name, t in tensors.items():
        t = resize_heads(t, heads, width)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        out.append(t)
    return out


def flash_attention_cuda(q, k, v, heads, key_bias=None):
    """Launch the CUDA kernel; every check the kernel relies on raises here."""
    _check(q, k, v, heads, key_bias)
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    plan = flash_plan(d)
    _check_cuda(key_bias, q=q, k=k, v=v)
    if min(b, lq, lk) < 1 or heads > 65535 or b > 65535:
        raise ValueError(f"unsupported sizes b={b} lq={lq} lk={lk} heads={heads}")
    qk, kk, vk = _kernel_inputs(heads, plan.width, q=q, k=k, v=v)
    out = torch.empty_like(qk)
    lse = torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
    fn = cuda_build.function("flash_attention", "hv_flash_fwd", _FWD_ARGTYPES)
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    err = fn(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), bias_ptr, out.data_ptr(),
             lse.data_ptr(), b, lq, lk, heads, plan.width, d, *_plan_args(plan.width, "fwd"),
             cuda_build.stream_handle(q.device))
    cuda_build.check(err, "flash attention launch")
    launches[_width_key(plan.width)] += 1
    if is_own(plan.width):
        launches["own"] += 1
    _count(forward_launches_by_d, forward_pad_launches_by_d, forward_launches_by_config, d,
           plan.width, plan.forward)
    return resize_heads(out, heads, d), lse


def flash_attention_backward_plain(q, k, v, key_bias, g, lse, delta, heads: int,
                                   chunk: Optional[int] = None, scale_d: Optional[int] = None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in the
    input dtype. Recomputes ``p = exp(s * scale + bias - lse)`` in fp32
    from the natural-log ``lse``, rounds p and ds to the input dtype before
    their products (as the kernels do), and loops over chunks of q rows so
    that the fp32 (B, heads, chunk, Lk) intermediates stay near 512 MB.
    ``scale = scale_d ** -0.5``, the head width d by default."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    scale = (scale_d or d) ** -0.5
    if chunk is None:
        chunk = max(1, (512 << 20) // (b * heads * lk * 4))

    def split(t):  # (B, L, heads*d) -> (B, heads, L, d) fp32
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2).float()

    kh, vh = split(k), split(v)
    bias = 0.0 if key_bias is None else key_bias.float()[:, None, None, :]
    dq = torch.empty((b, heads, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, heads, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(0, lq, chunk):
        qc, gc = split(q[:, i:i + chunk]), split(g[:, i:i + chunk])
        s = torch.matmul(qc, kh.transpose(-1, -2)) * scale + bias
        p = torch.exp(s - lse[:, :, i:i + chunk, None].float())
        dv += torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gc)
        dp = torch.matmul(gc, vh.transpose(-1, -2))
        ds = (p * (dp - delta[:, :, i:i + chunk, None].float())).to(q.dtype).float()
        dq[:, :, i:i + chunk] = torch.matmul(ds, kh) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale

    def merge(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], c).to(q.dtype)

    return merge(dq), merge(dk), merge(dv)


def flash_attention_backward_cuda(q, k, v, key_bias, g, lse, delta, heads: int):
    """Launch the dk/dv and dq kernels; every check they rely on raises here."""
    _check(q, k, v, heads, key_bias)
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    plan = flash_plan(d)
    _check_cuda(key_bias, q=q, k=k, v=v, g=g)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != (b, heads, lq):
            raise ValueError(f"{name} must be contiguous fp32 {(b, heads, lq)} on q's device")
    if min(b, lq, lk) < 1 or heads > 65535 or b > 65535:
        raise ValueError(f"unsupported sizes b={b} lq={lq} lk={lk} heads={heads}")
    width = plan.backward_width
    qk, kk, vk, gk = _kernel_inputs(heads, width, q=q, k=k, v=v, g=g)
    dq, dk, dv = torch.empty_like(qk), torch.empty_like(kk), torch.empty_like(vk)
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    stream = cuda_build.stream_handle(q.device)
    common = (qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), bias_ptr, gk.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    sizes = (b, lq, lk, heads, width, d)
    wide = "" if width <= 128 else "_" + _width_key(width)
    source, mid = (("flash_attention_mid_bwd", "_mid") if 128 < width < WIDE_HEAD_DIM
                   else ("flash_attention_bwd", ""))
    fn = cuda_build.function(source, f"hv_flash_bwd{mid}_dkv", _DKV_ARGTYPES)
    own = is_own(width)
    cuda_build.check(fn(*common, dk.data_ptr(), dv.data_ptr(), *sizes,
                        *_plan_args(width, "dkv"), stream), "flash attention dk/dv launch")
    launches["bwd_dkv" + wide] += 1
    launches["bwd_dkv_own"] += own
    fn = cuda_build.function(source, f"hv_flash_bwd{mid}_dq", _DQ_ARGTYPES)
    cuda_build.check(fn(*common, dq.data_ptr(), *sizes, *_plan_args(width, "dq"), stream),
                     "flash attention dq launch")
    launches["bwd_dq" + wide] += 1
    launches["bwd_dq_own"] += own
    _count(backward_launches_by_d, backward_pad_launches_by_d, backward_launches_by_config, d,
           width, plan.backward)
    return tuple(resize_heads(t, heads, d) for t in (dq, dk, dv))


def attention_delta(g: torch.Tensor, out: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(g * out) per (row, head), fp32 (B, heads, Lq)."""
    b, lq, c = out.shape
    prod = g.float() * out.float()
    return prod.reshape(b, lq, heads, c // heads).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """(out, lse) of packed multi-head attention, differentiable in q, k and
    v; ``lse`` is not differentiable. The backward recomputes the
    probabilities from (q, k, bias, lse): no (Lq x Lk) residual is kept."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, heads):
        if q.device.type == "cpu":
            _check(q, k, v, heads, key_bias)
            out, lse = flash_attention_plain(q, k, v, heads, key_bias)
        else:
            out, lse = flash_attention_cuda(q, k, v, heads, key_bias)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.heads = heads
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        # the gradient arriving through to_out and reshapes may be strided
        g = g.contiguous()
        delta = attention_delta(g, out, ctx.heads)
        if q.device.type == "cpu":
            grads = flash_attention_backward_plain(q, k, v, key_bias, g, lse, delta, ctx.heads)
        else:
            grads = flash_attention_backward_cuda(q, k, v, key_bias, g, lse, delta, ctx.heads)
        return (*grads, None, None)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, key_bias: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed multi-head attention: (out, lse), differentiable in q, k and
    v. CPU tensors take the plain versions; CUDA tensors launch the kernels
    or raise."""
    return FlashAttention.apply(q, k, v, key_bias, heads)
