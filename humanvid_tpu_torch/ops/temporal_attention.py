"""Frame-axis multi-head attention in the spatial layout (kernel B).

``temporal_attention(q, k, v, heads)`` takes q/k/v of shape (b, f, l, c) with
heads packed in c and, for each (b, position l, head), attends over the f
frames: ``softmax(q k^T * d^-1/2) v``. The output has the input's layout; no
``(b f) l c <-> (b l) f c`` rearrange happens.

On a CUDA tensor it launches the hand-written kernel in
``csrc/temporal_attention.cu`` (bf16 only, any f, d <= 1280) or raises; on
a CPU tensor it runs :func:`temporal_attention_plain`. Up to ITEM_FRAMES
frames the kernel's work item is a run of positions x all frames x a chunk
of whole heads, or, for a head wider than CHUNK_COLUMNS, a few positions x
one head in column slices, a consumer warp a slice (:func:`split_plan`);
past ITEM_FRAMES the long forward takes one position x all
frames x whole heads where they fit its ring, else one head in panels of
LONG_PANEL frames and column chunks (:func:`long_fwd_plan`). A head whose
width is no multiple of 8 runs zero-padded to the next one
(``head_pad.resize_heads``), with the softmax scale of its true width.

The gradient (:class:`TemporalAttention`, an autograd Function) keeps only
q, k and v: on a CUDA tensor the one-pass kernel of
``csrc/temporal_attention_bwd.cu`` recomputes the softmax and writes dq, dk
and dv, over the forward's items (a head in slices: :func:`split_plan`'s
ring, which keeps an item for both sweeps or loads q, k and g again); past
ITEM_FRAMES frames, up to
FRAMES_KERNEL_FRAMES, the frames kernel takes the same kind of item (one
position x all frames x whole heads, or one head in column chunks) in a ring
whose stages :func:`long_backward_plan` fits to shared memory, and past
FRAMES_KERNEL_FRAMES the long backward, whose items :func:`long_bwd_plan`
fits as the forward's; on a CPU tensor
:func:`temporal_attention_backward_plain` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import cuda_build
from .head_pad import resize_heads, round_up8

ITEM_FRAMES = 32  # frames the item kernels hold; more run in the long kernels

MAX_HEAD_DIM = 1280  # one head over the widest motion channels
CHUNK_COLUMNS = 160  # an item's columns (8 UNet heads, 320 bytes); a chunk's most

# The backward's frames kernel past ITEM_FRAMES frames (kFramesTiles 16-frame
# tiles in csrc/temporal_attention_bwd.cu): the most frames it takes (past
# them the long kernel), the most stages of its ring, and the shared
# memory a block can use.
FRAMES_KERNEL_FRAMES = 128
FRAMES_KERNEL_MAX_STAGES = 4
SMEM_LIMIT = 232448

# The long kernels past ITEM_FRAMES frames (the forward) and past
# FRAMES_KERNEL_FRAMES (the backward), csrc/temporal_attention*.cu: their
# consumer warps (kLongConsumers), the frames of a streamed panel (kPanel),
# the widest column chunk of a streamed item (kLongChunk: the forward's,
# the backward's), the widest gradient slab of a resident backward item
# (kSlab), the deepest ring, the most frames a resident item takes (one
# TMA box), and the shared memory of a block when two share an SM (the
# forward's at d <= LONG_TWO_BLOCK_WIDTH, whose registers let two in).
LONG_CONSUMERS = 8
LONG_PANEL = 64
LONG_CHUNK = 64
LONG_FWD_CHUNK = 160
LONG_SLAB = 64
LONG_MAX_STAGES = 4
LONG_BOX_FRAMES = 256
LONG_TWO_BLOCK_WIDTH = 64
TWO_BLOCK_SMEM = 115712
# The long backward's resident items of heads at most LONG_PANEL_WIDTH
# wide and at most LONG_HELD_FRAMES frames take P and dS through shared
# memory a panel of LONG_PANEL_LD - 8 key frames at a time ([frames][ld]
# bf16 each) and hold dQ in registers (kPanelWidth, kPanelLd, kHeldTiles x
# kLongConsumers tiles).
LONG_PANEL_WIDTH = 64
LONG_PANEL_LD = 72
LONG_HELD_FRAMES = 256
# The entry points' `mode`: the item kernels (up to ITEM_FRAMES), the
# backward's frames kernel, the long kernels with whole items in the ring
# or with one head streamed in panels and chunks, and up to ITEM_FRAMES a
# head wider than CHUNK_COLUMNS in column slices (the split kernels; the
# backward's item kept for its second sweep, or q, k and g loaded again).
MODE_ITEMS, MODE_FRAMES, MODE_RESIDENT, MODE_STREAMED = 0, 1, 2, 3
MODE_SPLIT, MODE_SPLIT_STREAMED = 4, 5
# The split kernels (csrc/temporal_split.cuh): consumer warps a block
# (split::kWarps, a (position, slice) each), the deepest ring of tensor
# slots (split::kMaxStages), and the slots from which the backward keeps
# an item for both sweeps (four hold one item; with eight the next item's
# loads run under this one's: at seven, streaming q, k and g again was
# 1-5% faster at heads64's level 2 on the H100, 0.1000 against 0.1051 ms
# and 0.1035 against 0.1044 in two runs in turns: PERF.md section 6, the
# split kernels' finding).
SPLIT_WARPS = 8
SPLIT_MAX_STAGES = 8
SPLIT_RESIDENT_STAGES = 8
SPLIT_READY = 16  # the forward's store warp's ring of `ready` barriers (split::kReady)
# The backward's slices where 2, 4 or 8 of them cover the head and the
# ring of 160-column slices is not as deep as it may be: narrower tiles, a
# deeper ring (on the H100 0.1002 against 0.1070 ms at d 320 over 24
# frames; over one frame, whose ring is full either way, 0.3379 against
# 0.2161: PERF.md section 6, the split kernels' finding).
SPLIT_BWD_SLICE = 80

# Launches by kernel: the item kernels ("temporal", "temporal_bwd"), and past
# ITEM_FRAMES frames the long forward ("temporal_long"), the backward's frames
# kernel up to FRAMES_KERNEL_FRAMES ("temporal_bwd_frames") and its long
# kernel past that ("temporal_bwd_long").
launches = {"temporal": 0, "temporal_bwd": 0, "temporal_long": 0, "temporal_bwd_frames": 0,
            "temporal_bwd_long": 0}
# The forward's and the backward's launches by the caller's head width
# (before any pad) and by frame count: {d: count}, {f: count}.
forward_launches_by_d: dict = {}
backward_launches_by_d: dict = {}
forward_launches_by_f: dict = {}
backward_launches_by_f: dict = {}

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


class TemporalPlan(NamedTuple):
    """The kernels' item (forward and backward): ``heads`` whole heads of
    ``cols`` = heads * d columns, or (``chunks`` > 1) one head walked in
    ``chunks`` column chunks of ``cols`` columns (the last one narrower
    where d is no multiple of it); loaded ``padded`` columns wide (an odd
    number of 16-byte units, at least 8 columns past the chunk: the frames
    of a head then sit in distinct shared-memory banks, and the last
    16-deep step of a head with d % 16 == 8 stays inside the row). Past
    ITEM_FRAMES frames: the long forward's item (:func:`long_fwd_plan`)."""
    heads: int
    cols: int
    padded: int
    chunks: int


@functools.lru_cache(maxsize=None)
def temporal_plan(c: int, heads: int, frames: int = 1) -> TemporalPlan:
    """The most whole heads whose columns fit CHUNK_COLUMNS (at least
    one), or for a wider head its column slices (:func:`split_slices`);
    and the width the kernel loads them at. ``csrc/temporal_attention*.cu``
    derive the same slice width from d and the slice count. Past
    ITEM_FRAMES frames: the long forward's item (:func:`long_fwd_plan`)."""
    d = c // heads
    if frames > ITEM_FRAMES:
        p = long_fwd_plan(c, heads, frames)
        return TemporalPlan(p.heads, p.cols, p.padded, p.chunks)
    if d > CHUNK_COLUMNS:
        per = 1
        chunks, cols = split_slices(d)
    else:
        chunks = 1
        per = max(h for h in range(1, heads + 1)
                  if heads % h == 0 and h * d <= CHUNK_COLUMNS)
        cols = per * d
    return TemporalPlan(per, cols, _padded_width(cols), chunks)


class SplitPlan(NamedTuple):
    """A split kernel's plan (a head wider than CHUNK_COLUMNS, up to
    ITEM_FRAMES frames): items of ``positions`` positions x one head in
    ``slices`` column slices of ``cols`` columns (the last narrower where
    slices * cols > d), a consumer warp a (position, slice), each slice
    loaded ``padded`` columns wide (as :class:`TemporalPlan`); a ring of
    ``stages`` tensor slots (one tile a working warp), ``smem`` the bytes of
    shared memory a block lays out; ``mode`` MODE_SPLIT, or for the
    backward MODE_SPLIT_STREAMED (q, k and g loaded again for the second
    sweep)."""
    mode: int
    slices: int
    cols: int
    padded: int
    positions: int
    stages: int
    smem: int


def split_slices(d: int, max_slice: int = CHUNK_COLUMNS, warps: int = SPLIT_WARPS) -> tuple:
    """The column slices of a d-wide head: the fewest of 2, 4, 8 ... (a
    divisor of ``warps``) whose width, ceil(d / slices) rounded up to 8,
    is at most ``max_slice``, each slice non-empty; (slices, width).
    ``csrc/temporal_attention*.cu`` derive the same width from d and the
    slices."""
    n = 2
    while n <= warps:
        cols = round_up8(-(-d // n))
        if warps % n == 0 and cols <= max_slice and (n - 1) * cols < d:
            return n, cols
        n *= 2
    raise ValueError(f"no column slices of at most {max_slice} for d={d} over {warps} warps")


def split_smem(frames: int, padded: int, stages: int, warps: int = SPLIT_WARPS) -> int:
    """Bytes of shared memory a split kernel lays out for ``warps`` working
    warps: 128 bytes of alignment, ``stages`` slots of one [frames][padded]
    bf16 tile a warp (rounded to 128 bytes), the exchange of S's (and
    dP's) parts (one 16 MT x 16 MT fp32 tile a warp, MT = 1 up to 16 frames,
    else 2), the room past it that the mma tiles' 16 MT rows of the last
    tile read, two barriers a slot and SPLIT_READY ``ready`` barriers
    (``split::smem_bytes`` in csrc/temporal_split.cuh)."""
    mt = 1 if frames <= 16 else 2
    tile = -(-frames * padded // 64) * 64
    exchange = warps * 1024 * mt * mt
    room = max(0, -(-((16 * mt - frames) * padded * 2 - exchange) // 16) * 16)
    return 128 + stages * warps * tile * 2 + exchange + room + stages * 16 + SPLIT_READY * 8


def split_plan(d: int, frames: int, backward: bool = False) -> SplitPlan:
    """The split kernels' plan for a head of CHUNK_COLUMNS < d <=
    MAX_HEAD_DIM over ``frames`` <= ITEM_FRAMES: the head's slices
    (:func:`split_slices`: of at most CHUNK_COLUMNS; the backward's of at
    most SPLIT_BWD_SLICE where SPLIT_WARPS slices that wide cover the head
    and the wider slices' ring is shallower than SPLIT_MAX_STAGES),
    SPLIT_WARPS // slices positions an item (every consumer warp working),
    a ring as deep as fits SMEM_LIMIT up to SPLIT_MAX_STAGES. The backward
    keeps the item for both sweeps (MODE_SPLIT) where SPLIT_RESIDENT_STAGES
    slots fit, else loads q, k and g again (MODE_SPLIT_STREAMED)."""
    return _split_plan(d, frames, backward)


@functools.lru_cache(maxsize=None)
def _split_plan(d: int, frames: int, backward: bool = False, max_slice: Optional[int] = None,
                max_stages: int = SPLIT_MAX_STAGES, positions: Optional[int] = None,
                mode: Optional[int] = None, warps: int = SPLIT_WARPS) -> SplitPlan:
    """:func:`split_plan` with the variants' arguments: ``max_slice``,
    ``max_stages``, ``positions`` (fewer working warps) and ``mode`` off
    their defaults, and ``warps`` that of a source built with other
    consumer warps."""
    if not CHUNK_COLUMNS < d <= MAX_HEAD_DIM or not 1 <= frames <= ITEM_FRAMES:
        raise ValueError(f"the split kernels take {CHUNK_COLUMNS} < d <= {MAX_HEAD_DIM} over "
                         f"at most {ITEM_FRAMES} frames, got d={d}, frames={frames}")
    if max_slice is None:
        # the backward's narrower slices where they cover the head and the
        # ring of the wider ones is not as deep as it may be
        max_slice = CHUNK_COLUMNS
        if backward:
            try:
                split_slices(d, SPLIT_BWD_SLICE, warps)
                wide = _split_plan(d, frames, True, CHUNK_COLUMNS, max_stages, positions,
                                   MODE_SPLIT_STREAMED, warps)
                if wide.stages < max_stages:
                    max_slice = SPLIT_BWD_SLICE
            except ValueError:
                pass
    slices, cols = split_slices(d, max_slice, warps)
    padded = _padded_width(cols)
    per = positions or warps // slices
    if not 1 <= per * slices <= warps:
        raise ValueError(f"{per} positions of {slices} slices exceed {warps} warps")
    fits = [n for n in range(1, max_stages + 1)
            if split_smem(frames, padded, n, per * slices) <= SMEM_LIMIT]
    stages = fits[-1] if fits else 0
    if mode is None:
        mode = (MODE_SPLIT if not backward or stages >= SPLIT_RESIDENT_STAGES
                else MODE_SPLIT_STREAMED)
    least = 4 if backward and mode == MODE_SPLIT else 2
    if stages < least:
        raise ValueError(f"no split plan for d={d} at {frames} frames: {stages} slots fit")
    return SplitPlan(mode, slices, cols, padded, per, stages,
                     split_smem(frames, padded, stages, per * slices))


class LongBackwardPlan(NamedTuple):
    """The backward's frames kernel past ITEM_FRAMES frames: items of
    ``heads`` whole heads (``cols`` = heads * d columns), or (``chunks`` >
    1) one head walked twice in ``chunks`` chunks of ``cols`` columns;
    loaded ``padded`` columns wide (as :class:`TemporalPlan`), in a ring of
    ``stages`` stages; ``smem`` the bytes of shared memory a block lays out
    (:func:`long_backward_smem`)."""
    heads: int
    cols: int
    padded: int
    chunks: int
    stages: int
    smem: int


def _padded_width(cols: int) -> int:
    """At least 8 columns past ``cols``, an odd number of 16-byte units."""
    return cols + (8 if (cols // 8) % 2 == 0 else 16)


def frames_groups(frames: int) -> int:
    """The frames kernel's consumer groups (each one warp a 16-frame tile,
    its own P and dS): three up to 48 frames, else one (``frames_groups``
    in csrc/temporal_attention_bwd.cu)."""
    return 3 if frames <= 48 else 1


def long_backward_smem(frames: int, padded: int, stages: int,
                       groups: Optional[int] = None) -> int:
    """Bytes of shared memory the frames kernel lays out: ``stages`` x the
    Q, K, V and G tiles ([frames][padded] bf16 each, rounded to 128
    bytes), the room past the last for the 16-frame tiles' rows past
    ``frames``, each consumer group's P and dS ([fp][fp + 8] bf16, fp =
    frames rounded up to 16; ``groups`` of them, :func:`frames_groups` by
    default), the barriers and 128 bytes of alignment
    (``frames_smem_bytes`` in csrc/temporal_attention_bwd.cu)."""
    fp = -(-frames // 16) * 16
    tile = -(-frames * padded // 64) * 64
    room = -(-(fp - frames) * padded // 64) * 64
    pds = (groups or frames_groups(fp)) * 2 * fp * (fp + 8)
    return 128 + (stages * 4 * tile + room + pds) * 2 + 2 * stages * 8


@functools.lru_cache(maxsize=None)
def long_backward_plan(c: int, heads: int, frames: int, max_cols: int = CHUNK_COLUMNS,
                       max_stages: int = FRAMES_KERNEL_MAX_STAGES,
                       groups: Optional[int] = None) -> Optional[LongBackwardPlan]:
    """The frames kernel's plan for ``frames`` > ITEM_FRAMES (None past
    FRAMES_KERNEL_FRAMES: the long kernel runs there): items of whole heads
    of at most ``max_cols`` columns, the most heads whose stages leave one
    stage spare beside the consumer groups' (at 48 frames, 2 heads of 40
    where 4 would leave none: 0.735 against 0.780 ms at level 0 on the
    H100), else the most whose stages fit SMEM_LIMIT at least twice, else
    one head in the fewest chunks (at most ``max_cols`` columns, multiples
    of 8) that do; the ring as deep as fits, up to ``max_stages``.
    ``max_cols`` and ``max_stages`` below their defaults, and ``groups``
    (the consumer groups the kernel is built with), are the variants'
    ablations."""
    if not ITEM_FRAMES < frames <= FRAMES_KERNEL_FRAMES:
        return None
    d = c // heads
    groups = groups or frames_groups(frames)

    def plan(per, cols, chunks):
        padded = _padded_width(cols)
        fixed = long_backward_smem(frames, padded, 0, groups)
        stage = long_backward_smem(frames, padded, 1, groups) - fixed
        stages = min(max_stages, (SMEM_LIMIT - fixed) // stage)
        return LongBackwardPlan(per, cols, padded, chunks, stages,
                                long_backward_smem(frames, padded, stages, groups))

    whole = [plan(per, per * d, 1) for per in range(heads, 0, -1)
             if heads % per == 0 and per * d <= max_cols]
    for least in (min(groups + 1, max_stages), 2):
        for p in whole:
            if p.stages >= least:
                return p
    for n in range(max(-(-d // max_cols), 2), d // 8 + 1):
        p = plan(1, round_up8(-(-d // n)), n)
        if p.stages >= 2 and (n - 1) * p.cols < d:
            return p
    raise ValueError(f"no frames-kernel plan for d={d} at {frames} frames")


class LongPlan(NamedTuple):
    """A long kernel's plan: ``mode`` MODE_RESIDENT (items of ``heads``
    whole heads, ``cols`` = heads * d columns, all frames in one stage) or
    MODE_STREAMED (one head an item in ``chunks`` chunks of ``cols``
    columns, its frames in panels of LONG_PANEL); loaded ``padded`` columns
    wide (as :class:`TemporalPlan`), in a ring of ``stages`` stages;
    ``smem`` the bytes of shared memory a block lays out."""
    mode: int
    heads: int
    cols: int
    padded: int
    chunks: int
    stages: int
    smem: int


def _round16(frames: int) -> int:
    return -(-frames // 16) * 16


def long_fwd_smem(rows: int, padded: int, out_cols: int, stages: int,
                  consumers: int = LONG_CONSUMERS) -> int:
    """Bytes of shared memory the long forward lays out: ``stages`` x the
    Q, K and V tiles ([rows][padded] bf16: the item's frames rounded up to
    16, or LONG_PANEL streamed), each consumer warp's staging tile
    ([16][out_cols]: the head's width, or a streamed chunk's), the barriers
    and 128 bytes of alignment (``long_fwd_smem`` in
    csrc/temporal_attention.cu)."""
    return (128 + stages * 3 * rows * padded * 2 + consumers * 16 * out_cols * 2
            + stages * 16)


def long_bwd_smem(rows: int, padded: int, out_cols: int, stages: int, words: int,
                  pds: int = 0, consumers: int = LONG_CONSUMERS) -> int:
    """Bytes of shared memory the long backward lays out: ``stages`` x the
    Q, K, V and G tiles, two staging tiles a consumer warp ([16][out_cols]:
    a slab of at most LONG_SLAB of the head, or a streamed chunk), ``words``
    fp32 row words (max, 1 / sum, delta: a stage's heads' frames rounded up
    to 16, twice with the key panels, as the sums of two halves; twice the
    streamed item's panels), ``pds`` bf16 elements of P and dS, the
    barriers and 128 bytes of alignment (``long_bwd_smem`` in
    csrc/temporal_attention_bwd.cu)."""
    return (128 + stages * 4 * rows * padded * 2 + consumers * 2 * 16 * out_cols * 2
            + words * 4 + pds * 2 + stages * 16)


def long_bwd_panels(frames: int, d: int, consumers: int = LONG_CONSUMERS) -> bool:
    """Whether the long backward's resident item takes P and dS through
    shared memory a key panel at a time, dQ held in registers (at most
    LONG_HELD_FRAMES with LONG_CONSUMERS warps, in proportion with others)."""
    held = LONG_HELD_FRAMES * consumers // LONG_CONSUMERS
    return d <= LONG_PANEL_WIDTH and _round16(frames) <= held


def _long_smem(backward: bool, mode: int, frames: int, d: int, per: int, cols: int,
               padded: int, stages: int, consumers: int = LONG_CONSUMERS,
               panel: int = LONG_PANEL, panels: bool = True) -> int:
    if mode == MODE_RESIDENT:
        rows = _round16(frames)
        if not backward:
            return long_fwd_smem(rows, padded, d, stages, consumers)
        if panels and long_bwd_panels(frames, d, consumers):
            return long_bwd_smem(rows, padded, d, stages, stages * per * 6 * rows,
                                 2 * rows * LONG_PANEL_LD, consumers)
        return long_bwd_smem(rows, padded, min(LONG_SLAB, d), stages, stages * per * 3 * rows,
                             0, consumers)
    if not backward:
        return long_fwd_smem(panel, padded, cols, stages, consumers)
    panels = -(-frames // panel)
    return long_bwd_smem(panel, padded, cols, stages, 2 * 3 * panels * panel, 0, consumers)


def _long_plan(backward: bool, c: int, heads: int, frames: int, max_cols: int = CHUNK_COLUMNS,
               max_stages: int = LONG_MAX_STAGES, streamed: bool = False,
               consumers: int = LONG_CONSUMERS, panel: int = LONG_PANEL,
               panels: bool = True) -> LongPlan:
    """The long kernels' plan (:func:`long_fwd_plan`, :func:`long_bwd_plan`).
    ``max_cols``, ``max_stages`` and ``streamed`` (the streamed mode where
    the resident one fits) below or off their defaults are the variants'
    ablations; ``consumers``, ``panel`` and ``panels`` (the backward's key
    panels of P and dS) are those of a source built with others."""
    d = c // heads

    def plan(mode, per, cols, chunks, limit=SMEM_LIMIT):
        padded = _padded_width(cols)

        def smem(n):
            return _long_smem(backward, mode, frames, d, per, cols, padded, n, consumers, panel,
                              panels)

        fits = [n for n in range(1, max_stages + 1) if smem(n) <= limit]
        if not fits:
            return None
        return LongPlan(mode, per, cols, padded, chunks, fits[-1], smem(fits[-1]))

    if not streamed and d <= CHUNK_COLUMNS and _round16(frames) <= LONG_BOX_FRAMES:
        pers = [per for per in range(heads, 0, -1) if heads % per == 0 and per * d <= max_cols]
        if not backward and d <= LONG_TWO_BLOCK_WIDTH:
            # two blocks an SM where two stages fit half of its memory
            for per in pers:
                p = plan(MODE_RESIDENT, per, per * d, 1, TWO_BLOCK_SMEM)
                if p is not None and p.stages >= min(2, max_stages):
                    return p
        whole = [p for p in (plan(MODE_RESIDENT, per, per * d, 1) for per in pers)
                 if p is not None]
        for least in (min(2, max_stages), 1):
            for p in whole:
                if p.stages >= least:
                    return p
    chunks = -(-d // (LONG_CHUNK if backward else LONG_FWD_CHUNK))
    p = plan(MODE_STREAMED, 1, round_up8(-(-d // chunks)), chunks)
    if p is None:
        raise ValueError(f"no long-kernel plan for d={d} at {frames} frames")
    return p


@functools.lru_cache(maxsize=None)
def long_fwd_plan(c: int, heads: int, frames: int) -> LongPlan:
    """The long forward's plan for ``frames`` > ITEM_FRAMES: resident items
    of whole heads (d <= CHUNK_COLUMNS, frames rounded up to 16 at most
    LONG_BOX_FRAMES): at d <= LONG_TWO_BLOCK_WIDTH the most heads of at
    most CHUNK_COLUMNS columns whose two stages fit TWO_BLOCK_SMEM (two
    blocks an SM), else the most heads whose ring holds 2 stages, else 1,
    as deep as fits up to LONG_MAX_STAGES; else streamed, one head in the
    fewest chunks of at most LONG_FWD_CHUNK columns (multiples of 8)."""
    if frames <= ITEM_FRAMES:
        raise ValueError(f"the long forward takes more than {ITEM_FRAMES} frames, got {frames}")
    return _long_plan(False, c, heads, frames)


@functools.lru_cache(maxsize=None)
def long_bwd_plan(c: int, heads: int, frames: int) -> Optional[LongPlan]:
    """The long backward's plan past FRAMES_KERNEL_FRAMES frames (None up
    to it: the item kernels and the frames kernel run there): resident
    items of the most heads whose ring holds 2 stages (Q, K, V and G and
    the row words a stage), else 1; else streamed, one head in chunks of
    at most LONG_CHUNK columns."""
    if frames <= FRAMES_KERNEL_FRAMES:
        return None
    return _long_plan(True, c, heads, frames)


def temporal_width(d: int) -> int:
    """The head width the kernels run a d-wide head at: d, or d zero-padded
    to the next multiple of 8; raises past MAX_HEAD_DIM."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported by kernel B: it takes 1 <= d <= "
                         f"{MAX_HEAD_DIM}")
    return round_up8(d)


def launch_sizes(shape, heads: int, scale_d: Optional[int] = None):
    """The item both kernels take for q of ``shape`` (b, f, l, c), d a
    multiple of 8 (the wrapper pads first): (b, f, l, heads, d, heads an
    item, padded width, chunks a head, scale_d) from :func:`temporal_plan`,
    where ``scale_d`` (d by default) is the width whose d^-1/2 scales the
    logits; raises on sizes the kernels do not take."""
    b, f, l, c = shape
    d = c // heads
    if b > 65535 or heads > 65535 or min(b, f, l) < 1:
        raise ValueError(f"unsupported sizes {tuple(shape)} heads={heads}: b and heads "
                         f"take at most 65535, b, frames and l at least 1")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported: needs d % 8 == 0 and d <= {MAX_HEAD_DIM}")
    plan = temporal_plan(c, heads, f)
    return b, f, l, heads, d, plan.heads, plan.padded, plan.chunks, scale_d or d


def forward_launch_sizes(shape, heads: int, scale_d: Optional[int] = None):
    """The size arguments the forward kernel takes for q of ``shape``:
    :func:`launch_sizes`, then the mode, the ring's stages and its
    shared-memory bytes: up to ITEM_FRAMES zeros, or for a head in slices
    :func:`split_plan`'s (its positions an item in place of the heads an
    item), past it :func:`long_fwd_plan`'s."""
    sizes = launch_sizes(shape, heads, scale_d)
    if shape[1] <= ITEM_FRAMES:
        return _items_sizes(sizes, False)
    p = long_fwd_plan(shape[-1], heads, shape[1])
    return (*sizes, p.mode, p.stages, p.smem)


def _items_sizes(sizes, backward: bool) -> tuple:
    """Up to ITEM_FRAMES frames: :func:`launch_sizes`' ints with the mode,
    stages and bytes; a head in slices takes :func:`split_plan`'s, its
    positions an item in place of the heads an item."""
    b, f, l, heads, d, per, padded, chunks, scale_d = sizes
    if chunks == 1:
        return (*sizes, MODE_ITEMS, 0, 0)
    p = split_plan(d, f, backward)
    return (b, f, l, heads, d, p.positions, p.padded, p.slices, scale_d, p.mode, p.stages,
            p.smem)


def backward_launch_sizes(shape, heads: int, scale_d: Optional[int] = None):
    """The size arguments the backward kernel takes for q of ``shape``:
    :func:`launch_sizes`, then the mode, the ring's stages and its
    shared-memory bytes: up to ITEM_FRAMES the item kernels' (zeros), or
    for a head in slices :func:`split_plan`'s (as the forward's), up
    to FRAMES_KERNEL_FRAMES the frames kernel's item, ring and bytes
    (:func:`long_backward_plan`, MODE_FRAMES), past it the long backward's
    (:func:`long_bwd_plan`)."""
    sizes = launch_sizes(shape, heads, scale_d)
    b, f, l, c = shape
    if f <= ITEM_FRAMES:
        return _items_sizes(sizes, True)
    frames = long_backward_plan(c, heads, f)
    if frames is not None:
        return (*sizes[:5], frames.heads, frames.padded, frames.chunks, sizes[8], MODE_FRAMES,
                frames.stages, frames.smem)
    p = long_bwd_plan(c, heads, f)
    return (*sizes[:5], p.heads, p.padded, p.chunks, sizes[8], p.mode, p.stages, p.smem)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for counts in (forward_launches_by_d, backward_launches_by_d, forward_launches_by_f,
                   backward_launches_by_f):
        counts.clear()


def _count(kernel: str, by_d: dict, by_f: dict, d: int, f: int) -> None:
    """One launch of ``kernel`` (past ITEM_FRAMES frames its frames or long
    variant)."""
    if f <= ITEM_FRAMES:
        launches[kernel] += 1
    elif kernel == "temporal_bwd" and f <= FRAMES_KERNEL_FRAMES:
        launches["temporal_bwd_frames"] += 1
    else:
        launches[kernel + "_long"] += 1
    by_d[d] = by_d.get(d, 0) + 1
    by_f[f] = by_f.get(f, 0) + 1


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, scale_d: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits and softmax over the frame axis,
    probabilities rounded to the input dtype before the PV product. The
    logits are scaled by ``scale_d ** -0.5`` (the head width d by default)."""
    b, f, l, c = q.shape
    d = c // heads

    def split(t):  # (b, f, l, c) -> (b, l, heads, f, d)
        return t.reshape(b, f, l, heads, d).permute(0, 2, 3, 1, 4).float()

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * ((scale_d or d) ** -0.5)
    p = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.matmul(p, split(v))  # (b, l, heads, f, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, f, l, c).to(q.dtype)


def _check(q, k, v, heads):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share a (b, f, l, c) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[-1] % heads:
        raise ValueError(f"channels {q.shape[-1]} not divisible by {heads} heads")


def _check_cuda(**tensors):
    """Every tensor on the first one's CUDA device, bf16, contiguous and
    16-byte aligned."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _padded(heads, width, **tensors):
    """The tensors zero-padded to ``width`` columns a head (where that
    differs), each checked as the kernels need it."""
    tensors = {name: resize_heads(t, heads, width) for name, t in tensors.items()}
    _check_cuda(**tensors)
    return list(tensors.values())


def temporal_attention_cuda(q, k, v, heads):
    _check(q, k, v, heads)
    d = q.shape[-1] // heads
    width = temporal_width(d)
    qk, kk, vk = _padded(heads, width, q=q, k=k, v=v)
    sizes = forward_launch_sizes(tuple(qk.shape), heads, d)
    out = torch.empty_like(qk)
    fn = cuda_build.function("temporal_attention", "hv_temporal_fwd", _FWD_ARGTYPES)
    err = fn(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), out.data_ptr(), *sizes,
             cuda_build.stream_handle(q.device))
    cuda_build.check(err, "temporal attention launch")
    _count("temporal", forward_launches_by_d, forward_launches_by_f, d, q.shape[1])
    return resize_heads(out, heads, d)


def temporal_attention_backward_plain(q, k, v, g, heads: int, scale_d: Optional[int] = None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    input dtype. Recomputes the fp32 softmax, takes delta = rowsum(dp * p)
    and rounds p and ds to the input dtype before their products.
    ``scale = scale_d ** -0.5``, the head width d by default."""
    b, f, l, c = q.shape
    d = c // heads
    scale = (scale_d or d) ** -0.5

    def split(t):  # (b, f, l, c) -> (b, l, heads, f, d)
        return t.reshape(b, f, l, heads, d).permute(0, 2, 3, 1, 4).float()

    qh, kh, vh, gh = split(q), split(k), split(v), split(g)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale

    def merge(t):
        return t.permute(0, 3, 1, 2, 4).reshape(b, f, l, c).to(q.dtype)

    return merge(dq), merge(dk), merge(dv)


def temporal_attention_backward_cuda(q, k, v, g, heads: int):
    """Launch the backward kernel; every check it relies on raises here."""
    _check(q, k, v, heads)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} != q {tuple(q.shape)}")
    d = q.shape[-1] // heads
    width = temporal_width(d)
    qk, kk, vk, gk = _padded(heads, width, q=q, k=k, v=v, g=g)
    sizes = backward_launch_sizes(tuple(qk.shape), heads, d)
    dq, dk, dv = torch.empty_like(qk), torch.empty_like(kk), torch.empty_like(vk)
    fn = cuda_build.function("temporal_attention_bwd", "hv_temporal_bwd", _BWD_ARGTYPES)
    err = fn(qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), gk.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), *sizes, cuda_build.stream_handle(q.device))
    cuda_build.check(err, "temporal attention backward launch")
    _count("temporal_bwd", backward_launches_by_d, backward_launches_by_f, d, q.shape[1])
    return tuple(resize_heads(t, heads, d) for t in (dq, dk, dv))


class TemporalAttention(torch.autograd.Function):
    """Frame-axis attention, differentiable in q, k and v; the backward
    recomputes the softmax from them (no other residual)."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        if q.device.type == "cpu":
            _check(q, k, v, heads)
            out = temporal_attention_plain(q, k, v, heads)
        else:
            out = temporal_attention_cuda(q, k, v, heads)
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # the gradient arriving through to_out and reshapes may be strided
        g = g.contiguous()
        if q.device.type == "cpu":
            grads = temporal_attention_backward_plain(q, k, v, g, ctx.heads)
        else:
            grads = temporal_attention_backward_cuda(q, k, v, g, ctx.heads)
        return (*grads, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Frame-axis attention, differentiable in q, k and v; CPU tensors take
    the plain versions, CUDA tensors launch the kernels or raise."""
    return TemporalAttention.apply(q, k, v, heads)
