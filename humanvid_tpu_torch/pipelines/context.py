"""Temporal context windows for long-video inference.

Sliding windows with power-of-two strides and wrap-around (the reference's
``uniform`` context scheduler). The reference's production pipeline calls it
with ``step=0`` for every denoising step, so one window set serves the whole
sampling run.
"""

from __future__ import annotations

from typing import List

import numpy as np


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction of a 64-bit integer (van der Corput sequence)."""
    rev = int(f"{val:064b}"[::-1], 2)
    return rev / (1 << 64)


def uniform_windows(
    step: int,
    num_frames: int,
    context_size: int = 24,
    context_stride: int = 1,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> List[List[int]]:
    """Frame-index windows for one denoising step (wrap-around, mod num_frames)."""
    if num_frames <= context_size:
        return [list(range(num_frames))]

    context_stride = min(
        context_stride, int(np.ceil(np.log2(num_frames / context_size))) + 1
    )
    windows: List[List[int]] = []
    for context_step in (1 << np.arange(context_stride)):
        context_step = int(context_step)
        pad = int(round(num_frames * ordered_halving(step)))
        start = int(ordered_halving(step) * context_step) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        stride = context_size * context_step - context_overlap
        for j in range(start, stop, stride):
            windows.append(
                [e % num_frames for e in range(j, j + context_size * context_step, context_step)]
            )
    return windows


def all_step_windows(
    num_steps: int,
    num_frames: int,
    context_size: int = 24,
    context_stride: int = 1,
    context_overlap: int = 4,
    closed_loop: bool = True,
) -> np.ndarray:
    """The windows of every denoising step, ``(steps, W, context)`` int32:
    the step-0 set repeated, as the reference's pipeline passes ``step=0``
    to the scheduler at every step."""
    step0 = uniform_windows(
        0, num_frames, context_size, context_stride, context_overlap, closed_loop)
    return np.broadcast_to(
        np.asarray(step0, dtype=np.int32)[None],
        (num_steps, len(step0), len(step0[0])),
    ).copy()
