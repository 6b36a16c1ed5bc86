"""Head widths the attention kernels do not hold natively: a zero pad.

Kernels A and B read heads packed side by side in the channel axis, each
``d`` columns wide, and hold only some widths natively (d a multiple of 8,
and kernel A's configurations up to 128 and at 512). A head of another
width runs at a wider one: its columns are padded with zeros, the kernel
runs with the softmax scale of the true width, and the output and the
gradients are cut back. Zero columns add nothing to q k^T, so the logits,
the log-sum-exp and the probabilities are those of the true width; the
output's and the gradients' pad columns are exactly zero.
"""

from __future__ import annotations

import torch


def round_up8(d: int) -> int:
    """The next multiple of 8 at or above d."""
    return -(-d // 8) * 8


def resize_heads(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """``t`` (..., heads * d) as (..., heads * width): each head's columns
    padded with zeros (width > d) or cut to their first ``width`` (width <
    d). The same tensor where width == d, else a new contiguous one. The
    wrappers pad q, k, v and g with it on the way in and cut the output and
    the gradients on the way out."""
    *lead, c = t.shape
    d = c // heads
    if width == d:
        return t
    x = t.reshape(*lead, heads, d)
    x = torch.nn.functional.pad(x, (0, width - d)) if width > d else x[..., :width]
    return x.reshape(*lead, heads * width).contiguous()
