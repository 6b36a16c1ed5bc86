"""Frame-axis multi-head attention in the spatial layout (kernel B).

``temporal_attention(q, k, v, heads)`` takes q/k/v of shape (b, f, l, c) with
heads packed in c and, for each (b, position l, head), attends over the f
frames: ``softmax(q k^T * d^-1/2) v``. The output has the input's layout; no
``(b f) l c <-> (b l) f c`` rearrange happens.

On a CUDA tensor it launches the hand-written kernel in
``csrc/temporal_attention.cu`` (bf16 only, any f, d <= 1280) or raises; on
a CPU tensor it runs :func:`temporal_attention_plain`. Up to ITEM_FRAMES
frames the kernel's work item is a run of positions x all frames x a chunk
of whole heads, or, for a head wider than CHUNK_COLUMNS, one head walked in
column chunks; past ITEM_FRAMES the long kernels take one head in query and
key tiles of 16 frames and LONG_COLUMNS-column pieces
(:func:`temporal_plan`). A head whose width is no multiple of 8 runs
zero-padded to the next one (``head_pad.resize_heads``), with the softmax
scale of its true width.

The gradient (:class:`TemporalAttention`, an autograd Function) keeps only
q, k and v: on a CUDA tensor the one-pass kernel of
``csrc/temporal_attention_bwd.cu`` recomputes the softmax and writes dq, dk
and dv, over the forward's items; on a CPU tensor
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
LONG_COLUMNS = 64  # the long kernels' depth pieces and output slabs (tiles::kPiece)

MAX_HEAD_DIM = 1280  # one head over the widest motion channels
CHUNK_COLUMNS = 160  # an item's columns (8 UNet heads, 320 bytes); a chunk's most

# Launches by kernel: the item kernels ("temporal", "temporal_bwd") and the
# long kernels past ITEM_FRAMES frames ("temporal_long", "temporal_bwd_long").
launches = {"temporal": 0, "temporal_bwd": 0, "temporal_long": 0, "temporal_bwd_long": 0}
# The forward's and the backward's launches by the caller's head width
# (before any pad) and by frame count: {d: count}, {f: count}.
forward_launches_by_d: dict = {}
backward_launches_by_d: dict = {}
forward_launches_by_f: dict = {}
backward_launches_by_f: dict = {}

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class TemporalPlan(NamedTuple):
    """The kernels' item (forward and backward): ``heads`` whole heads of
    ``cols`` = heads * d columns, or (``chunks`` > 1) one head walked in
    ``chunks`` column chunks of ``cols`` columns (the last one narrower
    where d is no multiple of it); loaded ``padded`` columns wide (an odd
    number of 16-byte units, at least 8 columns past the chunk: the frames
    of a head then sit in distinct shared-memory banks, and the last
    16-deep step of a head with d % 16 == 8 stays inside the row). Past
    ITEM_FRAMES frames (the long kernels): one head in ``chunks`` pieces of
    LONG_COLUMNS columns, in tiles ``padded`` = LONG_COLUMNS + 8 wide."""
    heads: int
    cols: int
    padded: int
    chunks: int


@functools.lru_cache(maxsize=None)
def temporal_plan(c: int, heads: int, frames: int = 1) -> TemporalPlan:
    """The most whole heads whose columns fit CHUNK_COLUMNS (at least
    one), or for a wider head the fewest chunks of at most CHUNK_COLUMNS
    columns, a multiple of 8, that cover it; and the width the kernel loads
    them at. ``csrc/temporal_attention*.cu`` derive the same chunk width
    from d and the chunk count. Past ITEM_FRAMES frames: the long kernels'
    pieces."""
    d = c // heads
    if frames > ITEM_FRAMES:
        return TemporalPlan(1, LONG_COLUMNS, LONG_COLUMNS + 8, -(-d // LONG_COLUMNS))
    if d > CHUNK_COLUMNS:
        chunks = -(-d // CHUNK_COLUMNS)
        per, cols = 1, round_up8(-(-d // chunks))
    else:
        chunks = 1
        per = max(h for h in range(1, heads + 1)
                  if heads % h == 0 and h * d <= CHUNK_COLUMNS)
        cols = per * d
    return TemporalPlan(per, cols, cols + (8 if (cols // 8) % 2 == 0 else 16), chunks)


def temporal_width(d: int) -> int:
    """The head width the kernels run a d-wide head at: d, or d zero-padded
    to the next multiple of 8; raises past MAX_HEAD_DIM."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported by kernel B: it takes 1 <= d <= "
                         f"{MAX_HEAD_DIM}")
    return round_up8(d)


def launch_sizes(shape, heads: int, scale_d: Optional[int] = None):
    """The size arguments both kernels take for q of ``shape`` (b, f, l, c),
    d a multiple of 8 (the wrapper pads first): (b, f, l, heads, d, heads
    an item, padded width, chunks a head, scale_d) from
    :func:`temporal_plan`, where ``scale_d`` (d by default) is the width
    whose d^-1/2 scales the logits; raises on sizes the kernels do not
    take."""
    b, f, l, c = shape
    d = c // heads
    if b > 65535 or heads > 65535 or min(b, f, l) < 1:
        raise ValueError(f"unsupported sizes {tuple(shape)} heads={heads}: b and heads "
                         f"take at most 65535, b, frames and l at least 1")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported: needs d % 8 == 0 and d <= {MAX_HEAD_DIM}")
    plan = temporal_plan(c, heads, f)
    return b, f, l, heads, d, plan.heads, plan.padded, plan.chunks, scale_d or d


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for counts in (forward_launches_by_d, backward_launches_by_d, forward_launches_by_f,
                   backward_launches_by_f):
        counts.clear()


def _count(kernel: str, by_d: dict, by_f: dict, d: int, f: int) -> None:
    """One launch of ``kernel`` (its long variant past ITEM_FRAMES frames)."""
    launches[kernel + ("_long" if f > ITEM_FRAMES else "")] += 1
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
    sizes = launch_sizes(tuple(qk.shape), heads, d)
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
    sizes = launch_sizes(tuple(qk.shape), heads, d)
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
