"""Frame-axis multi-head attention in the spatial layout (kernel B).

``temporal_attention(q, k, v, heads)`` takes q/k/v of shape (b, f, l, c) with
heads packed in c and, for each (b, position l, head), attends over the f
frames: ``softmax(q k^T * d^-1/2) v``. The output has the input's layout; no
``(b f) l c <-> (b l) f c`` rearrange happens.

On a CUDA tensor it launches the hand-written kernel in
``csrc/temporal_attention.cu`` (bf16 only, f <= 32) or raises; on a CPU
tensor it runs :func:`temporal_attention_plain`. The kernel's work item is
a run of positions x all frames x a chunk of whole heads
(:func:`temporal_plan`).

The gradient (:class:`TemporalAttention`, an autograd Function) keeps only
q, k and v: on a CUDA tensor the one-pass kernel of
``csrc/temporal_attention_bwd.cu`` recomputes the softmax and writes dq, dk
and dv, over the forward's items; on a CPU tensor
:func:`temporal_attention_backward_plain` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build

MAX_FRAMES = 32  # the motion modules' position-encoding table bounds f

MAX_HEAD_DIM = 160
CHUNK_COLUMNS = 160  # columns of an item: the UNet's 8 heads in 320-byte pieces

launches = {"temporal": 0, "temporal_bwd": 0}

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class TemporalPlan(NamedTuple):
    """The kernels' item (forward and backward): ``heads`` whole heads, ``cols`` =
    heads * d columns, loaded ``padded`` columns wide (an odd number of
    16-byte units, at least 8 columns past the chunk: the frames of a
    head then sit in distinct shared-memory banks, and the last 16-deep
    step of a head with d % 16 == 8 stays inside the row)."""
    heads: int
    cols: int
    padded: int


@functools.lru_cache(maxsize=None)
def temporal_plan(c: int, heads: int) -> TemporalPlan:
    """The most whole heads whose columns fit CHUNK_COLUMNS (at least
    one), and the width the kernel loads them at."""
    d = c // heads
    per = max(h for h in range(1, heads + 1)
              if heads % h == 0 and (h == 1 or h * d <= CHUNK_COLUMNS))
    cols = per * d
    return TemporalPlan(per, cols, cols + (8 if (cols // 8) % 2 == 0 else 16))


def launch_sizes(shape, heads: int):
    """The size arguments both kernels take for q of ``shape`` (b, f, l, c):
    (b, f, l, heads, d, heads an item, padded width) from
    :func:`temporal_plan`; raises on sizes the kernels do not take."""
    b, f, l, c = shape
    d = c // heads
    if b > 65535 or heads > 65535 or min(b, f, l) < 1:
        raise ValueError(f"unsupported sizes {tuple(shape)} heads={heads}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported: needs d % 8 == 0 and d <= {MAX_HEAD_DIM}")
    plan = temporal_plan(c, heads)
    return b, f, l, heads, d, plan.heads, plan.padded


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits and softmax over the frame axis,
    probabilities rounded to the input dtype before the PV product."""
    b, f, l, c = q.shape
    d = c // heads

    def split(t):  # (b, f, l, c) -> (b, l, heads, f, d)
        return t.reshape(b, f, l, heads, d).permute(0, 2, 3, 1, 4).float()

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * (d ** -0.5)
    p = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.matmul(p, split(v))  # (b, l, heads, f, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, f, l, c).to(q.dtype)


def _check(q, k, v, heads):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share a (b, f, l, c) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[-1] % heads:
        raise ValueError(f"channels {q.shape[-1]} not divisible by {heads} heads")
    if q.shape[1] > MAX_FRAMES:
        raise ValueError(f"{q.shape[1]} frames > {MAX_FRAMES}")


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


def temporal_attention_cuda(q, k, v, heads):
    _check(q, k, v, heads)
    _check_cuda(q=q, k=k, v=v)
    out = torch.empty_like(q)
    fn = cuda_build.function("temporal_attention", "hv_temporal_fwd", _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *launch_sizes(tuple(q.shape), heads), cuda_build.stream_handle(q.device))
    cuda_build.check(err, "temporal attention launch")
    launches["temporal"] += 1
    return out


def temporal_attention_backward_plain(q, k, v, g, heads: int):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    input dtype. Recomputes the fp32 softmax, takes delta = rowsum(dp * p)
    and rounds p and ds to the input dtype before their products."""
    b, f, l, c = q.shape
    d = c // heads
    scale = d ** -0.5

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
    _check_cuda(q=q, k=k, v=v, g=g)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} != q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = cuda_build.function("temporal_attention_bwd", "hv_temporal_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), *launch_sizes(tuple(q.shape), heads),
             cuda_build.stream_handle(q.device))
    cuda_build.check(err, "temporal attention backward launch")
    launches["temporal_bwd"] += 1
    return dq, dk, dv


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
