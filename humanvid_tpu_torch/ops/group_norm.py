"""GroupNorm(+SiLU) on NCHW tensors with fp32 statistics (kernel C).

``group_norm_act(x, weight, bias, groups, eps, act)`` takes x of logical
shape ``((b f), C, H, W)`` and, for each (sample, group of C/groups adjacent
channels), the fp32 mean and biased variance over H*W*C/groups values; it
returns ``act(x * a + b)`` with ``a = rstd * weight`` and
``b = bias - mean * a`` per (sample, channel), computed in fp32 and rounded
once to x's dtype, in x's shape and memory format. ``act`` is None or
``"silu"``. This is the JAX package's ``_fused_fwd_impl`` (its Pallas
statistics kernel and the folded apply) and its ``_reference``.

On a CUDA tensor it launches the hand-written kernels of
``csrc/group_norm.cu`` (bf16 x, ``channels_last`` or contiguous) or raises;
on a CPU tensor it runs :func:`group_norm_act_plain`.

The gradient (:class:`GroupNormAct`, an autograd Function) keeps x, weight
and bias and recomputes through ``F.group_norm`` (+ ``F.silu``) in the
backward, as the JAX ``custom_vjp`` recomputes through ``_reference`` on XLA;
the JAX package has no backward kernel, and neither has the port.
LayerNorm is ``torch.nn.LayerNorm``, which keeps its statistics in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

launches = {"group_norm": 0}

# Statistics blocks aimed at per call: two waves of 8 blocks on each of the
# H100's 132 SMs, so that the tail of the last wave stays short.
_BLOCK_TARGET = 2 * 8 * 132
_MAX_CHANNELS = 4096  # the statistics kernel's shared memory holds P * C pairs


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(x, weight, bias, groups, act):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must have shape ({c},)")
    if act not in (None, "silu"):
        raise ValueError(f"act {act!r}")


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 upcast, centred two-pass statistics per
    (sample, group), the folded apply, SiLU, one rounding to x's dtype.
    The mean is summed about each group's first value, as the kernel sums
    about a pivot, so that it keeps its digits when |mean| >> std."""
    n, c = x.shape[:2]
    xf = x.float()
    xg = xf.reshape(n, groups, -1)
    pivot = xg[..., 0]
    mean = pivot + (xg - pivot[..., None]).mean(-1)
    var = (xg - mean[..., None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(c // groups, dim=1) * weight.float()
    b = bias.float() - mean.repeat_interleave(c // groups, dim=1) * a
    y = xf * a[:, :, None, None] + b[:, :, None, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _tiling(n: int, rows: int, lanes: int):
    """(tiles, rows per tile): about _BLOCK_TARGET blocks in all, and at
    least 4 rows for each of a block's row lanes."""
    tiles = max(1, min(-(-_BLOCK_TARGET // n), -(-rows // (4 * lanes))))
    per_tile = -(-rows // tiles)
    return -(-rows // per_tile), per_tile


def group_norm_act_cuda(x, weight, bias, groups, eps, act=None):
    """Launch kernel C; every check the kernel relies on raises here."""
    _check(x, weight, bias, groups, act)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    if c % 8 or c > _MAX_CHANNELS:
        raise ValueError(f"channels {c} unsupported: needs C % 8 == 0 and C <= {_MAX_CHANNELS}")
    if n > 65535 or x.numel() == 0:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    elif x.is_contiguous():
        channels_last = False
    else:
        raise ValueError(f"x must be channels_last or contiguous, got strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if weight.dtype != bias.dtype or weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"weight and bias must share bfloat16 or float32, got "
                        f"{weight.dtype} and {bias.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on x's device")
    hw = h * w
    lanes = max(1, 256 // (c // 8)) if channels_last else 32
    tiles, per_tile = _tiling(n, hw, lanes)
    y = torch.empty_like(x)
    part = torch.empty((n, tiles, c, 2), device=x.device, dtype=torch.float32)
    ab = torch.empty((n, c, 2), device=x.device, dtype=torch.float32)
    lib = cuda_build.load("group_norm")
    fn = lib.hv_group_norm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), part.data_ptr(),
             ab.data_ptr(), n, c, hw, groups, int(channels_last),
             int(weight.dtype == torch.bfloat16), int(act == "silu"), tiles, per_tile, lanes,
             float(eps), cuda_build.stream_handle(x.device))
    cuda_build.check(err, "group norm launch")
    launches["group_norm"] += 1
    return y


class GroupNormAct(torch.autograd.Function):
    """GroupNorm(+SiLU), differentiable in x, weight and bias; the backward
    recomputes through ``F.group_norm`` from the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act):
        if x.device.type == "cpu":
            _check(x, weight, bias, groups, act)
            y = group_norm_act_plain(x, weight, bias, groups, eps, act)
        else:
            y = group_norm_act_cuda(x, weight, bias, groups, eps, act)
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (groups, eps, act)
        return y

    @staticmethod
    def backward(ctx, g):
        groups, eps, act = ctx.config
        need = ctx.needs_input_grad[:3]  # frozen weights get no dgamma, dbeta
        x, weight, bias = (t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need))
        with torch.enable_grad():
            y = F.group_norm(x, groups, weight, bias, eps)
            if act == "silu":
                y = F.silu(y)
            grads = iter(torch.autograd.grad(
                y, [t for t in (x, weight, bias) if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need), None, None, None)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over the channel axis (dim 1), optionally followed by SiLU;
    CPU tensors take the plain version, CUDA tensors launch kernel C or
    raise."""
    return GroupNormAct.apply(x, weight, bias, groups, eps, act)
