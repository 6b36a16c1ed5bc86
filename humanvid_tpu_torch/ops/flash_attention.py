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
128, and d = 512. Any other d up to 512 runs through a zero pad
(``head_pad.resize_heads``): to the next multiple of 8 up to 128, to 512
above it, with the softmax scale of the true d. Past 512 every width runs
in the xwide kernels (forward, dV, dK and dQ; column slabs of at most 256),
padded to the next multiple of 8.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_build
from .head_pad import resize_heads, round_up8

WIDE_HEAD_DIM = 512  # the 512-wide kernels' width; wider heads run in the xwide kernels

_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# Launches of the CUDA kernels by the width they ran at, "d<=128" (the
# UNet's heads), "d>128" (the 512-wide kernels: the VAE's single head, and
# heads padded to 512) and "d>512" (the xwide kernels): the forward and the
# backward's two entry points.
launches = {"d<=128": 0, "d>128": 0, "d>512": 0, "bwd_dkv": 0, "bwd_dq": 0,
            "bwd_dkv_d>128": 0, "bwd_dq_d>128": 0, "bwd_dkv_d>512": 0, "bwd_dq_d>512": 0}
# The forward's and the backward's launches by the caller's head width
# (before any pad): {d: count}.
forward_launches_by_d: dict = {}
backward_launches_by_d: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    forward_launches_by_d.clear()
    backward_launches_by_d.clear()


class FlashPlan(NamedTuple):
    """How the kernels run a d-wide head: at ``width`` columns (d, or d
    zero-padded), through the forward's configuration ``forward`` in
    ``csrc/flash_attention.cu`` and the backward's ``backward`` in
    ``csrc/flash_attention_bwd.cu`` (dk/dv, dq)."""
    width: int
    forward: str
    backward: str


@functools.lru_cache(maxsize=None)
def flash_plan(d: int) -> FlashPlan:
    """The kernels' plan for a head of d columns (the C entry points pick
    the same configurations by width); raises for d < 1."""
    if d < 1:
        raise ValueError(f"head width {d} unsupported by kernel A: it takes d >= 1")
    w = round_up8(d)
    if d > WIDE_HEAD_DIM:
        return FlashPlan(w, "Xwide", "XwideDv+XwideDk/XwideDq")
    if w <= 40:
        return FlashPlan(w, "Cfg<48, 40>", "DkvCfg48/DqCfg48")
    if w <= 80:
        return FlashPlan(w, "Cfg<80, 80>", "DkvCfg80s/DqCfg80s" if w % 16 == 0
                         else "DkvCfg80/DqCfg80")
    if w < 128:
        return FlashPlan(w, "Cfg<128, 128>", "DkvCfg128/DqCfg128")
    if w == 128:
        return FlashPlan(w, "Cfg<128, 128, swizzled>", "DkvCfg128w/DqCfg128w")
    return FlashPlan(WIDE_HEAD_DIM, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq")


def _width_key(width: int) -> str:
    """The launch counter of the kernels that run a head ``width`` wide."""
    return "d<=128" if width <= 128 else ("d>128" if width <= WIDE_HEAD_DIM else "d>512")


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
             lse.data_ptr(), b, lq, lk, heads, plan.width, d,
             cuda_build.stream_handle(q.device))
    cuda_build.check(err, "flash attention launch")
    launches[_width_key(plan.width)] += 1
    forward_launches_by_d[d] = forward_launches_by_d.get(d, 0) + 1
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
    qk, kk, vk, gk = _kernel_inputs(heads, plan.width, q=q, k=k, v=v, g=g)
    dq, dk, dv = torch.empty_like(qk), torch.empty_like(kk), torch.empty_like(vk)
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    stream = cuda_build.stream_handle(q.device)
    common = (qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), bias_ptr, gk.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    sizes = (b, lq, lk, heads, plan.width, d, stream)
    wide = "" if plan.width <= 128 else "_" + _width_key(plan.width)
    fn = cuda_build.function("flash_attention_bwd", "hv_flash_bwd_dkv", _DKV_ARGTYPES)
    cuda_build.check(fn(*common, dk.data_ptr(), dv.data_ptr(), *sizes),
                     "flash attention dk/dv launch")
    launches["bwd_dkv" + wide] += 1
    fn = cuda_build.function("flash_attention_bwd", "hv_flash_bwd_dq", _DQ_ARGTYPES)
    cuda_build.check(fn(*common, dq.data_ptr(), *sizes), "flash attention dq launch")
    launches["bwd_dq" + wide] += 1
    backward_launches_by_d[d] = backward_launches_by_d.get(d, 0) + 1
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
