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
dk/dv and dq entry points of ``csrc/flash_attention_bwd.cu`` (the head
widths of the forward: d <= 80, and d = 512, where the dk/dv entry point
launches a dV and a dK kernel), on a CPU tensor
through :func:`flash_attention_backward_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build

# Launches of the CUDA kernels by head-width class, "d<=128" (the UNet's
# heads) and "d>128" (the VAE's single 512-wide head): the forward and the
# backward's two kernels.
launches = {"d<=128": 0, "d>128": 0, "bwd_dkv": 0, "bwd_dq": 0,
            "bwd_dkv_d>128": 0, "bwd_dq_d>128": 0}
# The forward's launches by head width: {d: count}.
forward_launches_by_d: dict = {}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    forward_launches_by_d.clear()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, key_bias: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: fp32 logits and softmax, the
    probabilities rounded to the input dtype before the PV product (as the
    JAX kernel does)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, lk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (d ** -0.5)
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


def flash_attention_cuda(q, k, v, heads, key_bias=None):
    """Launch the CUDA kernel; every check the kernel relies on raises here."""
    _check(q, k, v, heads, key_bias)
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d % 8 or (d > 80 and d != 512):
        raise ValueError(f"head dim {d} unsupported: needs d % 8 == 0 and d <= 80, "
                         f"or d == 512")
    if key_bias is not None:
        if key_bias.device != q.device or key_bias.dtype != torch.float32 \
                or not key_bias.is_contiguous():
            raise ValueError("key_bias must be contiguous fp32 on q's device")
    if min(b, lq, lk) < 1 or heads > 65535 or b > 65535:
        raise ValueError(f"unsupported sizes b={b} lq={lq} lk={lk} heads={heads}")
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
    lib = cuda_build.load("flash_attention")
    fn = lib.hv_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
             lse.data_ptr(), b, lq, lk, heads, d,
             cuda_build.stream_handle(q.device))
    cuda_build.check(err, "flash attention launch")
    launches["d<=128" if d <= 128 else "d>128"] += 1
    forward_launches_by_d[d] = forward_launches_by_d.get(d, 0) + 1
    return out, lse


def flash_attention_backward_plain(q, k, v, key_bias, g, lse, delta, heads: int,
                                   chunk: Optional[int] = None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in the
    input dtype. Recomputes ``p = exp(s * scale + bias - lse)`` in fp32
    from the natural-log ``lse``, rounds p and ds to the input dtype before
    their products (as the kernels do), and loops over chunks of q rows so
    that the fp32 (B, heads, chunk, Lk) intermediates stay near 512 MB."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    scale = d ** -0.5
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
    if d % 8 or (d > 80 and d != 512):
        raise ValueError(f"head dim {d} unsupported by the backward kernels: "
                         f"needs d % 8 == 0 and d <= 80, or d == 512")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != (b, heads, lq):
            raise ValueError(f"{name} must be contiguous fp32 {(b, heads, lq)} on q's device")
    if key_bias is not None:
        if key_bias.device != q.device or key_bias.dtype != torch.float32 \
                or not key_bias.is_contiguous():
            raise ValueError("key_bias must be contiguous fp32 on q's device")
    if min(b, lq, lk) < 1 or heads > 65535 or b > 65535:
        raise ValueError(f"unsupported sizes b={b} lq={lq} lk={lk} heads={heads}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = cuda_build.load("flash_attention_bwd")
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    stream = cuda_build.stream_handle(q.device)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, g.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    fn = lib.hv_flash_bwd_dkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    wide = "_d>128" if d > 128 else ""
    cuda_build.check(fn(*common, dk.data_ptr(), dv.data_ptr(), b, lq, lk, heads, d, stream),
                     "flash attention dk/dv launch")
    launches["bwd_dkv" + wide] += 1
    fn = lib.hv_flash_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    cuda_build.check(fn(*common, dq.data_ptr(), b, lq, lk, heads, d, stream),
                     "flash attention dq launch")
    launches["bwd_dq" + wide] += 1
    return dq, dk, dv


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
