"""The kernels of the measurement probes (``humanvid_tpu_torch.tools.microbench``).

Three hand-written CUDA kernels, each with its plain PyTorch version and a
launch counter, as every kernel of the port has:

- :func:`dmajor` (``csrc/probe_dmajor.cu``): one matrix product per problem
  in one of four orientations, of which a fixed slice is stored; it asks
  which way round a 40-wide head should enter the tensor-core product.
- :func:`pvt` (``csrc/probe_pvt.cu``): a flash attention forward computed
  transposed (keys down, queries across), returning out and the
  log-sum-exp in log2 units; it is timed against kernel A.
- :func:`hbm_map` (``csrc/probe_hbm.cu``): ``y = x * 1.0001 + 0.5`` streamed once,
  the card's streaming rate.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version. No path of the models runs them. Each wrapper
binds its C function once (``cuda_build.function``) and does no other host
work a call than its checks, the output's allocation and the launch: the
kernels' times are near the wrappers' own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import cuda_build

LOG2E = 1.4426950408889634
HBM_SCALE = 1.0001  # the TPU probe's constant; rounds to exactly 1.0 in bf16
HBM_SCALE_BF16 = float(torch.tensor(HBM_SCALE, dtype=torch.bfloat16))  # what kernel 10 takes
STORED = 128        # columns the QK and pv_d_on_lanes arms store
PV_DMAJOR_STORED = 1024  # rows of the (d, lq) output the pv_dmajor_out arm stores

# The orientation arms, in the order of the kernel's `arm` argument:
# (inputs, output) per problem g.
DMAJOR_ARMS = {
    "qk_d_on_lanes": 0,     # q (lq, d), k (lk, d)   -> (q k^T)[:, :128]
    "qk_d_on_sublanes": 1,  # q (d, lq), k (d, lk)   -> (q^T k)[:, :128]
    "pv_d_on_lanes": 2,     # p (lq, lk), v (lk, d)  -> p v zero-padded to 128 columns
    "pv_dmajor_out": 3,     # v (d, lk), p (lq, lk)  -> (v p^T)[:, :1024]
}

launches = {"probe_dmajor": 0, "probe_pvt": 0, "probe_hbm": 0}

# the C entry points' argument types
DMAJOR_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
PVT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
HBM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p]


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check_cuda(tensors, dtype=torch.bfloat16):
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the first input's CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


# --- kernel 8: the orientation probe ---------------------------------------

def _dmajor_dims(arm: str, a: torch.Tensor, b: torch.Tensor):
    """(G, lq, lk, d) of an arm's inputs; raises on shapes that disagree."""
    if arm not in DMAJOR_ARMS:
        raise ValueError(f"arm {arm!r} not in {sorted(DMAJOR_ARMS)}")
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} {tuple(b.shape)}")
    g = a.shape[0]
    if arm == "qk_d_on_lanes":
        (lq, d), (lk, d2) = a.shape[1:], b.shape[1:]
    elif arm == "qk_d_on_sublanes":
        (d, lq), (d2, lk) = a.shape[1:], b.shape[1:]
    elif arm == "pv_d_on_lanes":
        (lq, lk), (lk2, d) = a.shape[1:], b.shape[1:]
        d2 = d if lk2 == lk else -1
    else:
        (d, lk), (lq, lk2) = a.shape[1:], b.shape[1:]
        d2 = d if lk2 == lk else -1
    if d2 != d:
        raise ValueError(f"arm {arm}: inputs {tuple(a.shape)} and {tuple(b.shape)} disagree")
    return g, lq, lk, d


def dmajor_plain(arm: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the fp32 product of the arm, its stored slice rounded
    to the inputs' dtype."""
    _, _, _, d = _dmajor_dims(arm, a, b)
    af, bf = a.float(), b.float()
    if arm == "qk_d_on_lanes":
        out = torch.matmul(af, bf.transpose(1, 2))[:, :, :STORED]
    elif arm == "qk_d_on_sublanes":
        out = torch.matmul(af.transpose(1, 2), bf)[:, :, :STORED]
    elif arm == "pv_d_on_lanes":
        out = F.pad(torch.matmul(af, bf), (0, STORED - d))
    else:
        out = torch.matmul(af, bf.transpose(1, 2))[:, :, :PV_DMAJOR_STORED]
    return out.to(a.dtype)


def dmajor_cuda(arm: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch kernel 8; every check the kernel relies on raises here."""
    g, lq, lk, d = _dmajor_dims(arm, a, b)
    _check_cuda([("a", a), ("b", b)])
    if g > 65535 or lq % 64 or lk % 64 or d % 8:
        raise ValueError(f"unsupported G={g} lq={lq} lk={lk} d={d}: needs lq, lk multiples "
                         f"of 64 and d of 8")
    if arm.startswith("qk") and not (d <= 48 or d == 128) or arm.startswith("pv") and d > 48:
        raise ValueError(f"arm {arm} does not take d={d}")
    if arm.startswith("qk") and lk < STORED:
        raise ValueError(f"arm {arm} stores {STORED} columns: needs lk >= {STORED}")
    if arm == "pv_dmajor_out" and lq > PV_DMAJOR_STORED:
        raise ValueError(f"arm {arm} stores {PV_DMAJOR_STORED} rows: needs lq <= "
                         f"{PV_DMAJOR_STORED}")
    shape = (g, d, lq) if arm == "pv_dmajor_out" else (g, lq, STORED)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    fn = cuda_build.function("probe_dmajor", "hv_probe_dmajor", DMAJOR_ARGTYPES)
    cuda_build.check(fn(DMAJOR_ARMS[arm], a.data_ptr(), b.data_ptr(), out.data_ptr(), None,
                        g, lq, lk, d, cuda_build.stream_handle(a.device)),
                     f"probe_dmajor {arm} launch")
    launches["probe_dmajor"] += 1
    return out


def dmajor(arm: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The arm's stored product; CPU tensors take the plain version, CUDA
    tensors launch kernel 8 or raise."""
    if a.device.type == "cpu":
        return dmajor_plain(arm, a, b)
    return dmajor_cuda(arm, a, b)


# --- kernel 9: the transposed flash forward ---------------------------------

def _pvt_check(q, k, v, heads, key_bias):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or q.shape[2] % heads:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"for {heads} heads")
    if key_bias is not None and tuple(key_bias.shape) != (q.shape[0], k.shape[1]):
        raise ValueError(f"key_bias {tuple(key_bias.shape)} != {(q.shape[0], k.shape[1])}")


def _prescale(q: torch.Tensor, heads: int) -> torch.Tensor:
    """q * (d^-1/2 * log2 e) with the constant and the product rounded to
    q's dtype, as the JAX probe folds the scale into q."""
    d = q.shape[-1] // heads
    # the constant rounded on the host (no copy to the card); a product with
    # a value exact in q's dtype rounds once, as JAX's product in that dtype
    return q * float(torch.tensor(d ** -0.5 * LOG2E, dtype=q.dtype))


def pvt_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              key_bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (out, lse) with lse (B, heads, Lq) fp32 in log2 units.
    Logits in fp32 from the pre-scaled q, p = exp2(s - max) rounded to the
    input dtype before the PV product and summed so rounded in fp32, as the
    JAX probe sums it (a ones row under V^T)."""
    _pvt_check(q, k, v, heads, key_bias)
    b, lq, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2).float()

    s = torch.matmul(split(_prescale(q, heads)), split(k).transpose(-1, -2))
    if key_bias is not None:
        s = s + (key_bias.float() * LOG2E)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m).to(q.dtype).float()
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, split(v)) / l
    lse = (m + torch.log2(l)).squeeze(-1)
    return out.to(q.dtype).transpose(1, 2).reshape(b, lq, c), lse


def pvt_cuda(q, k, v, heads, key_bias=None):
    """Launch kernel 9 (after the pre-scaling of q); every check the kernel
    relies on raises here."""
    _pvt_check(q, k, v, heads, key_bias)
    _check_cuda([("q", q), ("k", k), ("v", v)])
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    if d % 8 or d > 80:
        raise ValueError(f"head dim {d} unsupported: needs d % 8 == 0 and d <= 80")
    if key_bias is not None:
        _check_cuda([("key_bias", key_bias)], torch.float32)
        if key_bias.device != q.device:
            raise ValueError("key_bias must be on q's device")
    if min(b, lq, lk) < 1 or heads > 65535 or b > 65535:
        raise ValueError(f"unsupported sizes b={b} lq={lq} lk={lk} heads={heads}")
    qs = _prescale(q, heads)
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
    fn = cuda_build.function("probe_pvt", "hv_probe_pvt", PVT_ARGTYPES)
    bias_ptr = key_bias.data_ptr() if key_bias is not None else None
    cuda_build.check(fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                        lse.data_ptr(), b, lq, lk, heads, d, cuda_build.stream_handle(q.device)),
                     "probe_pvt launch")
    launches["probe_pvt"] += 1
    return out, lse


def pvt(q, k, v, heads, key_bias=None):
    """(out, lse in log2 units); CPU tensors take the plain version, CUDA
    tensors launch kernel 9 or raise."""
    if q.device.type == "cpu":
        return pvt_plain(q, k, v, heads, key_bias)
    return pvt_cuda(q, k, v, heads, key_bias)


# --- kernel 10: the streaming probe -----------------------------------------

def hbm_map_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``x * 1.0001 + 0.5`` as JAX computes it on a bf16
    array: the constant rounded to x's dtype, each operation rounded to x's
    dtype."""
    c = float(torch.tensor(HBM_SCALE, dtype=x.dtype))
    t = (x.float() * c).to(x.dtype)
    return (t.float() + 0.5).to(x.dtype)


def hbm_blocks(n: int) -> int:
    """The grid's cap kernel 10 is given: one block of 256 threads for every
    256 16-byte vectors. The kernel launches no more blocks than its own
    unit of work fills."""
    return max(1, -(-n // (8 * 256)))


def hbm_map_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch kernel 10; every check the kernel relies on raises here."""
    _check_cuda([("x", x)])
    if x.numel() == 0:
        raise ValueError("x is empty")
    y = torch.empty_like(x)
    fn = cuda_build.function("probe_hbm", "hv_probe_hbm", HBM_ARGTYPES)
    cuda_build.check(fn(x.data_ptr(), y.data_ptr(), x.numel(), HBM_SCALE_BF16,
                        hbm_blocks(x.numel()), cuda_build.stream_handle(x.device)),
                     "probe_hbm launch")
    launches["probe_hbm"] += 1
    return y


def hbm_map(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.0001 + 0.5`` rounded as in bf16 JAX; CPU tensors take the
    plain version, CUDA tensors launch kernel 10 or raise."""
    if x.device.type == "cpu":
        return hbm_map_plain(x)
    return hbm_map_cuda(x)
