"""Pieces shared by the metric networks: their float32 arithmetic, a frozen
batch norm, and batched evaluation of host arrays.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which keeps 10 bits of mantissa. FID
and FVD take the square root of a product of covariances estimated from few
samples, which amplifies a small error in the features, so every metric
call runs in IEEE float32 (``strict_fp32``). The settings are restored when
the block ends, so the generator's arithmetic is untouched.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    """TF32 on (``True``) or off for cuDNN convolutions and cuBLAS matmuls
    inside the block; both settings are restored after it."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


def strict_fp32():
    """The metric networks' setting: TF32 off."""
    return tf32_mode(False)


class FrozenBatchNorm(nn.Module):
    """Batch norm at inference: running statistics, an affine map, and the
    state-dict keys ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (no ``num_batches_tracked``)."""

    def __init__(self, channels: int, eps: float = 0.001):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def load_frozen(module: nn.Module, state_dict, skip_prefixes: Sequence[str] = ()) -> nn.Module:
    """``load_state_dict(strict=True)`` of a torch checkpoint without its
    ``num_batches_tracked`` counters and the heads under ``skip_prefixes``."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked") and not k.startswith(tuple(skip_prefixes))}
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def run_batched(fn: Callable[..., torch.Tensor], arrays: Sequence[np.ndarray], batch: int,
                device) -> np.ndarray:
    """``fn`` over chunks of ``batch`` rows of the host arrays (float32 on
    ``device``), in IEEE float32 and without autograd; the outputs
    concatenated on the host."""
    outs = []
    with torch.inference_mode(), strict_fp32():
        for i in range(0, len(arrays[0]), batch):
            chunk = [torch.as_tensor(np.ascontiguousarray(a[i:i + batch]), dtype=torch.float32,
                                     device=device) for a in arrays]
            outs.append(fn(*chunk).float().cpu().numpy())
    return np.concatenate(outs, axis=0)
