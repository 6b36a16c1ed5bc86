"""Kernel C's function on the CPU: the port's ``group_norm_act`` (its plain
version and its autograd Function) against the JAX package's ``_fused`` (the
Pallas statistics kernel in interpret mode, as ``tests/test_ops.py`` runs it)
and ``_reference``, fp32.

Inputs are made with numpy in the JAX package's NHWC layout and transposed
to the port's NCHW. Tolerances are those of ``tests/test_ops.py``: 2e-5 on
values, 2e-4 on the gradients of x, weight and bias under sum(y^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_helpers import nchw, nhwc
from humanvid_tpu.ops.group_norm import _fused, _reference
from humanvid_tpu_torch.ops import group_norm as gn

VALUE_TOL = 2e-5
GRAD_TOL = 2e-4
EPS = 1e-6
SHAPES = [((2, 8, 8, 64), 8), ((1, 7, 5, 32), 4), ((2, 5, 7, 320), 32)]


def _inputs(shape, seed, shift=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    return x, w, b


def _port(x, w, b, groups, act, memory_format):
    xt = nchw(x).contiguous(memory_format=memory_format).requires_grad_()
    wt, bt = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = gn.group_norm_act(xt, wt, bt, groups, EPS, act)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    assert y.is_contiguous(memory_format=memory_format)
    grads = torch.autograd.grad(y.square().sum(), (xt, wt, bt))
    return y, grads


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last],
                         ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES, ids=lambda v: str(v))
def test_group_norm_matches_jax_fused_and_reference(shape, groups, act, memory_format):
    x, w, b = _inputs(shape, 11)
    y, (dx, dw, db) = _port(x, w, b, groups, act, memory_format)
    xj, wj, bj = map(jnp.asarray, (x, w, b))
    ref = _reference(xj, wj, bj, groups, EPS, act)
    with pltpu.force_tpu_interpret_mode():
        fused = _fused(xj, wj, bj, groups, EPS, act, True)
        g_fused = jax.grad(lambda *a: jnp.sum(_fused(*a, groups, EPS, act, True) ** 2),
                           (0, 1, 2))(xj, wj, bj)
    for want in (ref, fused):
        np.testing.assert_allclose(nhwc(y), np.asarray(want), rtol=VALUE_TOL, atol=VALUE_TOL)
    g_ref = jax.grad(lambda *a: jnp.sum(_reference(*a, groups, EPS, act) ** 2),
                     (0, 1, 2))(xj, wj, bj)
    for want in (g_ref, g_fused):
        np.testing.assert_allclose(nhwc(dx), np.asarray(want[0]), rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "silu"])
def test_group_norm_keeps_digits_when_mean_dwarfs_std(act):
    """x * 0.1 + 50: the one-pass E[x^2] - mean^2 of the JAX kernel loses
    the variance's digits here; the port's centred statistics hold a float64
    reference to 1e-4."""
    shape, groups = (2, 5, 7, 320), 32
    x, w, b = _inputs(shape, 12, shift=50.0, scale=0.1)
    y = gn.group_norm_act(nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups, EPS, act)
    x64 = nchw(x).double()
    ref = torch.nn.functional.group_norm(x64, groups, torch.from_numpy(w).double(),
                                         torch.from_numpy(b).double(), EPS)
    if act == "silu":
        ref = torch.nn.functional.silu(ref)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_group_norm_plain_rounds_once_in_bf16():
    """bf16 x with fp32 weights: fp32 math, one rounding of the result."""
    x, w, b = _inputs((2, 4, 6, 64), 13)
    xt = nchw(x).to(torch.bfloat16)
    y = gn.group_norm_act_plain(xt, torch.from_numpy(w), torch.from_numpy(b), 8, EPS, "silu")
    ref = gn.group_norm_act_plain(xt.float(), torch.from_numpy(w), torch.from_numpy(b), 8, EPS,
                                  "silu")
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref.to(torch.bfloat16))


def test_group_norm_rejects_what_it_does_not_take():
    x = torch.zeros((1, 12, 4, 4))
    w = torch.ones(12)
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, w, 5, EPS)          # 12 channels, 5 groups
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, w, 4, EPS, "gelu")  # only None or "silu"
    with pytest.raises(ValueError):
        gn.group_norm_act(x[0], w, w, 4, EPS)       # not (N, C, H, W)
    with pytest.raises(ValueError):                 # the CUDA wrapper takes no CPU tensor
        gn.group_norm_act_cuda(x.to(torch.bfloat16), w, w, 4, EPS)
