"""Kernel B (frame-axis attention): the port's plain versions of the
forward and of the backward against the JAX Pallas kernels run in TPU
interpret mode. The CUDA kernels are held to the plain versions on the card
in test_torch_cuda.py.

Tolerance 2e-4 (fp32 on the CPU): the Pallas kernel scales q before the dot
and normalizes after the softmax's exp2 in the log2 domain; the plain
version scales the logits; the observed differences are near 1e-6, in the
gradients as in the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_helpers  # noqa: F401  (caps torch threads)
from humanvid_tpu.ops.temporal_attention import temporal_attention as jax_temporal
from humanvid_tpu_torch.ops import temporal_attention as ta

TOL = 2e-4


def _inputs(b, f, l, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, f, l, c)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,f,l,c,heads", [
    (2, 6, 96, 64, 4),
    (1, 24, 80, 128, 8),   # 24 frames, several heads
    (1, 8, 100, 64, 4),    # ragged l (not a multiple of the Pallas tile)
    (1, 5, 7, 48, 3),      # ragged everything
])
def test_plain_matches_pallas_interpret(b, f, l, c, heads):
    q, k, v = _inputs(b, f, l, c)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_temporal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    out = ta.temporal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), heads)
    assert out.shape == (b, f, l, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("b,f,l,c,heads", [
    (2, 6, 96, 64, 4),
    (1, 24, 40, 160, 4),   # 24 frames, d = 40
    (1, 5, 7, 48, 3),      # ragged everything
])
def test_plain_backward_matches_pallas_vjp(b, f, l, c, heads):
    q, k, v = _inputs(b, f, l, c, seed=1)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_temporal(q_, k_, v_, heads),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = vjp(jnp.asarray(g))
    grads = ta.temporal_attention_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, g)), heads)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_function_gradient_matches_autograd_through_plain():
    q, k, v = _inputs(2, 7, 9, 48, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(ta.temporal_attention(*leaves, 3), leaves, g)
    ref = torch.autograd.grad(ta.temporal_attention_plain(*leaves, 3), leaves, g)
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5, rtol=0)


def test_rejects_too_many_frames_and_cpu_launch():
    q, k, v = (torch.zeros(1, 33, 4, 8) for _ in range(3))
    with pytest.raises(ValueError, match="frames"):
        ta.temporal_attention(q, k, v, 2)
    q, k, v = (torch.zeros(1, 4, 4, 8) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        ta.temporal_attention_cuda(q, k, v, 2)
