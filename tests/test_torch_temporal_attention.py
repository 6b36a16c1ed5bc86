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
    (1, 24, 12, 256, 1),   # d = 256 (5 motion heads at levels 2-3): two 128-column chunks
    (1, 24, 7, 640, 2),    # d = 320: two 160-column chunks
    (1, 8, 5, 1280, 1),    # d = 1280, one head over the widest channels: eight chunks
    (1, 5, 7, 108, 3),     # d = 36: the kernels pad it to 40
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
    (2, 1, 9, 320, 8),     # one frame (the stage-1 camera encoder): dq = dk = 0, dv = g
    (1, 24, 12, 640, 8),   # d = 80
    (1, 24, 12, 1280, 8),  # d = 160
    (1, 24, 12, 256, 1),   # d = 256: two chunks
    (1, 24, 7, 640, 2),    # d = 320
    (1, 8, 5, 1280, 1),    # d = 1280: eight chunks
    (1, 5, 7, 108, 3),     # d = 36: padded to 40
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


@pytest.mark.parametrize("c,heads", [
    (320, 8), (640, 8), (1280, 8),     # the motion modules' levels: d = 40, 80, 160
    (64, 2), (16, 2), (40, 1), (24, 1), (320, 5), (96, 12), (128, 16), (160, 1),
])
def test_temporal_plan_items_hold_whole_heads(c, heads):
    """An item holds whole heads, at most 160 columns unless one head is
    wider, loaded at least 8 columns wider (the last 16-deep step of a
    head with d % 16 == 8 stays in the row) and an odd number of 16-byte
    units wide (the frames of a head in distinct banks), within a TMA
    box's 256 elements."""
    plan = ta.temporal_plan(c, heads)
    d = c // heads
    assert plan.chunks == 1  # whole heads: d <= 160
    assert heads % plan.heads == 0 and plan.cols == plan.heads * d
    assert plan.cols <= ta.CHUNK_COLUMNS or plan.heads == 1
    assert plan.padded % 8 == 0 and (plan.padded // 8) % 2 == 1
    assert plan.cols + 8 <= plan.padded <= plan.cols + 16 and plan.padded <= 256
    # the most heads that fit: one more whole-head divisor would not
    assert not any(heads % h == 0 and h * d <= ta.CHUNK_COLUMNS
                   for h in range(plan.heads + 1, heads + 1))
    if c == 320 and heads == 8:
        assert plan == ta.TemporalPlan(4, 160, 168, 1)


@pytest.mark.parametrize("shape,heads,sizes", [
    # the stage-2 step's five temporal shapes (896x512x24f) and the stage-1
    # camera encoder's (bs 8, one frame): 320-byte items, loaded 336 wide
    ((1, 24, 7168, 320), 8, (1, 24, 7168, 8, 40, 4, 168, 1, 40)),
    ((1, 24, 1792, 640), 8, (1, 24, 1792, 8, 80, 2, 168, 1, 80)),
    ((1, 24, 448, 1280), 8, (1, 24, 448, 8, 160, 1, 168, 1, 160)),
    ((1, 24, 112, 1280), 8, (1, 24, 112, 8, 160, 1, 168, 1, 160)),
    ((8, 1, 7168, 320), 8, (8, 1, 7168, 8, 40, 4, 168, 1, 40)),
    ((2, 5, 9, 48), 3, (2, 5, 9, 3, 16, 3, 56, 1, 16)),
    ((1, 7, 33, 64), 2, (1, 7, 33, 2, 32, 2, 72, 1, 32)),
])
def test_launch_sizes_of_both_kernels(shape, heads, sizes):
    """The size arguments the forward and backward wrappers pass their
    kernels: (b, f, l, heads, d, heads an item, padded width, chunks a
    head, softmax width), the item from ``temporal_plan``; within what
    both C entry points accept (cwp at most 256, an odd number of 16-byte
    units, at least 8 past the item's columns)."""
    got = ta.launch_sizes(shape, heads)
    assert got == sizes
    d, per, cwp = got[4], got[5], got[6]
    assert cwp <= 256 and cwp % 8 == 0 and (cwp // 8) % 2 == 1 and cwp >= per * d + 8
    assert got[3] % per == 0


@pytest.mark.parametrize("shape,heads,error", [
    ((1, 4, 8, 2816), 2, "head dim 1408"),
    ((1, 4, 8, 60), 2, "head dim 30"),
    ((1, 33, 8, 64), 2, "frames"),
    ((1, 4, 0, 64), 2, "unsupported sizes"),
    ((65536, 4, 8, 64), 2, "unsupported sizes"),
])
def test_launch_sizes_reject_what_the_kernels_do_not_take(shape, heads, error):
    with pytest.raises(ValueError, match=error):
        ta.launch_sizes(shape, heads)
