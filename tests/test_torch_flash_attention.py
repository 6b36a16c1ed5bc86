"""Kernel A (flash attention, packed heads): the port's plain versions of
the forward and of the backward against the JAX Pallas kernels run in TPU
interpret mode. The CUDA kernels are held to the plain versions on the card
in test_torch_cuda.py.

Tolerance 2e-4 for the forward (fp32 on the CPU): the two sides sum logits,
exponentials and the PV product in different orders (the Pallas kernel in
128-key blocks with an online softmax in the log2 domain, the plain version
in one pass); the observed differences are near 1e-6. The backward's
gradients are held to 5e-4, as the JAX package's own backward test holds
its kernels to einsum gradients; the observed differences are near 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_helpers  # noqa: F401  (caps torch threads)
from humanvid_tpu.ops.common import NEG_INF
from humanvid_tpu.ops.flash_attention import _flash_fwd
from humanvid_tpu.ops.flash_attention import flash_attention_packed as jax_flash
from humanvid_tpu_torch.ops import flash_attention as fa
from humanvid_tpu_torch.pipelines.system import resolve_device

TOL = 2e-4
BWD_TOL = 5e-4


def _inputs(b, lq, lk, heads, d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    c = heads * d
    q, k, v = (rng.normal(size=(b, n, c)).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if with_bias:
        # the CFG pattern: row 0 hides the second half of its keys; "all rows"
        # is the stage-2 uncond step's, where every row hides them
        bias = np.zeros((b, lk), np.float32)
        bias[slice(None) if with_bias == "all rows" else 0, lk // 2:] = NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("b,lq,lk,heads,d,with_bias", [
    (2, 128, 256, 2, 40, False),     # d = 40, the UNet's level-0 head width
    (2, 128, 256, 2, 40, True),      # with the reference-KV bias
    (2, 100, 300, 2, 40, True),      # ragged Lq / Lk with the bias
    (1, 100, 200, 3, 16, False),     # ragged, no bias (padded keys masked)
    (1, 64, 96, 1, 512, False),      # the VAE's single wide head
    (2, 100, 300, 2, 64, True),      # d = 64 (5 heads at level 0), ragged, the bias
    (2, 100, 300, 2, 128, True),     # d = 128 (5 heads at level 1), ragged, the bias
    (1, 100, 200, 3, 36, True),      # no multiple of 8: the kernels pad it to 40
    (1, 64, 96, 2, 192, True),       # 128 < d < 512: the kernels pad it to 512
    (1, 100, 200, 2, 96, True),      # d = 96 and 112: the own-width kernels' boxes of 32
    (1, 100, 200, 2, 112, True),     # and 16 columns
])
def test_plain_matches_pallas_interpret(b, lq, lk, heads, d, with_bias):
    q, k, v, bias = _inputs(b, lq, lk, heads, d, with_bias)
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = _flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), heads,
            block_q=128, block_kv=128, with_lse=True)
    out, lse = fa.flash_attention_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        None if bias is None else torch.from_numpy(bias))
    assert out.shape == (b, lq, heads * d) and lse.shape == (b, heads, lq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=0)
    # the JAX kernel keeps its log-sum-exp in log2 units, the port in natural log
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse) * np.log(2.0),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("b,lq,lk,heads,d,with_bias", [
    (2, 100, 300, 2, 40, True),      # ragged Lq / Lk, d = 40, the CFG bias
    (2, 128, 256, 2, 40, False),
    (1, 64, 96, 3, 16, True),
    (1, 64, 96, 1, 512, True),       # the VAE's wide head: the straight-layout kernels
    (2, 128, 512, 2, 40, "all rows"),  # every row hides whole 128-key tiles
    (1, 192, 192, 2, 80, False),     # Lq = Lk (the ReferenceNet's self-attention), d = 80
    (2, 100, 300, 2, 64, True),      # d = 64, ragged, the bias
    (2, 100, 300, 2, 128, "all rows"),  # d = 128, ragged, the CFG-dropout bias on every row
    (1, 100, 200, 3, 36, True),      # padded to 40 by the kernels' wrapper
    (1, 64, 96, 2, 192, True),       # padded to 512
    (1, 100, 200, 2, 96, True),      # d = 96 and 112 (the own-width kernels' widths)
    (1, 100, 200, 2, 112, "all rows"),
])
def test_plain_backward_matches_pallas_vjp(b, lq, lk, heads, d, with_bias):
    q, k, v, bias = _inputs(b, lq, lk, heads, d, with_bias, seed=1)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    jbias = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, heads, jbias, block_q=128,
                                                        block_kv=128),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = vjp(jnp.asarray(g))
        _, lse_log2 = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias, heads,
                                 block_q=128, block_kv=128, with_lse=True)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tbias = None if bias is None else torch.from_numpy(bias)
    # the JAX kernels keep the log-sum-exp in log2 units, the port in natural log
    lse = torch.from_numpy(np.asarray(lse_log2) * np.log(2.0)).float()
    delta = fa.attention_delta(tg, torch.from_numpy(np.array(out)), heads)
    grads = fa.flash_attention_backward_plain(tq, tk, tv, tbias, tg, lse, delta, heads, chunk=48)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BWD_TOL, rtol=0)
    # the same through the port's own forward and autograd Function
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(fa.flash_attention_packed(*leaves, heads, tbias)[0], leaves, tg)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=BWD_TOL, rtol=0)


def test_function_gradient_matches_autograd_through_plain():
    q, k, v, bias = _inputs(2, 70, 90, 2, 24, True, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tbias = torch.from_numpy(bias)
    out, lse = fa.flash_attention_packed(*leaves, 2, tbias)
    assert not lse.requires_grad
    got = torch.autograd.grad(out, leaves, g)
    ref = torch.autograd.grad(fa.flash_attention_plain(*leaves, 2, tbias)[0], leaves, g)
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5, rtol=0)
    assert (got[1][0, 45:] == 0).all() and (got[2][0, 45:] == 0).all()  # hidden keys


def test_cpu_tensors_never_launch():
    q, k, v, _ = _inputs(1, 16, 16, 2, 8, False)
    before = dict(fa.launches)
    fa.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 2)
    assert fa.launches == before


def test_cuda_path_raises_without_a_card(monkeypatch):
    """Asking for the kernel without a card raises; nothing falls back."""
    q, k, v, _ = _inputs(1, 16, 16, 2, 8, False)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), 2)
    # the kernels take every head width, some through a zero pad (256 runs
    # padded to 512) and wider ones in the xwide kernels: on a CPU tensor
    # each asks for the card, forward and backward
    x = torch.zeros((1, 16, 640))
    lse = torch.zeros((1, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_backward_cuda(x, x, x, None, x, lse, lse, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(x, x, x, 1)
    for c in (256, 512, 36):
        x = torch.zeros((1, 16, c))
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_backward_cuda(x, x, x, None, x, lse, lse, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
