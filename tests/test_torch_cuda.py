"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where
those are not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are for bf16 outputs, the same as ``chip_smoke.py``'s: about 3x
the largest reading of the sound kernels at the main path's shapes on an
H100, as (relative L2 error, max error / rms(plain)). The relative L2 limit
catches a systematic fault (a wrong scale, a lost bias), the max-error limit
a fault confined to a few rows. Kernel A rounds unnormalized probabilities
to bf16 (readings 3.1e-3, 0.066); kernel B rounds normalized ones, as its
plain version does (readings 6.9e-5, 0.026).
"""

FLASH_TOL = (1e-2, 0.2)
TEMPORAL_TOL = (2e-4, 0.08)
# The backward kernels, per gradient (dq, dk, dv), the same way; both round
# p and ds to bf16 as their plain versions do (readings: kernel A 3.5e-4,
# 0.070; kernel B 5.4e-5, 0.058).
FLASH_BWD_TOL = (1e-3, 0.2)
TEMPORAL_BWD_TOL = (2e-4, 0.2)
# Kernel C and its plain version both compute in fp32 and round once to
# bf16; they differ by summation order and fused multiply-adds (readings
# 4.1e-5, 0.031). Its Function's gradients (F.group_norm's bf16 backward)
# are held against plain autograd in fp32 (readings 3.2e-3, 0.074).
GN_TOL = (1.5e-4, 0.1)
GN_GRAD_TOL = (1e-2, 0.25)
# The probes: kernel 8 and its plain version both accumulate in fp32 and
# round once to bf16, so they differ by summation order only (a bf16 ulp
# here and there); kernel 9 rounds unnormalized probabilities as kernel A
# does and takes kernel A's limits; kernel 10 is exact.
DMAJOR_TOL = (4e-3, 0.05)

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(out, ref, tol):
    ref = ref.float()
    diff = out.float() - ref
    if ref.norm() == 0:  # e.g. dq and dk over a single frame: exactly zero
        assert diff.abs().max().item() == 0
        return
    assert (diff.norm() / ref.norm()).item() <= tol[0]
    assert diff.abs().max().item() <= tol[1] * ref.pow(2).mean().sqrt().item()


def _randn(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d,with_bias", [
    (2, 300, 700, 8, 40, True),    # ragged, CFG bias, SD's d = 40
    (2, 256, 512, 8, 80, False),
    (1, 100, 1000, 2, 16, False),
    (2, 200, 200, 1, 512, False),  # the VAE's wide head, v columns split
    (2, 256, 300, 8, 40, False),   # ragged last key tile at a batch boundary
    (2, 200, 256, 8, 40, False),   # Lq not a multiple of the block's 128 rows
    (1, 128, 256, 8, 40, False),   # every head: 0-6 sit beside a neighbour, 7 at C
    (2, 300, 700, 8, 80, True),    # d = 80, ragged, with the bias
    (2, 200, 300, 1, 512, True),   # d = 512, ragged Lk at a batch boundary, bias
    (1, 100, 200, 2, 512, False),  # d = 512 at a head offset
])
def test_flash_kernel_matches_plain(b, lq, lk, heads, d, with_bias):
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v = (_randn((b, n, heads * d), s, dev) for s, n in enumerate((lq, lk, lk)))
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device=dev)
        bias[0, lk // 2:] = -1e9
    before = fa.launches["d<=128" if d <= 128 else "d>128"]
    out, lse = fa.flash_attention_packed(q, k, v, heads, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, heads, bias)
    torch.cuda.synchronize()
    assert fa.launches["d<=128" if d <= 128 else "d>128"] == before + 1
    # each head on its own: a head that read its neighbour's columns (or
    # past the last column) fails alone
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    again, lse_again = fa.flash_attention_packed(q, k, v, heads, bias)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,l,c,heads", [
    (1, 24, 1000, 320, 8), (2, 24, 96, 1280, 8), (1, 7, 33, 64, 2), (1, 1, 5, 16, 2),
])
def test_temporal_kernel_matches_plain(b, f, l, c, heads):
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v = (_randn((b, f, l, c), s, dev) for s in range(3))
    before = ta.launches["temporal"]
    out = ta.temporal_attention(q, k, v, heads)
    ref = ta.temporal_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal"] == before + 1
    _assert_close(out, ref, TEMPORAL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d,hide", [
    (2, 300, 700, 8, 40, ((0, 350, 700),)),  # ragged, CFG bias on one row, SD's d = 40
    (2, 256, 512, 8, 80, ()),
    (1, 100, 1000, 2, 16, ()),
    (2, 200, 300, 1, 512, ((0, 150, 300),)),  # the VAE's wide head: ragged, bias on one row
    (2, 256, 129, 8, 40, ()),    # Lk 1 past a 128-key tile, at a batch boundary
    (2, 256, 65, 8, 40, ()),     # Lk 1 past a 64-key step, at a batch boundary
    (2, 200, 256, 8, 40, ()),    # Lq not a multiple of the 64-row step or the 128-row block
    (1, 128, 256, 8, 40, ()),    # every head: 0-6 sit beside a neighbour, 7 at C
    (2, 130, 300, 8, 80, ()),    # d = 80: every head, ragged Lq and Lk
    (2, 200, 300, 4, 64, ((0, 150, 300),)),  # d = 64: 32-byte-swizzled boxes and a pad
    (1, 100, 200, 3, 48, ()),    # d = 48, the same
    (1, 100, 200, 3, 72, ()),    # d = 72: 8-column boxes up to 80
    (2, 448, 448, 8, 40, ()),    # Lq = Lk: the ReferenceNet's self-attention
    # whole 128-key tiles hidden on row 0 (the dq kernel passes them over), part of
    # a tile on row 1
    (2, 300, 700, 8, 40, ((0, 128, 512), (1, 100, 200))),
    # every row hides whole tiles up to a ragged end (the stage-2 uncond pattern:
    # the dk/dv blocks there write zeros)
    (2, 300, 700, 8, 40, ((0, 256, 700), (1, 256, 700))),
    (2, 300, 700, 4, 80, ((0, 128, 700),)),
    # d = 512 (64-row blocks, 32-row steps): Lq = Lk at multiples of both
    (2, 128, 128, 1, 512, ()),
    # Lq and Lk 1 past a 64-row block and a 32-row step, at a batch boundary
    (2, 65, 65, 1, 512, ()),
    (2, 97, 33, 1, 512, ()),
    (1, 100, 200, 2, 512, ()),   # d = 512 at a head offset
    # whole 64-key blocks and 32-key steps hidden on one row, part of a block on the other
    (2, 200, 300, 1, 512, ((0, 64, 192), (1, 10, 40))),
    # every row hides whole blocks up to a ragged end
    (2, 200, 300, 1, 512, ((0, 128, 300), (1, 128, 300))),
])
def test_flash_backward_kernels_match_plain(b, lq, lk, heads, d, hide):
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, g = (_randn((b, lq, heads * d), s, dev) for s in (0, 3))
    k, v = (_randn((b, lk, heads * d), s, dev) for s in (1, 2))
    bias = None
    if hide:
        bias = torch.zeros((b, lk), device=dev)
        for row, start, stop in hide:
            bias[row, start:stop] = -1e9
    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
    args = (q, k, v, bias, g, lse, fa.attention_delta(g, out, heads), heads)
    before = dict(fa.launches)
    grads = fa.flash_attention_backward_cuda(*args)
    refs = fa.flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    wide = "_d>128" if d > 128 else ""
    assert fa.launches["bwd_dkv" + wide] == before["bwd_dkv" + wide] + 1
    assert fa.launches["bwd_dq" + wide] == before["bwd_dq" + wide] + 1
    again = fa.flash_attention_backward_cuda(*args)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics
    # each head on its own: a head that read its neighbour's columns (or past
    # the last column) fails alone
    for got, ref in zip(grads, refs):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            _assert_close(got[..., cols], ref[..., cols], FLASH_BWD_TOL)
    for row, start, stop in hide:  # dk, dv of the keys the bias hides: exactly zero
        assert all((t[row, start:stop] == 0).all() for t in grads[1:])
    if hide:
        # a bias of -0.99e9 hides the same keys (p is 0 in fp32 either way) but
        # is above the -1e9 at which whole hidden tiles are passed over: the
        # tiles computed give the same bits as the tiles passed over
        computed = fa.flash_attention_backward_cuda(
            q, k, v, torch.where(bias <= -1e9, -0.99e9, bias), *args[4:])
        assert all(torch.equal(x, y) for x, y in zip(grads, computed))


@pytest.mark.cuda
def test_flash_function_gradient_on_card():
    """Through autograd, with the strided gradient a transpose hands back."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v = (_randn((2, 200, 320), s, dev).requires_grad_() for s in range(3))
    out, _ = fa.flash_attention_packed(q, k, v, 8)
    g = _randn((2, 320, 200), 4, dev).transpose(1, 2)
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref_out, lse = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(), 8)
    refs = fa.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), None, g.contiguous(), lse,
        fa.attention_delta(g, out.detach(), 8), 8)
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, FLASH_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,l,c,heads", [
    (1, 24, 1000, 320, 8), (2, 24, 96, 1280, 8), (1, 7, 33, 64, 2), (1, 1, 5, 16, 2),
])
def test_temporal_backward_kernel_matches_plain(b, f, l, c, heads):
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v, g = (_randn((b, f, l, c), s, dev) for s in range(4))
    before = ta.launches["temporal_bwd"]
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal_bwd"] == before + 1
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, TEMPORAL_BWD_TOL)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    x = torch.zeros((1, 64, 64), device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_packed(x, x, x, 2)           # fp32 on the card
    y = torch.zeros((1, 64, 60), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_packed(y, y, y, 2)           # d = 30, not a multiple of 8
    w = torch.zeros((1, 64, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_packed(w, w, w, 2)           # d = 128: only d <= 80 or 512
    u = torch.zeros((1, 4, 8, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.temporal_attention(u, u, u, 2)               # d = 256 > 160
    z = torch.zeros((1, 4, 8, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.temporal_attention(z.transpose(1, 2), z.transpose(1, 2), z.transpose(1, 2), 2)
    x = torch.zeros((1, 64, 256), device=dev, dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 64), device=dev)
    with pytest.raises(ValueError):                     # d = 256: only d <= 80 or 512
        fa.flash_attention_backward_cuda(x, x, x, None, x, lse, lse, 1)


@pytest.mark.cuda
def test_tiny_pipeline_on_card_goes_through_kernels():
    from humanvid_tpu_torch.data.camera import (
        get_relative_pose, intrinsics_vector, ray_condition, static_camera)
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta
    from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline, tiny_config

    _card()
    F, H, W = 4, 256, 256
    system = CamAnimate(tiny_config(), dtype=torch.bfloat16).init_random(0)
    rng = np.random.default_rng(0)
    cams = static_camera((W, H), F)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    fa.reset_launches()
    ta.reset_launches()
    gn.reset_launches()
    out = Pose2VideoPipeline(system)(
        rng.random((H, W, 3)), rng.random((F, H, W, 3)), plucker, rng.random((28, 28, 3)),
        num_inference_steps=2, cfg_mode="sequential")
    assert out.videos.shape == (1, F, H, W, 3) and np.isfinite(out.videos).all()
    assert fa.launches["d<=128"] > 0 and ta.launches["temporal"] > 0
    assert gn.launches["group_norm"] > 0


def _group_norm_inputs(shape, fmt, affine_dtype, dev):
    x = (_randn(shape, 5, dev).float() * 2 + 0.5).to(torch.bfloat16)
    x = x.contiguous(memory_format=fmt)
    gen = torch.Generator(device=dev).manual_seed(6)
    w = (1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)).to(affine_dtype)
    b = (0.1 * torch.randn(shape[1], generator=gen, device=dev)).to(affine_dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "silu"])
@pytest.mark.parametrize("fmt", [torch.channels_last, torch.contiguous_format],
                         ids=["channels_last", "contiguous"])
@pytest.mark.parametrize("shape,affine_dtype", [
    ((2, 320, 37, 29), torch.bfloat16),   # ragged rows
    ((3, 64, 1, 1), torch.float32),       # H = W = 1: both layouts at once
    ((2, 2560, 12, 8), torch.bfloat16),   # the UNet's widest concatenation
    ((4, 128, 64, 48), torch.float32),
])
def test_group_norm_kernel_matches_plain(shape, affine_dtype, fmt, act):
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    x, w, b = _group_norm_inputs(shape, fmt, affine_dtype, dev)
    before = gn.launches["group_norm"]
    y = gn.group_norm_act(x, w, b, 32, 1e-6, act)
    again = gn.group_norm_act(x, w, b, 32, 1e-6, act)
    ref = gn.group_norm_act_plain(x, w, b, 32, 1e-6, act)
    torch.cuda.synchronize()
    assert gn.launches["group_norm"] == before + 2
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous(memory_format=fmt)
    assert torch.equal(y, again)  # no float atomics: a run repeats bit for bit
    _assert_close(y, ref, GN_TOL)


@pytest.mark.cuda
def test_group_norm_function_gradient_on_card():
    """dx, dgamma and dbeta through the Function (kernel C forward,
    F.group_norm recompute) against plain autograd on fp32 copies."""
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    x, w, b = _group_norm_inputs((4, 320, 37, 29), torch.channels_last, torch.bfloat16, dev)
    g = _randn(x.shape, 7, dev).contiguous(memory_format=torch.channels_last)
    leaves = [t.requires_grad_() for t in (x, w, b)]
    grads = torch.autograd.grad(gn.group_norm_act(*leaves, 32, 1e-5, "silu"), leaves, g)
    plain = [t.detach().float().requires_grad_() for t in leaves]
    refs = torch.autograd.grad(gn.group_norm_act_plain(*plain, 32, 1e-5, "silu"), plain,
                               g.float())
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, GN_GRAD_TOL)


@pytest.mark.cuda
def test_group_norm_rejects_what_it_does_not_take():
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    w = torch.ones(64, device=dev, dtype=torch.bfloat16)
    x = torch.zeros((2, 64, 6, 5), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # neither layout
        gn.group_norm_act(x.transpose(2, 3), w, w, 32, 1e-6)
    with pytest.raises(ValueError):                     # a channel slice: other strides
        gn.group_norm_act(torch.zeros((2, 128, 6, 5), device=dev,
                                      dtype=torch.bfloat16)[:, :64], w, w, 32, 1e-6)
    with pytest.raises(TypeError):                      # fp32 on the card
        gn.group_norm_act(x.float(), w, w, 32, 1e-6)
    v = torch.ones(12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # C % 8 != 0
        gn.group_norm_act(torch.zeros((1, 12, 4, 4), device=dev, dtype=torch.bfloat16),
                          v, v, 4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("arm,d", [
    ("qk_d_on_lanes", 40), ("qk_d_on_sublanes", 40), ("pv_d_on_lanes", 40),
    ("pv_dmajor_out", 40), ("qk_d_on_lanes", 128), ("qk_d_on_sublanes", 128),
])
def test_probe_dmajor_kernel_matches_plain(arm, d):
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    G, lq, lk = 3, 192, 320
    shapes = {"qk_d_on_lanes": ((lq, d), (lk, d)), "qk_d_on_sublanes": ((d, lq), (d, lk)),
              "pv_d_on_lanes": ((lq, lk), (lk, d)), "pv_dmajor_out": ((d, lk), (lq, lk))}[arm]
    a, b = (_randn((G,) + s, i, dev) for i, s in enumerate(shapes))
    before = pk.launches["probe_dmajor"]
    out = pk.dmajor(arm, a, b)
    ref = pk.dmajor_plain(arm, a, b)
    torch.cuda.synchronize()
    assert pk.launches["probe_dmajor"] == before + 1
    assert out.shape == ref.shape
    _assert_close(out, ref, DMAJOR_TOL)
    if arm == "pv_d_on_lanes":
        assert (out[:, :, d:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d,hide", [
    (2, 300, 700, 8, 40, "every7"),  # ragged, every 7th key hidden
    (1, 256, 512, 8, 80, ()),
    (2, 192, 129, 8, 40, ()),   # Lk 1 past a 128-key tile, at a batch boundary
    (2, 200, 256, 8, 40, ()),   # Lq not a multiple of the 192-query block
    (2, 130, 300, 4, 16, ()),   # d = 16 (48-deep pad), every head
    (2, 130, 300, 3, 48, ()),   # d = 48: O^T's rows in two m64 tiles
    (1, 100, 200, 3, 64, ()),   # d = 64: V^T's 64 rows and the ones row
    (2, 130, 300, 8, 80, ()),   # d = 80, every head, ragged Lq and Lk
    # whole 128-key tiles hidden on row 0, part of a tile on row 1
    (2, 300, 700, 8, 40, ((0, 128, 512), (1, 100, 200))),
    # every row hides whole tiles up to a ragged end
    (2, 300, 700, 8, 40, ((0, 256, 700), (1, 256, 700))),
])
def test_probe_pvt_kernel_matches_plain(b, lq, lk, heads, d, hide):
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    q, k, v = (_randn((b, n, heads * d), s, dev) for s, n in enumerate((lq, lk, lk)))
    bias = None
    if hide == "every7":
        bias = torch.where(torch.arange(lk, device=dev) % 7 == 0, -1e9, 0.0)
        bias = bias.expand(b, lk).contiguous()
    elif hide:
        bias = torch.zeros((b, lk), device=dev)
        for row, start, stop in hide:
            bias[row, start:stop] = -1e9
    before = pk.launches["probe_pvt"]
    out, lse = pk.pvt(q, k, v, heads, bias)
    ref, ref_lse = pk.pvt_plain(q, k, v, heads, bias)
    torch.cuda.synchronize()
    assert pk.launches["probe_pvt"] == before + 1
    # each head on its own: a head that read its neighbour's columns (or past
    # the last column) fails alone
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    again, lse_again = pk.pvt(q, k, v, heads, bias)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)  # no atomics


def _dmajor_inputs(arm, G, lq, lk, d, dev):
    shapes = {"qk_d_on_lanes": ((lq, d), (lk, d)), "qk_d_on_sublanes": ((d, lq), (d, lk)),
              "pv_d_on_lanes": ((lq, lk), (lk, d)), "pv_dmajor_out": ((d, lk), (lq, lk))}[arm]
    return (_randn((G,) + s, 10 + i, dev) for i, s in enumerate(shapes))


_ARMS = ("qk_d_on_lanes", "qk_d_on_sublanes", "pv_d_on_lanes", "pv_dmajor_out")


@pytest.mark.cuda
@pytest.mark.parametrize("arm,d,G,lq,lk", [
    # every width a PV tile takes (wgmma's N = d) and every contracted pad of
    # the QK arms, with lk = 320: a ragged last 128-key tile (in the d-major
    # layout a 64-key box past lk) next to the next problem's keys
    *((arm, d, 3, 192, 320) for arm in _ARMS for d in (8, 16, 24, 32, 48)),
    # lq = 64: a single block row, most of a block's rows past lq
    *((arm, 40, 2, 64, 256) for arm in _ARMS),
    ("qk_d_on_lanes", 128, 2, 64, 128),
    ("qk_d_on_sublanes", 128, 2, 64, 192),
    # more blocks than one wave of the card holds
    *((arm, 40, 300, 128, 192) for arm in _ARMS),
])
def test_probe_dmajor_kernel_shapes(arm, d, G, lq, lk):
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    a, b = _dmajor_inputs(arm, G, lq, lk, d, dev)
    before = pk.launches["probe_dmajor"]
    out = pk.dmajor(arm, a, b)
    ref = pk.dmajor_plain(arm, a, b)
    again = pk.dmajor(arm, a, b)
    torch.cuda.synchronize()
    assert pk.launches["probe_dmajor"] == before + 2
    assert out.shape == ref.shape
    _assert_close(out, ref, DMAJOR_TOL)
    if arm == "pv_d_on_lanes":
        assert (out[:, :, d:] == 0).all()
    assert torch.equal(out, again)  # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 29), (8, 64, 128), (5,)])
def test_probe_hbm_kernel_is_exact(shape):
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    x = (_randn(shape, 0, dev).float() * 4).to(torch.bfloat16)
    before = pk.launches["probe_hbm"]
    y = pk.hbm_map(x)
    torch.cuda.synchronize()
    assert pk.launches["probe_hbm"] == before + 1
    assert torch.equal(y, pk.hbm_map_plain(x))
    assert torch.equal(y, torch.add(x, 0.5))  # bf16(1.0001) is exactly 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [
    (1, 0), (7, 0),                  # fewer than one 16-byte vector: the tail alone
    (16384 * 5 + 8 * 37 + 5, 0),     # no multiple of a 32 KB chunk, of the unroll, or of 8
    (8 * 2 ** 20 + 13, 0),           # more vectors than one wave of blocks takes
    (16384 * 5 + 8 * 37 + 5, 8),     # the input 16 bytes into a larger allocation
    (4099, 8),
])
def test_probe_hbm_kernel_ragged_and_offset(n, offset):
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    base = (_randn((n + offset + 64,), 3, dev).float() * 4).to(torch.bfloat16)
    x = base[offset:offset + n]
    assert x.data_ptr() % 16 == 0 and (offset == 0 or x.data_ptr() % 128 != 0)
    before = pk.launches["probe_hbm"]
    y = pk.hbm_map(x)
    again = pk.hbm_map(x)
    torch.cuda.synchronize()
    assert pk.launches["probe_hbm"] == before + 2
    assert torch.equal(y, pk.hbm_map_plain(x))
    assert torch.equal(y, torch.add(x, 0.5))
    assert torch.equal(y, again)


@pytest.mark.cuda
def test_probe_kernels_reject_what_they_do_not_take():
    from humanvid_tpu_torch.tools import probe_kernels as pk

    dev = _card()
    a = torch.zeros((1, 100, 40), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # lq not a multiple of 64
        pk.dmajor("qk_d_on_lanes", a, a)
    w = torch.zeros((1, 64, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # pv arms: d <= 48
        pk.dmajor("pv_d_on_lanes", torch.zeros((1, 64, 64), device=dev,
                                               dtype=torch.bfloat16), w)
    q = torch.zeros((1, 64, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # d = 96 > 80
        pk.pvt(q, q, q, 1)
    with pytest.raises(TypeError):                      # fp32 on the card
        pk.hbm_map(torch.zeros(16, device=dev))
