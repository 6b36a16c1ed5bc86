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
    (2, 300, 700, 5, 64, True),    # 5 heads of 64 (level 0 of 5-head configs), the bias
    (2, 300, 700, 5, 128, True),   # 5 heads of 128: the 128-byte swizzle, the bias
    (2, 130, 129, 5, 128, False),  # d = 128, ragged Lq and Lk 1 past a key tile
    (2, 256, 512, 4, 96, False),   # d = 96: 32-column boxes in the 64-byte swizzle
    (1, 100, 200, 3, 120, True),   # d = 120: 8-column boxes, depth 128
    # the own widths ragged with the bias, and Lq / Lk one past a block and a tile
    (2, 300, 700, 4, 96, True),
    (2, 300, 700, 4, 112, True),   # d = 112: 16-column boxes in the 32-byte swizzle
    (2, 300, 700, 3, 88, True),    # d = 88: 8-column boxes, depth 96
    (2, 300, 700, 3, 104, True),   # d = 104: depth 112
    (2, 193, 129, 5, 64, False),   # 3 consumer warpgroups: 192 rows a block
    (2, 193, 129, 4, 96, False),
    (2, 129, 129, 4, 112, False),
    (2, 300, 700, 5, 36, True),    # d = 36: zero-padded to 40
    (2, 200, 300, 2, 192, True),   # d = 192: the mid kernel
    (1, 100, 200, 3, 260, False),  # d = 260: the mid kernel (depth 320), at a head offset
])
def test_flash_kernel_matches_plain(b, lq, lk, heads, d, with_bias):
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, k, v = (_randn((b, n, heads * d), s, dev) for s, n in enumerate((lq, lk, lk)))
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device=dev)
        bias[0, lk // 2:] = -1e9
    key = fa._width_key(fa.flash_plan(d).width)
    before = fa.launches[key]
    out, lse = fa.flash_attention_packed(q, k, v, heads, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, heads, bias)
    torch.cuda.synchronize()
    assert fa.launches[key] == before + 1
    # each head on its own: a head that read its neighbour's columns (or
    # past the last column) fails alone
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    again, lse_again = fa.flash_attention_packed(q, k, v, heads, bias)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads", [(64, 5), (96, 4), (112, 4), (128, 5), (88, 3), (120, 3)])
def test_flash_own_forward_passes_hidden_tiles_over(d, heads):
    """The forward at the head's own width, on batch rows that hide whole
    128-key tiles (row 0 from key 128 to a ragged end, row 1 its first 256
    keys): it agrees with the plain version, the hidden keys' values add
    exactly nothing, and the tiles it passes over give the same bits as
    computing them (a bias of -0.99e9 hides the same keys but is above the
    -1e9 at which tiles are passed over)."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    b, lq, lk = 2, 200, 700
    q, k, v = (_randn((b, n, heads * d), 20 + s, dev) for s, n in enumerate((lq, lk, lk)))
    bias = torch.zeros((b, lk), device=dev)
    bias[0, 128:] = -1e9
    bias[1, :256] = -1e9
    before = fa.launches["own"]
    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, heads, bias)
    torch.cuda.synchronize()
    assert fa.launches["own"] == before + 1
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    v2 = v.clone()
    v2[0, 128:] = _randn((lk - 128, heads * d), 30, dev)
    v2[1, :256] = _randn((256, heads * d), 31, dev)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v2, heads, bias)[0])
    computed = fa.flash_attention_cuda(q, k, v, heads, torch.where(bias <= -1e9, -0.99e9, bias))
    assert torch.equal(out, computed[0]) and torch.equal(lse, computed[1])


TEMPORAL_WIDE = [
    (1, 24, 100, 1280, 5),   # d = 256 (5 motion heads at levels 2-3): 2 chunks of 128
    (2, 24, 37, 640, 2),     # d = 320: 2 chunks of 160
    (1, 24, 33, 640, 1),     # d = 640: 4 chunks
    (1, 24, 21, 1280, 1),    # d = 1280: 8 chunks
    (2, 1, 50, 1280, 5),     # one frame
    (1, 13, 9, 2640, 10),    # d = 264: 2 chunks of 136, 13 frames (16-row tiles)
    (1, 7, 33, 180, 5),      # d = 36: zero-padded to 40
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,l,c,heads", [
    (1, 24, 1000, 320, 8), (2, 24, 96, 1280, 8), (1, 7, 33, 64, 2), (1, 1, 5, 16, 2),
] + TEMPORAL_WIDE)
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
@pytest.mark.parametrize("b,f,l,c,heads", [
    (2, 24, 96, 320, 8),     # d = 40, 4 heads an item
    (2, 7, 100, 640, 8),     # d = 80, 7 frames
    (1, 24, 33, 1280, 8),    # d = 160, one head an item
    (2, 24, 37, 64, 8),      # d = 8, one chunk of 8 heads
    (1, 5, 9, 48, 3),        # d = 16, 3 heads
    (2, 24, 37, 1280, 5),    # d = 256: 2 chunks, 5 heads, 37 positions (items of 4)
    (3, 7, 10, 1280, 2),     # d = 640: 4 chunks
    (2, 9, 11, 180, 5),      # d = 36: zero-padded
])
def test_temporal_kernel_every_head_and_no_leak_across_samples(b, f, l, c, heads):
    """Every head of the output agrees with the plain version on its own,
    and each sample's output is the kernel's output on that sample alone
    to the bit: no frame of one sample reaches another's, whatever f and l
    (neither a multiple of the item's frames or positions)."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v = (_randn((b, f, l, c), 10 + s, dev) for s in range(3))
    out = ta.temporal_attention_cuda(q, k, v, heads)
    ref = ta.temporal_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    d = c // heads
    for h in range(heads):
        _assert_close(out[..., h * d:(h + 1) * d], ref[..., h * d:(h + 1) * d], TEMPORAL_TOL)
    for i in range(b):
        alone = ta.temporal_attention_cuda(*(t[i:i + 1].contiguous() for t in (q, k, v)), heads)
        assert torch.equal(out[i:i + 1], alone)
    assert torch.equal(out, ta.temporal_attention_cuda(q, k, v, heads))  # repeat: same bits


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
    (2, 300, 700, 5, 64, ((0, 350, 700),)),   # 5 heads of 64, CFG bias on one row
    (2, 300, 700, 5, 128, ((0, 350, 700),)),  # 5 heads of 128: the 128-byte swizzle
    # d = 128, every row hides whole 128-key tiles up to a ragged end
    (2, 300, 700, 4, 128, ((0, 256, 700), (1, 256, 700))),
    (2, 130, 129, 5, 128, ()),   # d = 128, ragged Lq, Lk 1 past a tile
    (2, 200, 300, 4, 96, ()),    # d = 96: 32-column boxes in the 64-byte swizzle
    (1, 100, 200, 3, 120, ((0, 100, 200),)),  # d = 120: 8-column boxes, depth 128
    # the own widths: every row hides whole 128-key tiles up to a ragged end,
    # and Lq / Lk one past a block and a tile
    (2, 300, 700, 5, 64, ((0, 256, 700), (1, 128, 700))),
    (2, 300, 700, 4, 96, ((0, 256, 700), (1, 384, 700))),
    (2, 300, 700, 4, 112, ((0, 256, 700), (1, 128, 700))),
    (2, 300, 700, 3, 88, ((0, 350, 700),)),
    (2, 300, 700, 3, 104, ((1, 128, 700),)),
    (2, 129, 129, 5, 64, ()),
    (2, 129, 129, 4, 96, ()),
    (2, 129, 129, 4, 112, ()),
    (2, 300, 700, 5, 36, ((0, 350, 700),)),   # d = 36, zero-padded to 40
    (2, 200, 300, 2, 192, ((0, 150, 300),)),  # d = 192: the mid backward, merged
    (1, 100, 200, 1, 320, ((0, 100, 200),)),  # d = 320 (long_wide's level 0), the same
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
    width = fa.flash_plan(d).backward_width
    wide = "_" + fa._width_key(width) if width > 128 else ""
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
] + TEMPORAL_WIDE)
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
@pytest.mark.parametrize("b,f,l,c,heads", [
    (2, 24, 37, 64, 8),      # d = 8, one chunk of 8 heads
    (2, 5, 9, 48, 3),        # d = 16, 3 heads, 5 frames
    (2, 24, 96, 320, 8),     # d = 40, 4 heads an item
    (2, 7, 100, 640, 8),     # d = 80, 7 frames
    (2, 24, 33, 1280, 8),    # d = 160, one head an item
    (2, 1, 50, 320, 8),      # one frame
    (2, 1, 19, 1280, 8),
    (2, 16, 23, 320, 8),     # the most frames of one 16-row tile
    (2, 17, 9, 640, 8),      # the fewest of two
    (2, 32, 21, 320, 8),     # the most frames
    (2, 32, 13, 1280, 8),
    (2, 5, 17, 640, 8),
    (2, 7, 11, 1280, 8),
    (2, 24, 37, 1280, 5),    # d = 256: 2 chunks, 37 positions (items of 2)
    (2, 16, 23, 1280, 5),    # d = 256 at 16 frames (16-row tiles)
    (3, 32, 9, 1280, 1),     # d = 1280 at 32 frames: 8 chunks
    (2, 1, 19, 1280, 5),     # one frame
    (2, 9, 11, 180, 5),      # d = 36: zero-padded
])
def test_temporal_backward_every_head_and_sample_alone(b, f, l, c, heads):
    """dq, dk and dv agree with the plain version, every head within the
    max-error limit on its own; each sample's gradients are the kernel's on
    that sample alone to the bit (f and l no multiple of anything the kernel
    tiles by), and a repeat launch gives the same bits. (A head's relative
    L2 error over these few thousand values is set by the one or two bf16
    roundings of p or ds that fall on either side of a rounding boundary
    in the kernel and the plain version: up to 4.2e-4 here, with the first
    design's kernel giving the same bits, so the relative limit holds each
    gradient as a whole.)"""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v, g = (_randn((b, f, l, c), 20 + s, dev) for s in range(4))
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    d = c // heads
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, TEMPORAL_BWD_TOL)
        for h in range(heads):
            head, want = got[..., h * d:(h + 1) * d].float(), ref[..., h * d:(h + 1) * d].float()
            limit = TEMPORAL_BWD_TOL[1] * want.pow(2).mean().sqrt().item()
            assert (head - want).abs().max().item() <= limit
    for i in range(b):
        alone = ta.temporal_attention_backward_cuda(
            *(t[i:i + 1].contiguous() for t in (q, k, v, g)), heads)
        for got, one in zip(grads, alone):
            assert torch.equal(got[i:i + 1], one)
    for got, again in zip(grads, ta.temporal_attention_backward_cuda(q, k, v, g, heads)):
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,c", [(2, 77, 320), (1, 9, 1280), (8, 300, 320), (2, 33, 2048),
                                   (1, 9, 10240)])
def test_temporal_backward_of_one_frame_is_exact(b, l, c):
    """Over one frame p = 1: dq = dk = 0 and dv = g, exactly."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v, g = (_randn((b, 1, l, c), 30 + s, dev) for s in range(4))
    dq, dk, dv = ta.temporal_attention_backward_cuda(q, k, v, g, 8)
    torch.cuda.synchronize()
    assert torch.equal(dq, torch.zeros_like(dq)) and torch.equal(dk, torch.zeros_like(dk))
    assert torch.equal(dv, g)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hot", [(320, 1), (320, 4), (640, 1), (1280, 2), (64, 3), (2048, 3),
                                   (2048, 7), (5120, 1), (288, 2), (2560, 1), (2560, 7)],
                         ids=["d40-head1", "d40-head4-next-chunk", "d80", "d160", "d8",
                              "d256-head3", "d256-last-head", "d640", "d36-padded",
                              "d320-split-head1", "d320-split-last-head"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_temporal_heads_and_positions_isolated_from_an_inf(c, hot, direction):
    """An Inf in one head's q, k, v (and g) columns at some positions
    reaches no other head and no other position: everything else is finite
    and the same bits as the run without it. (At d = 40 the last 16-deep
    step of a head's q k^T reads the next head's first 8 columns, and of the
    chunk's last head the next chunk's.)"""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    b, f, l, heads = 2, 24, 30, 8
    d = c // heads
    clean = [_randn((b, f, l, c), 40 + s, dev) for s in range(4)]
    hot_in = [t.clone() for t in clean]
    for t in hot_in:
        t[:, :, 1::3, hot * d:(hot + 1) * d] = float("inf")
    hit = torch.zeros((b, f, l, c), dtype=torch.bool, device=dev)
    hit[:, :, 1::3, hot * d:(hot + 1) * d] = True
    if direction == "forward":
        outs = [ta.temporal_attention_cuda(*ts[:3], heads) for ts in (clean, hot_in)]
        pairs = [outs]
    else:
        grads = [ta.temporal_attention_backward_cuda(*ts, heads) for ts in (clean, hot_in)]
        pairs = list(zip(*grads))
    torch.cuda.synchronize()
    for want, got in pairs:
        assert torch.isfinite(got[~hit]).all()
        assert torch.equal(got[~hit], want[~hit])


@pytest.mark.cuda
@pytest.mark.parametrize("d,hot", [(40, 1), (40, 7), (80, 1), (80, 7), (64, 1), (128, 1),
                                   (128, 7), (96, 7), (36, 1), (192, 7), (136, 1), (200, 7),
                                   (264, 1), (320, 7), (448, 1), (504, 7), (96, 1), (112, 1),
                                   (112, 7), (64, 7)],
                         ids=["d40-head1", "d40-last-head", "d80-head1", "d80-last-head",
                              "d64-head1", "d128-head1", "d128-last-head", "d96-last-head",
                              "d36-padded", "d192-mid-last-head", "d136-mid-head1",
                              "d200-mid-last-head", "d264-mid-head1", "d320-mid-last-head",
                              "d448-mid-head1", "d504-mid-last-head", "d96-head1", "d112-head1",
                              "d112-last-head", "d64-last-head"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_flash_heads_isolated_from_an_inf(d, hot, with_bias, direction):
    """An Inf in one head's q, k, v (and g) columns at some positions
    reaches no other head: every element outside that head's columns (and
    its lse) is finite and the same bits as the run without it. Kernel A
    packs heads side by side (at d = 40 a head's contracted pad is the next
    head's first columns), so a head that read past its own columns would
    meet the Inf, and 0 x Inf is NaN."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    b, lq, lk, heads = 2, 300, 700, 8
    c = heads * d
    clean = [_randn((b, n, c), 50 + s, dev) for s, n in enumerate((lq, lk, lk, lq))]
    hot_in = [t.clone() for t in clean]
    for t in hot_in:
        t[:, 1::3, hot * d:(hot + 1) * d] = float("inf")
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device=dev)
        bias[0, lk // 2:] = -1e9
    keep = torch.ones(c, dtype=torch.bool, device=dev)
    keep[hot * d:(hot + 1) * d] = False
    others = [h for h in range(heads) if h != hot]
    runs = []
    for q, k, v, g in (clean, hot_in):
        out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
        if direction == "forward":
            runs.append([out[..., keep], lse[:, others]])
        else:
            grads = fa.flash_attention_backward_cuda(
                q, k, v, bias, g, lse, fa.attention_delta(g, out, heads), heads)
            runs.append([t[..., keep] for t in grads])
    torch.cuda.synchronize()
    for want, got in zip(*runs):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_temporal_backward_items_of_other_shared_memory_in_turn():
    """Kernel B's backward at frame counts (item sizes, 16- and 32-row
    tiles, grids) called in turn, the largest again after the smaller."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    for b, f, l, c in ((1, 24, 96, 320), (2, 7, 33, 320), (1, 32, 40, 1280), (1, 1, 40, 640),
                       (1, 24, 96, 320)):
        q, k, v, g = (_randn((b, f, l, c), s, dev) for s in range(4))
        grads = ta.temporal_attention_backward_cuda(q, k, v, g, 8)
        for got, ref in zip(grads, ta.temporal_attention_backward_plain(q, k, v, g, 8)):
            _assert_close(got, ref, TEMPORAL_BWD_TOL)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    x = torch.zeros((1, 64, 64), device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention_packed(x, x, x, 2)           # fp32 on the card
    u = torch.zeros((1, 4, 8, 2816), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 1408"):
        ta.temporal_attention(u, u, u, 2)               # d = 1408 > 1280
    z = torch.zeros((1, 4, 8, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.temporal_attention(z.transpose(1, 2), z.transpose(1, 2), z.transpose(1, 2), 2)
    x = torch.zeros((1, 64, 640), device=dev, dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 64), device=dev)
    with pytest.raises(ValueError, match="lse must be contiguous fp32"):
        fa.flash_attention_backward_cuda(x, x, x, None, x, lse[..., :32], lse, 1)


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
@pytest.mark.parametrize("shape,one_pass,rereads", [
    ((2, 320, 96, 64), True, True),      # UNet level 0: 160-channel slabs, re-read from L2
    ((2, 960, 96, 64), True, True),      # the up-block concatenation: 30-wide groups
    ((2, 960, 112, 64), True, True),     # the same at the stage-2 level 0
    ((3, 1280, 24, 16), True, False),    # level 2: every row held
    ((2, 2560, 12, 8), True, False),     # level 3: one block a cluster
    ((2, 512, 96, 64), True, True),      # the decode's 96x64
    ((2, 512, 192, 128), False, False),  # the decode's 192x128: two passes
    ((1, 128, 384, 256), False, False),  # and 384x256 at 128 channels
])
def test_group_norm_size_rule_both_sides(shape, one_pass, rereads):
    """Both sides of the size rule, on the card: the one-pass cluster
    kernel where the rule finds a plan (with and without rows re-read from
    L2), the two-pass kernels where it does not; each agrees with the plain
    version and repeats its bits."""
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    plan = gn.cluster_plan(shape[1], shape[2] * shape[3], 32)
    assert (plan is not None) == one_pass
    assert (plan is not None and plan.resident < plan.rows) == rereads
    x, w, b = _group_norm_inputs(shape, torch.channels_last, torch.bfloat16, dev)
    for act in (None, "silu"):
        y = gn.group_norm_act_cuda(x, w, b, 32, 1e-5, act)
        again = gn.group_norm_act_cuda(x, w, b, 32, 1e-5, act)
        ref = gn.group_norm_act_plain(x, w, b, 32, 1e-5, act)
        torch.cuda.synchronize()
        assert torch.equal(y, again)
        assert y.is_contiguous(memory_format=torch.channels_last)
        _assert_close(y, ref, GN_TOL)


@pytest.mark.cuda
def test_group_norm_plans_of_other_shared_memory_in_turn():
    """The launch keeps each plan's attributes and occupancy after its
    first call: plans of larger and smaller shared memory called in turn,
    the larger first and again after the smaller, still launch and agree."""
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    shapes = [(2, 320, 112, 64), (2, 320, 37, 29), (2, 2560, 12, 8), (2, 320, 112, 64),
              (2, 1920, 24, 16), (2, 320, 37, 29)]
    assert len({gn.cluster_plan(s[1], s[2] * s[3], 32) for s in shapes}) == 4
    for shape in shapes:
        x, w, b = _group_norm_inputs(shape, torch.channels_last, torch.bfloat16, dev)
        y = gn.group_norm_act_cuda(x, w, b, 32, 1e-5, "silu")
        _assert_close(y, gn.group_norm_act_plain(x, w, b, 32, 1e-5, "silu"), GN_TOL)


@pytest.mark.cuda
def test_temporal_items_of_other_shared_memory_in_turn():
    """The same for kernel B's forward: frame counts (and so item sizes
    and grids) called in turn, the largest again after the smaller."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    for b, f, l, c in ((1, 24, 96, 320), (2, 7, 33, 320), (1, 24, 96, 1280), (1, 1, 40, 640),
                       (1, 24, 96, 320)):
        q, k, v = (_randn((b, f, l, c), s, dev) for s in range(3))
        out = ta.temporal_attention_cuda(q, k, v, 8)
        _assert_close(out, ta.temporal_attention_plain(q, k, v, 8), TEMPORAL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 320, 96, 64), (2, 512, 192, 128)],
                         ids=["one_pass", "two_pass"])
def test_group_norm_keeps_digits_when_mean_dwarfs_std_on_card(shape):
    """x = 8 + 0.1 * noise in bf16: both kernels hold a float64 GroupNorm
    of the same bf16 input, rounded once to bf16 as they round, to the
    usual limits (a one-pass E[x^2] - mean^2 in fp32 would lose the
    variance's digits here)."""
    from humanvid_tpu_torch.ops import group_norm as gn

    dev = _card()
    x = (8 + 0.1 * _randn(shape, 8, dev).float()).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.ones(shape[1], device=dev, dtype=torch.bfloat16)
    b = torch.zeros(shape[1], device=dev, dtype=torch.bfloat16)
    y = gn.group_norm_act_cuda(x, w, b, 32, 1e-6, "silu")
    ref = torch.nn.functional.silu(torch.nn.functional.group_norm(
        x.double(), 32, w.double(), b.double(), 1e-6)).to(torch.bfloat16)
    torch.cuda.synchronize()
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


@pytest.mark.cuda
def test_loader_uploads_through_pinned_memory_to_the_card():
    from humanvid_tpu_torch.data.loader import Loader, to_device

    dev = _card()
    rng = np.random.default_rng(0)
    samples = [{"tgt": rng.normal(size=(4, 32, 16, 3)).astype(np.float32),
                "clip": rng.normal(size=(28, 28, 3)).astype(np.float32)} for _ in range(6)]
    batches = [[0, 1], [2, 3], [4, 5]]
    got = list(Loader(samples, batches, num_workers=2, device=dev))
    assert len(got) == 3
    for batch, idx in zip(got, batches):
        for k, v in batch.items():
            assert v.device.type == "cuda" and v.dtype == torch.float32
            want = np.stack([samples[i][k] for i in idx])
            assert torch.equal(v.cpu(), torch.from_numpy(want))
    # the host side of the upload is pinned, so the copy need not stall the host
    pinned = []
    real = torch.Tensor.pin_memory

    def record(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        pinned.append(out.is_pinned())
        return out

    torch.Tensor.pin_memory = record
    try:
        out = to_device(samples[0], dev)
    finally:
        torch.Tensor.pin_memory = real
    torch.cuda.synchronize()
    assert pinned == [True, True] and all(v.is_cuda for v in out.values())


@pytest.mark.cuda
def test_tiny_training_driver_steps_on_the_card(tmp_path):
    """Two stage-2 steps of the tiny config through the driver on the card
    (bf16, kernels), the frames served from memory (no OpenCV needed)."""
    import json

    from humanvid_tpu_torch.cli import train_stage_1 as drv
    from humanvid_tpu_torch.data import datasets
    from humanvid_tpu_torch.ops import temporal_attention as ta

    _card()
    root = tmp_path / "pexels"
    (root / "camera").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = {str(root / "videos" / "a.mp4"): rng.integers(0, 256, (12, 96, 64, 3), np.uint8),
              str(root / "dwpose" / "a.mp4"): rng.integers(0, 256, (12, 96, 64, 3), np.uint8)}
    (root / "camera" / "a.txt").write_text("".join(
        f"{i} {0.01 * i} 0 0 0 0 0 1 1.0 1.788 1.0\n" for i in range(12)))
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps([{"video_path": str(root / "videos" / "a.mp4"),
                                 "kps_path": str(root / "dwpose" / "a.mp4"),
                                 "start_frame": 0, "end_frame": 12}]))
    cfg = {"model": "tiny", "n_sample_frames": 4, "seed": 0, "checkpointing_steps": 1,
           "exp_name": "tiny", "output_dir": str(tmp_path / "out"),
           "data": {"train_bs": 1, "train_size_small": 64, "train_size_large": 96,
                    "horizontal_meta": [], "vertical_meta": [str(meta)], "sample_rate": 3,
                    "n_sample_frames": 4, "num_workers": 2},
           "solver": {"enable_gradient_checkpointing": True, "max_train_steps": 2,
                      "max_grad_norm": 1.0, "learning_rate": 1e-5, "lr_warmup_steps": 1,
                      "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_weight_decay": 1e-2,
                      "adam_epsilon": 1e-8}}
    path = tmp_path / "tiny.py"
    path.write_text(f"cfg = {cfg!r}\n")
    real = datasets.read_frames
    datasets.read_frames = lambda p, indices=None, max_frames=None: frames[p][list(indices)]
    try:
        ta.reset_launches()
        out = drv.run_training(2, ["--config", str(path)])
    finally:
        datasets.read_frames = real
    torch.cuda.synchronize()
    assert ta.launches["temporal"] > 0 and ta.launches["temporal_bwd"] > 0
    assert len(out["step_seconds"]) == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in out["logged"])
    files = set(p.name for p in (tmp_path / "out" / "tiny").iterdir())
    assert {"motion_module-1.pt", "motion_module-2.pt", "opt_state-2.pt"} <= files


def _tiny_stage2_spec(**kw):
    from humanvid_tpu_torch.pipelines import tiny_config
    from humanvid_tpu_torch.train import OptimizerConfig, TrainConfig, sample_draws, stage_config

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    b, f, h, w = 2, 4, 64, 64

    def batch():
        return {"tgt": rng.normal(size=(b, f, h, w, 3)).astype(np.float32) * 0.5,
                "ref": rng.normal(size=(b, h, w, 3)).astype(np.float32) * 0.5,
                "clip": rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
                "pose": rng.random((b, f, h, w, 3)).astype(np.float32),
                "plucker": rng.normal(size=(b, f, h, w, 6)).astype(np.float32)}

    spec = dict(config=stage_config(2, tiny_config(), gradient_checkpointing=True), seed=0,
                dtype=torch.bfloat16, device="cuda", backend="gloo", mesh="flat",
                train=TrainConfig(), optimizer=OptimizerConfig(warmup_steps=1),
                batches=[batch(), batch()],
                draws=[sample_draws(gen, b, f, h, w, 1000, 0.5) for _ in range(2)])
    spec.update(kw)
    return spec


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card_with_zero1():
    """Two ranks of the tiny stage-2 step on one card (gloo: the collectives
    go through host memory), ZeRO-1 on every leaf: both ranks hold the same
    masters bit for bit after each update, and the loss is finite."""
    from humanvid_tpu_torch.parallel.launch import launch
    from humanvid_tpu_torch.tools.dryrun_multichip import train_worker

    _card()
    out = launch(train_worker, 2, args=(_tiny_stage2_spec(zero1=True, min_size=1),),
                 timeout_s=300, join_timeout_s=600, threads=None)
    assert out[0]["sharded"] and len(out[0]["masters"]) == 2
    assert all(np.isfinite(x) for x in out[0]["loss"]) and out[0]["loss"] == out[1]["loss"]
    for u in range(2):
        for name, m in out[0]["masters"][u].items():
            assert torch.equal(out[1]["masters"][u][name], m), (u, name)


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card():
    from humanvid_tpu_torch.parallel.launch import launch
    from humanvid_tpu_torch.tools.dryrun_multichip import train_worker

    _card()
    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks fit on two cards")
    with pytest.raises(Exception, match="Duplicate GPU detected"):
        launch(train_worker, 2, args=(_tiny_stage2_spec(backend="nccl"),), backend="nccl",
               timeout_s=120, join_timeout_s=300, threads=None)


@pytest.mark.cuda
def test_fanout_on_two_gloo_ranks_sharing_the_card():
    """The tiny pipeline's window x CFG rows over two ranks on one card:
    the same latents on both ranks, bit for bit; rank 0 alone decodes."""
    from humanvid_tpu_torch.parallel.launch import launch
    from humanvid_tpu_torch.pipelines import tiny_config
    from humanvid_tpu_torch.tools.dryrun_multichip import fanout_worker

    _card()
    rng = np.random.default_rng(0)
    f, h, w = 12, 64, 64
    inputs = (rng.random((h, w, 3), dtype=np.float32), rng.random((f, h, w, 3), dtype=np.float32),
              rng.normal(size=(f, h, w, 6)).astype(np.float32),
              rng.random((28, 28, 3), dtype=np.float32))
    spec = dict(config=tiny_config(motion_max_len=8), seed=0, dtype=torch.bfloat16,
                device="cuda", backend="gloo", inputs=inputs,
                kwargs=dict(num_inference_steps=2, context_frames=8, context_overlap=4,
                            init_latents=rng.normal(size=(f, h // 8, w // 8, 4))))
    out = launch(fanout_worker, 2, args=(spec,), timeout_s=300, join_timeout_s=600,
                 threads=None)
    np.testing.assert_array_equal(out[0]["latents"], out[1]["latents"])
    assert np.isfinite(out[0]["latents"]).all() and out[1]["videos"] is None
    assert out[0]["videos"].shape == (1, f, h, w, 3) and np.isfinite(out[0]["videos"]).all()


@pytest.mark.cuda
def test_bench_configs_c1_on_the_card(capsys):
    import json

    from humanvid_tpu_torch.tools import bench_configs

    _card()
    assert bench_configs.main(["c1", "--steps", "2", "--runs", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "pose2img_images_per_sec_256x256_ddim20_cfg"
    assert rec["ddim_steps"] == 2 and np.isfinite(rec["value"]) and rec["value"] > 0


TEMPORAL_LONG = [
    (1, 33, 40, 320, 8),     # one frame past the item kernels, d = 40
    (1, 48, 100, 640, 8),    # the long path's 48 frames, d = 80 (two 64-column pieces)
    (2, 64, 30, 1280, 8),    # 64 frames, d = 160 (three pieces)
    (1, 96, 20, 1280, 5),    # 96 frames, d = 256
    (1, 40, 16, 1280, 1),    # d = 1280: twenty pieces
    (2, 37, 11, 180, 5),     # d = 36: zero-padded to 40, frames no multiple of 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,l,c,heads", TEMPORAL_LONG)
def test_temporal_long_kernels_match_plain(b, f, l, c, heads):
    """Past 32 frames: the long kernels, forward and backward, every head on
    its own, each sample alone the same bits, a repeat the same bits."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    q, k, v, g = (_randn((b, f, l, c), 20 + s, dev) for s in range(4))
    before = dict(ta.launches)
    out = ta.temporal_attention_cuda(q, k, v, heads)
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    ref = ta.temporal_attention_plain(q, k, v, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal_long"] == before["temporal_long"] + 1
    assert ta.launches["temporal_bwd_frames"] == before["temporal_bwd_frames"] + 1
    assert ta.launches["temporal"] == before["temporal"]
    d = c // heads
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], TEMPORAL_TOL)
    for got, want in zip(grads, refs):
        _assert_close(got, want, TEMPORAL_BWD_TOL)
    for i in range(b):
        alone = ta.temporal_attention_cuda(*(t[i:i + 1].contiguous() for t in (q, k, v)), heads)
        assert torch.equal(out[i:i + 1], alone)
    assert torch.equal(out, ta.temporal_attention_cuda(q, k, v, heads))
    again = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d,hide", [
    (2, 300, 700, 1, 640, ((0, 350, 700),)),   # one spatial head at UNet level 1, CFG bias
    (2, 200, 300, 2, 520, ()),                  # two heads: the second at a head offset
    (1, 130, 257, 1, 1280, ((0, 128, 257),)),   # five slabs, Lk 1 past a key tile
    (1, 100, 200, 3, 600, ()),                  # three heads of 600
    (2, 65, 65, 1, 1000, ((0, 64, 65), (1, 10, 40))),  # Lq and Lk 1 past a tile
    (2, 100, 200, 1, 516, ()),                  # d = 516: zero-padded to 520
    (1, 130, 200, 1, 2056, ((0, 64, 128),)),    # past one cluster: 2 groups of 5 blocks
    (2, 200, 300, 1, 640, ((0, 64, 128),)),     # key tile 1 hidden on row 0, seen on row 1
    (2, 150, 260, 1, 640, ((0, 0, 64), (1, 0, 130))),  # the first tile(s) of a row hidden
    (2, 100, 200, 1, 640, ((1, 0, 200),)),      # row 1 sees no key: every tile computed
    (2, 200, 300, 3, 520, ((0, 0, 64),)),       # 3 heads of 520: last slices of 8 columns
    (1, 100, 260, 2, 600, ((0, 192, 260),)),    # 2 heads of 600: last slices of 88 columns
])
def test_flash_xwide_kernels_match_plain(b, lq, lk, heads, d, hide):
    """Past 512 columns: the xwide kernels, forward and backward, every head
    on its own; keys hidden in a batch row that sees some key get exactly
    zero dk and dv (in a row that sees none the plain version's p is
    uniform); a repeat the same bits."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    q, g = (_randn((b, lq, heads * d), s, dev) for s in (0, 3))
    k, v = (_randn((b, lk, heads * d), s, dev) for s in (1, 2))
    bias = None
    if hide:
        bias = torch.zeros((b, lk), device=dev)
        for row, start, stop in hide:
            bias[row, start:stop] = -1e9
    before = dict(fa.launches)
    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
    args = (q, k, v, bias, g, lse, fa.attention_delta(g, out, heads), heads)
    grads = fa.flash_attention_backward_cuda(*args)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, heads, bias)
    refs = fa.flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    for key in ("d>512", "bwd_dkv_d>512", "bwd_dq_d>512"):
        assert fa.launches[key] == before[key] + 1
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
        for got, want in zip(grads, refs):
            _assert_close(got[..., cols], want[..., cols], FLASH_BWD_TOL)
    for row, start, stop in hide:
        if bool((bias[row] > -1e9).any()):
            assert all((t[row, start:stop] == 0).all() for t in grads[1:])
    again, lse_again = fa.flash_attention_cuda(q, k, v, heads, bias)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    assert all(torch.equal(x, y) for x, y in zip(grads, fa.flash_attention_backward_cuda(*args)))


MID_WIDTHS = [136, 192, 200, 256, 264, 320, 448, 504]


@pytest.mark.cuda
@pytest.mark.parametrize("d", MID_WIDTHS)
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_flash_mid_forward_matches_plain(d, with_bias):
    """Between 128 and 512 columns: the mid forward at the head's own width
    (no launch through the pad), ragged Lq and Lk, two heads side by side,
    every head on its own against the plain version; with the bias, the
    keys it hides add exactly nothing (other values of v there give the
    same bits) and whole hidden key tiles passed over give the bits of the
    same tiles computed (a bias of -0.99e9 hides them all the same); a
    repeat the same bits."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    b, lq, lk, heads = 2, 300, 700, 2
    q, k, v = (_randn((b, n, heads * d), 60 + s, dev) for s, n in enumerate((lq, lk, lk)))
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device=dev)
        bias[0, 128:512] = -1e9  # whole 64- and 32-key tiles of row 0
        bias[1, 650:] = -1e9
    before = dict(fa.launches)
    pad_before = dict(fa.forward_pad_launches_by_d)
    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, heads, bias)
    torch.cuda.synchronize()
    assert fa.launches["128<d<512"] == before["128<d<512"] + 1
    assert fa.launches["d>128"] == before["d>128"] and fa.forward_pad_launches_by_d == pad_before
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], FLASH_TOL)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    again, lse_again = fa.flash_attention_cuda(q, k, v, heads, bias)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    if with_bias:
        v2 = torch.where((bias <= -1e9)[..., None], _randn(v.shape, 70, dev), v)
        assert torch.equal(out, fa.flash_attention_cuda(q, k, v2, heads, bias)[0])
        computed = fa.flash_attention_cuda(q, k, v, heads,
                                           torch.where(bias <= -1e9, -0.99e9, bias))
        assert torch.equal(out, computed[0]) and torch.equal(lse, computed[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", MID_WIDTHS)
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_flash_mid_backward_matches_plain(d, with_bias):
    """Between 128 and 512 columns: the mid backward at the head's own width
    (its own launch keys, none through the pad), ragged Lq and Lk, two
    heads side by side, every head and gradient on its own against the
    plain version; with the bias, the keys it hides get exactly zero dk and
    dv, whole hidden key blocks and steps passed over give the bits of the
    same computed (a bias of -0.99e9), and a batch row that sees no key
    (every step computed there) holds to the plain version too; a repeat
    the same bits."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    dev = _card()
    b, lq, lk, heads = 3, 300, 700, 2
    q, g = (_randn((b, lq, heads * d), 90 + s, dev) for s in (0, 3))
    k, v = (_randn((b, lk, heads * d), 90 + s, dev) for s in (1, 2))
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk), device=dev)
        bias[0, 128:512] = -1e9  # whole 64-key blocks and 32-key steps of row 0
        bias[1, 32:64] = -1e9    # one 32-key step: the steps around it computed in turn
        bias[1, 650:] = -1e9     # part of the last block
        bias[2] = -1e9           # row 2 sees no key
    out, lse = fa.flash_attention_cuda(q, k, v, heads, bias)
    args = (q, k, v, bias, g, lse, fa.attention_delta(g, out, heads), heads)
    before = dict(fa.launches)
    pad_before = dict(fa.backward_pad_launches_by_d)
    grads = fa.flash_attention_backward_cuda(*args)
    refs = fa.flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    for key in ("bwd_dkv_128<d<512", "bwd_dq_128<d<512"):
        assert fa.launches[key] == before[key] + 1
    for key in ("bwd_dkv_d>128", "bwd_dq_d>128"):
        assert fa.launches[key] == before[key]
    assert fa.backward_pad_launches_by_d == pad_before
    for got, ref in zip(grads, refs):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            _assert_close(got[..., cols], ref[..., cols], FLASH_BWD_TOL)
    again = fa.flash_attention_backward_cuda(*args)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics
    if with_bias:
        for row, keys in ((0, slice(128, 512)), (1, slice(32, 64)), (1, slice(650, None))):
            assert all((t[row, keys] == 0).all() for t in grads[1:])
        # (row 2, which sees no key, keeps its bias: nothing is passed over there)
        sees = (bias > -1e9).any(-1, keepdim=True)
        computed = fa.flash_attention_backward_cuda(
            q, k, v, torch.where((bias <= -1e9) & sees, -0.99e9, bias), *args[4:])
        assert all(torch.equal(x, y) for x, y in zip(grads, computed))


# the split kernels (heads wider than 160 columns, up to 32 frames): d =
# 256, 264 (two uneven slices), 320, 480 (4 slices of 120), 640 and 1280, at
# f = 1, 13, 16 (16-row tiles; the backward's item kept), 24 and 32, at a
# ragged L (not a multiple of the positions an item)
SPLIT = [(f, c, heads) for f in (1, 13, 16, 24, 32)
         for c, heads in ((1280, 5), (2640, 10), (1280, 4), (960, 2), (1280, 2), (1280, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("f,c,heads", SPLIT, ids=[f"f{f}-d{c // h}" for f, c, h in SPLIT])
def test_temporal_split_kernels_match_plain(f, c, heads):
    """Kernel B's split forward and backward: the output every head
    against the plain version on its own, each gradient as a whole and
    every head within the max-error limit, each sample alone the same
    bits, a repeat the same bits (no atomics), the launch keys, and at one
    frame the output v and the gradients dq = dk = 0, dv = g exactly.

    A gradient's head is held by its largest error, not its relative L2,
    as in test_temporal_backward_every_head_and_sample_alone: a head's
    relative L2 moves by about 2e-4 when one large element of ds rounds to
    the other side of a bf16 boundary. At f 13 and d 264 (slices of 72,
    72, 72 and 48 columns) one head's dq and dk read 2.1e-4 and 2.8e-4
    against the plain version on the card and the same against it on the
    CPU, the two plain versions 6e-5 and 4e-5 apart
    (``tools/temporal_heads.py`` prints these readings)."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    b, l = 2, 11
    d = c // heads
    q, k, v, g = (_randn((b, f, l, c), 140 + s, dev) for s in range(4))
    before = dict(ta.launches)
    out = ta.temporal_attention_cuda(q, k, v, heads)
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    ref = ta.temporal_attention_plain(q, k, v, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal"] == before["temporal"] + 1
    assert ta.launches["temporal_bwd"] == before["temporal_bwd"] + 1
    for got, want in zip(grads, refs):
        _assert_close(got, want, TEMPORAL_BWD_TOL)
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], TEMPORAL_TOL)
        for got, want in zip(grads, refs):
            head, want = got[..., cols].float(), want[..., cols].float()
            limit = TEMPORAL_BWD_TOL[1] * want.pow(2).mean().sqrt().item()
            assert (head - want).abs().max().item() <= limit
    assert torch.equal(out, ta.temporal_attention_cuda(q, k, v, heads))
    again = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    for i in range(b):
        one = [t[i:i + 1].contiguous() for t in (q, k, v, g)]
        assert torch.equal(out[i:i + 1], ta.temporal_attention_cuda(*one[:3], heads))
        alone = ta.temporal_attention_backward_cuda(*one, heads)
        assert all(torch.equal(x[i:i + 1], y) for x, y in zip(grads, alone))
    if f == 1:
        assert torch.equal(out, v)
        assert not grads[0].any() and not grads[1].any() and torch.equal(grads[2], g)


# the long kernels' redesign: d = 8, 40, 160, 256 and 1280 (resident items
# up to 160 columns where they fit the ring, streamed panels past that)
LONG_PAST = [(f, c, heads) for f in (33, 48, 100, 136, 200, 256)
             for c, heads in ((32, 4), (320, 8), (640, 4), (1280, 5), (1280, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("f,c,heads", LONG_PAST,
                         ids=[f"f{f}-d{c // h}" for f, c, h in LONG_PAST])
def test_temporal_long_redesign_matches_plain(f, c, heads):
    """Kernel B's long forward past 32 frames and its long backward past
    the frames kernel's reach, at a ragged L: every head against the plain
    version on its own, each sample alone the same bits, a repeat the same
    bits (no atomics), the launch keys, and for the backward an Inf in one
    head's columns at some positions reaching no other head or position
    (the backward's gradients held head by head, as the forward)."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    b, l = 2, 7
    d = c // heads
    q, k, v, g = (_randn((b, f, l, c), 120 + s, dev) for s in range(4))
    before = dict(ta.launches)
    out = ta.temporal_attention_cuda(q, k, v, heads)
    ref = ta.temporal_attention_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal_long"] == before["temporal_long"] + 1
    assert ta.launches["temporal"] == before["temporal"]
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        _assert_close(out[..., cols], ref[..., cols], TEMPORAL_TOL)
    assert torch.equal(out, ta.temporal_attention_cuda(q, k, v, heads))
    for i in range(b):
        alone = ta.temporal_attention_cuda(*(t[i:i + 1].contiguous() for t in (q, k, v)), heads)
        assert torch.equal(out[i:i + 1], alone)
    if f <= ta.FRAMES_KERNEL_FRAMES:
        return
    before = dict(ta.launches)
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert ta.launches["temporal_bwd_long"] == before["temporal_bwd_long"] + 1
    assert ta.launches["temporal_bwd_frames"] == before["temporal_bwd_frames"]
    for got, want in zip(grads, refs):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            _assert_close(got[..., cols], want[..., cols], TEMPORAL_BWD_TOL)
    again = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics
    for i in range(b):
        alone = ta.temporal_attention_backward_cuda(
            *(t[i:i + 1].contiguous() for t in (q, k, v, g)), heads)
        assert all(torch.equal(x[i:i + 1], y) for x, y in zip(grads, alone))
    hot = heads // 2
    hot_in = [t.clone() for t in (q, k, v, g)]
    for t in hot_in:
        t[:, :, 1::3, hot * d:(hot + 1) * d] = float("inf")
    hit = torch.zeros((b, f, l, c), dtype=torch.bool, device=dev)
    hit[:, :, 1::3, hot * d:(hot + 1) * d] = True
    for want, got in zip(grads, ta.temporal_attention_backward_cuda(*hot_in, heads)):
        assert torch.isfinite(got[~hit]).all()
        assert torch.equal(got[~hit], want[~hit])


FRAMES_LONG = [(f, c, heads) for f in (33, 48, 64, 96, 97, 100, 112, 128, 129)
               for c, heads in ((320, 8), (640, 8), (1280, 8), (1280, 5), (1280, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("f,c,heads", FRAMES_LONG,
                         ids=[f"f{f}-d{c // h}" for f, c, h in FRAMES_LONG])
def test_temporal_frames_backward_matches_plain(f, c, heads):
    """Kernel B's backward past 32 frames at d = 40, 80, 160, 256 and 1280
    (the frames kernel up to 128 frames, the long kernel at 129): dq, dk and
    dv against the plain version, every head within the max-error limit on
    its own; each sample alone the same bits; a repeat the same bits; an
    Inf in one head's columns at some positions reaches no other head or
    position."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    dev = _card()
    b, l = 2, 11
    d = c // heads
    q, k, v, g = (_randn((b, f, l, c), 80 + s, dev) for s in range(4))
    before = dict(ta.launches)
    grads = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    refs = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    long = f > ta.FRAMES_KERNEL_FRAMES  # the long kernel
    assert ta.launches["temporal_bwd_long"] == before["temporal_bwd_long"] + long
    assert ta.launches["temporal_bwd_frames"] == before["temporal_bwd_frames"] + (not long)
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, TEMPORAL_BWD_TOL)
        for h in range(heads):
            head, want = got[..., h * d:(h + 1) * d].float(), ref[..., h * d:(h + 1) * d].float()
            assert (head - want).abs().max().item() <= \
                TEMPORAL_BWD_TOL[1] * want.pow(2).mean().sqrt().item()
    for i in range(b):
        alone = ta.temporal_attention_backward_cuda(
            *(t[i:i + 1].contiguous() for t in (q, k, v, g)), heads)
        assert all(torch.equal(x[i:i + 1], y) for x, y in zip(grads, alone))
    again = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))  # no atomics
    hot = heads // 2
    hot_in = [t.clone() for t in (q, k, v, g)]
    for t in hot_in:
        t[:, :, 1::3, hot * d:(hot + 1) * d] = float("inf")
    hit = torch.zeros((b, f, l, c), dtype=torch.bool, device=dev)
    hit[:, :, 1::3, hot * d:(hot + 1) * d] = True
    for want, got in zip(grads, ta.temporal_attention_backward_cuda(*hot_in, heads)):
        assert torch.isfinite(got[~hit]).all()
        assert torch.equal(got[~hit], want[~hit])
