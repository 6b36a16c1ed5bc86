"""The last shapes the attention kernels take, on the CPU: kernel B past 32
frames and kernel A past 512 columns, against the JAX package.

- The motion module without a position table (``use_pe=False``) takes more
  frames than ``max_len``, as the JAX block does; with the table it still
  raises there (the JAX block fails to broadcast). fp32, atol 1e-5.
- Kernel B's autograd Function (on CPU tensors: the plain versions) at
  f = 33, 48, 64, 100, 128, 136 and 200, forward and gradients, against the
  JAX Pallas kernel and its vjp in TPU interpret mode. atol 1e-5: both
  sides compute in fp32 and differ by summation order only (observed near
  1e-6).
- Kernel A's ``flash_attention_packed`` at d = 520 and 640, and between
  128 and 512 at d = 192 and 320 (the mid kernels' two widths on the
  long_wide and heads64 paths) and 256 and 448 (the mid backward's other
  layouts), forward and gradients, with and without
  the bias, against the JAX kernel and its vjp in interpret mode, at the
  tolerances of ``test_torch_flash_attention.py`` (2e-4 forward, 5e-4
  gradients; observed near 1e-6).
- The plans: d > 512 and f > 32 get the new kernels' plans, every d <= 128
  and f <= 32 the plan it had, 128 < d < 512 the mid forward and backward
  at the head's width (to 8), the backward's shared memory reckoned as
  ``csrc/flash_attention_mid_bwd.cu`` lays it out. Past 512 the
  xwide kernels' cluster plan (``xwide_plan``) at every width from 520 to
  4104: slices that are multiples of 16 and cover the head, clusters of at
  most 8 blocks, and shared memory, reckoned as the kernels lay it out,
  that a block can use; its constants are those of ``csrc/xwide.cuh``.
  Kernel B's backward past 32 frames (``long_backward_plan``): the frames
  kernel's items up to 128 frames at every width to 1280 (whole heads of
  at most 160 columns where two stages fit, else one head in chunks), the
  long kernel past 128 frames; shared memory reckoned as
  ``csrc/temporal_attention_bwd.cu`` lays it out, its constants read from
  that source. The long kernels' plans (``long_fwd_plan`` past 32 frames,
  ``long_bwd_plan`` past 128): at every d that is a multiple of 8 up to
  1280 and f up to 1024, resident items of whole heads or one head
  streamed in panels and chunks, within a block's shared memory as both
  sources reckon it; the boundaries at 32/33 and 128/129.
- The slice: the tiny config with one spatial head and a 40-frame motion
  and camera table, pose2vid over 40 frames in one window (2 DDIM steps,
  batched CFG) and one stage-2 loss and its gradients, through the port and
  through the JAX package from the same weights (``from_jax_params``). The
  tolerances of ``test_torch_pose2vid.py`` (1e-3 on latents and videos) and
  ``test_torch_train.py`` (loss 1e-5 relative, each gradient 1e-4 of its
  leaf's largest entry). At tiny sizes Lq stays under 1024, so the width is
  covered by the kernel A cases above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_helpers  # noqa: F401  (caps torch threads)
from test_torch_helpers import init_like, jax_system_params, nchw, nhwc, sub_state_dict
from humanvid_tpu.models import layers as jl
from humanvid_tpu.ops.common import NEG_INF
from humanvid_tpu.ops.flash_attention import flash_attention_packed as jax_flash
from humanvid_tpu.ops.temporal_attention import temporal_attention as jax_temporal
from humanvid_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train import TrainConfig as JTrainConfig
from humanvid_tpu.train import combine_params, make_loss_fn, partition_params
from humanvid_tpu.train import stage2_trainable as j_stage2
from humanvid_tpu_torch.data.camera import (
    get_relative_pose,
    intrinsics_vector,
    ray_condition,
    static_camera,
)
from humanvid_tpu_torch.models import layers
from humanvid_tpu_torch.ops import flash_attention as fa
from humanvid_tpu_torch.ops import temporal_attention as ta
from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline, tiny_config
from humanvid_tpu_torch.train import (
    TRAIN_COMPONENTS,
    Draws,
    TrainConfig,
    TrainState,
    loss_from_draws,
    stage2_trainable,
)
from humanvid_tpu_torch.utils.weights import from_jax_params

STEP0_TOL = 1e-5
FLASH_TOL, FLASH_BWD_TOL = 2e-4, 5e-4
TOL = 1e-3


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- the motion module past its table, without one ------------------------------

def _motion_module(use_pe):
    frames, c = 12, 32
    x = _rand((2 * frames, 3, 2, c), 0)
    jm = jl.TemporalTransformer(dim=c, heads=4, max_len=8, use_pe=use_pe)
    p = init_like(jm, 2, jnp.asarray(x), 8)
    sd = from_jax_params({"params": {"down_0_motion_0": p["params"]}}, "unet")
    m = layers.MotionModule(c, heads=4, max_len=8, use_pe=use_pe)
    m.load_state_dict(sub_state_dict(sd, "down_blocks.0.motion_modules.0."), strict=True)
    return jm, p, m.eval(), x, frames


def test_motion_module_without_position_table_takes_more_frames(monkeypatch):
    jm, p, m, x, frames = _motion_module(use_pe=False)
    monkeypatch.setenv("HVT_TEMPORAL_FUSED", "1")
    with pltpu.force_tpu_interpret_mode():
        ref = jm.apply(p, jnp.asarray(x), frames)
    with torch.no_grad():
        out = m(nchw(x), frames)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=STEP0_TOL, rtol=0)


def test_motion_module_with_position_table_raises_past_it():
    _, _, m, x, frames = _motion_module(use_pe=True)
    with pytest.raises(ValueError, match="12 frames > position table length 8"):
        m(nchw(x), frames)


# ---- kernel B past 32 frames ------------------------------------------------------

@pytest.mark.parametrize("b,f,l,c,heads", [
    (1, 33, 5, 64, 2),     # one frame past the item kernels, d = 32
    (1, 48, 4, 160, 4),    # the long path's 48 frames, d = 40 (the motion modules' level 0)
    (1, 64, 3, 256, 1),    # 64 frames, d = 256
    (1, 100, 2, 160, 4),   # the 100-frame step's frame count, d = 40
    (1, 128, 2, 128, 1),   # the frames kernel's reach, d = 128
    (1, 136, 2, 64, 2),    # past it: the 136-frame step's frame count, d = 32
    (1, 200, 1, 48, 3),    # 200 frames (four 64-frame panels when streamed), d = 16
])
def test_temporal_attention_past_32_frames_matches_jax(b, f, l, c, heads):
    q, k, v, g = (_rand((b, f, l, c), s) for s in range(4))
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda q_, k_, v_: jax_temporal(q_, k_, v_, heads),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = ta.TemporalAttention.apply(*leaves, heads)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=STEP0_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STEP0_TOL, rtol=0)


# ---- kernel A past 512 columns ----------------------------------------------------

def _flash_against_jax(d, with_bias):
    b, lq, lk = 2, 128, 256
    q, g = _rand((b, lq, d), 0), _rand((b, lq, d), 3)
    k, v = _rand((b, lk, d), 1), _rand((b, lk, d), 2)
    bias = None
    if with_bias:  # the CFG pattern: row 0 hides the second half of its keys
        bias = np.zeros((b, lk), np.float32)
        bias[0, lk // 2:] = NEG_INF
    jbias = None if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, 1, jbias, block_q=128,
                                                        block_kv=128),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, _ = fa.flash_attention_packed(*leaves, 1, None if bias is None else torch.from_numpy(bias))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FLASH_TOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLASH_BWD_TOL, rtol=0)


@pytest.mark.parametrize("d", [520, 640])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_past_512_columns_matches_jax(d, with_bias):
    _flash_against_jax(d, with_bias)


@pytest.mark.parametrize("d", [192, 256, 320, 448])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_between_128_and_512_columns_matches_jax(d, with_bias):
    _flash_against_jax(d, with_bias)


# ---- the plans ------------------------------------------------------------------------

XWIDE = ("Xwide", "XwideDkv/XwideDq")


@pytest.mark.parametrize("d,plan", [
    (513, fa.FlashPlan(520, *XWIDE, 520)),     # past 512: the xwide kernels, padded to 8
    (520, fa.FlashPlan(520, *XWIDE, 520)),
    (640, fa.FlashPlan(640, *XWIDE, 640)),     # one spatial head at UNet level 1
    (1280, fa.FlashPlan(1280, *XWIDE, 1280)),  # one head at levels 2-3
    (4100, fa.FlashPlan(4104, *XWIDE, 4104)),
    (40, fa.FlashPlan(40, "Cfg<48, 40>", "DkvCfg48/DqCfg48", 40)),  # unchanged below
    (128, fa.FlashPlan(128, "Own<128, 64>", "DkvOwn<128, 64>/DqOwn<128, 64>", 128)),
    # level 0's one head: the mid forward and backward at 320
    (320, fa.FlashPlan(320, "Mid<320, rows>", "MidDkv<320>/MidDq<320>", 320)),
    (512, fa.FlashPlan(512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq", 512)),
])
def test_flash_plan_past_512_and_below(d, plan):
    assert fa.flash_plan(d) == plan


def test_xwide_plan_of_every_width_fits_one_block():
    for d in range(520, 4105, 8):
        p = fa.xwide_plan(d)
        assert p.slice % 16 == 0 and p.slice <= 256 and p.key_tile == 64
        assert 1 <= p.cluster <= 8 and p.groups >= 1
        slices = p.cluster * p.groups
        assert slices * p.slice >= d > (slices - p.cluster) * p.slice  # cover, no idle group
        assert p.fwd_stages >= 2 and p.bwd_stages >= 2 and p.fwd_exchange in (1, 2)
        assert p.groups == 1 or p.fwd_stages >= 3
        for kernel in ("fwd", "bwd"):
            assert fa.xwide_smem(p, kernel) <= fa.SMEM_LIMIT, (d, kernel)
        assert fa._plan_args(d, "fwd") == (p.slice, p.cluster, p.groups, 64, p.fwd_stages,
                                           p.fwd_exchange, fa.xwide_smem(p, "fwd"))


@pytest.mark.parametrize("d,cluster,groups", [
    (520, 3, 1),    # a last slice of 8 columns
    (640, 3, 1),    # long_wide's level 1: 256 + 256 + 128
    (1280, 5, 1),
    (2048, 8, 1),   # one cluster's reach at 256 columns a slice
    (2056, 5, 2),   # past it: two groups of five slices
    (4104, 6, 3),
])
def test_xwide_plan_at_named_widths(d, cluster, groups):
    p = fa.xwide_plan(d)
    assert (p.slice, p.cluster, p.groups) == (256, cluster, groups)
    fwd_stages = 2 if groups == 1 else 3  # both Q slices and K held at once past one cluster
    assert (p.fwd_stages, p.fwd_exchange, p.bwd_stages) == (fwd_stages, 2, 4)
    half = fa.xwide_plan(d, 128)  # the variants' slice width
    assert half.slice == 128 and half.cluster * half.groups * 128 >= d


def test_xwide_plan_raises_below_its_widths_and_passes_zeros_there():
    for d, slice_ in ((512, 256), (644, 256), (640, 192)):
        with pytest.raises(ValueError):
            fa.xwide_plan(d, slice_)
    assert fa._plan_args(512, "dkv") == (0,) * 7 and fa._plan_args(40, "fwd") == (0,) * 7


def test_xwide_smem_reckons_as_the_kernels_header():
    """The wrapper's constants and its reckoning of shared memory are those
    of ``xwide::Layout`` in csrc/xwide.cuh (which checks the bytes passed
    to it against its own on the card)."""
    import re

    from humanvid_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "xwide.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kInfoSlots") == fa.XWIDE_INFO_SLOTS and const("kRows") == fa.XWIDE_KEY_TILE
    assert const("kMaxCluster") == fa.XWIDE_MAX_CLUSTER and const("kSmemLimit") == fa.SMEM_LIMIT
    assert "kInfoBytes = 2 * kRows * 4 + 16" in text and fa.XWIDE_INFO_BYTES == 2 * 64 * 4 + 16
    p = fa.xwide_plan(640)
    piece, partial = 64 * 256 * 2, 64 * 64 * 4
    bars_fwd = 2 * 2 + 2 * 3 + 1 + 2 * 2 * 2 * 4
    assert fa.xwide_smem(p, "fwd") == 4 * piece + 4 * partial + 3 * 528 + 8 * bars_fwd + 1024
    bars_bwd = 2 * 4 + 2 * 3 + 1 + 2 * 1 * 2 * 4
    assert fa.xwide_smem(p, "bwd") == 6 * piece + 2 * partial + 3 * 528 + 8 * bars_bwd + 1024


@pytest.mark.parametrize("shape,heads,sizes", [
    # past 32 frames: the long forward's plan, whole heads of at most 160
    # columns where their ring fits (all frames a stage), else one head in
    # chunks of at most 160 columns of 64-frame panels
    ((1, 33, 8, 256), 1, (1, 33, 8, 1, 256, 1, 136, 2, 256)),
    ((1, 48, 6144, 320), 8, (1, 48, 6144, 8, 40, 4, 168, 1, 40)),   # level 0 of the long path
    ((1, 48, 1792, 640), 8, (1, 48, 1792, 8, 80, 2, 168, 1, 80)),
    ((1, 96, 96, 1280), 8, (1, 96, 96, 8, 160, 1, 168, 1, 160)),
    ((1, 64, 9, 1280), 1, (1, 64, 9, 1, 1280, 1, 168, 8, 1280)),
    # up to 32 frames: the item kernels' plans as before (a 256-wide head in
    # two column slices: the split kernels, whose plan the tail carries)
    ((1, 32, 8, 256), 1, (1, 32, 8, 1, 256, 1, 136, 2, 256)),
    ((1, 24, 7168, 320), 8, (1, 24, 7168, 8, 40, 4, 168, 1, 40)),
    ((8, 1, 7168, 320), 8, (8, 1, 7168, 8, 40, 4, 168, 1, 40)),
    ((1, 24, 448, 1280), 8, (1, 24, 448, 8, 160, 1, 168, 1, 160)),
])
def test_launch_sizes_past_32_frames_and_below(shape, heads, sizes):
    assert ta.launch_sizes(shape, heads) == sizes
    plan = ta.temporal_plan(shape[-1], heads, shape[1])
    assert (plan.heads, plan.padded, plan.chunks) == sizes[5:8]
    tail = ta.forward_launch_sizes(shape, heads)[9:]
    if shape[1] <= ta.ITEM_FRAMES and sizes[7] == 1:
        assert tail == (ta.MODE_ITEMS, 0, 0)
    elif shape[1] <= ta.ITEM_FRAMES:
        p = ta.split_plan(sizes[4], shape[1])
        assert tail == (ta.MODE_SPLIT, p.stages, p.smem) and p.mode == ta.MODE_SPLIT
    else:
        p = ta.long_fwd_plan(shape[-1], heads, shape[1])
        assert tail == (p.mode, p.stages, p.smem)
        assert p.mode == (ta.MODE_RESIDENT if sizes[7] == 1 else ta.MODE_STREAMED)


@pytest.mark.parametrize("f,c,heads,plan", [
    # the long_wide stage-2 step's levels: whole heads with a stage spare
    # beside the 3 groups' where one fits (80 columns in 4 stages), else 160
    # columns in 3
    (48, 320, 8, ta.LongBackwardPlan(2, 80, 88, 1, 4, 167616)),
    (48, 640, 8, ta.LongBackwardPlan(1, 80, 88, 1, 4, 167616)),
    (48, 1280, 8, ta.LongBackwardPlan(1, 160, 168, 1, 3, 225968)),
    (33, 320, 8, ta.LongBackwardPlan(4, 160, 168, 1, 4, 215744)),   # room for 4 stages
    # one 256-wide head in chunks: 2 of 128 at 64 frames, 3 of 88 at 96
    (64, 1280, 5, ta.LongBackwardPlan(1, 128, 136, 2, 3, 227504)),
    (96, 1280, 5, ta.LongBackwardPlan(1, 88, 104, 3, 2, 199840)),
    # at 96 frames 160 columns no longer fit two stages: 2 heads of 40, a
    # 160-wide head in 2 chunks
    (96, 320, 8, ta.LongBackwardPlan(2, 80, 88, 1, 2, 175264)),
    (96, 1280, 8, ta.LongBackwardPlan(1, 80, 88, 2, 2, 175264)),
    (40, 1280, 1, ta.LongBackwardPlan(1, 160, 168, 8, 3, 196400)),  # d = 1280
    # past 96 frames P and dS take 53.8 KB (100) to 69.6 KB (128): the
    # 100-frame step's level 0 in two heads of 40, one head of 40 at 128
    (100, 320, 8, ta.LongBackwardPlan(2, 80, 88, 1, 2, 197408)),
    (128, 320, 8, ta.LongBackwardPlan(1, 40, 56, 1, 2, 184480)),
    (128, 1280, 1, ta.LongBackwardPlan(1, 64, 72, 20, 2, 217248)),
])
def test_long_backward_plan_at_named_frame_counts(f, c, heads, plan):
    assert ta.long_backward_plan(c, heads, f) == plan
    assert ta.backward_launch_sizes((1, f, 7, c), heads) == (
        1, f, 7, heads, c // heads, plan.heads, plan.padded, plan.chunks, c // heads,
        ta.MODE_FRAMES, plan.stages, plan.smem)


@pytest.mark.parametrize("f", [32, 97, 100, 128, 129, 256])
def test_long_backward_plan_boundaries(f):
    """Up to 32 frames the item kernels' plan with zeros for the mode, the
    ring's stages and bytes; the frames kernel from 33 to 128; past 128
    the long backward's plan (``long_bwd_plan``)."""
    assert ta.FRAMES_KERNEL_FRAMES == 128
    plan = ta.long_backward_plan(320, 8, f)
    sizes = ta.backward_launch_sizes((1, f, 7, 320), 8)
    if ta.ITEM_FRAMES < f <= ta.FRAMES_KERNEL_FRAMES:
        assert plan is not None and sizes[-3:] == (ta.MODE_FRAMES, plan.stages, plan.smem)
        assert ta.long_bwd_plan(320, 8, f) is None
    elif f <= ta.ITEM_FRAMES:
        assert plan is None and sizes == (*ta.launch_sizes((1, f, 7, 320), 8), 0, 0, 0)
    else:
        assert plan is None
        p = ta.long_bwd_plan(320, 8, f)
        assert sizes == (1, f, 7, 8, 40, p.heads, p.padded, p.chunks, 40, p.mode, p.stages,
                         p.smem)
    assert ta.long_backward_plan(320, 8, 33) is not None
    assert ta.long_backward_plan(320, 8, ta.FRAMES_KERNEL_FRAMES) is not None


def test_long_backward_plan_of_every_shape_fits_one_block():
    """From 33 to 128 frames, every width the motion modules and the heads64
    and long_wide configs give (and the narrowest and widest): a ring of at
    least 2 stages in a block's shared memory, chunks of at most 160
    columns, multiples of 8, covering the head with none empty, or whole
    heads that divide the head count; loaded at a width the C side takes."""
    for f in range(33, ta.FRAMES_KERNEL_FRAMES + 1):
        for c, heads in ((320, 8), (640, 8), (1280, 8), (1280, 5), (320, 5), (640, 5), (64, 8),
                         (1280, 1), (640, 1), (320, 1), (1272, 1), (8, 1), (200, 5)):
            d = c // heads
            p = ta.long_backward_plan(c, heads, f)
            assert 2 <= p.stages <= ta.FRAMES_KERNEL_MAX_STAGES
            assert p.smem == ta.long_backward_smem(f, p.padded, p.stages) <= ta.SMEM_LIMIT
            assert p.cols % 8 == 0 and p.cols <= ta.CHUNK_COLUMNS
            assert p.padded >= p.cols + 8 and (p.padded // 8) % 2 == 1 and p.padded <= 256
            if p.chunks == 1:
                assert heads % p.heads == 0 and p.cols == p.heads * d
            else:
                assert p.heads == 1 and (p.chunks - 1) * p.cols < d <= p.chunks * p.cols


def test_long_backward_smem_reckons_as_the_kernels_source():
    """The wrapper's constants and its reckoning of the frames kernel's
    shared memory are those of csrc/temporal_attention_bwd.cu (which checks
    the bytes passed to it against its own on the card)."""
    import re

    from humanvid_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    tiles = int(re.search(r"constexpr int kFramesTiles = (\d+);", text).group(1))
    assert 16 * tiles == ta.FRAMES_KERNEL_FRAMES
    assert "constexpr int frames_groups(int QT) { return QT <= 3 ? 3 : 1; }" in text
    assert [ta.frames_groups(f) for f in (33, 48, 49, 96)] == [3, 3, 1, 1]
    assert ("(size_t)frames_groups(FP / 16) * 2 * FP * (FP + 8)) * 2 + 2 * stages * 8;"
            in text)
    assert "if (bytes != smem || bytes > 232448)" in text and ta.SMEM_LIMIT == 232448
    assert "constexpr int kChunkColumns = 160;" in text and ta.CHUNK_COLUMNS == 160
    # 48 frames, 168 columns: 3 x 4 tiles of 48 x 168, no room, three groups'
    # P and dS of 48 x 56, 6 barriers, 128 bytes of alignment
    assert ta.long_backward_smem(48, 168, 3) == 128 + (3 * 4 * 8064 + 0 + 3 * 2 * 48 * 56) * 2 + 48
    # 33 frames: each tile rounded to 64 elements, the room of 15 rows
    assert ta.long_backward_smem(33, 168, 4) == \
        128 + (4 * 4 * 5568 + 2560 + 3 * 2 * 48 * 56) * 2 + 64
    # 64 frames: one group
    assert ta.long_backward_smem(64, 136, 3) == 128 + (3 * 4 * 8704 + 0 + 1 * 2 * 64 * 72) * 2 + 48


# ---- the long kernels' plans (the forward past 32 frames, the backward past 128) --

def _check_long_plan(p, c, heads, f, backward):
    d = c // heads
    assert 1 <= p.stages <= ta.LONG_MAX_STAGES
    assert p.padded >= p.cols + 8 and (p.padded // 8) % 2 == 1 and p.padded <= 256
    if p.mode == ta.MODE_RESIDENT:
        assert p.chunks == 1 and heads % p.heads == 0 and p.cols == p.heads * d
        assert p.cols <= ta.CHUNK_COLUMNS and -(-f // 16) * 16 <= ta.LONG_BOX_FRAMES
    else:
        assert p.mode == ta.MODE_STREAMED and p.heads == 1 and p.cols % 8 == 0
        assert p.cols <= (ta.LONG_CHUNK if backward else ta.LONG_FWD_CHUNK)
        assert (p.chunks - 1) * p.cols < d <= p.chunks * p.cols
    smem = ta._long_smem(backward, p.mode, f, d, p.heads, p.cols, p.padded, p.stages)
    assert p.smem == smem <= ta.SMEM_LIMIT


@pytest.mark.parametrize("backward", [False, True])
def test_long_plans_of_every_width_fit_one_block(backward):
    """At every d that is a multiple of 8 up to 1280 (one head, the widest
    item) and every f from 33 (forward) or 129 (backward) up to 1024: a
    plan whose ring and staging fit a block's shared memory, chunks that
    cover the head with none empty; and at the motion modules' and the
    heads64 config's head counts the whole-head items divide the heads."""
    plan = ta.long_bwd_plan if backward else ta.long_fwd_plan
    first = ta.FRAMES_KERNEL_FRAMES + 1 if backward else ta.ITEM_FRAMES + 1
    for d in range(8, ta.MAX_HEAD_DIM + 1, 8):
        for f in list(range(first, 300)) + list(range(300, 1025, 29)) + [1024]:
            _check_long_plan(plan(d, 1, f), d, 1, f, backward)
    for c, heads in ((320, 8), (640, 8), (1280, 8), (1280, 5), (320, 5), (640, 5), (64, 8)):
        for f in range(first, 1025, 7):
            _check_long_plan(plan(c, heads, f), c, heads, f, backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("f,c,heads,mode,per,stages", [
    # the long_wide path's level 0: 4 heads an item, two stages in half an
    # SM's memory (the forward: two blocks an SM)
    (48, 320, 8, ta.MODE_RESIDENT, 4, 2),
    (136, 320, 8, ta.MODE_RESIDENT, None, 2),  # the 136-frame step's level 0
    (256, 320, 8, ta.MODE_RESIDENT, None, None),
    (256, 1280, 8, ta.MODE_STREAMED, 1, None),  # d = 160 at 256 frames: panels (and chunks)
    (136, 1280, 1, ta.MODE_STREAMED, 1, None),  # d = 1280: chunks of 160 (64 backward)
])
def test_long_plans_at_named_shapes(backward, f, c, heads, mode, per, stages):
    plan = ta.long_bwd_plan if backward else ta.long_fwd_plan
    if backward and f <= ta.FRAMES_KERNEL_FRAMES:
        assert plan(c, heads, f) is None
        return
    p = plan(c, heads, f)
    assert p.mode == mode
    assert per is None or p.heads == per
    assert stages is None or p.stages == stages
    if mode == ta.MODE_STREAMED:
        d = c // heads
        chunk = ta.LONG_CHUNK if backward else ta.LONG_FWD_CHUNK
        assert p.chunks == -(-d // chunk) and p.cols == (-(-d // p.chunks) + 7) // 8 * 8
    # the streamed mode where the resident one fits (the variants' ablation)
    s = ta._long_plan(backward, c, heads, f, streamed=True)
    assert s.mode == ta.MODE_STREAMED and s.heads == 1


@pytest.mark.parametrize("f", [32, 33])
def test_long_forward_boundary(f):
    """32 frames take the item kernels (mode 0, no ring), 33 the long
    forward; ``long_fwd_plan`` raises at or below 32."""
    sizes = ta.forward_launch_sizes((1, f, 7, 320), 8)
    assert sizes[:9] == ta.launch_sizes((1, f, 7, 320), 8)
    if f <= ta.ITEM_FRAMES:
        assert sizes[9:] == (ta.MODE_ITEMS, 0, 0)
        with pytest.raises(ValueError):
            ta.long_fwd_plan(320, 8, f)
    else:
        p = ta.long_fwd_plan(320, 8, f)
        assert sizes[9:] == (p.mode, p.stages, p.smem) and p.mode == ta.MODE_RESIDENT


def test_long_smem_reckons_as_the_kernels_sources():
    """The wrappers' constants and their reckoning of the long kernels'
    shared memory are those of csrc/temporal_attention.cu and
    csrc/temporal_attention_bwd.cu (which check the bytes passed to them
    against their own on the card)."""
    import re

    from humanvid_tpu_torch.ops import cuda_build

    for name, backward in (("temporal_attention.cu", False), ("temporal_attention_bwd.cu", True)):
        text = (cuda_build.CSRC / name).read_text()

        def const(key):
            return int(re.search(rf"constexpr int {key} = (\d+);", text).group(1))

        assert const("kLongConsumers") == ta.LONG_CONSUMERS and const("kPanel") == ta.LONG_PANEL
        assert const("kLongChunk") == (ta.LONG_CHUNK if backward else ta.LONG_FWD_CHUNK)
        assert const("kLongMaxStages") == ta.LONG_MAX_STAGES
        assert "if (bytes != smem || bytes > 232448)" in text and ta.SMEM_LIMIT == 232448
        assert "(F + 15) / 16 * 16 > 256" in text and ta.LONG_BOX_FRAMES == 256
        assert ("constexpr int kModeItems = 0, kModeResident = 2, kModeStreamed = 3;" in text
                or "constexpr int kModeItems = 0, kModeFrames = 1, kModeResident = 2, "
                   "kModeStreamed = 3;" in text)
        if backward:
            assert const("kSlab") == ta.LONG_SLAB
            assert ("return 128 + (size_t)stages * 4 * rows * cwp * 2 + (size_t)kLongConsumers * 2 "
                    "* 16 * ow * 2 +\n         (size_t)words * 4 + (size_t)pds * 2 + "
                    "(size_t)stages * 16;") in text
            assert ("const int words = STREAMED ? 2 * 3 * NP * kPanel : stages * per * (PANELS ? "
                    "6 : 3) * FP;") in text
            assert "const int pds = PANELS ? 2 * FP * kPanelLd : 0;" in text
            assert const("kPanelWidth") == ta.LONG_PANEL_WIDTH
            assert 16 * const("kPanelTiles") + 8 == ta.LONG_PANEL_LD
            assert 16 * const("kHeldTiles") * const("kLongConsumers") == ta.LONG_HELD_FRAMES
            assert ("if (d <= kPanelWidth && (F + 15) / 16 <= kHeldTiles * kLongConsumers)"
                    in text)
            assert "const int ow = STREAMED ? CW : min(kSlab, d);" in text
        else:
            assert ("return 128 + (size_t)stages * 3 * rows * cwp * 2 + "
                    "(size_t)kLongConsumers * 16 * ow * 2 +\n         (size_t)stages * 16;") in text
            assert "const int ow = STREAMED ? CW : d;" in text
        assert "const int rows = STREAMED ? kPanel : (F + 15) / 16 * 16;" in text or \
            "const int rows = STREAMED ? kPanel : FP;" in text
    assert (ta.MODE_ITEMS, ta.MODE_FRAMES, ta.MODE_RESIDENT, ta.MODE_STREAMED) == (0, 1, 2, 3)
    # 48 frames, 4 heads of 40 (168 wide), 2 stages: 3 tiles of 48 x 168, eight
    # 16 x 40 staging tiles, 4 barriers, 128 bytes of alignment: half an SM
    assert ta.long_fwd_smem(48, 168, 40, 2) == 128 + 2 * 3 * 48 * 168 * 2 + 8 * 16 * 40 * 2 + 32
    assert ta.long_fwd_plan(320, 8, 48).smem == ta.long_fwd_smem(48, 168, 40, 2)
    assert ta.long_fwd_smem(48, 168, 40, 2) <= ta.TWO_BLOCK_SMEM < ta.long_fwd_smem(48, 168, 40, 3)
    # 136 frames, one head of 40 (56 wide), 2 stages: 4 tiles of 144 x 56,
    # two 16 x 40 staging tiles a warp, the two halves' words of 144 rows a
    # stage, P and dS of a 64-key panel (144 x 72 each)
    assert ta.long_bwd_smem(144, 56, 40, 2, 2 * 6 * 144, 2 * 144 * 72) == \
        128 + 2 * 4 * 144 * 56 * 2 + 8 * 2 * 16 * 40 * 2 + 2 * 6 * 144 * 4 + 2 * 144 * 72 * 2 + 32
    assert ta.long_bwd_plan(320, 8, 136).smem == \
        ta.long_bwd_smem(144, 56, 40, 2, 2 * 6 * 144, 2 * 144 * 72)
    # past 64 columns: the words once, no panel (d = 80 at 136 frames)
    p = ta.long_bwd_plan(640, 8, 136)
    assert p.smem == ta.long_bwd_smem(144, p.padded, 64, p.stages, p.stages * p.heads * 3 * 144)
    # streamed: 64-frame panels, d = 160 in 3 chunks of 56 (72 wide), the
    # item's words twice
    assert ta.long_bwd_plan(1280, 8, 256).smem == ta.long_bwd_smem(64, 72, 56, 4, 2 * 3 * 256)
    assert ta.long_bwd_panels(136, 40) and not ta.long_bwd_panels(136, 80)
    # the forward's: d = 256 in two chunks of 128 (136 wide)
    assert ta.long_fwd_plan(1280, 5, 96).smem == ta.long_fwd_smem(64, 136, 128, 3)


def test_mid_plan_of_every_width_and_the_c_side():
    """Between 128 and 512 (multiples of 8) the mid forward runs d rounded
    up to 64 in the layout MID_LAYOUTS names; the C entry point takes
    exactly the (width, layout) pairs MID_WIDTHS lists, one layout a width;
    the plan ints are zeros for the backward and outside the band."""
    import re

    from humanvid_tpu_torch.ops import cuda_build

    for d in range(136, 512, 8):
        p = fa.mid_plan(d)
        assert p.width == -(-d // 64) * 64 and p.layout == fa.MID_LAYOUTS[p.width]
        assert fa._plan_args(d, "fwd") == (p.width, 1 if p.layout == "rows" else 2, 0, 0, 0, 0, 0)
        assert fa.flash_plan(d).backward_width == d
        assert fa._plan_args(d, "dkv")[0] == fa._plan_args(d, "dq")[0] == p.width
    for d in (128, 512, 130, 0, 520):
        with pytest.raises(ValueError):
            fa.mid_plan(d)
    text = (cuda_build.CSRC / "flash_attention.cu").read_text()
    built = {"rows": (), "columns": ()}
    for cluster, width in re.findall(r"x_cluster == (\d) && x_slice == (\d+)\) return MID", text):
        key = "rows" if cluster == "1" else "columns"
        built[key] += (int(width),)
    assert built == fa.MID_WIDTHS
    assert not set(built["rows"]) & set(built["columns"])


def test_mid_backward_plan_of_every_width_and_the_c_side():
    """Between 128 and 512 (multiples of 8) the mid backward runs d rounded
    up to 64: one merged dk/dv kernel and dq by role up to 320, a dV and a
    dK kernel and dq by columns past it, every ring at least one stage in a
    block's shared memory, reckoned as ``mid_smem`` in
    csrc/flash_attention_mid_bwd.cu reckons it; the C entry points take
    exactly the (width, layout, rows) the plans give."""
    import re

    from humanvid_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "flash_attention_mid_bwd.cu").read_text()
    assert f"constexpr int kSmemLimit = {fa.SMEM_LIMIT};" in text
    assert ("return (mode == kDv ? 1 : 2) * kRows * dqk * 2 + stages * (2 * bs * dqk * 2 + "
            "2 * bs * 4 + 16) +\n         (by_roles(mode) ? kXSlots : 4) * kRows * bs * 4 +\n"
            "         (3 * stages + 1 + (by_roles(mode) ? 2 * kXSlots : 0)) * 8 + 1024;") in text
    assert "constexpr int kXSlots = 2;" in text
    assert ("return mode == kDkv || mode == kDqRoles;" in text)
    merged = {(int(w), int(r)) for w, r in re.findall(
        r"if \(x_slice == (\d+) && x_key_tile == (\d+)\) return MERGED", text)}
    split = {int(w) for w in re.findall(r"if \(x_slice == (\d+)\) SPLIT", text)}
    dq = {(int(w), int(r), kind) for w, r, kind in re.findall(
        r"if \(x_slice == (\d+) && x_key_tile == (\d+)\) return (ROLES|COLUMNS)", text)}
    for d in range(136, 512, 8):
        p = fa.mid_backward_plan(d)
        assert p.width == -(-d // 64) * 64 == fa.mid_plan(d).width
        assert p.layout == ("merged" if p.width <= 320 else "split")
        roles = p.dq_layout == "roles"
        assert roles == (p.width <= 320)
        assert (p.width, p.dq_rows, "ROLES" if roles else "COLUMNS") in dq
        if p.layout == "merged":
            assert (p.width, p.rows) in merged and p.dk_stages == 0
            kernels = (("dkv", p.rows, p.stages),)
        else:
            assert p.width in split and p.rows == 32
            kernels = (("dv", p.rows, p.stages), ("dk", p.rows, p.dk_stages))
        dq_kernel = "dq_roles" if roles else "dq"
        for kernel, rows, stages in kernels + ((dq_kernel, p.dq_rows, p.dq_stages),):
            assert 1 <= stages <= fa.MID_BWD_MAX_STAGES
            smem = fa.mid_bwd_smem(kernel, p.width, rows, stages)
            assert smem <= fa.SMEM_LIMIT < fa.mid_bwd_smem(kernel, p.width, rows, stages + 1) \
                or stages == fa.MID_BWD_MAX_STAGES
        dkv, dq_args = fa._plan_args(d, "dkv"), fa._plan_args(d, "dq")
        assert dq_args == (p.width, 1 if roles else 2, 0, p.dq_rows, p.dq_stages, 0,
                           fa.mid_bwd_smem(dq_kernel, p.width, p.dq_rows, p.dq_stages))
        if p.layout == "merged":
            assert dkv == (p.width, 1, 0, p.rows, p.stages, 0,
                           fa.mid_bwd_smem("dkv", p.width, p.rows, p.stages))
        else:
            assert dkv == (p.width, 2, fa.mid_bwd_smem("dk", p.width, 32, p.dk_stages), 32,
                           p.stages, p.dk_stages, fa.mid_bwd_smem("dv", p.width, 32, p.stages))
    # the named layouts: level 0's d = 320 in 32-row steps, 3 stages each;
    # d = 192 in 64-row steps, 3 stages (232096 bytes of 232448)
    assert fa.mid_backward_plan(320) == fa.MidBackwardPlan(320, "merged", 32, 3, 0, "roles", 32, 3)
    assert fa.mid_backward_plan(192) == fa.MidBackwardPlan(192, "merged", 64, 3, 0, "roles", 64, 3)
    assert fa.mid_backward_plan(448) == fa.MidBackwardPlan(448, "split", 32, 2, 1, "columns", 32, 1)
    assert fa.mid_bwd_smem("dkv", 192, 64, 3) == (2 * 64 * 192 * 2 + 3 * (2 * 64 * 192 * 2 + 528)
                                                 + 2 * 64 * 64 * 4 + 14 * 8 + 1024) == 232096
    assert fa.mid_bwd_smem("dq", 448, 32, 1) == (2 * 64 * 448 * 2 + (2 * 32 * 448 * 2 + 272)
                                                + 4 * 64 * 32 * 4 + 4 * 8 + 1024)
    for d in (128, 512, 130, 0, 520):
        with pytest.raises(ValueError):
            fa.mid_backward_plan(d)
    with pytest.raises(ValueError):
        fa._plan_args(320, "bwd")


# ---- the slice: one spatial head, 40 frames --------------------------------------------

F, H, W = 40, 32, 32


def _long_wide(cfg):
    """The tiny config with one spatial head in both UNets (motion and
    camera-encoder heads as shipped)."""
    return dataclasses.replace(
        cfg,
        reference_unet=dataclasses.replace(cfg.reference_unet, attention_heads=1),
        denoising_unet=dataclasses.replace(cfg.denoising_unet, attention_heads=1))


@pytest.fixture(scope="module")
def systems():
    js = JCamAnimate(_long_wide(jax_tiny_config(motion_max_len=F)))
    params = jax_system_params(js, F, H, W)
    port = CamAnimate(_long_wide(tiny_config(motion_max_len=F)),
                      device="cpu").load_jax_params(params)
    return js, params, port


def test_pose2vid_over_40_frames_in_one_window_matches_jax(systems):
    js, params, port = systems
    heads = {m.heads for m in port.denoising_unet.modules() if hasattr(m, "heads")}
    assert 1 in heads
    rng = np.random.default_rng(7)
    ref_image = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((F, H, W, 3)).astype(np.float32)
    clip_image = rng.random((28, 28, 3)).astype(np.float32)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    cams = static_camera((W, H), F)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    kw = dict(num_inference_steps=2, guidance_scale=3.5, context_frames=F, context_overlap=4,
              cfg_mode="batched", init_latents=init)
    ref = JPipeline(js, params)(ref_image, pose, plucker, clip_image, **kw)
    ta.reset_launches()
    out = Pose2VideoPipeline(port)(ref_image, pose, plucker, clip_image, **kw)
    assert out.videos.shape == (1, F, H, W, 3)
    np.testing.assert_allclose(out.latents, ref.latents, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.videos, ref.videos, atol=TOL, rtol=0)


def test_stage2_step_over_40_frames_matches_jax(systems):
    """One cond stage-2 loss and the gradients of every trained leaf (the
    motion modules and the camera encoder) over 40 frames, from the same
    weights, batch and draws."""
    js, params, port = systems
    b = 1
    rng = np.random.default_rng(8)
    batch = {"tgt": (rng.normal(size=(b, F, H, W, 3)) * 0.5).astype(np.float32),
             "ref": (rng.normal(size=(b, H, W, 3)) * 0.5).astype(np.float32),
             "clip": rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
             "pose": rng.random((b, F, H, W, 3)).astype(np.float32),
             "plucker": rng.normal(size=(b, F, H, W, 6)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    sched = js.make_schedule(beta_schedule="scaled_linear")
    loss_fn = make_loss_fn(js, sched, JTrainConfig(uncond_ratio=0.0))
    trainable = {k: params[k] for k in TRAIN_COMPONENTS}
    frozen = {k: params[k] for k in ("vae_encoder", "vae_decoder", "clip")}
    train_part, static = partition_params(trainable, j_stage2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rngkey = jax.random.fold_in(key, 0)
    ref_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda tp: loss_fn(combine_params(tp, static), frozen, jbatch, rngkey)[0]))(train_part)

    # the JAX loss's own draws, in the port's NCHW layout
    r_noise, r_off, r_t, r_vae1, r_vae2, _ = jax.random.split(rngkey, 6)
    h8, w8 = H // 8, W // 8

    def to_nchw(x):
        return torch.from_numpy(np.moveaxis(np.asarray(x), -1, -3).copy())

    draws = Draws(noise=to_nchw(jax.random.normal(r_noise, (b, F, h8, w8, 4))),
                  offset_noise=to_nchw(jax.random.normal(r_off, (b, 1, 1, 1, 4))),
                  t=torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, 1000))).long(),
                  vae_eps=to_nchw(jax.random.normal(r_vae1, (b * F, h8, w8, 4))),
                  ref_vae_eps=to_nchw(jax.random.normal(r_vae2, (b, h8, w8, 4))),
                  uncond=False)
    state = TrainState(port, stage2_trainable)
    loss, _ = loss_from_draws(port, port.make_schedule(beta_schedule="scaled_linear"),
                              TrainConfig(uncond_ratio=0.0), batch, draws)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    loss.backward()
    kinds = {"denoising_unet": "unet", "camera_encoder": "camera_encoder"}
    ref_grads = {}
    for comp, kind in kinds.items():
        tree = jax.tree_util.tree_map(np.asarray, j_grads[comp])
        flat = {k: v for k, v in from_jax_params(_prune(tree), kind).items()}
        ref_grads.update({f"{comp}/{k}": v for k, v in flat.items()})
    grads = dict(zip(state.names, state.grads()))
    assert sorted(grads) == sorted(ref_grads)
    for name, got in grads.items():
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * scale, rtol=0, err_msg=name)


def _prune(tree):
    """A nested dict without its None leaves and empty branches."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
