"""Every head width the attention kernels take: the zero pad, the width plans
and the whole slice at other head counts, on the CPU.

- The pad (``head_pad.resize_heads``): plain attention on zero-padded heads
  with the true width's softmax scale equals plain attention at the true
  width, in the output, the log-sum-exp and all three gradients, and the
  pad columns' gradients are exactly zero (kernels A and B). Tolerance 1e-6
  (fp32): the padded sums add exact zeros, so only summation order differs.
- The width plans, pure functions: which configuration kernel A's entry
  points pick or which width a head is padded to (d > 512 takes the xwide
  kernels, d < 1 raises), and kernel B's item: whole heads up to 160
  columns, column chunks up to 1280 (d > 1280 raises; f > 32 takes the long
  kernels, ``test_torch_long_wide.py``).
- The slice: the tiny config with other head counts (spatial heads 16 and
  32 wide, motion heads 32 and 64, camera-encoder heads 16; the shipped
  tiny config's are 4 to 16) through the port's and the JAX package's
  Pose2VideoPipeline for 2 steps and one stage-2 loss, fp32, weights
  carried by ``from_jax_params``, at the tolerances of
  ``test_torch_pose2vid.py`` (1e-3) and ``test_torch_train.py`` (loss
  1e-5 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch threads)
from test_torch_helpers import jax_system_params
from humanvid_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train import TrainConfig as JTrainConfig
from humanvid_tpu.train import make_loss_fn
from humanvid_tpu_torch.data.camera import (
    get_relative_pose,
    intrinsics_vector,
    ray_condition,
    static_camera,
)
from humanvid_tpu_torch.ops import flash_attention as fa
from humanvid_tpu_torch.ops import temporal_attention as ta
from humanvid_tpu_torch.ops.head_pad import resize_heads, round_up8
from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline, tiny_config
from humanvid_tpu_torch.train import TRAIN_COMPONENTS, TrainConfig, loss_from_draws

PAD_TOL = 1e-6
TOL = 1e-3


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# ---- the pad ----------------------------------------------------------------

def test_resize_heads_pads_with_zeros_and_cuts_back():
    x = _normal((2, 5, 3 * 36), 0)
    wide = resize_heads(x, 3, 40)
    assert wide.shape == (2, 5, 120) and wide.is_contiguous()
    heads = wide.view(2, 5, 3, 40)
    assert torch.equal(heads[..., :36], x.view(2, 5, 3, 36))
    assert (heads[..., 36:] == 0).all()
    assert torch.equal(resize_heads(wide, 3, 36), x)
    assert resize_heads(x, 3, 36) is x
    # the frame-axis layout (b, f, l, c): the same per head of the last axis
    y = _normal((1, 4, 6, 2 * 20), 1)
    assert torch.equal(resize_heads(resize_heads(y, 2, 24), 2, 20), y)


@pytest.mark.parametrize("d,width,with_bias", [
    (36, 40, True),     # kernel A's pad to the next multiple of 8
    (100, 104, False),
    (192, 512, True),   # and to the 512-wide kernels
    (260, 512, False),
])
def test_flash_on_padded_heads_equals_the_true_width(d, width, with_bias):
    b, lq, lk, heads = 2, 37, 53, 3
    q, k, v = (_normal((b, n, heads * d), s) for s, n in enumerate((lq, lk, lk)))
    g = _normal((b, lq, heads * d), 3)
    bias = None
    if with_bias:
        bias = torch.zeros((b, lk))
        bias[0, lk // 2:] = -1e9
    out, lse = fa.flash_attention_plain(q, k, v, heads, bias)
    pq, pk, pv, pg = (resize_heads(t, heads, width) for t in (q, k, v, g))
    pout, plse = fa.flash_attention_plain(pq, pk, pv, heads, bias, scale_d=d)
    np.testing.assert_allclose(resize_heads(pout, heads, d).numpy(), out.numpy(),
                               atol=PAD_TOL, rtol=0)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=PAD_TOL, rtol=0)
    assert (pout.view(b, lq, heads, width)[..., d:] == 0).all()
    delta = fa.attention_delta(g, out, heads)
    # delta = rowsum(g * out) sums d + pad products of size ~5: relative
    np.testing.assert_allclose(fa.attention_delta(pg, pout, heads).numpy(), delta.numpy(),
                               atol=PAD_TOL, rtol=PAD_TOL)
    grads = fa.flash_attention_backward_plain(q, k, v, bias, g, lse, delta, heads)
    pgrads = fa.flash_attention_backward_plain(pq, pk, pv, bias, pg, lse, delta, heads,
                                               scale_d=d)
    for got, ref in zip(pgrads, grads):
        np.testing.assert_allclose(resize_heads(got, heads, d).numpy(), ref.numpy(),
                                   atol=PAD_TOL, rtol=0)
        assert (got.view(*got.shape[:2], heads, width)[..., d:] == 0).all()


@pytest.mark.parametrize("f,d", [(24, 36), (7, 100), (1, 12)])
def test_temporal_on_padded_heads_equals_the_true_width(f, d):
    b, l, heads = 2, 5, 3
    width = round_up8(d)
    q, k, v, g = (_normal((b, f, l, heads * d), 10 + s) for s in range(4))
    out = ta.temporal_attention_plain(q, k, v, heads)
    pq, pk, pv, pg = (resize_heads(t, heads, width) for t in (q, k, v, g))
    pout = ta.temporal_attention_plain(pq, pk, pv, heads, scale_d=d)
    np.testing.assert_allclose(resize_heads(pout, heads, d).numpy(), out.numpy(),
                               atol=PAD_TOL, rtol=0)
    assert (pout.view(b, f, l, heads, width)[..., d:] == 0).all()
    grads = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    pgrads = ta.temporal_attention_backward_plain(pq, pk, pv, pg, heads, scale_d=d)
    for got, ref in zip(pgrads, grads):
        np.testing.assert_allclose(resize_heads(got, heads, d).numpy(), ref.numpy(),
                                   atol=PAD_TOL, rtol=0)
        assert (got.view(b, f, l, heads, width)[..., d:] == 0).all()


# ---- the width plans ----------------------------------------------------------

@pytest.mark.parametrize("d,width,forward,backward", [
    (8, 8, "Cfg<48, 40>", "DkvCfg48/DqCfg48"),
    (36, 40, "Cfg<48, 40>", "DkvCfg48/DqCfg48"),
    (40, 40, "Cfg<48, 40>", "DkvCfg48/DqCfg48"),
    (64, 64, "Cfg<80, 80>", "DkvCfg80s/DqCfg80s"),
    (72, 72, "Cfg<80, 80>", "DkvCfg80/DqCfg80"),
    (80, 80, "Cfg<80, 80>", "DkvCfg80s/DqCfg80s"),
    (81, 88, "Cfg<128, 128>", "DkvCfg128/DqCfg128"),
    (96, 96, "Cfg<128, 128>", "DkvCfg128/DqCfg128"),
    (120, 120, "Cfg<128, 128>", "DkvCfg128/DqCfg128"),
    (128, 128, "Cfg<128, 128, swizzled>", "DkvCfg128w/DqCfg128w"),
    (129, 512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq"),
    (192, 512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq"),
    (512, 512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq"),
])
def test_flash_plan_of_each_width(d, width, forward, backward):
    assert fa.flash_plan(d) == fa.FlashPlan(width, forward, backward)


@pytest.mark.parametrize("d", [0, 513, 640, 1280])
def test_flash_plan_raises_past_512(d):
    """Past 512 the plan is the xwide kernels' (the width padded to 8);
    only d < 1 raises."""
    if d < 1:
        with pytest.raises(ValueError, match=f"head width {d} unsupported"):
            fa.flash_plan(d)
    else:
        assert fa.flash_plan(d) == fa.FlashPlan(round_up8(d), "Xwide",
                                                "XwideDv+XwideDk/XwideDq")


def test_flash_plan_runs_every_width_at_a_width_a_configuration_holds():
    for d in range(1, 513):
        w = fa.flash_plan(d).width
        assert w >= d and w % 8 == 0 and (w <= 128 or w == 512)
        assert w - d < 8 or d > 128


@pytest.mark.parametrize("d,plan", [
    (256, ta.TemporalPlan(1, 128, 136, 2)),   # 5 motion heads at levels 2-3
    (320, ta.TemporalPlan(1, 160, 168, 2)),
    (640, ta.TemporalPlan(1, 160, 168, 4)),
    (1280, ta.TemporalPlan(1, 160, 168, 8)),  # one head over the widest channels
    (168, ta.TemporalPlan(1, 88, 104, 2)),    # the last chunk narrower (80)
    (264, ta.TemporalPlan(1, 136, 152, 2)),
])
def test_temporal_plan_walks_a_wide_head_in_chunks(d, plan):
    assert ta.temporal_plan(d, 1) == plan
    assert ta.temporal_plan(5 * d, 5) == plan


def test_temporal_plan_chunks_cover_every_wide_width():
    """For every width 168..1280 (a multiple of 8): the fewest chunks of at
    most 160 columns, each a multiple of 8, that cover the head with every
    chunk non-empty, loaded at the padded width both entry points accept."""
    for d in range(168, ta.MAX_HEAD_DIM + 1, 8):
        p = ta.temporal_plan(d, 1)
        assert p.heads == 1 and p.chunks == -(-d // ta.CHUNK_COLUMNS)
        assert p.cols % 8 == 0 and p.cols <= ta.CHUNK_COLUMNS
        assert (p.chunks - 1) * p.cols < d <= p.chunks * p.cols
        assert p.cols + 8 <= p.padded <= p.cols + 16 and (p.padded // 8) % 2 == 1
        assert p.padded <= 256


@pytest.mark.parametrize("d,width", [(1, 8), (36, 40), (160, 160), (161, 168), (1280, 1280)])
def test_temporal_width_pads_to_a_multiple_of_8(d, width):
    assert ta.temporal_width(d) == width


@pytest.mark.parametrize("shape,heads,sizes", [
    # the heads64 motion modules' level 2 (stage 2, 896x512x24f): d = 256
    ((1, 24, 448, 1280), 5, (1, 24, 448, 5, 256, 1, 136, 2, 256)),
    ((8, 1, 448, 1280), 1, (8, 1, 448, 1, 1280, 1, 168, 8, 1280)),
    ((1, 24, 9, 640), 2, (1, 24, 9, 2, 320, 1, 168, 2, 320)),
])
def test_launch_sizes_of_wide_heads(shape, heads, sizes):
    assert ta.launch_sizes(shape, heads) == sizes
    # a zero-padded head: the kernel's width, the true width's scale
    assert ta.launch_sizes((1, 4, 8, 5 * 40), 5, 36)[-1] == 36


@pytest.mark.parametrize("d", [1288, 2560])
def test_temporal_width_raises_past_1280(d):
    with pytest.raises(ValueError, match=f"head dim {d} unsupported"):
        ta.temporal_width(d)
    with pytest.raises(ValueError, match=f"head dim {d} unsupported"):
        ta.launch_sizes((1, 4, 8, d), 1)


def test_launch_sizes_raise_past_32_frames():
    """33 frames no longer raise: they take the long kernels' plan (one head
    an item in 64-column pieces, tiles 72 wide)."""
    assert ta.launch_sizes((1, 33, 8, 256), 1) == (1, 33, 8, 1, 256, 1, 72, 4, 256)


# ---- the slice at other head counts --------------------------------------------

F, H, W = 4, 32, 32


def _other_heads(cfg):
    """The tiny config with 2 spatial heads (16 and 32 wide), 1 motion head
    (32 and 64 wide) and 2 camera-encoder heads (16 wide)."""
    return dataclasses.replace(
        cfg,
        reference_unet=dataclasses.replace(cfg.reference_unet, attention_heads=2),
        denoising_unet=dataclasses.replace(cfg.denoising_unet, attention_heads=2,
                                           motion_num_heads=1),
        camera_encoder=dataclasses.replace(cfg.camera_encoder, num_heads=2))


@pytest.fixture(scope="module")
def systems():
    js = JCamAnimate(_other_heads(jax_tiny_config()))
    params = jax_system_params(js, F, H, W)
    port = CamAnimate(_other_heads(tiny_config()), device="cpu").load_jax_params(params)
    return js, params, port


def test_other_heads_change_no_parameter_shape(systems):
    js, params, port = systems
    shipped = CamAnimate(tiny_config(), device="cpu")
    for name, module in port.components().items():
        ours = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        theirs = {k: tuple(v.shape)
                  for k, v in getattr(shipped, name).state_dict().items()}
        assert ours == theirs, name
    heads = [m.heads for m in port.denoising_unet.modules() if hasattr(m, "heads")]
    assert set(heads) == {1, 2}


@pytest.mark.parametrize("cfg_mode,context_frames", [("sequential", 24), ("batched", 3)])
def test_pipeline_at_other_head_counts_matches_jax(systems, cfg_mode, context_frames):
    js, params, port = systems
    rng = np.random.default_rng(7)
    ref_image = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((F, H, W, 3)).astype(np.float32)
    clip_image = rng.random((28, 28, 3)).astype(np.float32)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    cams = static_camera((W, H), F)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    kw = dict(num_inference_steps=2, guidance_scale=3.5, context_frames=context_frames,
              context_overlap=1, cfg_mode=cfg_mode, init_latents=init)
    ref = JPipeline(js, params)(ref_image, pose, plucker, clip_image, **kw)
    out = Pose2VideoPipeline(port)(ref_image, pose, plucker, clip_image, **kw)
    assert out.videos.shape == (1, F, H, W, 3)
    np.testing.assert_allclose(out.latents, ref.latents, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.videos, ref.videos, atol=TOL, rtol=0)


@pytest.mark.parametrize("uncond", [False, True])
def test_stage2_loss_at_other_head_counts_matches_jax(systems, uncond):
    """One stage-2 loss (the motion modules' attention and, uncond, the
    reference-KV bias) from the same weights, batch and draws."""
    from test_torch_train import _jax_draws

    js, params, port = systems
    b, f = 2, 2
    rng = np.random.default_rng(8)
    batch = {"tgt": (rng.normal(size=(b, f, H, W, 3)) * 0.5).astype(np.float32),
             "ref": (rng.normal(size=(b, H, W, 3)) * 0.5).astype(np.float32),
             "clip": rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
             "pose": rng.random((b, f, H, W, 3)).astype(np.float32),
             "plucker": rng.normal(size=(b, f, H, W, 6)).astype(np.float32)}
    ratio = 1.0 if uncond else 0.0
    key = jax.random.PRNGKey(3)
    sched = js.make_schedule(beta_schedule="scaled_linear")
    loss_fn = jax.jit(make_loss_fn(js, sched, JTrainConfig(uncond_ratio=ratio)))
    trainable = {k: params[k] for k in TRAIN_COMPONENTS}
    frozen = {k: params[k] for k in ("vae_encoder", "vae_decoder", "clip")}
    ref_loss = float(loss_fn(trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.fold_in(key, 0))[0])
    draws = _jax_draws(key, ratio)
    assert draws.uncond == uncond
    loss, _ = loss_from_draws(port, port.make_schedule(beta_schedule="scaled_linear"),
                              TrainConfig(uncond_ratio=ratio), batch, draws)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
