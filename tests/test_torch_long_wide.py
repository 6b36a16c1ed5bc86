"""The last shapes the attention kernels take, on the CPU: kernel B past 32
frames and kernel A past 512 columns, against the JAX package.

- The motion module without a position table (``use_pe=False``) takes more
  frames than ``max_len``, as the JAX block does; with the table it still
  raises there (the JAX block fails to broadcast). fp32, atol 1e-5.
- Kernel B's autograd Function (on CPU tensors: the plain versions) at
  f = 33, 48 and 64, forward and gradients, against the JAX Pallas kernel
  and its vjp in TPU interpret mode. atol 1e-5: both sides compute in fp32
  and differ by summation order only (observed near 1e-6).
- Kernel A's ``flash_attention_packed`` at d = 520 and 640, forward and
  gradients, with and without the bias, against the JAX kernel and its vjp
  in interpret mode, at the tolerances of ``test_torch_flash_attention.py``
  (2e-4 forward, 5e-4 gradients; observed near 1e-6).
- The plans: d > 512 and f > 32 get the new kernels' plans, every d <= 512
  and f <= 32 the plan it had.
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
    (1, 64, 3, 256, 1),    # 64 frames, d = 256 (four 64-column pieces)
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

@pytest.mark.parametrize("d", [520, 640])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_past_512_columns_matches_jax(d, with_bias):
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


# ---- the plans ------------------------------------------------------------------------

XWIDE = ("Xwide", "XwideDv+XwideDk/XwideDq")


@pytest.mark.parametrize("d,plan", [
    (513, fa.FlashPlan(520, *XWIDE)),     # past 512: the xwide kernels, padded to 8
    (520, fa.FlashPlan(520, *XWIDE)),
    (640, fa.FlashPlan(640, *XWIDE)),     # one spatial head at UNet level 1
    (1280, fa.FlashPlan(1280, *XWIDE)),   # one head at levels 2-3
    (4100, fa.FlashPlan(4104, *XWIDE)),
    (40, fa.FlashPlan(40, "Cfg<48, 40>", "DkvCfg48/DqCfg48")),  # unchanged below
    (128, fa.FlashPlan(128, "Cfg<128, 128, swizzled>", "DkvCfg128w/DqCfg128w")),
    (320, fa.FlashPlan(512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq")),
    (512, fa.FlashPlan(512, "Cfg<512, 256, wide>", "WideDv+WideDk/WideDq")),
])
def test_flash_plan_past_512_and_below(d, plan):
    assert fa.flash_plan(d) == plan


@pytest.mark.parametrize("shape,heads,sizes", [
    # past 32 frames: one head an item in 64-column pieces, tiles 72 wide
    ((1, 33, 8, 256), 1, (1, 33, 8, 1, 256, 1, 72, 4, 256)),
    ((1, 48, 6144, 320), 8, (1, 48, 6144, 8, 40, 1, 72, 1, 40)),   # level 0 of the long path
    ((1, 48, 1792, 640), 8, (1, 48, 1792, 8, 80, 1, 72, 2, 80)),
    ((1, 96, 96, 1280), 8, (1, 96, 96, 8, 160, 1, 72, 3, 160)),
    ((1, 64, 9, 1280), 1, (1, 64, 9, 1, 1280, 1, 72, 20, 1280)),
    # up to 32 frames: the item kernels' plans as before
    ((1, 32, 8, 256), 1, (1, 32, 8, 1, 256, 1, 136, 2, 256)),
    ((1, 24, 7168, 320), 8, (1, 24, 7168, 8, 40, 4, 168, 1, 40)),
    ((8, 1, 7168, 320), 8, (8, 1, 7168, 8, 40, 4, 168, 1, 40)),
    ((1, 24, 448, 1280), 8, (1, 24, 448, 8, 160, 1, 168, 1, 160)),
])
def test_launch_sizes_past_32_frames_and_below(shape, heads, sizes):
    assert ta.launch_sizes(shape, heads) == sizes
    plan = ta.temporal_plan(shape[-1], heads, shape[1])
    assert (plan.heads, plan.padded, plan.chunks) == sizes[5:8]


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
