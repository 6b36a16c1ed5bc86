"""The whole slice: the port's Pose2VideoPipeline against the JAX package's
at the tiny config, fp32 on the CPU, 32x32, 4 frames, 2 DDIM steps, with the
same weights and the same initial latents (the two RNGs differ).

Tolerance 1e-3 on latents and videos, the UNet's tolerance: the pipeline is
two steps of UNet passes plus encode and decode. The sampler options (latent
interpolation before the decode, the leading and linspace spacings, a
schedule without ``set_alpha_to_one``) are held the same way.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_helpers import jax_system_params
from humanvid_tpu.data.camera import (
    get_relative_pose as j_relative_pose,
    intrinsics_vector as j_intrinsics,
    ray_condition as j_ray_condition,
    static_camera as j_static_camera,
)
from humanvid_tpu.diffusion.schedule import make_noise_schedule as j_make_noise_schedule
from humanvid_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu_torch.data.camera import (
    get_relative_pose,
    intrinsics_vector,
    ray_condition,
    static_camera,
)
from humanvid_tpu_torch.diffusion.schedule import make_noise_schedule
from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline, tiny_config

TOL = 1e-3
F, H, W = 4, 32, 32


@pytest.fixture(scope="module")
def systems():
    js = JCamAnimate(jax_tiny_config())
    params = jax_system_params(js, F, H, W)
    port = CamAnimate(tiny_config(), device="cpu").load_jax_params(params)
    return js, params, port


def test_camera_rays_match():
    cams, jcams = static_camera((W, H), F), j_static_camera((W, H), F)
    K, jK = intrinsics_vector(cams, (W, H)), j_intrinsics(jcams, (W, H))
    c2w, jc2w = get_relative_pose(cams), j_relative_pose(jcams)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(c2w, jc2w)
    np.testing.assert_allclose(ray_condition(K, c2w, H, W), j_ray_condition(jK, jc2w, H, W),
                               atol=1e-6)


@pytest.mark.parametrize("cfg_mode,context_frames", [
    ("sequential", 24),   # the flagship form: one window, two passes per step
    ("batched", 3),       # two overlapping windows, CFG rows in one pass
])
def test_pipeline_matches_jax(systems, cfg_mode, context_frames):
    js, params, port = systems
    rng = np.random.default_rng(5)
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
    assert out.videos.shape == (1, F, H, W, 3) and out.latents.shape == init.shape
    np.testing.assert_allclose(out.latents, ref.latents, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.videos, ref.videos, atol=TOL, rtol=0)


@pytest.mark.parametrize("rate,mode,spacing,alpha_to_one", [
    (2, "slerp", "trailing", True),
    (2, "linear", "trailing", True),
    (1, "slerp", "leading", True),
    (3, "slerp", "linspace", False),
], ids=["slerp2", "linear2", "leading", "linspace3-final-alpha"])
def test_pipeline_options_match_jax(systems, rate, mode, spacing, alpha_to_one):
    js, params, port = systems
    js = type(js)(dataclasses.replace(js.config, timestep_spacing=spacing))
    port = CamAnimate(dataclasses.replace(port.config, timestep_spacing=spacing),
                      device="cpu").load_jax_params(params)
    rng = np.random.default_rng(6)
    ref_image = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((F, H, W, 3)).astype(np.float32)
    clip_image = rng.random((28, 28, 3)).astype(np.float32)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    cams = static_camera((W, H), F)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)
    kw = dict(num_inference_steps=2, guidance_scale=3.5, context_overlap=1, init_latents=init,
              interpolation_rate=rate, interpolation_mode=mode)
    jpipe, pipe = JPipeline(js, params), Pose2VideoPipeline(port)
    if not alpha_to_one:  # neither config has the switch: set the schedule on both
        c = port.config
        sched_kw = dict(num_train_timesteps=c.num_train_timesteps, beta_start=c.beta_start,
                        beta_end=c.beta_end, beta_schedule=c.beta_schedule,
                        rescale_betas_zero_snr=c.rescale_betas_zero_snr,
                        prediction_type=c.prediction_type, set_alpha_to_one=False)
        jpipe.sched = j_make_noise_schedule(**sched_kw)
        pipe.sched = make_noise_schedule(**sched_kw)
    ref = jpipe(ref_image, pose, plucker, clip_image, **kw)
    out = pipe(ref_image, pose, plucker, clip_image, **kw)
    frames = F + (F - 1) * (rate - 1)
    assert out.videos.shape == ref.videos.shape == (1, frames, H, W, 3)
    assert out.latents.shape == init.shape
    np.testing.assert_allclose(out.latents, ref.latents, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.videos, ref.videos, atol=TOL, rtol=0)
