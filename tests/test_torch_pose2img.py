"""The stage-1 sampler: the port's Pose2ImagePipeline against the JAX
package's at the tiny config, fp32 on the CPU, 32x32, 2 DDIM steps, with
the same weights (through ``from_jax_params``) and the same initial latents:
the JAX pipeline draws them as ``jax.random.normal(rng, (1, h8, w8, 4))``,
and the test hands that draw to the port.

Tolerance 1e-3 on latents and images, as ``tests/test_torch_pose2vid.py``.
"""

import jax
import numpy as np
import pytest

from test_torch_helpers import jax_system_params
from humanvid_tpu.pipelines.pose2img import Pose2ImagePipeline as JPipeline
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu_torch.data.camera import (
    get_relative_pose,
    intrinsics_vector,
    ray_condition,
    static_camera,
)
from humanvid_tpu_torch.pipelines import CamAnimate, Pose2ImagePipeline, tiny_config

TOL = 1e-3
H, W = 32, 32


@pytest.fixture(scope="module")
def systems():
    js = JCamAnimate(jax_tiny_config())
    params = jax_system_params(js, 1, H, W)
    port = CamAnimate(tiny_config(), device="cpu").load_jax_params(params)
    return js, params, port


@pytest.mark.parametrize("guidance_scale", [3.5, 1.0], ids=["cfg", "no_cfg"])
def test_pose2img_matches_jax(systems, guidance_scale):
    js, params, port = systems
    rng = np.random.default_rng(7)
    ref_image = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((H, W, 3)).astype(np.float32)
    clip_image = rng.random((28, 28, 3)).astype(np.float32)
    cams = static_camera((W, H), 1)
    plucker = ray_condition(intrinsics_vector(cams, (W, H)), get_relative_pose(cams), H, W)[0]
    key = jax.random.PRNGKey(3)
    init = np.array(jax.random.normal(key, (1, H // 8, W // 8, 4), js.dtype))
    kw = dict(num_inference_steps=2, guidance_scale=guidance_scale)
    ref = JPipeline(js, params)(ref_image, pose, plucker, clip_image, rng=key, **kw)
    out = Pose2ImagePipeline(port)(ref_image, pose, plucker, clip_image, init_latents=init, **kw)
    assert out.images.shape == (1, H, W, 3) and out.latents.shape == init.shape
    assert ref.images.shape == out.images.shape
    np.testing.assert_allclose(out.latents, ref.latents, atol=TOL, rtol=0)
    np.testing.assert_allclose(out.images, ref.images, atol=TOL, rtol=0)
