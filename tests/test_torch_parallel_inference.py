"""The window x CFG fan-out of the port's ``Pose2VideoPipeline`` on gloo ranks
(spawned with ``parallel.launch``) against the JAX pipeline sharded over its
virtual CPU mesh, fp32, tiny config, 32x32, 12 frames, context 8, overlap 4
(3 windows), 2 DDIM steps, the same weights and initial latents:

- CFG at 2 ranks (6 rows, 3 a rank), against ``make_mesh(2)``;
- padded: 6 rows over 4 ranks (2 copies of window 0 a bank), against
  ``make_mesh(4)``;
- no CFG at 2 ranks (3 rows padded to 4), against ``make_mesh(2)``.

Tolerances are the JAX fan-out test's (``tests/test_parallel_inference.py``):
latents 2e-4, videos 2e-3. Every rank holds the same latents bit for bit;
rank 0 decodes and the others return no video. Then the dry run,
``python -m humanvid_tpu_torch.tools.dryrun_multichip --ranks 8``, prints
the counterpart of ``MULTICHIP_r05.json``'s lines.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from test_torch_helpers import jax_system_params
from humanvid_tpu.parallel.mesh import make_mesh as j_make_mesh
from humanvid_tpu.pipelines import Pose2VideoPipeline as JPipeline
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu_torch.data.camera import (
    get_relative_pose,
    intrinsics_vector,
    ray_condition,
    static_camera,
)
from humanvid_tpu_torch.parallel.launch import launch
from humanvid_tpu_torch.pipelines import CamAnimate, Pose2VideoPipeline, tiny_config
from humanvid_tpu_torch.tools.dryrun_multichip import fanout_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 12, 32, 32


@pytest.fixture(scope="module")
def setup():
    js = JCamAnimate(jax_tiny_config(motion_max_len=8))
    params = jax_system_params(js, 8, H, W)
    rng = np.random.default_rng(0)
    ref = rng.random((H, W, 3)).astype(np.float32)
    pose = rng.random((F, H, W, 3)).astype(np.float32)
    clip = rng.random((28, 28, 3)).astype(np.float32)
    cams = static_camera((W, H), F + 1)
    plucker = ray_condition(intrinsics_vector(cams[1:], (W, H)), get_relative_pose(cams)[1:],
                            H, W)
    init = rng.normal(size=(F, H // 8, W // 8, 4)).astype(np.float32)
    port = CamAnimate(tiny_config(motion_max_len=8), device="cpu").load_jax_params(params)
    state_dicts = {n: m.state_dict() for n, m in port.components().items()}
    return js, params, (ref, pose, plucker, clip), init, state_dicts


@pytest.mark.parametrize("ranks,guidance", [(2, 3.5), (4, 3.5), (2, 1.0)],
                         ids=["cfg-2ranks", "padded-6rows-4ranks", "nocfg-2ranks"])
def test_fan_out_matches_jax_sharded(setup, ranks, guidance):
    js, params, inputs, init, state_dicts = setup
    kw = dict(num_inference_steps=2, guidance_scale=guidance, context_frames=8,
              context_overlap=4, init_latents=init)
    ref = JPipeline(js, params, mesh=j_make_mesh(ranks))(*inputs, **kw)
    spec = dict(config=tiny_config(motion_max_len=8), state_dicts=state_dicts, device="cpu",
                inputs=inputs, kwargs=kw)
    out = launch(fanout_worker, ranks, args=(spec,), timeout_s=120, join_timeout_s=300)
    assert out[0]["videos"].shape == ref.videos.shape
    assert all(r["videos"] is None for r in out[1:])
    for r in out[1:]:
        np.testing.assert_array_equal(r["latents"], out[0]["latents"])
    np.testing.assert_allclose(out[0]["latents"], ref.latents, atol=2e-4)
    np.testing.assert_allclose(out[0]["videos"], ref.videos, atol=2e-3)


def test_sequential_windows_take_no_mesh(setup):
    """``window_mode="sequential"`` is the single-device mode, as the JAX
    pipeline asserts; on one process the pipeline takes no mesh at all."""
    _, _, inputs, init, state_dicts = setup
    spec = dict(config=tiny_config(motion_max_len=8), state_dicts=state_dicts, device="cpu",
                inputs=inputs,
                kwargs=dict(num_inference_steps=1, context_frames=8, context_overlap=4,
                            init_latents=init, window_mode="sequential"))
    with pytest.raises(Exception, match="sequential.*takes no mesh"):
        launch(fanout_worker, 2, args=(spec,), timeout_s=120, join_timeout_s=300)
    assert Pose2VideoPipeline(CamAnimate(tiny_config(), device="cpu")).mesh is None


def test_dryrun_multichip_prints_the_jax_records_lines():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "humanvid_tpu_torch.tools.dryrun_multichip",
                          "--ranks", "8", "--device", "cpu", "--timeout", "240"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("dryrun_multichip(8) OK: loss=")
    flat = float(lines[0].rsplit("=", 1)[1])
    assert lines[1].startswith("dryrun_multichip(8) hierarchical 2x4 OK: loss=")
    assert abs(float(lines[1].rsplit("=", 1)[1]) - flat) < 1e-4
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        record = json.load(f)
    jax_line = record["tail"].strip().splitlines()[-1]
    assert lines[2] == jax_line.replace("8 devices", "8 ranks")
