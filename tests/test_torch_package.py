"""The port stands alone: it imports neither JAX nor the JAX package, and its
weight conversion yields exactly the JAX package's exported key set."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_helpers import init_like
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.utils.convert import export_state_dict
from humanvid_tpu_torch.pipelines.system import COMPONENT_KINDS
from humanvid_tpu_torch.utils.weights import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "humanvid_tpu_torch").rglob("*.py")) + \
    sorted((ROOT / "humanvid_tpu_torch").rglob("*.cu")) + [ROOT / "chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "humanvid_tpu_torch").rglob("*.py"))


def test_import_blocks_jax_and_reference_package():
    """Importing every port module (and chip_smoke) with jax, flax and
    humanvid_tpu made unimportable succeeds and loads none of them."""
    modules = PORT_MODULES
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'humanvid_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'humanvid_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr


@pytest.mark.parametrize("module", [
    "humanvid_tpu_torch.cli.pose2vid", "humanvid_tpu_torch.cli.pose2img",
    "humanvid_tpu_torch.utils.config", "humanvid_tpu_torch.utils.convert",
    "humanvid_tpu_torch.pipelines.interpolation", "humanvid_tpu_torch.data.video_io",
    "humanvid_tpu_torch.data.datasets", "humanvid_tpu_torch.data.samplers",
    "humanvid_tpu_torch.data.loader", "humanvid_tpu_torch.data.__init__",
    "humanvid_tpu_torch.utils.profiling", "humanvid_tpu_torch.utils.tracker",
    "humanvid_tpu_torch.train.state", "humanvid_tpu_torch.train.step",
    "humanvid_tpu_torch.train.checkpoint", "humanvid_tpu_torch.cli.train_stage_1",
    "humanvid_tpu_torch.cli.train_stage_2"])
def test_import_check_covers_the_command_line_slice(module):
    assert module in PORT_MODULES


BLOCKED_AT_IMPORT = ("jax", "jaxlib", "flax", "humanvid_tpu", "msgpack", "transformers", "cv2",
                     "PIL")


def test_import_blocks_msgpack_transformers_opencv_and_pil():
    """Every port module (and chip_smoke) imports with none of jax, flax,
    the JAX package, msgpack, transformers, OpenCV or PIL importable: the
    card's machine has none of them, and OpenCV is imported where video
    files are read or written."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED_AT_IMPORT!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED_AT_IMPORT!r} "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr


@pytest.mark.parametrize("module", [
    "humanvid_tpu_torch.metrics.__init__", "humanvid_tpu_torch.metrics.frame",
    "humanvid_tpu_torch.metrics.frechet", "humanvid_tpu_torch.metrics.clip_sim",
    "humanvid_tpu_torch.metrics.lpips", "humanvid_tpu_torch.metrics.inception",
    "humanvid_tpu_torch.metrics.i3d", "humanvid_tpu_torch.metrics.weights",
    "humanvid_tpu_torch.metrics.runner", "humanvid_tpu_torch.metrics.nets",
    "humanvid_tpu_torch.cli.eval_pose2vid", "humanvid_tpu_torch.cli.eval_pose2img",
    "humanvid_tpu_torch.tools.make_random_metric_weights", "humanvid_tpu_torch.tools.eval_gate",
    "humanvid_tpu_torch.utils.msgpack"])
def test_import_checks_cover_the_evaluation_slice(module):
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "humanvid_tpu_torch.data.pose_draw", "humanvid_tpu_torch.data.native_video",
    "humanvid_tpu_torch.data.meta_tools", "humanvid_tpu_torch.data.visualization",
    "humanvid_tpu_torch.native.__init__", "humanvid_tpu_torch.pose.__init__",
    "humanvid_tpu_torch.pose.onnx_reader", "humanvid_tpu_torch.pose.yolox",
    "humanvid_tpu_torch.pose.rtmpose", "humanvid_tpu_torch.pose.detector",
    "humanvid_tpu_torch.pose.smplx", "humanvid_tpu_torch.tools.prepare_videos",
    "humanvid_tpu_torch.tools.build_meta", "humanvid_tpu_torch.tools.make_random_pose_weights",
    "humanvid_tpu_torch.cli.convert_weights"])
def test_import_checks_cover_the_data_preparation_slice(module):
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "humanvid_tpu_torch.parallel.__init__", "humanvid_tpu_torch.parallel.mesh",
    "humanvid_tpu_torch.parallel.launch", "humanvid_tpu_torch.tools.dryrun_multichip",
    "humanvid_tpu_torch.tools.bench_configs", "humanvid_tpu_torch.tools.loader_bench"])
def test_import_checks_cover_the_parallel_slice(module):
    assert module in PORT_MODULES


def test_rasterizer_and_crops_never_import_opencv():
    """``pose_draw``, ``letterbox`` and ``crop_affine`` run with OpenCV made
    unimportable (the card's machine has none)."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import numpy as np, torch\n"
        "from humanvid_tpu_torch.data.pose_draw import draw_pose\n"
        "from humanvid_tpu_torch.pose import rtmpose, yolox\n"
        "pose = {'bodies': {'candidate': np.array([[0.2, 0.3], [0.5, 0.6]]),\n"
        "                   'subset': np.array([[0, 1] + [-1] * 16], float)},\n"
        "        'hands': [np.full((21, 2), 0.4)], 'faces': [np.full((68, 2), 0.5)],\n"
        "        'feet': [np.full((6, 2), 0.6)]}\n"
        "assert draw_pose(pose, 32, 48).max() > 0\n"
        "img = torch.zeros(40, 60, 3, dtype=torch.uint8)\n"
        "assert yolox.letterbox(img)[0].shape == (640, 640, 3)\n"
        "c, s = rtmpose.bbox_to_center_scale(np.array([5, 5, 30, 35], np.float32))\n"
        "assert rtmpose.crop_affine(img, c, s)[0].shape == (384, 288, 3)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_jax_or_reference_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", text, re.M)
    assert not re.search(r"\bhumanvid_tpu\.", text)
    assert not re.search(r"^\s*(import|from)\s+humanvid_tpu\b(?!_)", text, re.M)


def _jax_tree(js, name):
    c = js.config
    import jax
    import jax.numpy as jnp

    ctx = jnp.zeros((1, 1, c.reference_unet.cross_attention_dim))
    t = jnp.zeros((1,))
    lat = jnp.zeros((1, 4, 4, 4))
    if name == "reference_unet":
        return init_like(js.reference_unet, 0, lat, t, ctx, collect_ref_features=True)
    if name == "denoising_unet":
        pref = init_like(js.reference_unet, 0, lat, t, ctx, collect_ref_features=True)
        _, feats = jax.eval_shape(lambda: js.reference_unet.apply(
            pref, lat, t, ctx, collect_ref_features=True))
        return init_like(js.denoising_unet, 1, jnp.zeros((2, 4, 4, 4)), t, ctx,
                         ref_features=[jnp.zeros(f.shape) for f in feats], frames=2)
    img = jnp.zeros((1, 32, 32, 3))
    args = {
        "pose_guider": (img,),
        "camera_encoder": (jnp.zeros((2, 32, 32, 6)), 2),
        "vae_encoder": (img,),
        "vae_decoder": (lat,),
        "clip": (jnp.zeros((1, 28, 28, 3)),),
    }[name]
    return init_like(getattr(js, name), 2, *args)


@pytest.mark.parametrize("component", sorted(COMPONENT_KINDS))
def test_from_jax_params_matches_export_state_dict(component):
    js = JCamAnimate(jax_tiny_config())
    tree = _jax_tree(js, component)
    kind = COMPONENT_KINDS[component]
    ours = from_jax_params(tree, kind)
    ref = export_state_dict(tree, kind)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_chip_smoke_cites_each_tpu_kernel_at_its_def():
    """Every ``file:line`` that ``chip_smoke.py``'s kernel line gives as the
    TPU kernel a CUDA kernel replaces is the line of that function's ``def``
    (the Pallas kernel itself, or the function that reaches
    ``pl.pallas_call``)."""
    text = (ROOT / "chip_smoke.py").read_text()
    cites = re.findall(r'"((?:humanvid_tpu/ops|tools)/\w+\.py):(\d+)"', text)
    assert len(cites) >= 12
    for path, line in cites:
        src = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert src.lstrip().startswith("def "), (path, line, src)
