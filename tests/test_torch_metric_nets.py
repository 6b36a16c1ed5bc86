"""The metric networks of the port (``humanvid_tpu_torch/metrics/``) against
the JAX package's, on the CPU in float32, at their published widths.

Weights cross over as torch state dicts: the port's
``tools/make_random_metric_weights`` writes them (seeded), the JAX package
converts them with its own ``load_torch_weights`` / ``load_torch_state_dict``,
the port loads them with ``strict=True``. Inputs come from
``np.random.default_rng``. Tolerances, relative to the reference's largest
magnitude: LPIPS at 64x64 1e-4, InceptionV3 (2 images of 64x64 through the
299 resize, 2048 features) 1e-4, I3D (400 logits) 1e-4 at (1, 16, 64, 64)
and at the odd (1, 15, 63, 65), which splits the TF-SAME padding unevenly;
``preprocess_video`` 1e-5 absolute on landscape, portrait and odd clips.
CLIP consistency on a small ``CLIPVisionConfig`` (features 1e-5 on the same
crops, consistency 1e-6); the CLIP-L/14 key set against transformers'; the
weights tool's files against the JAX tool's and loaders."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import init_like
from humanvid_tpu.data.datasets import clip_crop_raw as j_clip_crop_raw
from humanvid_tpu.metrics import i3d as j_i3d
from humanvid_tpu.metrics import inception as j_inception
from humanvid_tpu.metrics import lpips as j_lpips
from humanvid_tpu.metrics import weights as j_weights
from humanvid_tpu.metrics.clip_sim import frame_consistency as j_frame_consistency
from humanvid_tpu.models.clip_vision import CLIPVisionEncoder as JCLIPVisionEncoder
from humanvid_tpu.models.clip_vision import clip_preprocess as j_clip_preprocess
from humanvid_tpu.models.configs import CLIPVisionConfig as JCLIPVisionConfig
from humanvid_tpu_torch.metrics import i3d, inception, lpips
from humanvid_tpu_torch.metrics import weights as W
from humanvid_tpu_torch.metrics.clip_sim import frame_consistency
from humanvid_tpu_torch.models.configs import CLIPVisionConfig
from humanvid_tpu_torch.tools import make_random_metric_weights as mk
from humanvid_tpu_torch.utils.weights import from_jax_params

NET_TOL = 1e-4
PREP_TOL = 1e-5
CLIP_TOL = 1e-5
SIM_TOL = 1e-6
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def rel_err(ours, ref):
    return float(np.abs(np.asarray(ours) - np.asarray(ref)).max() / np.abs(ref).max())


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The port tool's LPIPS, Inception and I3D files (seed 0)."""
    root = str(tmp_path_factory.mktemp("metric_weights"))
    mk.main([root, "--skip-clip"])
    return root


def test_lpips_matches_jax(weights_dir):
    vgg = W.torch_load(os.path.join(weights_dir, W.LPIPS_VGG))
    lins = W.torch_load(os.path.join(weights_dir, W.LPIPS_LINS))
    model = lpips.from_torch(vgg, lins)
    variables = j_lpips.load_torch_weights(numpy_sd(vgg), numpy_sd(lins))
    rng = np.random.default_rng(0)
    a = rng.random((2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ours = lpips.lpips_distance(model, a, b, batch=1)
    ref = np.asarray(jax.jit(j_lpips.LPIPS().apply)(variables, a, b))
    assert ours.shape == (2,) and rel_err(ours, ref) <= NET_TOL
    # the flax variables (eval_pose2img's .msgpack) give the same module
    flax_model = lpips.from_flax(variables)
    for key, value in model.state_dict().items():
        assert torch.equal(flax_model.state_dict()[key], value), key


def test_lpips_lins_alias_and_missing_head(weights_dir):
    vgg = W.torch_load(os.path.join(weights_dir, W.LPIPS_VGG))
    lins = W.torch_load(os.path.join(weights_dir, W.LPIPS_LINS))
    aliased = {k.replace("lin", "lins.", 1): v for k, v in lins.items()}
    a = lpips.from_torch(vgg, lins).state_dict()
    b = lpips.from_torch(vgg, aliased).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    del aliased["lins.4.model.1.weight"]
    with pytest.raises(KeyError, match="stage 4"):
        lpips.from_torch(vgg, aliased)


def test_inception_features_match_jax(weights_dir):
    sd = W.torch_load(os.path.join(weights_dir, W.FID_INCEPTION))
    model = inception.from_torch(sd)
    variables = j_inception.load_torch_state_dict(numpy_sd(sd))
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    ours = inception.fid_features(model, x)
    ref = np.asarray(jax.jit(j_inception.InceptionV3Features().apply)(variables, x))
    assert ours.shape == (2, 2048) and rel_err(ours, ref) <= NET_TOL


@pytest.mark.parametrize("shape", [(1, 16, 64, 64), (1, 15, 63, 65)], ids=["even", "odd"])
def test_i3d_logits_match_jax(weights_dir, shape):
    sd = W.torch_load(os.path.join(weights_dir, W.FVD_I3D))
    model = i3d.from_torch(sd)
    variables = j_i3d.load_torch_state_dict(numpy_sd(sd))
    v = np.random.default_rng(2).uniform(-1, 1, shape + (3,)).astype(np.float32)
    ours = i3d.fvd_logits(model, v)
    ref = np.asarray(jax.jit(j_i3d.I3D().apply)(variables, v))
    assert ours.shape == (1, 400) and rel_err(ours, ref) <= NET_TOL


@pytest.mark.parametrize("n,k,s", [(16, 7, 2), (15, 7, 2), (63, 3, 2), (65, 3, 1), (8, 2, 2),
                                   (7, 1, 1), (5, 3, 3)])
def test_same_padding_splits_as_xla(n, k, s):
    low, high = i3d.same_pads([n], [k], [s])
    (want,) = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert (low, high) == tuple(want)


@pytest.mark.parametrize("shape", [(5, 48, 80, 3), (5, 80, 48, 3), (3, 37, 29, 3),
                                   (2, 224, 300, 3)], ids=["landscape", "portrait", "odd",
                                                          "short_side_224"])
def test_preprocess_video_matches_jax(shape):
    v = np.random.default_rng(3).random(shape).astype(np.float32)
    ours = i3d.preprocess_video(v)
    ref = j_i3d.preprocess_video(v)
    assert ours.shape == ref.shape == (shape[0], 224, 224, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=PREP_TOL, rtol=0)


SMALL_CLIP = dict(image_size=28, patch_size=14, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, projection_dim=32)


@pytest.fixture(scope="module")
def small_clip():
    jcfg = JCLIPVisionConfig(**SMALL_CLIP)
    jmodel = JCLIPVisionEncoder(config=jcfg)
    params = init_like(jmodel, 5, jnp.zeros((1, 28, 28, 3)))
    features = W.make_clip_apply(from_jax_params(params, "clip"), "cpu",
                                 CLIPVisionConfig(**SMALL_CLIP), clip_batch=3)
    return jmodel, params, features


def test_clip_features_and_consistency_match_jax(small_clip):
    jmodel, params, features = small_clip
    frames = np.random.default_rng(4).random((5, 48, 32, 3)).astype(np.float32)
    ours = features(frames)
    crops = features.crops(frames)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(p, j_clip_preprocess(x)))(params, crops))
    assert ours.shape == (5, 32) and rel_err(ours, ref) <= CLIP_TOL
    assert abs(frame_consistency(ours) - j_frame_consistency(jnp.asarray(ref))) <= SIM_TOL
    # the crops: the JAX package's PIL bicubic within one uint8 level
    u8 = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    want = np.stack([j_clip_crop_raw(f, 28) for f in u8])
    assert np.abs(crops - want).max() * 255 <= 1 + 1e-3


def test_frame_consistency_matches_jax():
    feats = np.random.default_rng(6).normal(size=(7, 768)).astype(np.float32)
    assert abs(frame_consistency(feats) - j_frame_consistency(jnp.asarray(feats))) <= SIM_TOL


def test_clip_weights_need_every_key(small_clip):
    _, params, _ = small_clip
    sd = from_jax_params(params, "clip")
    del sd["visual_projection.weight"]
    with pytest.raises(KeyError, match="visual_projection"):
        W.make_clip_apply(sd, "cpu", CLIPVisionConfig(**SMALL_CLIP))


def test_clip_l14_key_set_is_transformers(monkeypatch, tmp_path):
    transformers = pytest.importorskip("transformers")
    saved = {}
    monkeypatch.setattr(mk, "_normal", lambda shape, mean, std, gen: torch.empty(
        shape, device="meta"))
    monkeypatch.setattr(mk, "_save", lambda sd, path: saved.update(sd=sd, path=path))
    mk.make_clip(str(tmp_path), torch.Generator())
    cfg = transformers.CLIPVisionConfig(
        image_size=224, patch_size=14, hidden_size=1024, num_hidden_layers=24,
        num_attention_heads=16, intermediate_size=4096, projection_dim=768,
        hidden_act="quick_gelu")
    with torch.device("meta"):
        hf = transformers.CLIPVisionModelWithProjection(cfg)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    assert saved["path"].endswith(W.CLIP_VITL14)
    assert {k: tuple(v.shape) for k, v in saved["sd"].items()} == want
    assert {v.dtype for v in saved["sd"].values()} == {torch.float16}


@pytest.fixture(scope="module")
def jax_tool_dir(tmp_path_factory):
    """The JAX tool's LPIPS, Inception and I3D files."""
    sys.path.insert(0, TOOLS)
    try:
        import make_random_metric_weights as jmk
    finally:
        sys.path.remove(TOOLS)
    root = str(tmp_path_factory.mktemp("jax_metric_weights"))
    rng = np.random.default_rng(0)
    jmk.make_lpips(root, rng)
    jmk.make_inception(root, rng)
    jmk.make_i3d(root, rng)
    return root


@pytest.mark.parametrize("name", [W.LPIPS_VGG, W.LPIPS_LINS, W.FID_INCEPTION, W.FVD_I3D])
def test_weight_files_have_the_jax_tools_keys_and_shapes(weights_dir, jax_tool_dir, name):
    ours = W.torch_load(os.path.join(weights_dir, name))
    ref = W.torch_load(os.path.join(jax_tool_dir, name))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_jax_tools_files_load_into_the_port(jax_tool_dir):
    nets = W.load_metric_nets(jax_tool_dir, "cpu")
    assert set(nets) == {"lpips_model", "inception_model", "i3d_model"}
    sd = W.torch_load(os.path.join(jax_tool_dir, W.FVD_I3D))
    assert torch.equal(nets["i3d_model"].state_dict()["Mixed_5c.b3b.bn.running_var"],
                       sd["Mixed_5c.b3b.bn.running_var"])


def test_port_tools_files_load_into_the_jax_package(weights_dir):
    nets = j_weights.load_metric_nets(weights_dir)
    assert set(nets) == {"lpips_variables", "inception_variables", "i3d_variables"}
    z = jnp.zeros((1, 64, 64, 3))
    want = {
        "lpips_variables": jax.eval_shape(lambda: j_lpips.LPIPS().init(
            jax.random.PRNGKey(0), z, z)),
        "inception_variables": jax.eval_shape(lambda: j_inception.InceptionV3Features().init(
            jax.random.PRNGKey(0), z)),
        "i3d_variables": jax.eval_shape(lambda: j_i3d.I3D().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 64, 64, 3)))),
    }
    for key, tree in want.items():
        shapes = jax.tree.map(lambda a: tuple(np.shape(a)), nets[key])
        assert shapes == jax.tree.map(lambda s: tuple(s.shape), tree), key


def test_value_laws():
    gen = torch.Generator().manual_seed(0)
    sd = mk.random_state_dict(inception.InceptionV3Features, mk.conv_bn_law, gen)
    conv = sd["Mixed_6b.branch7x7_2.conv.weight"]
    assert abs(float(conv.std()) - 0.05) < 0.002 and abs(float(conv.mean())) < 0.002
    assert float(sd["Mixed_6b.branch7x7_2.bn.running_var"].min()) > 0.9
    assert not sd["Mixed_6b.branch7x7_2.bn.bias"].any()
    lins = mk.random_state_dict(lpips.LPIPS, mk.lpips_law, gen)
    assert float(lins["lin3.model.1.weight"].min()) >= 0
    again = mk.random_state_dict(inception.InceptionV3Features, mk.conv_bn_law,
                                 torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
