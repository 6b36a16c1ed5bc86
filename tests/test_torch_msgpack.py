"""The port's reader of flax ``.msgpack`` trees (``utils/msgpack.py``):
trees written by ``flax.serialization`` (the tiny system's parameters, an
LPIPS variables tree, every leaf kind flax writes, chunked arrays) read back
bit for bit against flax's own ``msgpack_restore``; ``.msgpack``
checkpoints load into the port (``utils/weights.py:load_pretrained``)
exactly as the JAX ``load_pretrained_params`` loads them; and the encoder
``chip_smoke.py`` writes its LPIPS file with is read by flax."""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from test_torch_helpers import fill_params, init_like, jax_system_params
from humanvid_tpu.metrics.lpips import LPIPS as JLPIPS
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.utils.weights import load_pretrained_params
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.pipelines.system import COMPONENT_KINDS
from humanvid_tpu_torch.utils.msgpack import load_msgpack, msgpack_restore
from humanvid_tpu_torch.utils.weights import from_jax_params, load_pretrained


def assert_same_tree(ours, ref, path=""):
    """Equal structure; arrays equal bit for bit in dtype and shape (flax's
    bfloat16 leaves against their float32 widening)."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), path
        for k in ref:
            assert_same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == jnp.bfloat16:
        assert ours.dtype == np.float32 and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, np.asarray(ref, np.float32), err_msg=path)
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref) and ours.dtype == ref.dtype, path
        assert ours.shape == ref.shape, path
        np.testing.assert_array_equal(np.atleast_1d(ours).view(np.uint8),
                                      np.atleast_1d(ref).view(np.uint8), err_msg=path)
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_same_tree(a, b, f"{path}/{i}")
    else:
        assert type(ours) is type(ref) and ours == ref, path


@pytest.fixture(scope="module")
def tiny_params():
    return jax_system_params(JCamAnimate(jax_tiny_config()), 2, 64, 64)


@pytest.mark.parametrize("component", sorted(COMPONENT_KINDS))
def test_tiny_system_trees_read_bit_for_bit(tiny_params, component, tmp_path):
    path = tmp_path / f"{component}.msgpack"
    path.write_bytes(serialization.to_bytes(tiny_params[component]))
    data = path.read_bytes()
    assert_same_tree(load_msgpack(str(path)), serialization.msgpack_restore(data))


def test_lpips_variables_read_bit_for_bit():
    variables = init_like(JLPIPS(), 3, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3)))
    data = serialization.to_bytes(variables)
    ours = msgpack_restore(data)
    assert_same_tree(ours, serialization.msgpack_restore(data))
    assert ours["params"]["vgg"]["conv_28"]["kernel"].shape == (3, 3, 512, 512)


def test_every_leaf_kind_reads_as_flax_reads_it():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(300,)),
        "f16": rng.normal(size=(2, 2, 2)).astype(np.float16),
        "i64": np.arange(-5, 5, dtype=np.int64),
        "u8": rng.integers(0, 256, (7,), dtype=np.uint8),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(9,)), jnp.bfloat16)),
        "scalar": np.float32(2.5),
        "nested": {"a": {"b": np.ones((1,), np.int32)}},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -200, -2**20, -2**40],
        "floats": 1.5,
        "text": "x" * 40,
        "long_text": "y" * 70000,
        "flag": True,
        "none": None,
        "complex": 1 + 2j,
    }
    data = serialization.msgpack_serialize(tree)
    assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_chunked_arrays_are_joined(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    w = np.random.default_rng(1).normal(size=(10, 7)).astype(np.float32)
    data = serialization.msgpack_serialize({"w": w, "deep": {"v": w[:3]}})
    ours = msgpack_restore(data)
    np.testing.assert_array_equal(ours["w"], w)
    assert_same_tree(ours, serialization.msgpack_restore(data))


def test_truncated_and_trailing_data_raise():
    data = serialization.msgpack_serialize({"w": np.ones((4,), np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")


@pytest.fixture(scope="module")
def jax_side(tiny_params):
    """(a JAX system whose ``init_params`` gives seeded weights, other
    seeded weights written as the ``.msgpack`` checkpoints)."""
    start = {name: fill_params(tree, 200 + i) for i, (name, tree) in enumerate(tiny_params.items())}
    return types.SimpleNamespace(init_params=lambda *a, **k: copy.deepcopy(start)), tiny_params


def test_msgpack_checkpoints_load_as_jax_loads_them(tmp_path, jax_side):
    js, params = jax_side
    cfg = {}
    for key, name in (("pose_guider_path", "pose_guider"),
                      ("camera_pose_encoder_path", "camera_encoder"),
                      ("reference_unet_path", "reference_unet"),
                      ("denoising_unet_path", "denoising_unet")):
        path = tmp_path / f"{name}-0.msgpack"
        path.write_bytes(serialization.to_bytes(params[name]))
        cfg[key] = str(path)
    ref = load_pretrained_params(js, cfg)
    port = load_pretrained(
        CamAnimate(tiny_config(), device="cpu").load_jax_params(js.init_params()), cfg)
    for name, module in port.components().items():
        want = from_jax_params(ref[name], COMPONENT_KINDS[name])
        got = module.state_dict()
        assert set(got) == set(want), name
        for key, value in want.items():
            assert torch.equal(got[key], value), f"{name}: {key}"
    # the files, not the starting weights, are what loaded
    got = port.pose_guider.state_dict()
    for key, value in from_jax_params(params["pose_guider"], "pose_guider").items():
        assert torch.equal(got[key], value), key


def test_a_motion_module_msgpack_loads_into_the_bf16_module(tmp_path, jax_side):
    js, params = jax_side
    path = tmp_path / "motion_module-0.msgpack"
    path.write_bytes(serialization.to_bytes(params["denoising_unet"]))
    system = CamAnimate(tiny_config(), device="cpu", dtype=torch.bfloat16)
    load_pretrained(system, {"motion_module_path": str(path)})
    want = from_jax_params(params["denoising_unet"], "unet")
    for key, value in system.denoising_unet.state_dict().items():
        assert value.dtype == torch.bfloat16
        assert torch.equal(value, want[key].to(torch.bfloat16)), key


def test_a_tree_of_another_component_raises(tmp_path, jax_side):
    js, params = jax_side
    path = tmp_path / "pose_guider.msgpack"
    path.write_bytes(serialization.to_bytes(params["camera_encoder"]))
    with pytest.raises(ValueError):
        load_pretrained_params(js, {"pose_guider_path": str(path)})
    with pytest.raises(ValueError, match="pose_guider.msgpack"):
        load_pretrained(CamAnimate(tiny_config(), device="cpu"),
                        {"pose_guider_path": str(path)})


def test_chip_smoke_encoder_is_read_by_flax():
    rng = np.random.default_rng(2)
    tree = {"params": {"vgg": {"conv_0": {"kernel": rng.normal(size=(3, 3, 3, 64)).astype(
        np.float32), "bias": np.zeros(64, np.float32)}}, "lin_0": np.abs(rng.normal(
            size=(64,))).astype(np.float32)}}
    data = chip_smoke._msgpack_bytes(np, tree)
    assert_same_tree(serialization.msgpack_restore(data), tree)
    assert_same_tree(msgpack_restore(data), tree)
