"""The DWPose networks and their host code against the JAX package on the CPU.

Weights are seeded with numpy in the upstream key layouts
(``tools/make_random_pose_weights.py``); the JAX side gets them through its
own converters (``load_torch_state_dict``), so both compute with the same
values. Tolerances:

- YOLOX's decoded predictions and DWPose's SimCC logits: 1e-4 of the
  largest magnitude (fp32, summation order only);
- ``letterbox`` against OpenCV's ``resize`` (11-bit fixed-point weights):
  1 uint8 level; ``crop_affine`` against ``warpAffine``: 1 level (measured
  at most 1, on noise and on smooth images);
- ``nms``, ``postprocess_person``, ``simcc_decode``, ``crop_to_image``,
  ``wholebody_to_openpose``, ``to_draw_format``: exact;
- the whole detector: boxes within 1 px; a keypoint may differ only where
  the JAX logits' top two are closer than twice the largest logit
  difference the two crops make, and the others within 0.5 px.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from humanvid_tpu.pose import detector as jdet
from humanvid_tpu.pose import rtmpose as jrt
from humanvid_tpu.pose import yolox as jyx
from humanvid_tpu.pose.onnx_reader import read_onnx_initializers as j_read_onnx
from humanvid_tpu_torch.pose import detector as tdet
from humanvid_tpu_torch.pose import rtmpose as trt
from humanvid_tpu_torch.pose import yolox as tyx
from humanvid_tpu_torch.pose.onnx_reader import read_onnx_initializers
from humanvid_tpu_torch.tools import make_random_pose_weights as mk

torch.set_num_threads(2)
TINY = dict(dep=1, wid=8)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * scale, (err, scale)


def _frame(h, w, seed):
    """A seeded frame with structure at several scales (RGB uint8)."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.random((3, 6, 8) if w > h else (3, 8, 6)) * 255)[None]
    img = F.interpolate(base.float(), size=(h, w), mode="bicubic", align_corners=False)[0]
    img = img.permute(1, 2, 0).numpy() + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tiny_yolox():
    """(port module, JAX variables) of the tiny YOLOX with detecting weights."""
    model = tyx.YOLOX(**TINY)
    sd = mk.detecting_yolox(model, 0)
    model = tdet.load_module(tyx.YOLOX(**TINY), sd).eval()
    return model, jyx.load_torch_state_dict(sd)


@pytest.fixture(scope="module")
def dwpose():
    """(port module, JAX variables, jitted JAX apply) of DWPose."""
    model = trt.DWPoseModel()
    sd = mk.random_state_dict(model, 1)
    tdet.load_module(model, sd).eval()
    return model, jrt.load_torch_state_dict(sd), jax.jit(jrt.DWPoseModel().apply)


# --- the ONNX reader ----------------------------------------------------------

def test_onnx_reader_hand_encoded(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.array([0.5, -1.0], np.float32)
    path = tmp_path / "m.onnx"
    path.write_bytes(mk.onnx_bytes({"conv.weight": w, "bias": b}))
    ours, ref = read_onnx_initializers(str(path)), j_read_onnx(str(path))
    assert list(ours) == list(ref) == ["conv.weight", "bias"]
    np.testing.assert_array_equal(ours["conv.weight"], w)
    np.testing.assert_array_equal(ours["bias"], ref["bias"])


def _export(module, path, shape):
    """``torch.onnx.export`` offline: the final step imports the onnx package
    only to inline onnxscript functions (none here)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
    try:
        torch.onnx.export(module, (torch.zeros(shape),), path, dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def test_onnx_reader_real_export_and_bn_folded_files_raise(tmp_path, tiny_yolox):
    """torch's exporter folds the batch norms into the convs and renames the
    folded initializers: both readers give the same tensors; the port's
    strict load raises naming the batch-norm keys; the JAX converter keeps
    the 18 unfused prediction layers only and its YOLOX raises at the first
    ``apply`` (the JAX behaviour is recorded, not repaired)."""
    model, _ = tiny_yolox
    path = str(tmp_path / "yolox_folded.onnx")
    _export(model, path, (1, 3, 64, 64))
    ours, ref = read_onnx_initializers(path), j_read_onnx(path)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(ours["head.cls_preds.0.weight"],
                                  model.state_dict()["head.cls_preds.0.weight"].numpy())
    assert not any(".bn." in k for k in ours)

    with pytest.raises(KeyError, match=r"lack \d+ of the YOLOX's \d+ keys.*\.bn\."):
        tdet.load_module(tyx.YOLOX(**TINY), ours, path)
    jvars = jyx.load_torch_state_dict(ref)
    assert list(jvars["params"]) == ["head"] and not jvars["batch_stats"]
    with pytest.raises(Exception, match="Could not find parameter"):
        jyx.YOLOX(**TINY).apply(jvars, np.zeros((1, 64, 64, 3), np.float32))


def test_load_module_drops_unused_keys_and_reads_pth_and_onnx(tmp_path, tiny_yolox):
    model, _ = tiny_yolox
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    torch.save({"state_dict": {**{k: torch.from_numpy(v) for k, v in sd.items()},
                               "backbone.backbone.stem.conv.bn.num_batches_tracked":
                                   torch.tensor(3)}}, tmp_path / "y.pth")
    (tmp_path / "y.onnx").write_bytes(mk.onnx_bytes(sd))
    for name in ("y.pth", "y.onnx"):
        loaded = tdet.load_module(tyx.YOLOX(**TINY), tdet.read_state_dict(str(tmp_path / name)))
        for k, v in loaded.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=f"{name} {k}")


# --- the networks -------------------------------------------------------------

def test_yolox_tiny_matches_jax(tiny_yolox):
    model, jvars = tiny_yolox
    x = np.random.default_rng(2).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    ref = np.asarray(jyx.YOLOX(**TINY).apply(jvars, x))
    with torch.inference_mode():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 85)
    for cols in (slice(0, 2), slice(2, 4), slice(4, None)):  # xy, wh, probabilities
        _close(ours[..., cols], ref[..., cols])


def test_yolox_l_key_set_and_forward_at_160():
    """YOLOX-L (dep 3, wid 64): the port's state dict is exactly the tree the
    JAX converter builds (paths and shapes of the JAX model's own init), and
    the decoded predictions agree at a 160x160 input."""
    model = tyx.YOLOX()
    sd = mk.detecting_yolox(model, 3)
    model = tdet.load_module(tyx.YOLOX(), sd).eval()
    x = np.random.default_rng(3).uniform(0, 255, (1, 160, 160, 3)).astype(np.float32)
    jvars = jyx.load_torch_state_dict(sd)
    shapes = jax.eval_shape(jyx.YOLOX().init, jax.random.PRNGKey(0), x)
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    got = jax.tree_util.tree_map(np.shape, jvars)
    assert got == want
    n_jax = sum(np.prod(s) for s in jax.tree_util.tree_leaves(want, is_leaf=lambda s: isinstance(s, tuple)))
    assert n_jax == sum(v.numel() for v in model.state_dict().values())
    ref = np.asarray(jax.jit(jyx.YOLOX().apply)(jvars, x))
    with torch.inference_mode():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    for cols in (slice(0, 2), slice(2, 4), slice(4, None)):
        _close(ours[..., cols], ref[..., cols])


def test_dwpose_matches_jax(dwpose):
    model, jvars, japply = dwpose
    x = np.random.default_rng(4).normal(size=(2, trt.INPUT_H, trt.INPUT_W, 3)).astype(np.float32)
    jx, jy = japply(jvars, x)
    with torch.inference_mode():
        tx, ty = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tx.shape == (2, 133, 576) and ty.shape == (2, 133, 768)
    _close(tx.numpy(), jx)
    _close(ty.numpy(), jy)


# --- pre and post processing --------------------------------------------------

@pytest.mark.parametrize("hw", [(96, 128), (128, 96), (1080, 1920), (1920, 1080), (333, 517)])
def test_letterbox_within_one_level_of_opencv(hw):
    img = _frame(*hw, seed=sum(hw))
    ours, r = tyx.letterbox(torch.from_numpy(img))
    ref, jr = jyx.letterbox(img)
    assert r == jr and ours.shape == (640, 640, 3) and ours.dtype == torch.float32
    assert np.abs(ours.numpy() - ref).max() <= 1


@pytest.mark.parametrize("hw", [(120, 160), (1080, 1920), (1920, 1080), (97, 61)])
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_crop_affine_within_one_level_of_opencv(hw, smooth):
    rng = np.random.default_rng(hw[0])
    img = _frame(*hw, seed=hw[1]) if smooth else rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    h, w = hw
    for _ in range(4):  # boxes inside and across the borders
        x1, y1 = rng.uniform(-0.2, 0.8) * w, rng.uniform(-0.2, 0.8) * h
        box = np.array([x1, y1, x1 + rng.uniform(0.05, 0.6) * w,
                        y1 + rng.uniform(0.05, 0.6) * h], np.float32)
        center, scale = trt.bbox_to_center_scale(box)
        np.testing.assert_array_equal(center, jrt.bbox_to_center_scale(box)[0])
        ours, (c, s) = trt.crop_affine(torch.from_numpy(img), center, scale)
        ref, _ = jrt.crop_affine(img, center, scale)
        assert ours.shape == ref.shape == (trt.INPUT_H, trt.INPUT_W, 3)
        assert np.abs(ours.numpy().astype(int) - ref).max() <= 1
        np.testing.assert_allclose(trt.normalize_crop(torch.from_numpy(ref)).permute(1, 2, 0),
                                   jrt.normalize_crop(ref), rtol=0, atol=1e-6)


def test_nms_postprocess_decode_exact():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 100, (60, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 60, (60, 2))], 1).astype(np.float32)
    scores = rng.random(60).astype(np.float32)
    assert tyx.nms(boxes, scores) == jyx.nms(boxes, scores)
    pred = rng.random((500, 85)).astype(np.float32)
    pred[:, :4] *= 200
    for thr in (0.3, 0.5, 0.99):
        np.testing.assert_array_equal(tyx.postprocess_person(pred, 0.75, thr),
                                      jyx.postprocess_person(pred, 0.75, thr))
    xl = rng.normal(size=(3, 133, 576)).astype(np.float32)
    yl = rng.normal(size=(3, 133, 768)).astype(np.float32)
    for a, b in zip(trt.simcc_decode(xl, yl), jrt.simcc_decode(xl, yl)):
        np.testing.assert_array_equal(a, b)
    kp = trt.simcc_decode(xl, yl)[0][0]
    c, s = np.array([40.5, 70.25], np.float32), np.array([90.0, 120.0], np.float32)
    np.testing.assert_array_equal(trt.crop_to_image(kp, c, s), jrt.crop_to_image(kp, c, s))


def test_wholebody_remap_and_draw_format_exact():
    rng = np.random.default_rng(6)
    kpts = rng.uniform(-5, 140, (3, 133, 2)).astype(np.float32)
    scores = rng.uniform(-0.5, 1.0, (3, 133)).astype(np.float32)
    ours, ref = tdet.wholebody_to_openpose(kpts, scores), jdet.wholebody_to_openpose(kpts, scores)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    dours, dref = tdet.to_draw_format(ours, 128, 96), jdet.to_draw_format(ref, 128, 96)
    for k in ("feet", "faces", "hands"):
        np.testing.assert_array_equal(dours[k], dref[k], err_msg=k)
    for k in ("candidate", "subset"):
        np.testing.assert_array_equal(dours["bodies"][k], dref["bodies"][k], err_msg=k)


# --- the whole detector -------------------------------------------------------

def test_detector_matches_jax_on_three_frames(tiny_yolox, dwpose):
    det_model, det_vars = tiny_yolox
    pose_model, pose_vars, japply = dwpose
    jd = jdet.DWposeDetector(det_vars, pose_vars)
    jd.det_model = jyx.YOLOX(**TINY)  # the tiny topology on both sides
    jd._det_fn = jax.jit(partial(jd.det_model.apply, det_vars))
    jd._pose_fn = partial(japply, pose_vars)
    ours = tdet.DWposeDetector(det_model, pose_model)
    for i, hw in enumerate([(96, 128), (128, 96), (120, 160)]):
        frame = _frame(*hw, seed=10 + i)
        boxes, jboxes = ours.detect_boxes(frame), jd.detect_boxes(frame)
        assert len(boxes) >= 1 and boxes.shape == jboxes.shape
        assert np.abs(boxes[:, :4] - jboxes[:, :4]).max() <= 1.0
        np.testing.assert_allclose(boxes[:, 4], jboxes[:, 4], atol=1e-4)

        # logits of each side's own crops
        bgr = np.ascontiguousarray(frame[..., ::-1])
        jl, tl = [], []
        for box, jbox in zip(boxes, jboxes):
            crop, _ = jrt.crop_affine(bgr, *jrt.bbox_to_center_scale(jbox))
            jl.append([np.asarray(a)[0] for a in japply(pose_vars, jrt.normalize_crop(crop)[None])])
            tcrop, _ = trt.crop_affine(torch.from_numpy(bgr), *trt.bbox_to_center_scale(box))
            with torch.inference_mode():
                tl.append([a[0].numpy() for a in pose_model(trt.normalize_crop(tcrop)[None])])
        kpts, scores = ours.estimate_poses(frame, boxes)
        jkpts, jscores = jd.estimate_poses(frame, jboxes)
        for p in range(len(boxes)):
            for axis in (0, 1):
                j, t = jl[p][axis], tl[p][axis]
                delta = np.abs(j - t).max()
                ji, ti = j.argmax(-1), t.argmax(-1)
                differ = ji != ti
                # where the argmax moved, the JAX logits' top two were that close
                gap = j.max(-1) - np.take_along_axis(j, ti[:, None], -1)[:, 0]
                assert (gap[differ] <= 2 * delta).all(), (p, axis, gap[differ], delta)
                same = ~differ
                np.testing.assert_allclose(kpts[p, same, axis], jkpts[p, same, axis], atol=0.5)
            np.testing.assert_allclose(scores[p], jscores[p], atol=2e-4 * np.abs(jscores).max())

        canvas, pose = ours(frame)
        assert canvas.shape == hw + (3,) and canvas.dtype == np.uint8
        assert (canvas.max(-1) > 0).mean() > 0.01  # limbs drawn
        assert pose["bodies"].shape == (len(boxes), 18, 2)
