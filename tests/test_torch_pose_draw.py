"""The port's skeleton rasterizer (numpy, no OpenCV) against the JAX
``draw_pose`` (OpenCV) and against the OpenCV primitives it replaces: the
same bits, on seeded pose dicts with body, hands, face and feet, near and
across the borders, at scale 1 and at UE scales."""

import cv2
import numpy as np
import pytest

from humanvid_tpu.data.pose_draw import draw_pose as j_draw_pose
from humanvid_tpu.pose.detector import to_draw_format as j_to_draw_format
from humanvid_tpu.pose.detector import wholebody_to_openpose as j_wholebody_to_openpose
from humanvid_tpu.pose.smplx import render_frame as j_render_frame
from humanvid_tpu_torch.data import pose_draw as pd
from humanvid_tpu_torch.pose.smplx import render_frame, smplx_to_coco_wholebody


def _pose(rng, n, h, w, spread=1.15):
    """A drawable pose dict of n persons: keypoints anywhere from a little
    outside the frame to a little past it, some of them masked."""
    kpts = rng.uniform(-0.1, spread, (n, 133, 2)) * np.array([w, h])
    # bodies compact enough to look like bodies, limbs of every length
    kpts[:, :23] = rng.uniform(0.2, 0.8, (n, 1, 2)) * np.array([w, h]) + \
        rng.normal(0, 0.15, (n, 23, 2)) * np.array([w, h])
    scores = rng.uniform(0.0, 1.0, (n, 133)).astype(np.float32)
    return j_to_draw_format(j_wholebody_to_openpose(kpts.astype(np.float32), scores), w, h)


@pytest.mark.parametrize("hw", [(64, 48), (96, 128), (270, 480), (1080, 1920), (1920, 1080)])
@pytest.mark.parametrize("scale", [1.0, 0.5, 1.7], ids=["scale1", "ue_half", "ue_1.7"])
def test_draw_pose_matches_jax(hw, scale):
    h, w = hw
    rng = np.random.default_rng(h * 7 + w + int(scale * 10))
    for n in (1, 3):
        pose = _pose(rng, n, h, w)
        got, want = pd.draw_pose(pose, h, w, scale), j_draw_pose(pose, h, w, scale)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        assert (want > 0).any()
        np.testing.assert_array_equal(got, want)


def test_render_frame_matches_jax_at_ue_scale():
    rng = np.random.default_rng(3)
    smplx = rng.uniform(5, 700, (2, 144, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, 144)).astype(np.float32)
    k, s = smplx_to_coco_wholebody(smplx, conf)
    np.testing.assert_array_equal(render_frame(k, s, 720, 1280), j_render_frame(k, s, 720, 1280))


@pytest.mark.parametrize("seed", range(4))
def test_primitives_match_opencv(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(8, 90)), int(rng.integers(8, 90))
    for _ in range(150):
        c = tuple(int(v) for v in rng.integers(-20, 110, 2))
        axes = (int(rng.integers(0, 70)), int(rng.integers(0, 9)))
        angle = int(rng.integers(-180, 181))
        poly = cv2.ellipse2Poly(c, axes, angle, 0, 360, 1)
        np.testing.assert_array_equal(pd.ellipse2poly(c, axes, angle, 0, 360, 1), poly)
        color = tuple(rng.uniform(0, 255, 3))
        p1 = tuple(int(v) for v in rng.integers(-60, 150, 2))
        p2 = tuple(int(v) for v in rng.integers(-60, 150, 2))
        r = int(rng.integers(0, 8))
        for ours, theirs in (
                (lambda im: pd.fill_convex_poly(im, poly, color),
                 lambda im: cv2.fillConvexPoly(im, poly, color)),
                (lambda im: pd.circle(im, c, r, color),
                 lambda im: cv2.circle(im, c, r, color, thickness=-1)),
                (lambda im: pd.line2(im, p1, p2, color),
                 lambda im: cv2.line(im, p1, p2, color, thickness=2)),
                (lambda im: pd._line8(im, *p1, *p2, pd._color(color)),
                 lambda im: cv2.line(im, p1, p2, color, thickness=1))):
            a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
            ours(a)
            theirs(b)
            np.testing.assert_array_equal(a, b)
