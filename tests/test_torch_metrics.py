"""The port's frame metrics, Fréchet maths and directory runner
(``humanvid_tpu_torch/metrics/``) against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng``. Tolerances: ``ssim``, ``psnr``
and ``l1`` 1e-5 absolute (odd sizes and one channel included); the Fréchet
distance 1e-8 relative on the same statistics; ``evaluate_pairs`` on two
paired 24-frame 48x32 clips with all three networks (the port's tool's
weights, converted by the JAX package's loaders), ``read_frames`` served
from memory in both packages: ssim, psnr, l1 and lpips 1e-4 relative, FID
and FVD 1e-3 relative (the square root of a rank-deficient covariance
product amplifies the features' float32 differences, ~1e-6, to ~1e-4); a
pair of different sizes through ``_align`` (the port resizes with an
antialiased ``F.interpolate`` rounded once, the JAX package with PIL,
whose two passes each round: one uint8 level apart) 2e-3 relative."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (two torch threads a worker)

from humanvid_tpu.metrics import frame as j_frame
from humanvid_tpu.metrics import frechet as j_frechet
from humanvid_tpu.metrics import runner as j_runner
from humanvid_tpu.metrics import weights as j_weights
from humanvid_tpu_torch.metrics import frame, frechet, runner
from humanvid_tpu_torch.metrics import weights as W
from humanvid_tpu_torch.tools import make_random_metric_weights as mk

FRAME_TOL = 1e-5
FRECHET_TOL = 1e-8
RUNNER_TOL = 1e-4
FRECHET_RUNNER_TOL = 1e-3
ALIGN_TOL = 2e-3


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 37, 29, 3), (1, 11, 11, 3),
                                   (2, 9, 40, 1)])
def test_frame_metrics_match_jax(shape):
    rng = np.random.default_rng(0)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    for fn, jfn in ((frame.ssim, j_frame.ssim), (frame.psnr, j_frame.psnr),
                    (frame.l1, j_frame.l1)):
        ours = fn(a, b).numpy()
        ref = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        assert ours.shape == (shape[0],)
        np.testing.assert_allclose(ours, ref, atol=FRAME_TOL, rtol=0, err_msg=fn.__name__)


def test_psnr_clamps_identical_images():
    a = np.random.default_rng(1).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(frame.psnr(a, a).numpy(), 120.0, rtol=1e-6)
    np.testing.assert_allclose(frame.ssim(a, a).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,d", [(50, 16), (10, 32), (200, 8)], ids=["full", "rank_deficient",
                                                                     "tall"])
def test_frechet_matches_jax(n, d):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(n, d))
    b = 0.8 * a + rng.normal(0.1, 0.5, size=(n, d))
    stats_a, stats_b = frechet.activation_statistics(a), frechet.activation_statistics(b)
    for ours, ref in zip(stats_a, j_frechet.activation_statistics(a)):
        np.testing.assert_array_equal(ours, ref)
    ours = frechet.frechet_distance(*stats_a, *stats_b)
    ref = j_frechet.frechet_distance(*stats_a, *stats_b)
    assert abs(ours - ref) <= FRECHET_TOL * abs(ref)
    split = [a[: n // 2], a[n // 2:]]
    assert abs(frechet.frechet_from_features(split, [b]) - ref) <= FRECHET_TOL * abs(ref)


def test_frechet_of_equal_statistics_is_zero():
    a = np.random.default_rng(3).normal(size=(40, 6))
    mu, sigma = frechet.activation_statistics(a)
    assert abs(frechet.frechet_distance(mu, sigma, mu, sigma)) < 1e-8


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the port's networks, the JAX package's variables) of the port tool's
    LPIPS, Inception and I3D files."""
    root = str(tmp_path_factory.mktemp("metric_weights"))
    mk.main([root, "--skip-clip"])
    return W.load_metric_nets(root, "cpu"), j_weights.load_metric_nets(root)


def _clips(rng, n, shape):
    out = []
    for _ in range(n):
        base = rng.random((shape[0], 4, 4, 3))
        smooth = base.repeat(shape[1] // 4 + 1, 1)[:, :shape[1]].repeat(
            shape[2] // 4 + 1, 2)[:, :, :shape[2]]
        clip = np.clip(smooth + rng.normal(0, 0.05, shape + (3,)), 0, 1)
        out.append((clip * 255).astype(np.uint8))
    return out


def _serve(monkeypatch, frames):
    def read_frames(path, indices=None, max_frames=None):
        clip = frames[path]
        return clip[list(indices)] if indices is not None else clip

    monkeypatch.setattr(runner, "read_frames", read_frames)
    monkeypatch.setattr(j_runner, "read_frames", read_frames)


def _pairs(rng, gen_shape, gt_shape):
    frames, pairs = {}, []
    for i, (g, t) in enumerate(zip(_clips(rng, 2, gen_shape), _clips(rng, 2, gt_shape))):
        frames[f"gen/c{i}.mp4"], frames[f"gt/c{i}.mp4"] = g, t
        pairs.append((f"c{i}", f"gen/c{i}.mp4", f"gt/c{i}.mp4"))
    return frames, pairs


def closed_form_frechet(feats_a, feats_b):
    """The Fréchet distance without a 2048x2048 square root: the nonzero
    eigenvalues of S1 S2 = A^T A B^T B / ((na-1)(nb-1)) (centred features)
    are the squared singular values of A B^T, an na x nb matrix."""
    a, b = (np.concatenate(f).astype(np.float64) for f in (feats_a, feats_b))
    ca, cb = a - a.mean(0), b - b.mean(0)
    na, nb = len(a) - 1, len(b) - 1
    tr_sqrt = np.linalg.svd(ca @ cb.T, compute_uv=False).sum() / np.sqrt(na * nb)
    diff = a.mean(0) - b.mean(0)
    return float(diff @ diff + (ca * ca).sum() / na + (cb * cb).sum() / nb - 2 * tr_sqrt)


def test_closed_form_frechet_is_the_frechet_distance():
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(30, 12)), rng.normal(0.3, 1.2, size=(20, 12))
    ref = frechet.frechet_from_features([a], [b])
    assert abs(closed_form_frechet([a], [b]) - ref) <= FRECHET_TOL * abs(ref)


def test_evaluate_pairs_matches_jax(nets, monkeypatch):
    """Every metric of the runner against the JAX runner's. The JAX side's
    Fréchet distances are taken in closed form on its features (one 2048-d
    ``sqrtm`` takes ~20 s here; ``frechet_distance`` itself is held to the
    JAX package's above), and its Inception runs in batches of the clip's
    picks rather than padded to 32 (the same values)."""
    from humanvid_tpu.metrics import inception as j_inception

    ours_nets, jax_nets = nets
    config = runner.MetricsConfig(fid_frames_per_clip=5)
    frames, pairs = _pairs(np.random.default_rng(4), (24, 48, 32), (24, 48, 32))
    _serve(monkeypatch, frames)
    feats = {}

    def capture(store):
        def frechet_from_features(fa, fb):
            store.setdefault("pairs", []).append((list(fa), list(fb)))
            return closed_form_frechet(fa, fb)
        return frechet_from_features

    jax_fid = j_inception.fid_features
    monkeypatch.setattr(j_inception, "fid_features", lambda v, x: jax_fid(v, x, batch=len(x)))
    monkeypatch.setattr(j_runner, "frechet_from_features", capture(feats))
    ours = runner.evaluate_pairs(pairs, config, device="cpu", **ours_nets)
    ref = j_runner.evaluate_pairs(pairs, j_runner.MetricsConfig(fid_frames_per_clip=5),
                                  **jax_nets)
    assert set(ours) == set(ref) == {"ssim", "psnr", "l1", "lpips", "fid", "fvd", "num_videos"}
    assert ours["num_videos"] == ref["num_videos"] == 2
    for key in ("ssim", "psnr", "l1", "lpips"):
        assert abs(ours[key] - ref[key]) <= RUNNER_TOL * abs(ref[key]), key
    for key in ("fid", "fvd"):
        assert abs(ours[key] - ref[key]) <= FRECHET_RUNNER_TOL * abs(ref[key]), (key, ours, ref)
    # the features the JAX runner compared: 2 clips x 5 Inception picks, 2 I3D clips
    (fid_a, _), (fvd_a, _) = feats["pairs"]
    assert [f.shape for f in fid_a] == [(5, 2048)] * 2 and [f.shape for f in fvd_a] == [(2, 400)]


def test_evaluate_pairs_aligns_sizes_as_jax(nets, monkeypatch):
    ours_nets, jax_nets = nets
    frames, pairs = _pairs(np.random.default_rng(5), (8, 48, 32), (9, 64, 40))
    _serve(monkeypatch, frames)
    kw = dict(groups=("frame", "lpips"))
    ours = runner.evaluate_pairs(pairs, device="cpu", lpips_model=ours_nets["lpips_model"], **kw)
    ref = j_runner.evaluate_pairs(pairs, lpips_variables=jax_nets["lpips_variables"], **kw)
    assert set(ours) == set(ref) == {"ssim", "psnr", "l1", "lpips", "num_videos"}
    for key in ("ssim", "psnr", "l1", "lpips"):
        assert abs(ours[key] - ref[key]) <= ALIGN_TOL * abs(ref[key]), (key, ours, ref)


def test_align_resizes_through_uint8_within_one_level():
    from PIL import Image

    rng = np.random.default_rng(6)
    a = rng.random((3, 48, 32, 3)).astype(np.float32)
    b = rng.random((4, 64, 40, 3)).astype(np.float32)
    a2, b2 = runner._align(a, b)
    assert a2.shape == b2.shape == (3, 48, 32, 3)
    u8 = np.clip(b[:3] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    pil = np.stack([np.asarray(Image.fromarray(f).resize((32, 48), Image.BILINEAR))
                    for f in u8])
    assert np.abs(b2 * 255 - pil).max() <= 1 + 1e-3


def test_groups_select_metrics_and_short_clips_skip_fvd(nets, monkeypatch):
    ours_nets, _ = nets
    frames, pairs = _pairs(np.random.default_rng(7), (12, 48, 32), (12, 48, 32))
    _serve(monkeypatch, frames)
    out = runner.evaluate_pairs(pairs, device="cpu", groups=("frame", "fvd"), **ours_nets)
    assert set(out) == {"ssim", "psnr", "l1", "num_videos"}  # 12 < 24 frames: no FVD
    with pytest.raises(ValueError, match="unknown metric groups"):
        runner.evaluate_pairs(pairs, device="cpu", groups=("frame", "psnr"))


def test_pair_videos_and_merge(tmp_path, monkeypatch):
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()
    for name in ("a.mp4", "b.mp4", "note.txt"):
        (gen / name).touch()
    (gt / "b.mp4").touch()
    (gt / "c.mp4").touch()
    assert runner.pair_videos(str(gen), str(gt)) == [("b", str(gen / "b.mp4"),
                                                      str(gt / "b.mp4"))]
    with pytest.raises(ValueError, match="no paired videos"):
        runner.pair_videos(str(gen), str(tmp_path))

    clip = (np.random.default_rng(8).random((4, 16, 16, 3)) * 255).astype(np.uint8)
    monkeypatch.setattr(runner, "read_frames", lambda path: clip)
    out_json = str(tmp_path / "m.json")
    with open(out_json, "w") as f:
        json.dump({"fid": 1.5, "ssim": -1.0}, f)
    merged = runner.evaluate_dirs(str(gen), str(gt), out_json=out_json, merge=True,
                                  groups=("frame",), device="cpu")
    assert merged["fid"] == 1.5 and merged["ssim"] == pytest.approx(1.0, abs=1e-6)
    assert json.load(open(out_json)) == merged
    fresh = runner.evaluate_dirs(str(gen), str(gt), out_json=out_json, groups=("frame",),
                                 device="cpu")
    assert "fid" not in fresh and os.path.exists(out_json)
