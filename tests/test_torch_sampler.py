"""The sampler options against the JAX package: DDIM timesteps under every
spacing and offset (exact), the DDIM step with ``set_alpha_to_one`` either
way through the last step (atol 1e-6), the context windows of every step
(exact), and latent interpolation (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanvid_tpu.diffusion import ddim as jddim
from humanvid_tpu.diffusion import schedule as jsched
from humanvid_tpu.pipelines import context as jcontext
from humanvid_tpu.pipelines import interpolation as jinterp
from humanvid_tpu_torch.diffusion import ddim, schedule
from humanvid_tpu_torch.pipelines import context, interpolation


@pytest.mark.parametrize("steps_offset", [0, 1])
@pytest.mark.parametrize("steps", [1, 10, 25, 30, 50])
@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
def test_ddim_timesteps_match_jax(spacing, steps, steps_offset):
    ours_sched = schedule.make_noise_schedule()
    ref = jddim.ddim_set_timesteps(jsched.make_noise_schedule(), steps, spacing, steps_offset)
    ours = ddim.ddim_set_timesteps(ours_sched, steps, spacing, steps_offset)
    np.testing.assert_array_equal(ours.timesteps, np.asarray(ref.timesteps))
    np.testing.assert_array_equal(ours.prev_timesteps, np.asarray(ref.prev_timesteps))
    assert ours.num_inference_steps == ref.num_inference_steps == steps


def test_unknown_spacing_raises():
    with pytest.raises(ValueError, match="spacing"):
        ddim.ddim_set_timesteps(schedule.make_noise_schedule(), 10, "karras")


@pytest.mark.parametrize("set_alpha_to_one", [True, False])
@pytest.mark.parametrize("beta_schedule,prediction_type", [
    ("linear", "v_prediction"), ("scaled_linear", "epsilon"), ("scaled_linear", "sample")])
def test_ddim_step_matches_jax(set_alpha_to_one, beta_schedule, prediction_type):
    kw = dict(beta_schedule=beta_schedule, prediction_type=prediction_type,
              rescale_betas_zero_snr=prediction_type == "v_prediction",
              set_alpha_to_one=set_alpha_to_one)
    js, ts = jsched.make_noise_schedule(**kw), schedule.make_noise_schedule(**kw)
    assert ts.final_alpha_cumprod == js.final_alpha_cumprod
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    state = ddim.ddim_set_timesteps(ts, 4, "leading", 1)
    rng = np.random.default_rng(0)
    sample = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    for t, prev in zip(state.timesteps.tolist(), state.prev_timesteps.tolist()):
        out = rng.normal(size=sample.shape).astype(np.float32)
        ref = np.asarray(jddim.ddim_step(js, jnp.asarray(out), jnp.int32(t), jnp.int32(prev),
                                         jnp.asarray(sample)))
        got = ddim.ddim_step(ts, torch.from_numpy(out), t, prev, torch.from_numpy(sample))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
        sample = np.array(ref)
    assert prev < 0  # the last step lands on final_alpha_cumprod


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_ddim_pred_x0_eps_matches_jax(prediction_type):
    """(x0, eps) of every prediction type at a few timesteps, the last one
    past the schedule's end (final_alpha_cumprod)."""
    kw = dict(prediction_type=prediction_type, set_alpha_to_one=False)
    js, ts = jsched.make_noise_schedule(**kw), schedule.make_noise_schedule(**kw)
    rng = np.random.default_rng(1)
    for t in (999, 500, 1, -1):
        out, sample = (rng.normal(size=(2, 4, 8, 8)).astype(np.float32) for _ in range(2))
        ref = jddim.ddim_pred_x0_eps(js, jnp.asarray(out), jnp.asarray(sample), jnp.int32(t))
        got = ddim.ddim_pred_x0_eps(ts, torch.from_numpy(out), torch.from_numpy(sample), t)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_set_alpha_to_one_changes_only_the_last_step():
    on, off = (schedule.make_noise_schedule(set_alpha_to_one=v) for v in (True, False))
    assert on.final_alpha_cumprod == 1.0
    assert off.final_alpha_cumprod == pytest.approx(float(off.alphas_cumprod[0]))
    x, eps = torch.ones(3), torch.full((3,), 0.5)
    assert torch.equal(ddim.ddim_step(on, eps, 500, 400, x), ddim.ddim_step(off, eps, 500, 400, x))
    assert not torch.equal(ddim.ddim_step(on, eps, 1, -32, x), ddim.ddim_step(off, eps, 1, -32, x))


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("frames", [8, 24, 48, 72])
def test_all_step_windows_match_jax(frames, stride):
    kw = dict(context_size=16, context_stride=stride, context_overlap=4)
    ours = context.all_step_windows(5, frames, **kw)
    ref = jcontext.all_step_windows(5, frames, **kw)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[0], np.asarray(context.uniform_windows(0, frames, **kw)))
    assert (ours == ours[:1]).all()


@pytest.mark.parametrize("mode", ["slerp", "linear"])
@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_interpolate_latents_matches_jax(rate, mode):
    rng = np.random.default_rng(rate)
    lat = rng.normal(size=(5, 4, 6, 4)).astype(np.float32)
    lat[3] = lat[2] * 1.5 + 1e-4 * rng.normal(size=lat[2].shape)  # a nearly parallel pair
    ref = np.asarray(jinterp.interpolate_latents(jnp.asarray(lat), rate, mode))
    got = interpolation.interpolate_latents(torch.from_numpy(lat), rate, mode).numpy()
    assert got.shape == ref.shape == (5 + 4 * (rate - 1),) + lat.shape[1:]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[::rate], lat)  # the sampled frames stay in place


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.9])
def test_slerp_and_lerp_match_jax(t):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(4, 8, 8)).astype(np.float32) for _ in range(2))
    for fn, jfn in ((interpolation.slerp, jinterp.slerp), (interpolation.lerp, jinterp.lerp)):
        np.testing.assert_allclose(fn(torch.from_numpy(a), torch.from_numpy(b), t).numpy(),
                                   np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), t)),
                                   atol=1e-5, rtol=0)


def test_slerp_takes_the_linear_form_when_nearly_parallel():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 8, 8)).astype(np.float32)
    b = 2.0 * a + 1e-4 * rng.normal(size=a.shape).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = interpolation.slerp(ta, tb, 0.3)
    np.testing.assert_allclose(got.numpy(), interpolation.lerp(ta, tb, 0.3).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jinterp.slerp(a, b, 0.3)),
                               atol=1e-5, rtol=0)


def test_interpolation_keeps_dtype_and_rejects_unknown_modes():
    lat = torch.randn(3, 4, 2, 2, generator=torch.Generator().manual_seed(0)).bfloat16()
    assert interpolation.interpolate_latents(lat, 2).dtype == torch.bfloat16
    assert interpolation.interpolate_latents(lat, 1) is lat
    with pytest.raises(ValueError, match="mode"):
        interpolation.interpolate_latents(lat, 2, "cubic")
