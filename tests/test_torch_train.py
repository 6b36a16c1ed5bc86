"""The training slice: the port's train step, state and checkpoints against
the JAX package's, fp32 on the CPU at the tiny config.

- the trainable name sets of both stages equal the JAX masks' "train" leaves;
- one stage-2 step of the port matches ``humanvid_tpu.train`` on the same
  weights, batch and draws (the draws rebuilt from the JAX step's own
  ``jax.random.split(fold_in(key, 0), 6)``): loss, every trainable
  gradient and the parameters after one AdamW update. Tolerances: loss 1e-5
  relative; gradients 1e-4 of each leaf's largest entry (both sides sum in
  other orders, and the port takes the attention backward from its plain
  kernel versions); updates, see the test;
- gradient checkpointing plus feed-forward chunking give the gradients of
  neither (1e-5, as the JAX package's own remat test);
- checkpoint rotation, the stage-2 motion-only filter and merge, and an
  exact resume.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import init_like
from humanvid_tpu.diffusion import schedule as jsched
from humanvid_tpu.models.vae import gaussian_sample as j_gaussian_sample
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train import OptimizerConfig as JOptimizerConfig
from humanvid_tpu.train import TrainConfig as JTrainConfig
from humanvid_tpu.train import TrainState as JTrainState
from humanvid_tpu.train import (
    combine_params,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    partition_params,
    trainability_mask,
)
from humanvid_tpu.train import stage1_trainable as j_stage1
from humanvid_tpu.train import stage2_trainable as j_stage2
from humanvid_tpu_torch.diffusion import schedule as tsched
from humanvid_tpu_torch.models.unet import UNetConditionModel
from humanvid_tpu_torch.models.vae import gaussian_sample
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.train import (
    TRAIN_COMPONENTS,
    Draws,
    OptimizerConfig,
    TrainConfig,
    TrainState,
    filter_motion_modules,
    load_train_checkpoint,
    loss_from_draws,
    merge_motion_modules,
    save_train_checkpoint,
    stage1_trainable,
    stage2_trainable,
    stage_config,
    train_step,
)
from humanvid_tpu_torch.train.checkpoint import save_checkpoint
from humanvid_tpu_torch.utils.weights import from_jax_params

B, F, H, W = 2, 2, 32, 32
KINDS = {"reference_unet": "unet", "denoising_unet": "unet",
         "pose_guider": "pose_guider", "camera_encoder": "camera_encoder"}


def _jax_params(js):
    c = js.config
    h8, w8 = H // 8, W // 8
    ctx = jnp.zeros((1, 1, c.reference_unet.cross_attention_dim))
    t = jnp.zeros((1,))
    ref_lat = jnp.zeros((1, h8, w8, 4))
    pref = init_like(js.reference_unet, 30, ref_lat, t, ctx, collect_ref_features=True)
    _, feats = jax.eval_shape(lambda: js.reference_unet.apply(
        pref, ref_lat, t, ctx, collect_ref_features=True))
    feats = [jnp.zeros(f.shape) for f in feats]
    return {
        "reference_unet": pref,
        "denoising_unet": init_like(js.denoising_unet, 31, jnp.zeros((F, h8, w8, 4)), t, ctx,
                                    ref_features=feats, frames=F),
        "pose_guider": init_like(js.pose_guider, 32, jnp.zeros((1, H, W, 3))),
        "camera_encoder": init_like(js.camera_encoder, 33, jnp.zeros((F, H, W, 6)), F),
        "vae_encoder": init_like(js.vae_encoder, 34, jnp.zeros((1, H, W, 3))),
        "vae_decoder": init_like(js.vae_decoder, 35, jnp.zeros((1, h8, w8, 4))),
        "clip": init_like(js.clip, 36, jnp.zeros((1, 28, 28, 3))),
    }


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "tgt": (rng.normal(size=(B, F, H, W, 3)) * 0.5).astype(f32),
        "ref": (rng.normal(size=(B, H, W, 3)) * 0.5).astype(f32),
        "clip": rng.normal(size=(B, 28, 28, 3)).astype(f32),
        "pose": rng.random((B, F, H, W, 3)).astype(f32),
        "plucker": rng.normal(size=(B, F, H, W, 6)).astype(f32),
    }


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, -3).copy())


def _jax_draws(key, ratio):
    """The JAX step's draws at step 0, in the port's NCHW layout."""
    r_noise, r_off, r_t, r_vae1, r_vae2, r_unc = jax.random.split(
        jax.random.fold_in(key, 0), 6)
    h8, w8 = H // 8, W // 8
    return Draws(
        noise=_nchw(jax.random.normal(r_noise, (B, F, h8, w8, 4))),
        offset_noise=_nchw(jax.random.normal(r_off, (B, 1, 1, 1, 4))),
        t=torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, 1000))).long(),
        vae_eps=_nchw(jax.random.normal(r_vae1, (B * F, h8, w8, 4))),
        ref_vae_eps=_nchw(jax.random.normal(r_vae2, (B, h8, w8, 4))),
        uncond=bool(jax.random.bernoulli(r_unc, ratio)))


def _prune(tree):
    """A nested dict without its None leaves and empty branches."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}


UNCOND_RATIO = 0.5


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX stage-2 step that also returns the trainable grads;
    it is called with two keys, one drawing cond and one uncond."""
    js = JCamAnimate(jax_tiny_config(motion_max_len=4))
    params = _jax_params(js)
    frozen = {k: params[k] for k in ("vae_encoder", "vae_decoder", "clip")}
    trainable = {k: params[k] for k in TRAIN_COMPONENTS}
    tx = make_optimizer(trainable, j_stage2, JOptimizerConfig(warmup_steps=0))
    state = JTrainState.create(trainable, frozen, tx)
    sched = js.make_schedule(beta_schedule="scaled_linear")
    cfg = JTrainConfig(uncond_ratio=UNCOND_RATIO)
    step = make_train_step(js, sched, cfg, trainable_predicate=j_stage2)
    loss_fn = make_loss_fn(js, sched, cfg)

    @jax.jit
    def run(state, batch, key):
        new_state, aux = step(state, batch, key)
        train_part, static = partition_params(state.params, j_stage2)
        rng = jax.random.fold_in(key, state.step)
        grads = jax.grad(lambda tp: loss_fn(combine_params(tp, static), state.frozen,
                                            batch, rng)[0])(train_part)
        return new_state.params, aux, grads

    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = {}
    for seed in range(64):  # the first key of each uncond draw
        uncond = _jax_draws(jax.random.PRNGKey(seed), UNCOND_RATIO).uncond
        keys.setdefault(uncond, seed)
        if len(keys) == 2:
            break
    results = {u: run(state, jbatch, jax.random.PRNGKey(s)) for u, s in keys.items()}
    return params, batch, keys, results


@pytest.mark.parametrize("uncond", [False, True])
def test_stage2_step_matches_jax(jax_step, uncond):
    params, batch, keys, results = jax_step
    j_params, j_aux, j_grads = results[uncond]
    draws = _jax_draws(jax.random.PRNGKey(keys[uncond]), UNCOND_RATIO)
    assert draws.uncond == uncond

    system = CamAnimate(tiny_config(motion_max_len=4), device="cpu").load_jax_params(params)
    state = TrainState(system, stage2_trainable, OptimizerConfig(warmup_steps=0))
    sched = system.make_schedule(beta_schedule="scaled_linear")
    loss, t_mean = loss_from_draws(system, sched, TrainConfig(uncond_ratio=UNCOND_RATIO),
                                   batch, draws)
    np.testing.assert_allclose(loss.item(), float(j_aux["loss"]), rtol=1e-5)
    assert float(t_mean) == float(j_aux["t_mean"])
    loss.backward()
    grads = dict(zip(state.names, state.grads()))
    before = [m.clone() for m in state.masters]
    norm = state.apply_gradients()
    np.testing.assert_allclose(float(norm), float(j_aux["grad_norm"]), rtol=1e-4)

    j_grads = {c: from_jax_params(_prune(j_grads[c]), KINDS[c])
               for c in ("denoising_unet", "camera_encoder")}
    j_new = {c: from_jax_params(j_params[c], KINDS[c])
             for c in ("denoising_unet", "camera_encoder")}
    assert sorted(grads) == sorted(f"{c}/{k}" for c, sd in j_grads.items() for k in sd)
    lr = OptimizerConfig().learning_rate
    for (name, g), old, new in zip(grads.items(), before, state.masters):
        comp, _, key = name.partition("/")
        ref = j_grads[comp][key].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * scale, rtol=0, err_msg=name)
        # One AdamW step from zero moments moves each entry by
        # lr * (g / (|g| + eps) + wd * p): where |g| is well above both the
        # gradients' error and eps (1e-8) the two updates agree to 1e-3 lr;
        # entries whose gradient is within the error may flip sign, at most
        # 2 lr apart. Both sides round p + update to fp32: one ulp of p more.
        delta, j_delta = (new - old).numpy(), j_new[comp][key].numpy() - old.numpy()
        ulp = np.spacing(np.abs(old.numpy()))
        sure = np.abs(ref) > max(1e-3 * scale, 1e-6)
        assert (np.abs(delta - j_delta) <= 1e-3 * lr + ulp)[sure].all(), name
        assert (np.abs(delta - j_delta) <= 2 * lr + ulp).all(), name


@pytest.mark.parametrize("stage,predicate,j_predicate", [
    (2, stage2_trainable, j_stage2), (1, stage1_trainable, j_stage1)])
def test_trainable_names_match_jax_masks(jax_step, stage, predicate, j_predicate):
    params = jax_step[0]
    trainable = {k: params[k] for k in TRAIN_COMPONENTS}
    labels = trainability_mask(trainable, j_predicate)
    expected = set()
    for comp, kind in KINDS.items():
        marks = jax.tree.map(lambda leaf, lab: np.full(np.shape(leaf), lab == "train", np.float32),
                             trainable[comp], labels[comp])
        expected |= {f"{comp}/{k}" for k, v in from_jax_params(marks, kind).items()
                     if bool(v.all())}
    system = CamAnimate(tiny_config(motion_max_len=4), device="cpu")
    got = {f"{c}/{k}" for c in TRAIN_COMPONENTS
           for k, _ in getattr(system, c).named_parameters() if predicate(c, k)}
    assert got == expected
    assert not any(predicate(c, "conv_in.weight") for c in ("vae_encoder", "clip"))
    state = TrainState(system, predicate)
    assert set(state.names) == expected
    assert all(p.requires_grad == (f"{c}/{k}" in expected) for c in TRAIN_COMPONENTS
               for k, p in getattr(system, c).named_parameters())


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("betas", ["scaled_linear", "linear"])
def test_schedule_training_functions_match_jax(pred, betas):
    js = jsched.make_noise_schedule(beta_schedule=betas, prediction_type=pred)
    ts = tsched.make_noise_schedule(beta_schedule=betas, prediction_type=pred)
    rng = np.random.default_rng(0)
    x0, noise = (rng.normal(size=(3, 2, 4, 5, 5)).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999])
    for jf, tf in ((jsched.add_noise, tsched.add_noise),
                   (jsched.get_velocity, tsched.get_velocity)):
        np.testing.assert_allclose(
            tf(ts, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t)).numpy(),
            np.asarray(jf(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))),
            atol=1e-6, rtol=0)
    t = np.arange(0, 1000, 37)
    got = tsched.min_snr_weights(ts, torch.from_numpy(t), 5.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jsched.min_snr_weights(js, jnp.asarray(t), 5.0)),
                               rtol=1e-6)


def test_gaussian_sample_matches_jax():
    rng = np.random.default_rng(1)
    moments = rng.normal(size=(3, 4, 4, 8)).astype(np.float32) * 20  # logvar hits both clips
    key = jax.random.PRNGKey(3)
    ref = j_gaussian_sample(jnp.asarray(moments), key)
    eps = _nchw(jax.random.normal(key, (3, 4, 4, 4)))
    got = gaussian_sample(_nchw(moments), eps)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               rtol=1e-6, atol=1e-5)


def test_checkpointing_and_ff_chunks_keep_the_gradients():
    torch.manual_seed(0)
    cfg = tiny_config(motion_max_len=4).denoising_unet
    plain = UNetConditionModel(cfg)
    levers = UNetConditionModel(dataclasses.replace(cfg, gradient_checkpointing=True,
                                                    ff_chunk_tokens=7))
    levers.load_state_dict(plain.state_dict())
    x = torch.randn(F, 4, 8, 8)
    ctx = torch.randn(1, 1, cfg.cross_attention_dim)
    outs, grads = [], []
    for model in (plain, levers):
        out, _ = model(x, torch.ones(1), ctx, frames=F)
        (out ** 2).mean().backward()
        outs.append(out.detach())
        # the single-token cross-attention never reads to_q / to_k: no grad
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5)
    assert grads[0].keys() == grads[1].keys()
    assert any(".ff." in k for k in grads[0]) and any(".motion_modules." in k for k in grads[0])
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(), atol=1e-5,
                                   err_msg=k)
    with torch.no_grad():  # inert without autograd
        np.testing.assert_array_equal(levers(x, torch.ones(1), ctx, frames=F)[0].numpy(),
                                      outs[1].numpy())


def _tiny_system(stage=2, seed=0):
    cfg = stage_config(stage, tiny_config(motion_max_len=4))
    return CamAnimate(cfg, device="cpu").init_random(seed)


def _draws(n, seed, uncond_first=True):
    gen = torch.Generator().manual_seed(seed)
    h8, w8 = H // 8, W // 8
    return [Draws(torch.randn((B, F, 4, h8, w8), generator=gen),
                  torch.randn((B, 1, 4, 1, 1), generator=gen),
                  torch.randint(0, 1000, (B,), generator=gen),
                  torch.randn((B * F, 4, h8, w8), generator=gen),
                  torch.randn((B, 4, h8, w8), generator=gen),
                  uncond_first and i == 0) for i in range(n)]


def test_checkpoint_resume_is_exact(tmp_path):
    batch, draws = _batch(1), _draws(3, 7)
    opt = OptimizerConfig(warmup_steps=1)

    def run(system, state, steps):
        sched = system.make_schedule(beta_schedule="scaled_linear")
        for i in steps:
            train_step(system, state, sched, TrainConfig(), batch, draws=draws[i])

    sys_a = _tiny_system()
    state_a = TrainState(sys_a, stage2_trainable, opt)
    start = [m.clone() for m in state_a.masters]
    run(sys_a, state_a, [0])
    # warmup 1: the first update has lr 0 and moves nothing
    assert all(torch.equal(a, b) for a, b in zip(start, state_a.masters))
    run(sys_a, state_a, [1, 2])

    sys_b = _tiny_system()
    state_b = TrainState(sys_b, stage2_trainable, opt)
    run(sys_b, state_b, [0, 1])
    paths = save_train_checkpoint(str(tmp_path), sys_b, state_b, motion_only=True)
    assert sorted(p.rsplit("/", 1)[1] for p in paths) == [
        "camera_encoder-2.pt", "motion_module-2.pt", "opt_state-2.pt"]
    sys_c = _tiny_system()
    state_c = TrainState(sys_c, stage2_trainable, opt)
    load_train_checkpoint(str(tmp_path), 2, sys_c, state_c, motion_only=True)
    run(sys_c, state_c, [2])
    assert state_c.step == state_a.step == 3
    for name, a, c in zip(state_a.names, state_a.masters, state_c.masters):
        assert torch.equal(a, c), name
    for comp in TRAIN_COMPONENTS:
        for (k, a), (_, c) in zip(getattr(sys_a, comp).state_dict().items(),
                                  getattr(sys_c, comp).state_dict().items()):
            assert torch.equal(a, c), f"{comp}/{k}"


def test_checkpoint_rotation_and_motion_filter(tmp_path):
    for step in range(1, 5):
        save_checkpoint(str(tmp_path), "camera_encoder", {"w": torch.ones(1) * step}, step,
                        total_limit=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "camera_encoder-3.pt", "camera_encoder-4.pt"]
    sd = _tiny_system().denoising_unet.state_dict()
    motion = filter_motion_modules(sd)
    assert motion and all(".motion_modules." in k for k in motion)
    assert len(motion) < len(sd)
    new = {k: torch.full_like(v, 2.0) for k, v in motion.items()}
    merged = merge_motion_modules(sd, new)
    assert merged.keys() == sd.keys()
    assert all(torch.equal(merged[k], new[k] if k in new else sd[k]) for k in sd)
    with pytest.raises(KeyError):
        merge_motion_modules(sd, {"down_blocks.9.motion_modules.0.x": torch.ones(1)})


def test_stage1_step_trains_its_leaves_only():
    """Stage 1: single frames, a video UNet without motion modules, and the
    ReferenceNet trained except its up_blocks.3 and output head."""
    system = _tiny_system(stage=1)
    assert not any(".motion_modules." in k for k in system.denoising_unet.state_dict())
    state = TrainState(system, stage1_trainable)
    frozen = {f"{c}/{k}": p.detach().clone() for c in TRAIN_COMPONENTS
              for k, p in getattr(system, c).named_parameters() if not p.requires_grad}
    assert "reference_unet/conv_out.weight" in frozen
    batch = {k: v[:, :1] if k in ("tgt", "pose", "plucker") else v for k, v in _batch(2).items()}
    sched = system.make_schedule(beta_schedule="scaled_linear")
    before = [m.clone() for m in state.masters]
    out = train_step(system, state, sched, TrainConfig(), batch,
                     generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(out["loss"])) and float(out["grad_norm"]) > 0
    moved = {n for n, a, b in zip(state.names, before, state.masters) if not torch.equal(a, b)}
    assert any(n.startswith("reference_unet/") for n in moved)
    assert any(n.startswith("pose_guider/") for n in moved)
    for c in TRAIN_COMPONENTS:
        for k, p in getattr(system, c).named_parameters():
            if f"{c}/{k}" in frozen:
                assert torch.equal(p, frozen[f"{c}/{k}"]), f"{c}/{k}"
