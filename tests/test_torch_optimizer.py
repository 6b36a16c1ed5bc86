"""The port's optimizer options and reference export against the JAX package.

- ``TrainState.apply_gradients`` against ``humanvid_tpu.train.make_optimizer``
  (optax: clip by global norm, AdamW with the warmup-constant rate, the
  'freeze' leaves set to zero, ``MultiSteps`` under accumulation) on the
  same parameters and the same gradient sequences, for
  ``gradient_accumulation_steps`` 1/2/4 x ``mu_dtype`` None/bf16 x warmup
  0/1: parameters and moments after every micro-step, to 1e-6 absolute
  (both sides do the same fp32 operations and differ only where one fuses
  a multiply-add). The bf16 case holds the port to the jitted JAX update,
  whose moment decay is beta1 rounded to bf16.
- a learning-rate schedule other than "constant" raises in both;
- ``export_reference_pth``'s files against the JAX function's on the same
  seeded parameters: names, keys and values exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import jax_system_params
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train import OptimizerConfig as JOptimizerConfig
from humanvid_tpu.train import make_optimizer
from humanvid_tpu.train.checkpoint import export_reference_pth as j_export_reference_pth
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.train import (
    TRAIN_COMPONENTS,
    OptimizerConfig,
    TrainState,
    export_reference_pth,
    stage1_trainable,
)

LR = 1e-2
# micro-step gradient scales: some below the clip limit, some far above
SCALES = [0.05, 3.0, 0.3, 8.0, 0.02, 1.5, 0.5, 4.0]
SHAPES = {"reference_unet": {"w": (5, 7), "frozen_w": (3,)},
          "denoising_unet": {"w": (4, 3, 2), "b": (6,)},
          "pose_guider": {"w": (9,)},
          "camera_encoder": {"w": (2, 5), "frozen_b": (4,)}}


def _trainable(component, name):
    return not name.split("/")[-1].startswith("frozen")


class _Leaves(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    params = {c: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
              for c, leaves in SHAPES.items()}
    grads = []
    for scale in SCALES:
        g = {c: {k: rng.normal(size=s).astype(np.float32) for k, s in leaves.items()}
             for c, leaves in SHAPES.items()}
        total = np.sqrt(sum(float((v ** 2).sum()) for leaves in g.values()
                            for k, v in leaves.items() if _trainable(None, k)))
        grads.append({c: {k: (v * (scale / total)).astype(np.float32) for k, v in leaves.items()}
                      for c, leaves in g.items()})
    return params, grads


def _jax_mu_nu(opt_state):
    mu = optax.tree_utils.tree_get(opt_state, "mu")
    nu = optax.tree_utils.tree_get(opt_state, "nu")
    return mu, nu


@pytest.mark.parametrize("warmup", [0, 1])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_update_matches_optax(k, mu_dtype, warmup):
    params, grads = _setup()
    jcfg = JOptimizerConfig(learning_rate=LR, warmup_steps=warmup,
                            gradient_accumulation_steps=k, mu_dtype=mu_dtype)
    jparams = {c: {"params": {k_: jnp.asarray(v) for k_, v in leaves.items()}}
               for c, leaves in params.items()}
    tx = make_optimizer(jparams, lambda c, path: _trainable(c, path), jcfg)
    opt = tx.init(jparams)

    system = types.SimpleNamespace(**{c: _Leaves(leaves) for c, leaves in params.items()})
    state = TrainState(system, _trainable, OptimizerConfig(
        learning_rate=LR, warmup_steps=warmup, gradient_accumulation_steps=k,
        mu_dtype=mu_dtype))
    assert state.names == [f"{c}/{n}" for c in TRAIN_COMPONENTS for n in SHAPES[c]
                           if _trainable(c, n)]
    bf16 = mu_dtype == "bfloat16"
    for i, g in enumerate(grads):
        jg = {c: {"params": {k_: jnp.asarray(v) for k_, v in leaves.items()}}
              for c, leaves in g.items()}
        updates, opt = jax.jit(tx.update)(jg, opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for c, leaves in g.items():  # autograd gives the trainable leaves gradients
            for name, v in leaves.items():
                if _trainable(c, name):
                    getattr(system, c)._parameters[name].grad = torch.from_numpy(v.copy())
        norm = state.apply_gradients()
        want_norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                for c, leaves in g.items() for n, v in leaves.items()
                                if _trainable(c, n)))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        assert state.step == i + 1 and state.updates == (i + 1) // k
        assert state.micro == (i + 1) % k
        mu, nu = _jax_mu_nu(opt)
        if k > 1:
            assert int(opt.mini_step) == state.micro and int(opt.gradient_step) == state.updates
        for j, name in enumerate(state.names):
            c, leaf = name.split("/")
            np.testing.assert_allclose(state.masters[j].numpy(),
                                       np.asarray(jparams[c]["params"][leaf]),
                                       atol=1e-6, rtol=0, err_msg=f"{name} step {i}")
            np.testing.assert_array_equal(
                getattr(system, c)._parameters[leaf].detach().numpy(), state.masters[j].numpy())
            jmu = np.asarray(mu[c]["params"][leaf].astype(jnp.float32))
            assert state.mu[j].dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(state.mu[j].float().numpy(), jmu,
                                       atol=1e-6, rtol=0, err_msg=name)
            np.testing.assert_allclose(state.nu[j].numpy(), np.asarray(nu[c]["params"][leaf]),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
        for c, leaves in params.items():
            for name, v in leaves.items():
                p = getattr(system, c)._parameters[name]
                assert p.grad is None and p.requires_grad == _trainable(c, name)
                if not _trainable(c, name):  # frozen leaves never move
                    np.testing.assert_array_equal(p.detach().numpy(), v)


def test_lr_schedule_other_than_constant_raises_in_both():
    params, _ = _setup()
    jparams = {c: {"params": leaves} for c, leaves in params.items()}
    with pytest.raises(ValueError, match="cosine"):
        make_optimizer(jparams, _trainable, JOptimizerConfig(lr_schedule="cosine"))
    system = types.SimpleNamespace(**{c: _Leaves(leaves) for c, leaves in params.items()})
    with pytest.raises(ValueError, match="cosine"):
        TrainState(system, _trainable, OptimizerConfig(lr_schedule="cosine"))


def test_export_reference_pth_matches_jax(tmp_path):
    js = JCamAnimate(jax_tiny_config(motion_max_len=4))
    params = jax_system_params(js, 4, 32, 32)
    trained = {c: params[c] for c in TRAIN_COMPONENTS}
    want = j_export_reference_pth(trained, str(tmp_path / "jax"), 7)
    system = CamAnimate(tiny_config(motion_max_len=4), device="cpu").load_jax_params(params)
    state = TrainState(system, stage1_trainable)
    with torch.no_grad():  # the masters, not the modules' copies, are exported
        for p in state.params:
            p.add_(1.0)
    got = export_reference_pth(system, state, str(tmp_path / "port"), 7)
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
    assert "camera_pose_encoder-7.pth" in got[-1]
    for g, w in zip(got, want):
        g_sd, w_sd = torch.load(g, weights_only=True), torch.load(w, weights_only=True)
        assert g_sd.keys() == w_sd.keys(), g
        for key in w_sd:
            assert g_sd[key].dtype == torch.float32
            np.testing.assert_array_equal(g_sd[key].numpy(), w_sd[key].numpy(), err_msg=key)
