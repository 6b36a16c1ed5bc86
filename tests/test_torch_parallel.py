"""Data-parallel training on the CPU: the port's ranks (gloo, spawned with
``parallel.launch`` on a ``file://`` store) against the JAX package's step
jitted over its 8-device virtual CPU mesh, fp32, tiny config, 32x32x2f.

- a flat step at 4 ranks against ``jax.jit`` over ``make_mesh(4)`` (one
  clip a device), and 2 micro-steps under accumulation 2 against JAX's
  ``MultiSteps`` on the mesh: each micro-step's loss (rtol 1e-5), its
  gradient as all-reduced over the ranks against ``jax.grad`` of the same
  loss over the mesh, every entry of every leaf (rtol 1e-4, atol 1e-4 of
  the leaf's largest entry, as the one-device step's test: both sides sum
  in other orders), its logged ``grad_norm`` (the norm of the reduced
  gradient; rtol 1e-4, as the one-device step's test), and the masters
  after the update (rtol 1e-5,
  atol 1e-6, the tolerances of ``tests/test_hierarchical_mesh.py``, on
  every entry whose first AdamW update ``lr * g / (|g| + eps)`` has
  saturated at lr on the JAX side, |g| >> eps, where the two sides' small
  gradient differences cannot move it; within two learning rates
  elsewhere, where a gradient near eps or within its noise of 0 sets it);
- a hierarchical 2 x 2 step equal to the flat one, with ZeRO-1 on ``data``
  sharding leaves, and the ranks' rows partitioning the global batch in
  rank order;
- ZeRO-1 against the replicated state at the same world size: the masters
  the same bits over 3 updates, with a bf16 first moment and accumulation 2;
- ``init_distributed`` refusing two NCCL ranks on one card and a card
  that is not there, ``dryrun_multichip`` taking the cards unless told, and
  the gcd rule.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_helpers import jax_system_params
from humanvid_tpu.parallel.mesh import make_mesh as j_make_mesh
from humanvid_tpu.pipelines.system import CamAnimate as JCamAnimate
from humanvid_tpu.pipelines.system import tiny_config as jax_tiny_config
from humanvid_tpu.train import OptimizerConfig as JOptimizerConfig
from humanvid_tpu.train import TrainConfig as JTrainConfig
from humanvid_tpu.train import TrainState as JTrainState
from humanvid_tpu.train import make_optimizer, make_train_step
from humanvid_tpu.train import stage2_trainable as j_stage2
from humanvid_tpu.train.state import combine_params, partition_params
from humanvid_tpu.train.step import make_loss_fn
from humanvid_tpu_torch.parallel import mesh as pmesh
from humanvid_tpu_torch.parallel.launch import launch
from humanvid_tpu_torch.pipelines import CamAnimate, tiny_config
from humanvid_tpu_torch.tools.dryrun_multichip import train_worker
from humanvid_tpu_torch.train import Draws, OptimizerConfig, TrainConfig, stage_config
from humanvid_tpu_torch.utils.weights import from_jax_params

RANKS, F, H, W = 4, 2, 32, 32
UNCOND_RATIO = 0.5
KINDS = {"denoising_unet": "unet", "camera_encoder": "camera_encoder"}


def batch(b, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"tgt": (rng.normal(size=(b, F, H, W, 3)) * 0.5).astype(f32),
            "ref": (rng.normal(size=(b, H, W, 3)) * 0.5).astype(f32),
            "clip": rng.normal(size=(b, 28, 28, 3)).astype(f32),
            "pose": rng.random((b, F, H, W, 3)).astype(f32),
            "plucker": rng.normal(size=(b, F, H, W, 6)).astype(f32)}


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, -3).copy())


def jax_draws(key, step, b, ratio=UNCOND_RATIO):
    """The JAX step's draws at ``step`` for a global batch of b, NCHW."""
    r_noise, r_off, r_t, r_vae1, r_vae2, r_unc = jax.random.split(
        jax.random.fold_in(key, step), 6)
    h8, w8 = H // 8, W // 8
    return Draws(
        noise=_nchw(jax.random.normal(r_noise, (b, F, h8, w8, 4))),
        offset_noise=_nchw(jax.random.normal(r_off, (b, 1, 1, 1, 4))),
        t=torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, 1000))).long(),
        vae_eps=_nchw(jax.random.normal(r_vae1, (b * F, h8, w8, 4))),
        ref_vae_eps=_nchw(jax.random.normal(r_vae2, (b, h8, w8, 4))),
        uncond=bool(jax.random.bernoulli(r_unc, ratio)))


def _prune(tree):
    """A nested dict without its None leaves and empty branches."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}


def port_state_dicts(params, config):
    system = CamAnimate(config, device="cpu").load_jax_params(params)
    return {name: m.state_dict() for name, m in system.components().items()}


@pytest.fixture(scope="module")
def weights():
    js = JCamAnimate(jax_tiny_config(motion_max_len=4))
    return js, jax_system_params(js, F, H, W)


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "accumulate2"])
def jax_run(request, weights):
    """JAX's stage-2 step jitted over make_mesh(4), batch sharded over
    ``data``, k micro-steps under ``MultiSteps(k)``: per micro-step (loss,
    grad_norm) and the trainable gradients (``jax.grad`` of the step's loss
    on the same sharded batch and key, at the params the micro-step sees,
    which ``MultiSteps`` keeps until the k-th), and the trainable params
    after the k-th."""
    k = request.param
    js, params = weights
    frozen = {c: params[c] for c in ("vae_encoder", "vae_decoder", "clip")}
    trainable = {c: params[c] for c in ("reference_unet", "denoising_unet", "pose_guider",
                                        "camera_encoder")}
    tx = make_optimizer(trainable, j_stage2,
                        JOptimizerConfig(warmup_steps=0, gradient_accumulation_steps=k))
    state = JTrainState.create(trainable, frozen, tx)
    mesh = j_make_mesh(RANKS)
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    state_sh = jax.tree.map(lambda _: repl, state)
    step = jax.jit(make_train_step(js, js.make_schedule(beta_schedule="scaled_linear"),
                                   JTrainConfig(uncond_ratio=UNCOND_RATIO),
                                   trainable_predicate=j_stage2),
                   in_shardings=(state_sh, shard, repl), out_shardings=(state_sh, repl))
    loss_fn = make_loss_fn(js, js.make_schedule(beta_schedule="scaled_linear"),
                           JTrainConfig(uncond_ratio=UNCOND_RATIO))

    def grads_fn(params, frozen, b, rng):
        train_part, static = partition_params(params, j_stage2)
        return jax.grad(lambda tp: loss_fn(combine_params(tp, static), frozen, b, rng)[0])(
            train_part)

    grads_fn = jax.jit(grads_fn, in_shardings=(repl, repl, shard, repl), out_shardings=repl)
    state = jax.device_put(state, state_sh)
    key = jax.random.PRNGKey(11)
    batches = [batch(RANKS, 40 + i) for i in range(k)]
    aux, grads = [], []
    for b in batches:
        jb = {n: jax.device_put(jnp.asarray(v), shard) for n, v in b.items()}
        g = grads_fn(state.params, state.frozen, jb, jax.random.fold_in(key, state.step))
        grads.append({c: from_jax_params(_prune(jax.device_get(g[c])), kind)
                      for c, kind in KINDS.items()})
        state, a = step(state, jb, key)
        aux.append((float(a["loss"]), float(a["grad_norm"])))
    new = {c: from_jax_params(jax.device_get(state.params[c]), kind) for c, kind in KINDS.items()}
    draws = [jax_draws(key, i, RANKS) for i in range(k)]
    return k, batches, draws, aux, grads, new


def _spec(params, **kw):
    config = tiny_config(motion_max_len=4)
    spec = dict(config=config, state_dicts=port_state_dicts(params, config), device="cpu",
                train=TrainConfig(uncond_ratio=UNCOND_RATIO), mesh="flat")
    spec.update(kw)
    return spec


def test_dp_step_matches_jax_on_its_mesh(weights, jax_run):
    _, params = weights
    k, batches, draws, aux, j_grads, new = jax_run
    spec = _spec(params, batches=batches, draws=draws, keep_grads=True,
                 optimizer=OptimizerConfig(warmup_steps=0, gradient_accumulation_steps=k))
    out = launch(train_worker, RANKS, args=(spec,), timeout_s=120, join_timeout_s=300)
    for r in out:  # every rank logs the reduced values
        assert r["loss"] == out[0]["loss"] and r["grad_norm"] == out[0]["grad_norm"]
    for (loss, norm), j in zip(zip(out[0]["loss"], out[0]["grad_norm"]), aux):
        np.testing.assert_allclose(loss, j[0], rtol=1e-5)
        np.testing.assert_allclose(norm, j[1], rtol=1e-4)
    assert len(out[0]["grads"]) == k
    for got, ref in zip(out[0]["grads"], j_grads):  # the mean over the ranks, every entry
        assert sorted(got) == sorted(f"{c}/{n}" for c, sd in ref.items() for n in sd)
        for name, g in got.items():
            comp, _, key = name.partition("/")
            r = ref[comp][key].numpy()
            scale = max(float(np.abs(r).max()), 1e-12)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
    assert len(out[0]["masters"]) == 1  # one update after k micro-steps
    masters = out[0]["masters"][0]
    start = {f"{c}/{n}": v for c, sd in spec["state_dicts"].items() for n, v in sd.items()}
    lr = OptimizerConfig().learning_rate
    checked = 0
    for name, got in masters.items():
        comp, _, key = name.partition("/")
        ref, old = new[comp][key].numpy(), start[name].numpy()
        delta, j_delta = got.numpy() - old, ref - old
        # AdamW's first step moves an entry by lr * g / (|g| + eps) (plus
        # lr * wd * p): where that has saturated, the masters agree to the
        # stated tolerance
        sure = np.abs(j_delta) > 0.99 * lr
        np.testing.assert_allclose(got.numpy()[sure], ref[sure], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert (np.abs(delta - j_delta) <= 2 * lr + np.spacing(np.abs(old))).all(), name
        checked += int(sure.sum())
    assert checked > 0.5 * sum(m.numel() for m in masters.values())


def test_hierarchical_equals_flat_and_zero1_shards_on_data(weights):
    _, params = weights
    b, d = batch(RANKS, 50), jax_draws(jax.random.PRNGKey(3), 0, RANKS)
    common = dict(batches=[b], draws=[d], optimizer=OptimizerConfig(warmup_steps=0))
    flat = launch(train_worker, RANKS, args=(_spec(params, **common),), timeout_s=120,
                  join_timeout_s=300)
    hier = launch(train_worker, RANKS, args=(_spec(params, mesh=("hier", 2), zero1=True,
                                                   **common),),
                  timeout_s=120, join_timeout_s=300)
    np.testing.assert_allclose(hier[0]["loss"], flat[0]["loss"], rtol=1e-5)
    for name, m in flat[0]["masters"][0].items():
        np.testing.assert_allclose(hier[0]["masters"][0][name].numpy(), m.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert hier[0]["sharded"], "no leaf sharded over data"
    assert all(r["masters"][0].keys() == hier[0]["masters"][0].keys() for r in hier)
    for r in hier[1:]:
        assert all(torch.equal(r["masters"][0][n], m) for n, m in hier[0]["masters"][0].items())
    # the rows partition the global batch in rank order, on both meshes
    for runs in (flat, hier):
        assert sum((r["rows"] for r in runs), []) == list(range(2 * RANKS))


def test_zero1_gives_the_replicated_bits():
    """bf16 mu and accumulation 2, 6 micro-steps (3 updates) at 2 ranks,
    with the stage-2 size rule's default ``min_size``: every master the same
    bits with and without ZeRO-1, and on both ranks; the gathered moments
    too."""
    config = stage_config(2, tiny_config(motion_max_len=4), gradient_checkpointing=True)
    gen = torch.Generator().manual_seed(0)
    from humanvid_tpu_torch.train import sample_draws

    draws = [sample_draws(gen, 2, F, H, W, 1000, 0.3) for _ in range(6)]
    spec = dict(config=config, seed=3, device="cpu", train=TrainConfig(uncond_ratio=0.3),
                mesh="flat",
                batches=[batch(2, 60 + i) for i in range(6)], draws=draws,
                optimizer=OptimizerConfig(warmup_steps=1, gradient_accumulation_steps=2,
                                          mu_dtype="bfloat16", max_grad_norm=0.05))
    plain = launch(train_worker, 2, args=(spec,), timeout_s=120, join_timeout_s=300)
    zero = launch(train_worker, 2, args=(dict(spec, zero1=True),), timeout_s=120,
                  join_timeout_s=300)
    assert zero[0]["sharded"] and not plain[0]["sharded"]
    assert len(zero[0]["masters"]) == 3
    for u in range(3):
        for name, m in plain[0]["masters"][u].items():
            for r in zero + plain[1:]:
                assert torch.equal(r["masters"][u][name], m), (u, name)
    assert zero[0]["grad_norm"] == plain[0]["grad_norm"]
    assert zero[1]["opt_state"] is None  # gathered to rank 0
    for key in ("mu", "nu", "acc"):
        for name, t in plain[0]["opt_state"][key].items():
            z = zero[0]["opt_state"][key][name]
            assert z.dtype == t.dtype and torch.equal(z, t), (key, name)


def test_take_rows_partitions_in_order():
    b = {"x": np.arange(12).reshape(6, 2), "y": list(range(6)),
         "d": Draws(*(torch.arange(6),) * 5, uncond=True)}
    parts = [pmesh.take_rows(b, i, 3) for i in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), b["x"])
    assert sum((p["y"] for p in parts), []) == b["y"]
    assert all(p["d"].uncond is True and isinstance(p["d"], Draws) for p in parts)
    assert torch.equal(torch.cat([p["d"].t for p in parts]), torch.arange(6))
    with pytest.raises(ValueError, match="do not split"):
        pmesh.take_rows(b, 0, 4)


def test_init_distributed_refuses_two_nccl_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="Duplicate GPU detected.*gloo"):
        pmesh.init_distributed("cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        pmesh.init_distributed("cpu", "nccl")
    assert not torch.distributed.is_initialized()


def test_init_distributed_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device.*CPU"):
        pmesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_runs_on_the_card_unless_told(monkeypatch, capsys):
    """With no ``--device`` the dry run takes the cards, on NCCL: without a
    card it exits 2, and ranks that outnumber the cards are refused with a
    message naming gloo, before any rank starts."""
    from humanvid_tpu_torch.tools import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun_multichip.main(["--ranks", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dryrun_multichip, "launch", lambda *a, **k: pytest.fail("launched"))
    with pytest.raises(SystemExit) as exit_:
        dryrun_multichip.main(["--ranks", "2"])
    assert exit_.value.code == 2 and "--backend gloo" in capsys.readouterr().err


@pytest.mark.parametrize("train_bs,world,ok", [(8, 8, True), (8, 4, True), (1, 1, True),
                                               (1, 2, False), (6, 4, False)])
def test_gcd_rule(train_bs, world, ok):
    if ok:
        assert pmesh.data_parallel_world(train_bs, world) == world
    else:
        import math

        with pytest.raises(ValueError, match=f"gcd {math.gcd(train_bs, world)}"):
            pmesh.data_parallel_world(train_bs, world)


def test_no_group_without_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and pmesh.world_size() == 1
    assert os.environ.get("WORLD_SIZE") is None
