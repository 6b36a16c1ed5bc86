"""Checkpoints of a data-parallel train state on the CPU (gloo ranks spawned
with ``parallel.launch``), tiny stage-2 config, fp32.

- the per-module files saved at 4 ranks with ZeRO-1 hold whole tensors
  (rank 0 writes them after the moments are gathered), and a run resumed
  from them at 2 ranks or at 1 continues like an unbroken run at that world
  size: masters and moments within 1e-6 (the ranks' gradient sums add in
  another order at another world size, so bits are not expected; the
  moments are fp32, as the shipped recipes keep them: a bf16 first moment
  turns those last-bit differences into whole bf16 steps);
- the ``torch.distributed.checkpoint`` backend (``DcpCheckpointer``) with
  ZeRO-1 shards as DTensors: restored onto the same mesh, every master,
  moment and count is the same bits and the modules hold the masters; the
  rotation keeps the newest K steps.
"""

import numpy as np
import pytest
import torch

from humanvid_tpu_torch.parallel.launch import launch
from humanvid_tpu_torch.pipelines import tiny_config
from humanvid_tpu_torch.tools.dryrun_multichip import dcp_worker, train_worker
from humanvid_tpu_torch.train import OptimizerConfig, TrainConfig, sample_draws, stage_config

F, H, W = 2, 32, 32
B = 4  # the global batch


def _batch(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"tgt": (rng.normal(size=(B, F, H, W, 3)) * 0.5).astype(f32),
            "ref": (rng.normal(size=(B, H, W, 3)) * 0.5).astype(f32),
            "clip": rng.normal(size=(B, 28, 28, 3)).astype(f32),
            "pose": rng.random((B, F, H, W, 3)).astype(f32),
            "plucker": rng.normal(size=(B, F, H, W, 6)).astype(f32)}


@pytest.fixture(scope="module")
def spec():
    gen = torch.Generator().manual_seed(5)
    config = stage_config(2, tiny_config(motion_max_len=4), gradient_checkpointing=True)
    return dict(config=config, seed=4, device="cpu", train=TrainConfig(uncond_ratio=0.3),
                optimizer=OptimizerConfig(warmup_steps=1),
                batches=[_batch(70 + i) for i in range(4)],
                draws=[sample_draws(gen, B, F, H, W, 1000, 0.3) for _ in range(4)])


@pytest.fixture(scope="module")
def saved_at_four(spec, tmp_path_factory):
    """Two steps at 4 ranks with ZeRO-1, saved at step 2."""
    path = str(tmp_path_factory.mktemp("zero1_at_4"))
    out = launch(train_worker, 4, args=(dict(spec, mesh="flat", zero1=True,
                                             batches=spec["batches"][:2],
                                             draws=spec["draws"][:2], save=path),),
                 timeout_s=120, join_timeout_s=300)
    assert out[0]["sharded"]
    return path, out


@pytest.mark.parametrize("world", [2, 1])
def test_zero1_files_resume_at_another_world_size(spec, saved_at_four, world):
    path, at_four = saved_at_four
    opt = torch.load(f"{path}/opt_state-2.pt", weights_only=True)
    # whole tensors, the same as the gathered state
    for name, t in at_four[0]["opt_state"]["nu"].items():
        assert torch.equal(opt["nu"][name], t)
    mesh = "flat" if world > 1 else None
    resumed = launch(train_worker, world, args=(dict(
        spec, mesh=mesh, zero1=world > 1, load=(path, 2), batches=spec["batches"][2:],
        draws=spec["draws"][2:]),), timeout_s=120, join_timeout_s=300)
    straight = launch(train_worker, world, args=(dict(spec, mesh=mesh, zero1=world > 1),),
                      timeout_s=120, join_timeout_s=300)
    assert len(resumed[0]["masters"]) == 2 and len(straight[0]["masters"]) == 4
    for name, m in straight[0]["masters"][-1].items():
        np.testing.assert_allclose(resumed[0]["masters"][-1][name].numpy(), m.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    for key in ("mu", "nu"):
        for name, t in straight[0]["opt_state"][key].items():
            np.testing.assert_allclose(resumed[0]["opt_state"][key][name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"{key} {name}")
    assert resumed[0]["opt_state"]["step"] == straight[0]["opt_state"]["step"] == 4


def test_distributed_checkpoint_round_trip_and_rotation(spec, tmp_path):
    out = launch(dcp_worker, 2, args=(dict(spec, dir=str(tmp_path / "dcp"), keep=2),),
                 timeout_s=120, join_timeout_s=300)
    for r in out:
        assert r["restored_step"] == 4 and r["kept"] == [3, 4]
        assert r["same"] and r["params_same"] and r["sharded"] > 0
    assert sorted(p.name for p in (tmp_path / "dcp").iterdir()) == ["3", "4"]
