"""Kernel C's function on the CPU: the port's ``group_norm_act`` (its plain
version and its autograd Function) against the JAX package's ``_fused`` (the
Pallas statistics kernel in interpret mode, as ``tests/test_ops.py`` runs it)
and ``_reference``, fp32.

Inputs are made with numpy in the JAX package's NHWC layout and transposed
to the port's NCHW. Tolerances are those of ``tests/test_ops.py``: 2e-5 on
values, 2e-4 on the gradients of x, weight and bias under sum(y^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_helpers import nchw, nhwc
from humanvid_tpu.ops.group_norm import _fused, _reference
from humanvid_tpu_torch.ops import group_norm as gn

VALUE_TOL = 2e-5
GRAD_TOL = 2e-4
EPS = 1e-6
SHAPES = [((2, 8, 8, 64), 8), ((1, 7, 5, 32), 4), ((2, 5, 7, 320), 32)]


def _inputs(shape, seed, shift=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    return x, w, b


def _port(x, w, b, groups, act, memory_format):
    xt = nchw(x).contiguous(memory_format=memory_format).requires_grad_()
    wt, bt = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = gn.group_norm_act(xt, wt, bt, groups, EPS, act)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    assert y.is_contiguous(memory_format=memory_format)
    grads = torch.autograd.grad(y.square().sum(), (xt, wt, bt))
    return y, grads


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last],
                         ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES, ids=lambda v: str(v))
def test_group_norm_matches_jax_fused_and_reference(shape, groups, act, memory_format):
    x, w, b = _inputs(shape, 11)
    y, (dx, dw, db) = _port(x, w, b, groups, act, memory_format)
    xj, wj, bj = map(jnp.asarray, (x, w, b))
    ref = _reference(xj, wj, bj, groups, EPS, act)
    with pltpu.force_tpu_interpret_mode():
        fused = _fused(xj, wj, bj, groups, EPS, act, True)
        g_fused = jax.grad(lambda *a: jnp.sum(_fused(*a, groups, EPS, act, True) ** 2),
                           (0, 1, 2))(xj, wj, bj)
    for want in (ref, fused):
        np.testing.assert_allclose(nhwc(y), np.asarray(want), rtol=VALUE_TOL, atol=VALUE_TOL)
    g_ref = jax.grad(lambda *a: jnp.sum(_reference(*a, groups, EPS, act) ** 2),
                     (0, 1, 2))(xj, wj, bj)
    for want in (g_ref, g_fused):
        np.testing.assert_allclose(nhwc(dx), np.asarray(want[0]), rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("act", [None, "silu"], ids=["none", "silu"])
def test_group_norm_keeps_digits_when_mean_dwarfs_std(act):
    """x * 0.1 + 50: the one-pass E[x^2] - mean^2 of the JAX kernel loses
    the variance's digits here; the port's centred statistics hold a float64
    reference to 1e-4."""
    shape, groups = (2, 5, 7, 320), 32
    x, w, b = _inputs(shape, 12, shift=50.0, scale=0.1)
    y = gn.group_norm_act(nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups, EPS, act)
    x64 = nchw(x).double()
    ref = torch.nn.functional.group_norm(x64, groups, torch.from_numpy(w).double(),
                                         torch.from_numpy(b).double(), EPS)
    if act == "silu":
        ref = torch.nn.functional.silu(ref)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_group_norm_plain_rounds_once_in_bf16():
    """bf16 x with fp32 weights: fp32 math, one rounding of the result."""
    x, w, b = _inputs((2, 4, 6, 64), 13)
    xt = nchw(x).to(torch.bfloat16)
    y = gn.group_norm_act_plain(xt, torch.from_numpy(w), torch.from_numpy(b), 8, EPS, "silu")
    ref = gn.group_norm_act_plain(xt.float(), torch.from_numpy(w), torch.from_numpy(b), 8, EPS,
                                  "silu")
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref.to(torch.bfloat16))


def test_group_norm_rejects_what_it_does_not_take():
    x = torch.zeros((1, 12, 4, 4))
    w = torch.ones(12)
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, w, 5, EPS)          # 12 channels, 5 groups
    with pytest.raises(ValueError):
        gn.group_norm_act(x, w, w, 4, EPS, "gelu")  # only None or "silu"
    with pytest.raises(ValueError):
        gn.group_norm_act(x[0], w, w, 4, EPS)       # not (N, C, H, W)
    with pytest.raises(ValueError):                 # the CUDA wrapper takes no CPU tensor
        gn.group_norm_act_cuda(x.to(torch.bfloat16), w, w, 4, EPS)


# The GroupNorms of the UNet at 768x512 (latent 96x64) and 896x512 (112x64),
# 24 frames: (C, H*W) at each level, the up-blocks' concatenations included.
UNET_GROUP_NORMS = [(c, (h // f) * (w // f)) for h, w in ((96, 64), (112, 64)) for c, f in (
    (320, 1), (640, 1), (960, 1), (320, 2), (640, 2), (960, 2), (1280, 2), (1920, 2),
    (640, 4), (1280, 4), (1920, 4), (2560, 4), (1280, 8), (2560, 8))]


def _assert_plan_holds(c, hw, groups, plan):
    cg = c // groups
    assert plan.slab % 8 == 0 and plan.slab % cg == 0 and c % plan.slab == 0
    assert gn.MIN_SLAB <= plan.slab <= gn.MAX_SLAB and plan.slab // cg <= gn.MAX_GROUPS
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.rows % plan.chunk == 0 and plan.chunk * plan.slab * 2 <= gn.CHUNK_BYTES
    assert plan.cluster * plan.rows >= hw > (plan.cluster - 1) * plan.rows  # no idle block
    assert plan.resident % plan.chunk == 0 and plan.chunk <= plan.resident <= plan.rows
    assert plan.resident // plan.chunk <= gn.MAX_CHUNKS
    assert plan.resident * plan.slab * 2 <= gn.CTA_BYTES
    assert plan.rows - plan.resident <= gn.REREAD * plan.resident


@pytest.mark.parametrize("c,hw", UNET_GROUP_NORMS, ids=lambda v: str(v))
def test_cluster_plan_takes_every_unet_group_norm_in_one_pass(c, hw):
    """The size rule sends every GroupNorm of the UNet (32 groups) to the
    one-pass cluster kernel, with a tiling the kernel takes."""
    plan = gn.cluster_plan(c, hw, 32)
    assert plan is not None
    _assert_plan_holds(c, hw, 32, plan)


@pytest.mark.parametrize("c,h,w,one_pass", [
    (512, 96, 64, True),      # the VAE decoder's mid block and first up block
    (512, 192, 128, False),
    (512, 384, 256, False),
    (256, 384, 256, False),
    (256, 768, 512, False),
    (128, 768, 512, False),
    (128, 1536, 1024, False),
])
def test_cluster_plan_leaves_the_larger_decode_shapes_to_two_passes(c, h, w, one_pass):
    """A 24-frame decode reaches the same shapes at decode chunk 8 or 24
    (the rule does not read N): from 192x128 up a sample's slab fits no
    cluster, and the two-pass kernels take it."""
    plan = gn.cluster_plan(c, h * w, 32)
    assert (plan is not None) == one_pass
    if plan is not None:
        _assert_plan_holds(c, h * w, 32, plan)


def test_smoke_cases_hold_every_plan_of_the_paths():
    """``chip_smoke.py``'s kernel-C cases take every plan the size rule
    gives the UNet's GroupNorms and the decode's (so each is held to the
    plain version on the card), and both sides of the rule."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = smoke.group_norm_cases()
    held = {gn.cluster_plan(shape[1], shape[2] * shape[3], 32) for _, shape, _ in cases}
    decode = [(c, h * w) for c, h, w in ((512, 96, 64), (512, 192, 128), (512, 384, 256),
                                         (256, 384, 256), (256, 768, 512), (128, 768, 512))]
    reached = {gn.cluster_plan(c, hw, 32) for c, hw in UNET_GROUP_NORMS + decode}
    assert None in reached and reached <= held, reached - held
    assert any(name + " channels_last act=silu" == smoke.GN_ONE_PASS_HEADLINE
               and gn.cluster_plan(shape[1], shape[2] * shape[3], 32) is not None
               for name, shape, _ in cases)


def test_cluster_plan_holds_its_limits_over_a_grid_of_shapes(monkeypatch):
    """Wherever the rule returns a plan, the kernel's limits hold: whole
    groups in 8-channel multiples, no idle block, shared memory, the
    mbarriers, at most REREAD re-read; the widest slab that needs no
    re-read wins over any that does, and some shape in the grid re-reads."""
    remainders = 0
    for c in (64, 128, 192, 320, 512, 640, 960, 1280, 1920, 2560, 4096):
        for groups in (8, 16, 32):
            if c % groups:
                continue
            for hw in (1, 7, 96, 1000, 1073, 6144, 7168, 24576, 100000):
                plan = gn.cluster_plan(c, hw, groups)
                if plan is None:
                    continue
                _assert_plan_holds(c, hw, groups, plan)
                remainders += plan.resident < plan.rows
                wider = [s for s in gn._slabs(c, groups) if s > plan.slab]
                for s in wider:  # a wider slab fits no cluster as well as this one
                    with monkeypatch.context() as m:
                        m.setattr(gn, "MIN_SLAB", s)
                        other = gn.cluster_plan(c, hw, groups)
                    assert other is None or (plan.resident == plan.rows
                                             and other.resident < other.rows)
    assert remainders >= 1


def test_cluster_plan_remainder_and_overrides(monkeypatch):
    """The UNet's level 0 (320 channels, 6144 rows) takes 160-channel slabs
    on clusters of 16, each block holding 96 of its 384 rows and re-reading
    the rest from L2; the stage-2 concatenation (960 channels, 7168 rows)
    holds 128 of 448. The rule's module constants, which the variants tool
    replaces, move it: blocks of 90 KB hold the level-0 rows whole on
    80-channel slabs, clusters of at most 4 send it to two passes, and
    slabs of 32 channels open where the floor of 64 closed them."""
    assert gn.cluster_plan(320, 6144, 32) == gn.ClusterPlan(160, 16, 384, 32, 96)
    assert gn.cluster_plan(960, 7168, 32) == gn.ClusterPlan(120, 16, 448, 64, 128)
    assert gn.cluster_plan(32, 6144, 32) is None                # slabs of 32 < MIN_SLAB
    with monkeypatch.context() as m:
        m.setattr(gn, "CTA_BYTES", 90 * 1024)
        m.setattr(gn, "REREAD", 0.25)
        assert gn.cluster_plan(320, 6144, 32) == gn.ClusterPlan(80, 16, 384, 64, 384)
    with monkeypatch.context() as m:
        m.setattr(gn, "MAX_CLUSTER", 4)
        assert gn.cluster_plan(320, 6144, 32) is None
    with monkeypatch.context() as m:
        m.setattr(gn, "MIN_SLAB", 32)
        assert gn.cluster_plan(32, 6144, 32) is not None
    # the wrapper's cached plans are the rule's
    assert gn._plan(320, 6144, 32) == gn.cluster_plan(320, 6144, 32)


def _warp_sum(v):
    """The kernel's ``warp_sum`` of 32 lanes' fp32 values: a butterfly,
    every lane adding the lane 16, 8, 4, 2, 1 apart."""
    v = np.asarray(v, dtype=np.float32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def _cluster_statistics(x, groups, plan):
    """The one-pass kernel's statistics in numpy fp32, in its order (FMA
    contraction aside): each block's rows, its row lanes (pivot = the
    lane's first value, sums of x - pivot row after row, the lane's mean
    and M2 from them), the lanes merged in two division-free steps (the
    mean from the lanes' offsets to lane 0's mean, then M2 with each
    lane's n * (mean_l - mean)^2), the blocks the same way in rank order,
    then each group's channels over a warp: lane j takes channels j,
    j + 32, ..., and the lanes' sums meet in the kernel's shuffle tree.
    x: (HW, C) of one sample. Returns the groups' (mean, variance)."""
    f32 = np.float32
    hw, c = x.shape
    s, k, t = plan.slab, plan.cluster, plan.rows
    lanes = 256 // (s // 8)
    cg = c // groups

    def two_step(counts, parts, total):
        """Merge (mean, M2) partials of `counts` rows each, in order."""
        ref = parts[0][0]
        sd = np.zeros_like(ref)
        for n, (m, _) in zip(counts, parts):
            sd = sd + f32(n) * (m - ref)
        mean = ref + sd / f32(total)
        m2 = np.zeros_like(ref)
        for n, (m, q) in zip(counts, parts):
            dd = m - mean
            m2 = m2 + (q + f32(n) * dd * dd)
        return mean, m2

    means, variances = [], []
    for c0 in range(0, c, s):
        blocks, block_rows = [], []
        for rank in range(k):
            rows = x[rank * t:min(hw, rank * t + t), c0:c0 + s]
            parts, counts = [], []
            for p in range(lanes):
                lane = rows[p::lanes]
                n = len(lane)
                if not n:  # an empty lane adds n = 0, so nothing
                    parts.append((np.zeros(s, f32), np.zeros(s, f32)))
                    counts.append(0)
                    continue
                s1, s2 = np.zeros(s, f32), np.zeros(s, f32)
                for row in lane:
                    d = row - lane[0]
                    s1 = s1 + d
                    s2 = s2 + d * d
                parts.append((lane[0] + s1 / f32(n), np.maximum(s2 - s1 * s1 / f32(n), f32(0))))
                counts.append(n)
            blocks.append(two_step(counts, parts, len(rows)))
            block_rows.append(len(rows))
        chan_mean, chan_m2 = two_step(block_rows, blocks, hw)
        for g in range(s // cg):
            cm, cq = chan_mean[g * cg:(g + 1) * cg], chan_m2[g * cg:(g + 1) * cg]
            ref = cm[0]
            sd, m2 = np.zeros(32, f32), np.zeros(32, f32)
            for j in range(cg):
                sd[j % 32] += cm[j] - ref
            mean = ref + _warp_sum(sd) / f32(cg)
            for j in range(cg):
                dd = cm[j] - mean
                m2[j % 32] += cq[j] + f32(hw) * dd * dd
            means.append(mean)
            variances.append(_warp_sum(m2) / (f32(hw) * f32(cg)))
    return np.array(means), np.array(variances)


@pytest.mark.parametrize("c,h,w,shift", [(320, 37, 29, 0.0), (320, 37, 29, 50.0),
                                         (960, 16, 33, 0.0)])
def test_cluster_tiling_merges_to_the_group_statistics(c, h, w, shift):
    """The kernel's partition of rows (blocks, lanes, the ragged last block)
    and its fixed merge order give each group's mean and variance to fp32
    accuracy, also when |mean| >> std (the pivot keeps the digits)."""
    groups = 32
    plan = gn.cluster_plan(c, h * w, groups)
    assert plan is not None
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(h * w, c)) * (0.1 if shift else 1.0) + shift).astype(np.float32)
    mean, var = _cluster_statistics(x, groups, plan)
    xg = x.astype(np.float64).reshape(h * w, groups, c // groups).transpose(1, 0, 2)
    xg = xg.reshape(groups, -1)
    np.testing.assert_allclose(mean, xg.mean(1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var, xg.var(1), rtol=1e-4, atol=1e-7)
