"""The measurement probes (``humanvid_tpu_torch.tools``): the plain versions
of kernels 8-10 against the JAX functions on the CPU, the microbench
tool's registry and entry point, and the design variants of kernel A and
kernel 9. The CUDA kernels are held to the plain versions on the card in
test_torch_cuda.py.

Kernel 8's arms are nested functions of the JAX tool and cannot be
imported: each is held to ``jax.lax.dot_general`` with the arm's
contraction dimensions, stored slice and zero padding, in fp32 (2e-4: only
the summation order differs). Kernel 9's plain version is held to the JAX
``_flash_fwd(..., with_lse=True)`` (the Pallas kernel in interpret mode),
out and log2 LSE, in fp32 at 2e-4 as kernel A's. Kernel 10's plain version
must equal bf16 ``x * 1.0001 + 0.5`` in ``jnp`` bit for bit.
"""

import ast
import ctypes
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_helpers  # noqa: F401  (caps torch threads)
from humanvid_tpu.ops.common import NEG_INF
from humanvid_tpu.ops.flash_attention import _flash_fwd
from humanvid_tpu_torch.ops import cuda_build
from humanvid_tpu_torch.tools import flash_variants, microbench
from humanvid_tpu_torch.tools import probe_kernels as pk

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-4


def _dot(a, b, dims):
    return jax.lax.dot_general(a, b, (dims, ((), ())), preferred_element_type=jnp.float32)


def _jax_arm(arm, a, b, d):
    """The JAX probe's arm (``tools/microbench.py:259-287``), batched over G."""
    def one(x, y):
        if arm == "qk_d_on_lanes":
            return _dot(x, y, ((1,), (1,)))[:, :128]
        if arm == "qk_d_on_sublanes":
            return _dot(x, y, ((0,), (0,)))[:, :128]
        if arm == "pv_d_on_lanes":
            return jnp.pad(_dot(x, y, ((1,), (0,))), ((0, 0), (0, 128 - d)))
        return _dot(x, y, ((1,), (1,)))[:, :1024]
    return jax.vmap(one)(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("arm,d", [
    ("qk_d_on_lanes", 40), ("qk_d_on_sublanes", 40), ("pv_d_on_lanes", 40),
    ("pv_dmajor_out", 40), ("qk_d_on_lanes", 128),  # the last: the d = 128 control
])
def test_dmajor_plain_matches_dot_general(arm, d):
    G, lq, lk = 2, 64, 256
    shapes = {"qk_d_on_lanes": ((lq, d), (lk, d)), "qk_d_on_sublanes": ((d, lq), (d, lk)),
              "pv_d_on_lanes": ((lq, lk), (lk, d)), "pv_dmajor_out": ((d, lk), (lq, lk))}[arm]
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(G,) + s).astype(np.float32) for s in shapes)
    ref = np.asarray(_jax_arm(arm, a, b, d))
    got = pk.dmajor(arm, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    if arm == "pv_d_on_lanes":
        assert (got[:, :, d:] == 0).all()


@pytest.mark.parametrize("b,lq,lk,with_bias", [
    (2, 100, 300, True),    # ragged Lq / Lk, every 7th key hidden
    (2, 128, 256, False),
])
def test_pvt_plain_matches_pallas_interpret(b, lq, lk, with_bias):
    heads, d = 8, 40
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(b, n, heads * d)).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if with_bias:
        bias = np.where(np.arange(lk) % 7 == 0, NEG_INF, 0.0).astype(np.float32)
        bias = np.broadcast_to(bias, (b, lk)).copy()
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = _flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), heads,
            block_q=128, block_kv=128, with_lse=True)
    out, lse = pk.pvt(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
                      None if bias is None else torch.from_numpy(bias))
    assert out.shape == (b, lq, heads * d) and lse.shape == (b, heads, lq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=0)
    # both keep the log-sum-exp in log2 units
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=TOL, rtol=0)


def test_pvt_prescale_rounds_as_jax():
    """In bf16 the scale folded into q rounds as the JAX probe's does: the
    constant to bf16, then the product to bf16, bit for bit."""
    heads, d = 8, 40
    x = np.random.default_rng(2).normal(size=(2, 64, heads * d)).astype(np.float32)
    xq = jnp.asarray(x, jnp.bfloat16)
    ref = (xq * xq.dtype.type(d ** -0.5 * pk.LOG2E)).astype(xq.dtype)
    got = pk._prescale(torch.from_numpy(x).to(torch.bfloat16), heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


def test_hbm_plain_matches_jnp_bit_for_bit():
    x = (np.random.default_rng(3).normal(size=(4, 37, 29, 8)) * 4).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda t: t * 1.0001 + 0.5)(xj)).view(np.int16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = pk.hbm_map(xt)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(xj * 1.0001 + 0.5).view(np.int16), ref)
    # the trap: keeping 1.0001 in fp32 through one rounding gives other bits
    fused = (xt.float() * 1.0001 + 0.5).to(torch.bfloat16)
    assert not torch.equal(fused, got)


def _jax_probe_names():
    """The keys of ``PROBES`` in the JAX tool, read without importing it."""
    tree = ast.parse((ROOT / "tools" / "microbench.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PROBES" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no PROBES in tools/microbench.py")


def test_probe_registry_is_the_jax_one_less_what_is_left_behind():
    jax_names = _jax_probe_names()
    assert len(jax_names) == 13
    assert set(microbench.PROBES) == jax_names - set(microbench.LEFT_BEHIND)
    assert set(microbench.DEFAULT_PROBES) <= set(microbench.PROBES)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name in microbench.LEFT_BEHIND:  # each is listed with its reason
        assert f"`{name}`" in roadmap


@pytest.mark.parametrize("name", sorted(flash_variants.VARIANTS))
def test_flash_variant_edits_apply_to_the_kernel_source(name):
    """Each of kernel A's design variants finds the text of each of its
    edits exactly once in the committed source, so the tool builds what it
    names; only ``kernel`` is the source unchanged."""
    text = flash_variants.variant_source(name)
    base = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert (text == base) == (name == "kernel")


@pytest.mark.parametrize("name", sorted(flash_variants.BWD_VARIANTS))
def test_flash_bwd_variant_edits_apply_to_the_kernel_source(name):
    """The same for the backward's variants, on its source."""
    text = flash_variants.variant_source(name, flash_variants.BWD_VARIANTS,
                                         "flash_attention_bwd.cu")
    base = (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert (text == base) == (name == "kernel")


@pytest.mark.parametrize("name", sorted(flash_variants.PVT_VARIANTS))
def test_flash_pvt_variant_edits_apply_to_the_kernel_source(name):
    """The same for kernel 9's variants, on its source."""
    text = flash_variants.variant_source(name, flash_variants.PVT_VARIANTS, "probe_pvt.cu")
    base = (cuda_build.CSRC / "probe_pvt.cu").read_text()
    assert (text == base) == (name == "kernel")


@pytest.mark.parametrize("mode,name", [
    *(("dmajor", n) for n in sorted(flash_variants.DMAJOR_VARIANTS)),
    *(("hbm", n) for n in sorted(flash_variants.HBM_VARIANTS)),
])
def test_probe_variant_edits_apply_to_the_kernel_source(mode, name):
    """The same for kernel 8's and kernel 10's variants, on their sources."""
    table, source = {"dmajor": (flash_variants.DMAJOR_VARIANTS, "probe_dmajor.cu"),
                     "hbm": (flash_variants.HBM_VARIANTS, "probe_hbm.cu")}[mode]
    text = flash_variants.variant_source(name, table, source)
    base = (cuda_build.CSRC / source).read_text()
    assert (text == base) == (name == "kernel")


@pytest.mark.parametrize("mode,name", [
    *(("gn", n) for n in sorted(flash_variants.GN_VARIANTS)),
    *(("temporal", n) for n in sorted(flash_variants.TEMPORAL_VARIANTS)),
])
def test_gn_and_temporal_variant_edits_apply_to_the_kernel_source(mode, name):
    """The same for kernel C's and kernel B's forward variants, on their
    sources; kernel C's plan overrides name constants of its size rule,
    which are back as they were afterwards."""
    from humanvid_tpu_torch.ops import group_norm as gn

    table, source = {"gn": (flash_variants.GN_VARIANTS, "group_norm.cu"),
                     "temporal": (flash_variants.TEMPORAL_VARIANTS,
                                  "temporal_attention.cu")}[mode]
    text = flash_variants.variant_source(name, table, source)
    base = (cuda_build.CSRC / source).read_text()
    assert (text == base) == (not table[name][0])
    if mode == "gn" and isinstance(table[name][2], dict):
        before = {k: getattr(gn, k) for k in table[name][2]}
        flash_variants.gn_variant_plan(320, 6144, 32, table[name][2])
        assert {k: getattr(gn, k) for k in table[name][2]} == before
    if mode == "gn":
        assert (flash_variants.gn_variant_plan(320, 6144, 32, table[name][2]) is None) == \
            (table[name][2] == "two_pass" or name == "cluster_4")


def test_gn_and_temporal_modes_raise_without_a_card(monkeypatch):
    """``--gn`` and ``--temporal`` need the card, take ``--against``,
    exclude the other modes and take only their own variants."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_gn(["kernel", "two_pass"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_temporal(["kernel", "stages_2"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--gn", "--against", "group_norm.cu"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--temporal", "no_loads", "--against", "temporal_attention.cu"])
    for argv in (["--gn", "--temporal"], ["--gn", "stages_2"], ["--temporal", "two_pass"],
                 ["--hbm", "--gn"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)



@pytest.mark.parametrize("name", sorted(flash_variants.TEMPORAL_BWD_VARIANTS))
def test_temporal_bwd_variant_edits_apply_to_the_kernel_source(name):
    """The same for kernel B's backward variants, on its source."""
    text = flash_variants.variant_source(name, flash_variants.TEMPORAL_BWD_VARIANTS,
                                         "temporal_attention_bwd.cu")
    base = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    assert (text == base) == (name == "kernel")


def test_temporal_bwd_mode_raises_without_a_card(monkeypatch):
    """``--temporal-bwd`` needs the card, takes ``--against``, excludes the
    other modes and takes only its own variants."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_temporal_bwd(["kernel", "out_tiles"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--temporal-bwd", "trans_smem", "--against",
                             "temporal_attention_bwd.cu"])
    for argv in (["--temporal-bwd", "--temporal"], ["--temporal-bwd", "positions_2"],
                 ["--temporal", "out_tiles"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)

@pytest.mark.parametrize("name", sorted(flash_variants.XWIDE_VARIANTS))
def test_xwide_variant_edits_apply_to_the_kernel_sources(name):
    """The same for the xwide kernels' variants, on the forward's and the
    backward's source (the shared header's edits in a copy inlined in
    place of its #include); the variants without edits run the kernel's
    own build on another plan, which fits a block."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    fwd, bwd = flash_variants.xwide_variant_sources(name)
    edits, header_edits = flash_variants.XWIDE_VARIANTS[name][:2]
    for text, source in ((fwd, "flash_attention.cu"), (bwd, "flash_attention_bwd.cu")):
        base = (cuda_build.CSRC / source).read_text()
        assert (text == base) == (not edits and not header_edits)
        assert ('#include "xwide.cuh"' in text) == (not header_edits)
    plan = flash_variants.xwide_variant_plan(name, 640)
    assert max(fa.xwide_smem(plan, k) for k in ("fwd", "bwd")) <= fa.SMEM_LIMIT



@pytest.mark.parametrize("name", sorted(flash_variants.OWN_VARIANTS))
def test_own_variant_edits_apply_to_the_kernel_sources(name):
    """The own-width variants: each edit found exactly once in the forward's
    or the backward's source, and every shape the tool times runs at a
    width the own-width kernels take."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    fwd_edits, bwd_edits, _ = flash_variants.OWN_VARIANTS[name]
    for edits, source in ((fwd_edits, "flash_attention.cu"),
                          (bwd_edits, "flash_attention_bwd.cu")):
        text = flash_variants.variant_source(name, {name: (edits, False)}, source)
        assert (text == (cuda_build.CSRC / source).read_text()) == (not edits)
    for shape in flash_variants.OWN_SHAPES + flash_variants.OWN_BWD_SHAPES:
        assert fa.is_own(shape[5]) and fa.flash_plan(shape[5]).forward.startswith("Own<")


@pytest.mark.parametrize("name", sorted(flash_variants.FRAMES_BWD_VARIANTS))
def test_frames_bwd_variants_apply_and_fit_one_block(name):
    """Kernel B's frames-kernel variants: each edit found exactly once in
    the backward's source, and the plan each runs fits a block at every
    shape past 32 frames the tool times it at."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    edits, overrides, most = flash_variants.FRAMES_BWD_VARIANTS[name]
    text = flash_variants.variant_source(name, {name: (edits, False)},
                                         "temporal_attention_bwd.cu")
    base = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    assert (text == base) == (not edits)
    assert 48 <= most <= ta.FRAMES_KERNEL_FRAMES
    for _, b, f, l, c, heads in flash_variants.TEMPORAL_BWD_LONG_SHAPES:
        if f > most:
            continue
        sizes = flash_variants.frames_variant_sizes(name, (b, f, l, c), heads)
        assert len(sizes) == 12 and sizes[9] == ta.MODE_FRAMES
        assert 2 <= sizes[10] and sizes[11] <= ta.SMEM_LIMIT
        assert sizes[:5] == (b, f, l, heads, c // heads)


@pytest.mark.parametrize("name", sorted(flash_variants.MID_VARIANTS))
def test_mid_variants_apply_to_the_kernel_source(name):
    """The mid forward's variants: each edit found exactly once in the
    forward's source, and a plan the kernel is built for at d = 320 (at
    d = 192 every variant but the columns layout)."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    edits = flash_variants.MID_VARIANTS[name][0]
    text = flash_variants.variant_source(name, {name: (edits, False)})
    base = (cuda_build.CSRC / "flash_attention.cu").read_text()
    assert (text == base) == (not edits)
    plan = flash_variants.mid_variant_plan(name, 320)
    assert plan.width in fa.MID_WIDTHS[plan.layout] and plan.width >= 320
    assert (flash_variants.mid_variant_plan(name, 192) is None) == (name == "columns")


def test_mid_mode_raises_without_a_card(monkeypatch):
    """``--mid`` needs the card, takes one ``--against``, excludes the other
    modes and takes only its own variants."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_mid(["kernel", "columns"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--mid", "no_skip", "--against", "flash_attention.cu"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--temporal-bwd", "frames_stages_2"])
    for argv in (["--mid", "--xwide"], ["--mid", "slice_128"], ["--xwide", "columns"],
                 ["--mid", "--against", "a.cu", "--against", "b.cu"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)


@pytest.mark.parametrize("name", sorted(flash_variants.MID_BWD_VARIANTS))
def test_mid_bwd_variants_apply_to_the_kernel_source(name):
    """The mid backward's variants: each edit found exactly once in its
    source, and at every width the tool times the plan each runs fits a
    block and is one the variant's source dispatches."""
    from humanvid_tpu_torch.ops import flash_attention as fa

    edits = flash_variants.MID_BWD_VARIANTS[name][0]
    text = flash_variants.variant_source(name, {name: (edits, False)},
                                         "flash_attention_mid_bwd.cu")
    base = (cuda_build.CSRC / "flash_attention_mid_bwd.cu").read_text()
    assert (text == base) == (not edits)
    for *_, d, _ in flash_variants.MID_BWD_SHAPES:
        p = flash_variants.mid_bwd_variant_plan(name, d)
        if p.layout == "merged":
            assert f"if (x_slice == {p.width} && x_key_tile == {p.rows}) return MERGED" in text
            kernels = (("dkv", p.stages),)
        else:
            assert f"if (x_slice == {p.width}) SPLIT({p.width}, {p.rows})" in text
            kernels = (("dv", p.stages), ("dk", p.dk_stages))
        kind = "ROLES" if p.dq_layout == "roles" else "COLUMNS"
        assert (f"if (x_slice == {p.width} && x_key_tile == {p.dq_rows}) "
                f"return {kind}({p.width}, {p.dq_rows});") in text
        for kernel, stages in kernels:
            assert stages >= 1 and fa.mid_bwd_smem(kernel, p.width, p.rows, stages) <= fa.SMEM_LIMIT
        dq = "dq_roles" if p.dq_layout == "roles" else "dq"
        assert fa.mid_bwd_smem(dq, p.width, p.dq_rows, p.dq_stages) <= fa.SMEM_LIMIT


def test_mid_bwd_mode_raises_without_a_card(monkeypatch):
    """``--mid-bwd`` needs the card, takes one ``--against``, excludes the
    other modes and takes only its own variants."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_mid_bwd(["kernel", "split"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--mid-bwd", "no_skip", "--against", "flash_attention_bwd.cu"])
    for argv in (["--mid-bwd", "--mid"], ["--mid-bwd", "columns"], ["--mid", "split"],
                 ["--mid-bwd", "--against", "a.cu", "--against", "b.cu"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)


def test_frames_reach_of_a_source():
    """An earlier backward source's frames-kernel reach (16 x its
    kFramesTiles, 32 before it had one), and the sizes its entry point of
    11 ints takes: the frames kernel's up to it, the earlier long
    kernel's pieces past it; an earlier forward's 9 ints past 32 frames the same
    pieces."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    text = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    assert flash_variants.frames_reach(text) == ta.FRAMES_KERNEL_FRAMES == 128
    assert flash_variants.frames_reach(text.replace("kFramesTiles = 8;", "kFramesTiles = 6;")) == 96
    assert flash_variants.frames_reach("int main() {}") == 32
    shape = (1, 100, 7, 320)
    pieces = (1, 100, 7, 8, 40, 1, 72, 1, 40)
    assert flash_variants.earlier_sizes(11, shape, 8, True, 96) == (*pieces, 0, 0)
    new = ta.backward_launch_sizes(shape, 8)
    assert flash_variants.earlier_sizes(11, shape, 8, True, 128) == (*new[:9], *new[10:])
    assert flash_variants.earlier_sizes(9, shape, 8, False) == pieces
    assert flash_variants.earlier_sizes(9, (1, 24, 7, 320), 8, False) == \
        ta.launch_sizes((1, 24, 7, 320), 8)
    assert flash_variants.frames_variant_sizes("kernel", shape, 8) == new


@pytest.mark.parametrize("name", sorted(flash_variants.LONG_VARIANTS))
def test_long_variants_apply_and_fit_one_block(name):
    """The long kernels' variants: each edit found exactly once in both
    sources, and the plan each runs fits a block at every shape past 32
    (forward) or 128 (backward) frames the tool times it at; the entry
    points' twelve size ints."""
    from humanvid_tpu_torch.ops import temporal_attention as ta

    edits, overrides = flash_variants.LONG_VARIANTS[name]
    for source in ("temporal_attention.cu", "temporal_attention_bwd.cu"):
        text = flash_variants.variant_source(name, {name: (edits, False)}, source)
        assert (text == (cuda_build.CSRC / source).read_text()) == (not edits)
    for backward, shapes in ((False, flash_variants.TEMPORAL_LONG_SHAPES),
                             (True, flash_variants.TEMPORAL_BWD_PAST_SHAPES)):
        for _, b, f, l, c, heads in shapes:
            sizes = flash_variants.long_variant_sizes(name, (b, f, l, c), heads, backward)
            assert len(sizes) == 12 and sizes[:5] == (b, f, l, heads, c // heads)
            assert sizes[9] in (ta.MODE_RESIDENT, ta.MODE_STREAMED)
            assert 1 <= sizes[10] and sizes[11] <= ta.SMEM_LIMIT
            if overrides.get("streamed"):
                assert sizes[9] == ta.MODE_STREAMED
    # each direction's own, and the backward's long kernel at the frames
    # kernel's shapes
    for table, source, shapes, backward in (
            (flash_variants.LONG_BWD_VARIANTS, "temporal_attention_bwd.cu",
             flash_variants.TEMPORAL_BWD_PAST_SHAPES, True),
            (flash_variants.LONG_FWD_VARIANTS, "temporal_attention.cu",
             flash_variants.TEMPORAL_LONG_SHAPES, False)):
        for name, (edits, overrides) in table.items():
            text = flash_variants.variant_source(name, {name: (edits, False)}, source)
            assert text != (cuda_build.CSRC / source).read_text()
            for _, b, f, l, c, heads in shapes:
                sizes = flash_variants.long_variant_sizes(name, (b, f, l, c), heads, backward)
                assert sizes[11] <= ta.SMEM_LIMIT
    for _, b, f, l, c, heads in flash_variants.TEMPORAL_BWD_LONG_SHAPES:
        sizes = flash_variants.long_variant_sizes(flash_variants.LONG_AT_FRAMES, (b, f, l, c),
                                                  heads, True)
        assert sizes[9] in (ta.MODE_RESIDENT, ta.MODE_STREAMED) and sizes[11] <= ta.SMEM_LIMIT


def test_xwide_mode_raises_without_a_card(monkeypatch):
    """``--xwide`` needs the card, takes ``--against`` up to twice (a
    forward and a backward source), excludes the other modes and takes
    only its own variants; the other modes take one ``--against``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_xwide(["kernel", "no_skip"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--xwide", "slice_128", "--against", "flash_attention.cu",
                             "--against", "flash_attention_bwd.cu"])
    for argv in (["--xwide", "--bwd"], ["--xwide", "two_stages"], ["--bwd", "slice_128"],
                 ["--bwd", "--against", "a.cu", "--against", "b.cu"],
                 ["--xwide", "--against", "a", "--against", "b", "--against", "c"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)


def test_dmajor_and_hbm_modes_raise_without_a_card(monkeypatch):
    """``--dmajor`` and ``--hbm`` need the card, take ``--against``, exclude
    each other and the other modes, and take only their own variants."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_dmajor(["kernel", "pv_stages_6"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_hbm(["kernel", "hbm_bulk_ring"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--dmajor", "--against", "probe_dmajor.cu"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--hbm", "hbm_unroll4", "--against", "probe_hbm.cu"])
    for argv in (["--dmajor", "--hbm"], ["--pvt", "--dmajor"], ["--hbm", "qk_consumers_2"],
                 ["--dmajor", "hbm_bulk_ring"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)


def test_pvt_and_wide_modes_raise_without_a_card(monkeypatch):
    """The ``--pvt`` mode and the backward's mode with its d = 512 shape need
    the card; ``--against`` needs a mode that takes it, and the two modes
    exclude each other."""
    assert any(shape[5] == 512 for shape in flash_variants.BWD_SHAPES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_pvt(["kernel", "pv_untransposed"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.main(["--pvt", "--against", "probe_pvt.cu"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_bwd(["kernel", "wide_dv_one_stage"])
    for argv in (["--against", "x.cu"], ["--bwd", "--pvt"], ["--pvt", "two_stages"]):
        with pytest.raises(SystemExit):
            flash_variants.main(argv)


def test_pvt_plain_sums_l_from_rounded_p():
    """In bf16 the plain version sums l from p rounded to bf16, as the JAX
    probe's ones row under V^T does, so its lse is m + log2 of that sum."""
    heads, d, lq, lk = 2, 16, 8, 40
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, heads * d)).astype(np.float32) * 3)
               .to(torch.bfloat16) for n in (lq, lk, lk))
    _, lse = pk.pvt_plain(q, k, v, heads)
    qs = pk._prescale(q, heads).float().reshape(1, lq, heads, d).transpose(1, 2)
    kh = k.float().reshape(1, lk, heads, d).transpose(1, 2)
    s = torch.matmul(qs, kh.transpose(-1, -2))
    m = s.amax(-1)
    p = np.asarray(jnp.asarray(torch.exp2(s - m[..., None]).numpy()).astype(jnp.bfloat16),
                   np.float32)
    want = m + torch.log2(torch.from_numpy(p).sum(-1))
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-6)
    unrounded = m + torch.log2(torch.exp2(s - m[..., None]).sum(-1))
    assert (lse - unrounded).abs().max() > 1e-5  # the rounding shows at this size


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run(["kernel"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        flash_variants.run_bwd(["kernel"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        microbench.main(["hbm"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        microbench.run(["pvt"])
    with pytest.raises(SystemExit):  # an unknown probe is refused before anything runs
        microbench.main(["flash_sweep"])


def test_cpu_tensors_never_launch(monkeypatch):
    """CPU tensors take the plain versions: no launch, and no library is
    built, loaded or bound; a CUDA wrapper given a CPU tensor raises before
    it loads one."""
    def no_load(name):
        raise AssertionError(f"a CPU tensor loaded the {name} library")

    monkeypatch.setattr(cuda_build, "load", no_load)
    monkeypatch.setattr(cuda_build, "_fns", {})
    rng = np.random.default_rng(4)
    before = dict(pk.launches)
    a, b = (torch.from_numpy(rng.normal(size=(1, 64, 128)).astype(np.float32)) for _ in range(2))
    pk.dmajor("qk_d_on_lanes", a, b)
    q = torch.from_numpy(rng.normal(size=(1, 10, 16)).astype(np.float32))
    pk.pvt(q, q, q, 2)
    pk.hbm_map(q.to(torch.bfloat16))
    assert pk.launches == before
    for call in (lambda: pk.dmajor_cuda("qk_d_on_lanes", a, b),
                 lambda: pk.pvt_cuda(q.to(torch.bfloat16), q.to(torch.bfloat16),
                                     q.to(torch.bfloat16), 2),
                 lambda: pk.hbm_map_cuda(q.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert pk.launches == before
    assert cuda_build._fns == {}


def test_wrappers_bind_each_function_once(monkeypatch):
    """``cuda_build.function`` loads a library and sets a function's types
    at its first call only; every later call returns the same bound object."""
    loads = []

    class Lib:
        def __init__(self):
            self.hv_probe_hbm = type("Fn", (), {})()

    def fake_load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(cuda_build, "_fns", {})
    first = cuda_build.function("probe_hbm", "hv_probe_hbm", pk.HBM_ARGTYPES)
    for _ in range(3):
        assert cuda_build.function("probe_hbm", "hv_probe_hbm", pk.HBM_ARGTYPES) is first
    assert loads == ["probe_hbm"]
    assert first.argtypes == pk.HBM_ARGTYPES and first.restype is ctypes.c_int
    # the probe wrappers and those of kernels A, B (forward and backward)
    # and C go through it and set no types themselves
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta

    for wrapper in (pk.dmajor_cuda, pk.pvt_cuda, pk.hbm_map_cuda, gn.group_norm_act_cuda,
                    ta.temporal_attention_cuda, ta.temporal_attention_backward_cuda,
                    fa.flash_attention_cuda, fa.flash_attention_backward_cuda):
        src = inspect.getsource(wrapper)
        assert "cuda_build.function(" in src
        assert "argtypes" not in src and "cuda_build.load(" not in src
    # kernel C's one-pass path allocates no scratch: only the two-pass
    # branch makes the statistics workspace
    src = inspect.getsource(gn.group_norm_act_cuda)
    one_pass = src[src.index("if plan is not None:"):src.index("else:", src.index("if plan is not None:"))]
    assert "torch.empty" not in one_pass and "part" not in one_pass


def _c_entry_points():
    """{symbol: [ctypes type of each parameter]} of every extern "C" entry
    point in the port's CUDA sources, read from the source text."""
    import re

    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float, "long long": ctypes.c_longlong, "int*": ctypes.c_void_p}
    out = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            params = [" ".join(p.split()[:-1]) for p in m.group(2).replace("\n", " ").split(",")]
            out[m.group(1)] = [kinds[p] for p in params]
    return out


def test_argtypes_match_the_c_entry_points():
    """The argument types each wrapper binds are those of its C entry point,
    parameter for parameter (a pointer passed as a 32-bit int would be cut)."""
    from humanvid_tpu_torch.ops import flash_attention as fa
    from humanvid_tpu_torch.ops import group_norm as gn
    from humanvid_tpu_torch.ops import temporal_attention as ta

    entries = _c_entry_points()
    bound = {"hv_flash_fwd": fa._FWD_ARGTYPES, "hv_flash_bwd_dkv": fa._DKV_ARGTYPES,
             "hv_flash_bwd_dq": fa._DQ_ARGTYPES, "hv_flash_bwd_mid_dkv": fa._DKV_ARGTYPES,
             "hv_flash_bwd_mid_dq": fa._DQ_ARGTYPES,
             "hv_group_norm_fwd": gn._TWO_PASS_ARGTYPES,
             "hv_group_norm_cluster": gn._CLUSTER_ARGTYPES,
             "hv_temporal_fwd": ta._FWD_ARGTYPES, "hv_temporal_bwd": ta._BWD_ARGTYPES,
             "hv_probe_dmajor": pk.DMAJOR_ARGTYPES, "hv_probe_pvt": pk.PVT_ARGTYPES,
             "hv_probe_hbm": pk.HBM_ARGTYPES}
    for symbol, types in bound.items():
        assert entries[symbol] == list(types), symbol


def test_hbm_constant_is_rounded_once_at_import():
    """Kernel 10 takes the TPU probe's constant rounded to bf16, computed
    once: bf16(1.0001) is exactly 1.0."""
    assert pk.HBM_SCALE_BF16 == float(torch.tensor(1.0001, dtype=torch.bfloat16))
    assert pk.HBM_SCALE_BF16 == 1.0
    assert isinstance(pk.HBM_SCALE_BF16, float)


def test_tools_import_nothing_of_jax_or_the_jax_tools():
    """The port's tools import with jax, flax, humanvid_tpu and the JAX
    package's ``tools`` made unimportable, and load none of them."""
    blocked = ("jax", "jaxlib", "flax", "humanvid_tpu", "tools")
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import humanvid_tpu_torch.tools.microbench, humanvid_tpu_torch.tools.probe_kernels\n"
        "import humanvid_tpu_torch.tools.flash_variants\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{blocked!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr
