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
    # the three wrappers go through it and set no types themselves
    for wrapper in (pk.dmajor_cuda, pk.pvt_cuda, pk.hbm_map_cuda):
        src = inspect.getsource(wrapper)
        assert "cuda_build.function(" in src
        assert "argtypes" not in src and "cuda_build.load(" not in src


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
