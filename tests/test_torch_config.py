"""The port's config loading against the JAX package's ``load_config``:
the same ``ConfigDict`` from a YAML file and from a ``.py`` module, dotted
lookups, the error on other extensions, and the repo's own configs."""

from pathlib import Path

import pytest

from humanvid_tpu.utils.config import load_config as jax_load_config
from humanvid_tpu_torch.utils.config import ConfigDict, load_config

ROOT = Path(__file__).resolve().parent.parent
TREE = {
    "model": "tiny",
    "base_model_path": "./pretrained_weights/stable-diffusion-v1-5",
    "solver": {"learning_rate": 1e-5, "max_train_steps": 10, "betas": [0.9, 0.999]},
    "test_cases": {"ref.png": ["pose_videos/a.mp4", "pose_videos/b.mp4"]},
    "layers": [{"name": "a", "width": 1}, {"name": "b", "width": 2}],
    "flag": True,
    "nothing": None,
}


def _write(tmp_path, kind):
    if kind == "yaml":
        import yaml

        path = tmp_path / "prompt.yaml"
        path.write_text(yaml.safe_dump(TREE))
    else:
        path = tmp_path / "prompt.py"
        path.write_text(f"cfg = {TREE!r}\n")
    return str(path)


def _plain(x):
    if isinstance(x, dict):
        assert type(x).__name__ == "ConfigDict"
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("kind", ["yaml", "py"])
def test_load_config_matches_jax(tmp_path, kind):
    path = _write(tmp_path, kind)
    ours, ref = load_config(path), jax_load_config(path)
    assert _plain(ours) == _plain(ref) == TREE
    assert ours.solver.learning_rate == 1e-5
    assert ours.layers[1].width == 2
    assert ours.get("missing") is None
    with pytest.raises(AttributeError):
        ours.missing


def test_yaml_and_py_give_the_same_config(tmp_path):
    assert load_config(_write(tmp_path, "yaml")) == load_config(_write(tmp_path, "py"))


def test_get_path_and_attribute_set():
    cfg = ConfigDict.wrap(TREE)
    assert cfg.get_path("solver.learning_rate") == 1e-5
    assert cfg.get_path("solver.nope", 7) == 7
    assert cfg.get_path("model.deeper", "x") == "x"  # a leaf has no children
    assert cfg.get_path("nothing", 3) is None        # present, even if None
    cfg.extra = {"a": 1}
    assert cfg["extra"] == {"a": 1}


@pytest.mark.parametrize("name", ["prompt.json", "prompt.toml", "prompt"])
def test_other_extensions_raise(tmp_path, name):
    path = tmp_path / name
    path.write_text("{}")
    with pytest.raises(ValueError, match="unsupported config extension"):
        load_config(str(path))
    with pytest.raises(ValueError):
        jax_load_config(str(path))


@pytest.mark.parametrize("path", sorted((ROOT / "configs").rglob("*.yaml")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_repo_configs_load_as_jax_does(path):
    ours, ref = load_config(str(path)), jax_load_config(str(path))
    assert _plain(ours) == _plain(ref)


def test_py_config_loads_without_pyyaml(tmp_path):
    import os
    import subprocess
    import sys

    path = _write(tmp_path, "py")
    code = ("import sys\nsys.modules['yaml'] = None\n"
            "from humanvid_tpu_torch.utils.config import load_config\n"
            f"print(load_config({path!r}).solver.max_train_steps)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0 and res.stdout.strip() == "10", res.stderr
