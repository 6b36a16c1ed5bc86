"""Config loading: YAML files or ``.py`` modules that export ``cfg``.

A small attribute-access dict stands in for OmegaConf
(``cfg.solver.learning_rate``). PyYAML is imported only for a YAML file, so
a ``.py`` config loads where PyYAML is not installed.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Mapping


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def load_config(path: str) -> ConfigDict:
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            return ConfigDict.wrap(yaml.safe_load(f))
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(path))[0], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return ConfigDict.wrap(mod.cfg)
    raise ValueError(f"unsupported config extension: {path}")
