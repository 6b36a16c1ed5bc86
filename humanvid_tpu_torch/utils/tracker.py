"""Experiment tracking: an append-only ``metrics.jsonl`` and a config snapshot.

The counterpart of ``humanvid_tpu/utils/tracker.py`` (the reference logs to
mlflow and wandb, which this deployment does not have): one JSON line a
logged step under ``run_dir/metrics.jsonl``, which any tool can tail, and
the run's config in ``run_dir/config.json``. The JAX package's optional
TensorBoard summaries (written through TensorFlow where it is importable)
are left out: the port does not use TensorFlow.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, run_dir: str, config: Optional[Dict[str, Any]] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a", buffering=1)
        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(_plain(config), f, indent=2, default=str)

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj
