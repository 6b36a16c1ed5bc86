"""Run a function on N ranks of a fresh process group, from one process.

``launch(fn, world, args)`` spawns ``world`` processes (the ``spawn`` start
method), each of which sets the environment ``torchrun`` would set
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), joins a
process group through a ``file://`` store in a directory of its own (so
concurrent launches never race for a port), calls ``fn(*args)`` and returns
every rank's result, in rank order. ``fn`` must be importable by name from
a module, since each child imports it anew. A process-group timeout and a
join deadline of their own bound a hung collective: past the deadline every
child is killed and :class:`TimeoutError` raised; a failed rank raises in
the caller with its traceback.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(index: int, fn: Callable, world: int, store_dir: str, backend: str,
           timeout_s: float, threads: Optional[int], args: Sequence) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                      LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
                            rank=index, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(store_dir, f"result{index}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
           timeout_s: float = 300.0, join_timeout_s: float = 600.0,
           threads: Optional[int] = 1) -> List[object]:
    """``fn(*args)`` on ranks 0..world-1 of a new ``backend`` group; their
    results in rank order. ``threads`` sets each child's torch threads."""
    store_dir = tempfile.mkdtemp(prefix="hvt_launch_")
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, world, store_dir, backend, timeout_s, threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish in {join_timeout_s} s")
        results = []
        for index in range(world):
            with open(os.path.join(store_dir, f"result{index}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
