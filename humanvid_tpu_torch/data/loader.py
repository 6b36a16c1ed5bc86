"""Prefetching host data loader with pinned uploads.

The counterpart of ``humanvid_tpu/data/loader.py``: a thread pool decodes
and augments samples (OpenCV, numpy and torch's host ops release the
interpreter lock for the heavy work) with sample-level pipelining, so that
every worker has a sample in hand even at batch size 1, while a bounded
queue keeps batches ready. Prefetch is bounded in samples and in batches (a
decoded stage-2 sample is about 0.5 GB of host arrays). The producer stops
when the consumer abandons the iterator, and a worker's exception is raised
again in the consumer.

With ``device``, each collated batch goes to the device as the producer
makes it: ``torch.from_numpy`` into pinned host memory (on a CUDA device),
then ``.to(device, non_blocking=True)``, so that the upload is queued
behind the running step instead of stalling the host on a pageable copy.
Without it, batches are dicts of numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``, through pinned memory on a CUDA device."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class Loader:
    """Iterate batches of a map-style dataset using a batch sampler."""

    def __init__(
        self,
        dataset,
        batch_sampler: Iterable[List[int]],
        num_workers: int = 4,
        prefetch: int = 2,
        device: Optional[torch.device] = None,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.device = device

    def __iter__(self) -> Iterator[Dict[str, object]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has left (break
            # or exception): otherwise the producer would block forever,
            # holding its prefetched batches and its worker pool
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def cancel(pending) -> None:
            for futs in pending:
                for f in futs:
                    f.cancel()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    it = iter(self.batch_sampler)
                    pending: deque = deque()

                    def refill():
                        # submit future batches until every worker has a
                        # sample plus a margin, bounded in samples and batches
                        while not stop.is_set():
                            inflight = sum(len(fs) for fs in pending)
                            if pending and (
                                    inflight >= self.num_workers + max(1, self.prefetch)
                                    and len(pending) > self.prefetch):
                                return
                            if len(pending) > self.prefetch + self.num_workers:
                                return
                            batch_idx = next(it, None)
                            if batch_idx is None:
                                return
                            pending.append(
                                [pool.submit(self.dataset.__getitem__, i) for i in batch_idx])

                    refill()
                    while pending:
                        if stop.is_set():
                            cancel(pending)
                            return
                        samples = [f.result() for f in pending.popleft()]
                        refill()  # resubmit before the collate and upload
                        batch = collate(samples)
                        if self.device is not None:
                            batch = to_device(batch, self.device)
                        if not put(batch):
                            cancel(pending)
                            return
            except BaseException as e:  # noqa: BLE001 — raised again in the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()
            # drain so that a blocked producer sees the stop soon
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
