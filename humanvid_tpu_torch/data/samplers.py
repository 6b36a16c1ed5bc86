"""Orientation-bucketed batch sampling.

The counterpart of ``humanvid_tpu/data/samplers.py``, line for line: every
batch is entirely horizontal or entirely vertical (the reference's
``OrientationBatchSampler``, ``dance_image_h_v_camera.py:397-452``), so a
batch has one frame size. Across replicas (the reference's distributed
variant) the shuffle is seeded by ``seed + epoch`` alone and replica
``rank`` takes every ``num_replicas``-th batch of the same list, truncated
to a common multiple so that every replica takes as many steps; fewer
batches than replicas raises. The single-card drivers use rank 0 of 1.
"""

from __future__ import annotations

import random
from typing import Iterator, List


class OrientationBatchSampler:
    def __init__(
        self,
        num_horizontal: int,
        num_vertical: int,
        batch_size: int,
        seed: int = 0,
        rank: int = 0,
        num_replicas: int = 1,
        drop_last: bool = True,
    ):
        self.num_horizontal = num_horizontal
        self.num_vertical = num_vertical
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.num_replicas = num_replicas
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[List[int]]:
        # rank-independent seed: every replica must shuffle identically for
        # the strided shard below to partition (not resample) the batch list
        rng = random.Random(self.seed + self.epoch)
        h = list(range(self.num_horizontal))
        v = list(range(self.num_horizontal, self.num_horizontal + self.num_vertical))
        rng.shuffle(h)
        rng.shuffle(v)

        def chunk(idxs: List[int]) -> List[List[int]]:
            out = [idxs[i:i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
            if self.drop_last and out and len(out[-1]) < self.batch_size:
                out.pop()
            return out

        batches = chunk(h) + chunk(v)
        rng.shuffle(batches)
        # shard batches across replicas: truncate to a common multiple first
        # so every rank sees the same number of steps (unequal shards would
        # deadlock the collective train step at epoch end)
        even = len(batches) // self.num_replicas * self.num_replicas
        if even == 0:
            # fewer batches than replicas: every rank would silently yield
            # zero batches per epoch and a misconfigured multi-host run would
            # spin forever — fail loudly instead.
            raise ValueError(
                f"dataset yields {len(batches)} batches (< num_replicas="
                f"{self.num_replicas}); shrink batch_size or replica count"
            )
        return batches[:even][self.rank::self.num_replicas]

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self._batches())

    def __len__(self) -> int:
        return len(self._batches())
