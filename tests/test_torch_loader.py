"""The port's batch sampler and loader against the JAX package's, on the CPU.

- ``OrientationBatchSampler``: the batches identical to the JAX package's
  (both pure Python) over seeds, epochs, replicas and ``drop_last``, and the
  same ``ValueError`` where there are fewer batches than replicas;
- ``Loader``: the JAX ``Loader``'s batches in the same order (exactly, with
  workers that finish out of order); a worker's exception raised in the
  consumer; the producer thread gone soon after the consumer breaks; with
  ``device``, tensors on that device with the same values. The pinned
  upload to a card is ``tests/test_torch_cuda.py``'s.
"""

import threading
import time

import numpy as np
import pytest
import torch

from humanvid_tpu.data.loader import Loader as JLoader
from humanvid_tpu.data.samplers import OrientationBatchSampler as JSampler
from humanvid_tpu_torch.data import Loader, OrientationBatchSampler, collate


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("rank,replicas", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (12580, 3)])
def test_sampler_batches_are_the_jax_packages(seed, epoch, rank, replicas, drop_last):
    for n_h, n_v, bs in ((13, 29, 4), (40, 0, 3), (5, 7, 1)):
        kw = dict(batch_size=bs, seed=seed, rank=rank, num_replicas=replicas,
                  drop_last=drop_last)
        ours, ref = OrientationBatchSampler(n_h, n_v, **kw), JSampler(n_h, n_v, **kw)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref) and len(ours) == len(ref)
        for batch in ours:  # one orientation a batch
            assert all(i < n_h for i in batch) or all(i >= n_h for i in batch)


def test_sampler_raises_as_the_jax_package_where_replicas_outnumber_batches():
    kw = dict(batch_size=4, num_replicas=8)
    with pytest.raises(ValueError) as ref:
        list(JSampler(9, 3, **kw))
    with pytest.raises(ValueError) as ours:
        list(OrientationBatchSampler(9, 3, **kw))
    assert str(ours.value) == str(ref.value)


class _Dataset:
    """Seeded arrays by index; later indices finish first."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"sample {i}")
        time.sleep(0.002 * ((7 * i) % 5))
        rng = np.random.default_rng(i)
        return {"tgt": rng.normal(size=(2, 3)).astype(np.float32),
                "clip": np.full((4,), i, np.float32)}


BATCHES = [[3, 1], [0, 2], [9, 4], [5, 8], [7, 6], [10, 11]]


@pytest.mark.parametrize("workers,prefetch", [(1, 1), (3, 2), (4, 3)])
def test_loader_yields_the_jax_loaders_batches_in_order(workers, prefetch):
    ds = _Dataset(12)
    ref = list(JLoader(ds, BATCHES, num_workers=workers, prefetch=prefetch))
    ours = list(Loader(ds, BATCHES, num_workers=workers, prefetch=prefetch))
    assert len(ours) == len(ref) == len(BATCHES)
    for a, b, idx in zip(ours, ref, BATCHES):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["clip"][:, 0], idx)


def test_collate_stacks_as_the_jax_package():
    from humanvid_tpu.data.loader import collate as j_collate

    samples = [_Dataset(3)[i] for i in range(3)]
    got, want = collate(samples), j_collate(samples)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_loader_raises_a_workers_error():
    for loader in (JLoader(_Dataset(12, fail_at=9), BATCHES, num_workers=2),
                   Loader(_Dataset(12, fail_at=9), BATCHES, num_workers=2)):
        seen = []
        with pytest.raises(KeyError, match="sample 9"):
            for batch in loader:
                seen.append(batch)
        assert len(seen) == 2  # the batches before the failing one


def _producers():
    return [t for t in threading.enumerate() if t.name != "MainThread" and t.is_alive()]


def test_producer_ends_when_the_consumer_breaks():
    before = set(_producers())
    it = iter(Loader(_Dataset(1000), [[i] for i in range(1000)], num_workers=2, prefetch=2))
    next(it)
    started = set(_producers()) - before
    assert started  # the producer and its pool
    it.close()  # what a break out of the for loop does
    deadline = time.time() + 10
    while time.time() < deadline and any(t.is_alive() for t in started):
        time.sleep(0.05)
    assert not any(t.is_alive() for t in started)


def test_upload_lands_on_the_device_asked_for():
    ds = _Dataset(12)
    ref = list(JLoader(ds, BATCHES[:3], num_workers=2))
    ours = list(Loader(ds, BATCHES[:3], num_workers=2, device=torch.device("cpu")))
    for a, b in zip(ours, ref):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_loader_under_many_workers_and_fast_thread_switches():
    """More workers than cores with a short switch interval: every batch
    arrives once, in order, with its own samples."""
    import os
    import sys

    batches = [[i, i + 1, i + 2] for i in range(0, 240, 3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.time()
        got = list(Loader(_Dataset(240), batches, num_workers=4 * (os.cpu_count() or 2),
                          prefetch=3))
    finally:
        sys.setswitchinterval(interval)
    assert time.time() - t0 < 60
    assert [b["clip"][:, 0].tolist() for b in got] == batches
