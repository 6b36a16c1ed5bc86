"""Process groups, device meshes and the collectives of data parallelism.

The counterpart of ``humanvid_tpu/parallel/mesh.py`` in ``torch.distributed``
idiom, one process per rank (``torchrun``) where the JAX package runs one
process over a device mesh:

- :func:`init_distributed` joins the process group that ``torchrun``
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on the card,
  gloo on the CPU, unless the caller names the backend;
- :func:`make_mesh` and :func:`make_hierarchical_mesh` build the flat
  ``("data",)`` mesh and the ``("replica", "data")`` mesh of multi-slice
  data parallelism as a ``DeviceMesh`` over every rank;
- :func:`rank_rows` is ``shard_batch``: this rank's contiguous rows of a
  global batch, in rank order over ``("replica", "data")``, as
  ``P(("replica", "data"))`` splits them; :func:`replicate` broadcasts
  from rank 0;
- :func:`zero1_opt_sharding` keeps the JAX size rule of ZeRO-1: a leaf is
  sharded over ``data`` when its sharded axis divides the axis and it has
  at least ``min_size`` elements. The sharded axis is dim 0 of the torch
  leaf, which for every ``Linear`` and conv weight and every 1-D leaf is
  the JAX leaf's last axis (``(out, in, ...)`` against ``(..., in, out)``);
  dim-0 shards are contiguous views.

The collectives below take CUDA tensors on a gloo group through host memory
(gloo reduces on the host), so that ranks sharing one card run the same code
as ranks on cards of their own.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA, REPLICA = "data", "replica"
BATCH_AXES = (REPLICA, DATA)
ZERO1_MIN_SIZE = 4096
# bytes a rank sends in one bucket of the bucketed collectives
BUCKET_BYTES = 64 << 20
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group ``torchrun`` describes and return this rank's
    device: on a CUDA device, card ``LOCAL_RANK % device_count`` (made the
    current card), else ``device``. The backend is NCCL for a CUDA device
    and gloo for the CPU unless named. Two local ranks on one card under
    NCCL raise (NCCL refuses them: "Duplicate GPU detected"); such ranks
    need ``backend="gloo"``, which is never chosen for the caller.

    Without ``WORLD_SIZE`` in the environment (no ``torchrun``) no group is
    made and ``device`` is returned. A group made by the caller is joined
    as it is."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"no CUDA device for {device}: name the CPU to run there")
        if backend == "nccl" and local_world > cards:
            raise ValueError(
                f"{local_world} local ranks on {cards} CUDA card(s): NCCL refuses two ranks "
                f"on one device ('Duplicate GPU detected'); run them with backend gloo")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def data_parallel_world(train_bs: int, world: int) -> int:
    """The data-parallel width of a global batch of ``train_bs`` over
    ``world`` ranks: ``gcd(train_bs, world)``, as the JAX driver sizes its
    mesh. Where that is below ``world`` it raises: a rank per process
    cannot sit idle the way a JAX process leaves devices unused."""
    import math

    n = math.gcd(train_bs, world)
    if n < world:
        raise ValueError(f"train_bs={train_bs} does not divide over {world} ranks "
                         f"(gcd {n}): run {n} ranks or a global batch that {world} divides")
    return n


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n: Optional[int] = None, axis_names: Sequence[str] = (DATA,)):
    """A 1-D mesh over every rank (trailing axes of size 1 where more names
    are given, as the JAX ``make_mesh`` shapes it)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: one process per rank")
    shape = (n,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=tuple(axis_names))


def make_hierarchical_mesh(n_slices: int, per_slice: Optional[int] = None,
                           axis_names: Sequence[str] = BATCH_AXES):
    """The 2-D (slices, ranks a slice) mesh of multi-slice data parallelism:
    rank r sits at ``(r // per_slice, r % per_slice)``. Shard batches over
    both axes (:func:`rank_rows`) and ZeRO-1 over the inner ``data`` axis."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if per_slice is None:
        if world % n_slices:
            raise ValueError(f"{world} ranks do not split into {n_slices} slices")
        per_slice = world // n_slices
    if n_slices * per_slice != world:
        raise ValueError(f"a {n_slices}x{per_slice} mesh in a world of {world}")
    return init_device_mesh(_mesh_device_type(), (n_slices, per_slice),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str = DATA) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis)) if axis in mesh.mesh_dim_names else 1


def mesh_position(mesh, axes: Sequence[str] = BATCH_AXES) -> Tuple[int, int]:
    """(this rank's index, the count) in row-major order over the mesh axes
    named in ``axes`` (those the mesh lacks count as size 1)."""
    index, count = 0, 1
    for axis in axes:
        if axis in mesh.mesh_dim_names:
            n = axis_size(mesh, axis)
            index, count = index * n + mesh.get_local_rank(axis), count * n
    return index, count


def take_rows(tree, index: int, count: int):
    """Rows ``[index * n / count, (index + 1) * n / count)`` of every leaf of
    ``tree`` (dicts and tuples are walked; tensors, arrays and lists are
    leaves; anything else, such as a flag, is kept whole)."""
    if isinstance(tree, dict):
        return {k: take_rows(v, index, count) for k, v in tree.items()}
    if isinstance(tree, tuple):
        rows = [take_rows(v, index, count) for v in tree]
        return type(tree)(*rows) if hasattr(tree, "_fields") else tuple(rows)
    if not hasattr(tree, "__len__") or isinstance(tree, str) or getattr(tree, "ndim", 1) == 0:
        return tree
    n = len(tree)
    if n % count:
        raise ValueError(f"{n} rows do not split over {count} ranks")
    k = n // count
    return tree[index * k:(index + 1) * k]


def rank_rows(tree, mesh, axes: Sequence[str] = BATCH_AXES):
    """This rank's contiguous rows of a global batch (``shard_batch``)."""
    return take_rows(tree, *mesh_position(mesh, axes))


def zero1_opt_sharding(tensors: Sequence[torch.Tensor], mesh, axis: str = DATA,
                       min_size: int = ZERO1_MIN_SIZE) -> List[bool]:
    """Which leaves ZeRO-1 shards along dim 0 over ``axis``: those whose dim
    0 divides the axis and that hold at least ``min_size`` elements. The
    rest stay replicated, and so does every leaf on an axis of one rank."""
    n = axis_size(mesh, axis)
    return [n > 1 and t.dim() >= 1 and t.shape[0] % n == 0 and t.numel() >= min_size
            for t in tensors]


def dim0_shard(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Shard ``index`` of ``count`` along dim 0: a contiguous view."""
    k = t.shape[0] // count
    return t.narrow(0, index * k, k)


class CommStats:
    """Bytes a rank sent and seconds spent in its collectives, by kind. On a
    CUDA device a span is two CUDA events (nothing waits for the device
    until :meth:`seconds` is read); on the CPU, the host clock."""

    def __init__(self):
        self.bytes = {}
        self._spans = {}

    def span(self, kind: str, nbytes: int, device: torch.device) -> "_Span":
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        return _Span(self._spans.setdefault(kind, []), device)

    def seconds(self) -> dict:
        out = {}
        for kind, spans in self._spans.items():
            total = 0.0
            for start, end in spans:
                if isinstance(start, float):
                    total += end - start
                else:
                    end.synchronize()
                    total += start.elapsed_time(end) / 1e3
            out[kind] = total
        return out

    def reset(self) -> None:
        self.bytes.clear()
        self._spans.clear()


class _Span:
    def __init__(self, spans: list, device: torch.device):
        self.spans, self.cuda = spans, device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        self.spans.append((self.start, end))


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _collective(op, out: torch.Tensor, inp: Optional[torch.Tensor], group, **kw) -> None:
    """``op(out, inp)`` (or ``op(out)``) on ``group``, CUDA tensors on gloo
    staged through host memory."""
    with warnings.catch_warnings():
        # newer torch renames all_gather_into_tensor; the card's keeps it
        warnings.filterwarnings("ignore", ".*all_gather_into_tensor.*", FutureWarning)
        _call(op, out, inp, group, **kw)


def _call(op, out: torch.Tensor, inp: Optional[torch.Tensor], group, **kw) -> None:
    if not _through_host(out, group):
        op(out, inp, group=group, **kw) if inp is not None else op(out, group=group, **kw)
        return
    host_out = out.cpu()
    if inp is None:
        op(host_out, group=group, **kw)
    else:
        op(host_out, inp.cpu(), group=group, **kw)
    out.copy_(host_out)


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> Iterator[List[int]]:
    """Indices of ``tensors`` in runs of at most ``limit`` bytes (a larger
    tensor alone)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if run and size + nbytes > limit:
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        yield run


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(tensors) == 1 and tensors[0].is_contiguous():
        return tensors[0].view(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    if len(tensors) == 1 and flat.data_ptr() == tensors[0].data_ptr():
        return
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     stats: Optional[CommStats] = None) -> None:
    """Every tensor made the mean of its value over every rank, in place,
    in buckets of at most ``BUCKET_BYTES`` (a sum, then a division by the
    world size). A world of one rank changes nothing."""
    n = dist.get_world_size()
    if n == 1:
        return
    for run in _buckets(tensors, BUCKET_BYTES):
        part = [tensors[i] for i in run]
        flat = _flat(part)
        span = (stats.span("all_reduce", flat.numel() * flat.element_size(), flat.device)
                if stats is not None else contextlib.nullcontext())
        with span:
            _collective(dist.all_reduce, flat, None, None)
        flat.div_(n)
        _unflatten_into(part, flat)


def broadcast_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Every tensor set to the value of ``group``'s rank 0, in place,
    bucketed."""
    if dist.get_world_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for run in _buckets(tensors, BUCKET_BYTES):
        part = [tensors[i] for i in run]
        flat = _flat(part)
        _collective(dist.broadcast, flat, None, group, src=src)
        _unflatten_into(part, flat)


def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values on every rank (a mesh spans every rank: one process
    per rank)."""
    with torch.no_grad():
        broadcast_(tensors)


def all_gather_dim0_(tensors: Sequence[torch.Tensor], group,
                     stats: Optional[CommStats] = None) -> None:
    """Each tensor holds this rank's dim-0 shard (of ``group``'s size) up to
    date; afterwards every shard, from the rank that owns it. Bucketed: the
    shards of a run of tensors travel as one buffer."""
    n, pos = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return
    for run in _buckets(tensors, max(1, BUCKET_BYTES // n)):
        fulls = [tensors[i] for i in run]
        shards = [dim0_shard(t, pos, n) for t in fulls]
        flat = torch.cat([s.reshape(-1) for s in shards])
        out = flat.new_empty(n * flat.numel())
        span = (stats.span("all_gather", flat.numel() * flat.element_size(), flat.device)
                if stats is not None else contextlib.nullcontext())
        with span:
            _collective(dist.all_gather_into_tensor, out, flat, group)
        sizes = [s.numel() for s in shards]
        for j, row in enumerate(out.view(n, -1)):
            if j != pos:
                for t, piece in zip(fulls, row.split(sizes)):
                    shard = dim0_shard(t, j, n)
                    shard.copy_(piece.view_as(shard))


def gather_dim0(shard: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``shard`` (dim 0, the same count on every rank)
    stacked in group-rank order, on every rank: the whole tensor whose
    dim-0 shards the ranks of ``group`` hold."""
    n = dist.get_world_size(group)
    if n == 1:
        return shard
    out = shard.new_empty((n * shard.shape[0],) + tuple(shard.shape[1:]))
    _collective(dist.all_gather_into_tensor, out, shard.contiguous(), group)
    return out
