"""Data parallelism over ``torch.distributed`` (counterpart of
``uvc_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh, and jit inserts
the gradient psum.  The port runs one process per GPU, as torchrun does,
and joins the processes with a process group:

* ``initialize_multihost`` forms the group: at ``tcp://<coordinator>``
  from ``--coordinator`` / ``--num_processes`` / ``--process_id``, or from
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``); NCCL for the card, gloo for the CPU.  Each process
  takes the card of its local rank before it makes any tensor.
* ``make_mesh`` returns a ``Mesh``, the data-parallel ranks.  Tensor
  parallelism (``mp > 1``) is not ported (ROADMAP.md queue A item 7b).
* ``replicate`` broadcasts a tree from rank 0, as
  ``DistributedDataParallel`` does at construction; ``shard_batch`` keeps
  this rank's rows of a global batch.
* ``all_reduce_mean`` is the gradient all-reduce: the leaves flattened
  into buckets of at most ``BUCKET_BYTES``, one ``all_reduce`` a bucket,
  divided by the world size.  The collectives sum each element in one
  order and hand every rank the result, so every rank ends with the same
  bytes.  The steps are functions over parameter trees, not
  ``nn.Module``s, so ``DistributedDataParallel``'s wrapper, which hooks a
  module's parameters, does not apply: this is its bucketing on a tree.
* ``flip_partners`` gives the rows that a flip of the global batch (the
  mixup partner) puts beside this rank's; ``sum_across`` sums a few
  scalars over the ranks (the eval totals).

Without a process group (one process), every function here is the
identity on one rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

TENSOR_PARALLEL = ("tensor parallelism (--mp > 1: param_partition_spec / "
                   "shard_params) is not ported yet; see ROADMAP.md queue "
                   "A item 7b")
# DistributedDataParallel's default bucket size
BUCKET_BYTES = 25 * 2 ** 20
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel ranks of the default process group: ``size`` of
    them, this process ``rank``."""

    size: int
    rank: int

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}


def _local_rank(rank: int) -> int:
    """``LOCAL_RANK`` (torchrun), else ``SLURM_LOCALID`` (srun), else the
    rank modulo the cards visible."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if os.environ.get(var, "") != "":
            return int(os.environ[var])
    return rank % max(1, torch.cuda.device_count())


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                         device="cuda") -> None:
    """Join the process group.  A no-op for one process (and when the
    group is already up).  ``num_processes > 1`` rendezvous at
    ``tcp://<coordinator>`` as rank ``process_id``, or, without a
    coordinator, at torchrun's ``MASTER_ADDR:MASTER_PORT``; with no
    ``num_processes``, torchrun's environment (``RANK``, ``WORLD_SIZE``,
    a world of one included) forms the group.  More than one process with
    neither raises ValueError at once.  The backend is NCCL when
    ``device`` is the card and gloo on the CPU, unless a Python caller
    names one; on the card each process first takes the card of its local
    rank (``LOCAL_RANK``, ``SLURM_LOCALID``, else the rank modulo the
    cards)."""
    if dist.is_initialized():
        return
    env = os.environ
    torchrun = all(env.get(v, "") != "" for v in _TORCHRUN)
    if num_processes is not None and num_processes > 1:
        if coordinator:
            init = f"tcp://{coordinator}"
        elif torchrun:
            init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            raise ValueError(
                f"--num_processes {num_processes} needs --coordinator "
                "host:port (or torchrun's MASTER_ADDR / MASTER_PORT)")
        if process_id is None:
            if not torchrun:
                raise ValueError(f"--num_processes {num_processes} needs "
                                 "--process_id")
            process_id = int(env["RANK"])
        world, rank = int(num_processes), int(process_id)
    elif num_processes is None and torchrun:
        init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in [0, {world})")
    on_card = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    kw = {}
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available; pass --device cpu")
        local = _local_rank(rank)
        torch.cuda.set_device(local)
        if backend == "nccl":
            # the group's collectives (the checkpoints' barrier too) on
            # this rank's card
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timeout, **kw)


def make_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """The data-parallel ranks of the process group (one rank without
    one).  ``mp > 1`` raises NotImplementedError (tensor parallelism is
    not ported); ``dp * mp`` other than the world size raises
    ValueError."""
    if mp > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    up = dist.is_initialized()
    n = dist.get_world_size() if up else 1
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp({dp}) * mp({mp}) != device count ({n})")
    return Mesh(size=n, rank=dist.get_rank() if up else 0)


def _joined(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and dist.is_initialized()


# ---------------------------------------------------------------------------
# trees of tensors (dicts, lists, tuples, named tuples and dataclasses)
# ---------------------------------------------------------------------------


def _tensors(obj, out: List[torch.Tensor]) -> None:
    if torch.is_tensor(obj):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)


def tree_tensors(obj) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    ``TrainState`` with its optimizer and minimax state), in order."""
    out: List[torch.Tensor] = []
    _tensors(obj, out)
    return out


def _rebuild(obj, it):
    if torch.is_tensor(obj):
        return next(it)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_rebuild(v, it) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else \
            type(obj)(vals)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), it)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _buckets(leaves: Sequence[torch.Tensor], limit: int) -> List[List[int]]:
    """Runs of consecutive leaves of one dtype and device, each at most
    ``limit`` bytes (a larger leaf alone)."""
    out, cur, size, key = [], [], 0, None
    for i, t in enumerate(leaves):
        k, n = (t.dtype, t.device), t.numel() * t.element_size()
        if cur and (k != key or size + n > limit):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
        key = k
    if cur:
        out.append(cur)
    return out


def _flat(leaves, idx) -> torch.Tensor:
    return torch.cat([leaves[i].reshape(-1) for i in idx])


def _unflat(flat: torch.Tensor, leaves, idx, out: list) -> None:
    sizes = [leaves[i].numel() for i in idx]
    for i, part in zip(idx, torch.split(flat, sizes)):
        out[i] = part.view(leaves[i].shape)


def replicate(tree, mesh: Optional[Mesh]):
    """The tree with every tensor rank 0's: its leaves flattened into
    buckets, one broadcast a bucket (new tensors; ``tree`` is not
    modified).  The identity without a process group."""
    if not _joined(mesh):
        return tree
    leaves: List[torch.Tensor] = []
    _tensors(tree, leaves)
    out = list(leaves)
    for idx in _buckets(leaves, BUCKET_BYTES):
        flat = _flat(leaves, idx)
        dist.broadcast(flat, src=0)
        _unflat(flat, leaves, idx, out)
    return _rebuild(tree, iter(out))


def _check_divisible(rows: int, dp: int) -> None:
    if rows % dp != 0:
        raise ValueError(
            f"batch {rows} is not divisible by the "
            f"data-parallel mesh size {dp}; pick --train_batch_size "
            f"as a multiple of it")


def shard_batch(batch, mesh: Mesh, axis: int = 0):
    """This rank's rows (along ``axis``) of every tensor of a global-batch
    tree; the rows of rank r are the r-th of ``mesh.size`` equal runs, so
    the global batch is the ranks' shards in rank order.  A batch the
    ranks do not divide raises ValueError."""
    leaves: List[torch.Tensor] = []
    _tensors(batch, leaves)
    out = []
    for t in leaves:
        _check_divisible(t.shape[axis], mesh.size)
        b = t.shape[axis] // mesh.size
        out.append(t.narrow(axis, mesh.rank * b, b))
    return _rebuild(batch, iter(out))


class _Clock:
    """The gradient all-reduce's calls and host seconds, and, with
    ``events`` on (a card run), a CUDA event pair around each call for its
    device time."""

    def __init__(self):
        self.reset()

    def reset(self, events: bool = False):
        self.calls, self.host_s, self.events = 0, 0.0, events
        self.pairs: list = []


_CLOCK = _Clock()


def reset_reduce_clock(events: bool = False) -> None:
    """Zero the all-reduce's clock; ``events`` also times each call on the
    card."""
    _CLOCK.reset(events)


def reduce_clock() -> dict:
    """``{"calls", "host_ms", "device_ms"}`` of the all-reduces since the
    last reset (``device_ms`` None unless events were on)."""
    dev = None
    if _CLOCK.pairs:
        _CLOCK.pairs[-1][1].synchronize()
        dev = sum(a.elapsed_time(b) for a, b in _CLOCK.pairs)
    return {"calls": _CLOCK.calls, "host_ms": _CLOCK.host_s * 1e3,
            "device_ms": dev}


def all_reduce_mean(tree, mesh: Optional[Mesh],
                    loss: Optional[torch.Tensor] = None):
    """``(tree, loss)`` averaged over the ranks: the leaves flattened into
    buckets of at most ``BUCKET_BYTES``, the loss in the last bucket of its
    dtype, one ``all_reduce`` a bucket, then divided by the world size.
    The identity without a process group."""
    if not _joined(mesh):
        return tree, loss
    t0 = time.perf_counter()
    leaves: List[torch.Tensor] = []
    _tensors(tree, leaves)
    if loss is not None:
        leaves.append(loss.reshape(1))
    timed = _CLOCK.events and leaves and leaves[0].is_cuda
    if timed:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
    out = list(leaves)
    for idx in _buckets(leaves, BUCKET_BYTES):
        flat = _flat(leaves, idx)
        dist.all_reduce(flat)
        flat.div_(mesh.size)
        _unflat(flat, leaves, idx, out)
    if timed:
        pair[1].record()
        _CLOCK.pairs.append(pair)
    _CLOCK.calls += 1
    _CLOCK.host_s += time.perf_counter() - t0
    if loss is not None:
        loss = out.pop().reshape(())
    return _rebuild(tree, iter(out)), loss


def sum_across(values: Sequence[float], mesh: Optional[Mesh],
               device=None) -> List[float]:
    """``values`` summed over the ranks in one ``all_reduce`` (f64, on the
    card under NCCL); the values themselves without a process group."""
    if not _joined(mesh):
        return [float(v) for v in values]
    if device is None:
        nccl = dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) \
            if nccl else torch.device("cpu")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t)
    return t.tolist()


def flip_partners(x: torch.Tensor, labels: torch.Tensor,
                  mesh: Optional[Mesh]):
    """The images and labels that a flip of the global batch puts beside
    this rank's rows, row j's partner at j: row j of rank r pairs with row
    ``b - 1 - j`` of rank ``W - 1 - r``.  One ``all_gather`` of the images
    and one of the labels; the local flip without a process group."""
    if not _joined(mesh):
        return x.flip(0), labels.flip(0)
    xs = [torch.empty_like(x) for _ in range(mesh.size)]
    ys = [torch.empty_like(labels) for _ in range(mesh.size)]
    dist.all_gather(xs, x.contiguous())
    dist.all_gather(ys, labels.contiguous())
    partner = mesh.size - 1 - mesh.rank
    return xs[partner].flip(0), ys[partner].flip(0)


def is_writer() -> bool:
    """True on the rank that writes files: rank 0 of the process group
    (every process without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
