"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``uvc_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ``(data, model)`` device
mesh, and jit inserts the collectives.  The port runs one process per
GPU, as torchrun does, and joins the processes with a process group:

* ``initialize_multihost`` forms the group: at ``tcp://<coordinator>``
  from ``--coordinator`` / ``--num_processes`` / ``--process_id``, or from
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``); NCCL for the card, gloo for the CPU.  Each process
  takes the card of its local rank before it makes any tensor.
* ``make_mesh(dp, mp)`` lays the ranks out as JAX's ``devices.reshape(dp,
  mp)``: rank r sits at (data index r // mp, model index r % mp).  With
  ``mp > 1`` it forms a group per data row (the model group: the ranks
  that hold one batch shard and split the weights) and per model column
  (the data group: the ranks that hold one weight shard and split the
  batch).
* Tensor parallelism (``mp > 1``) is Megatron's layout on the stacked
  ``'blocks'`` leaves (``param_partition_spec``): the qkv and fc1 kernels
  and biases split on their output axis, the proj and fc2 kernels on
  their input axis, everything else replicated.  ``shard_params`` keeps
  this rank's contiguous chunk of each such leaf, as a ``NamedSharding``
  places it on the JAX device at the same (data, model) index;
  ``gather_params`` all-gathers the chunks over the model group into the
  whole leaves.  Between steps a rank holds its chunk only; a step
  gathers the whole weights, runs the kernels on them whole (as XLA runs
  a TPU custom call whole on every device of a model group) and keeps
  its chunk of the update.
* ``replicate`` broadcasts a tree from rank 0, as
  ``DistributedDataParallel`` does at construction; ``shard_batch`` keeps
  this rank's rows of a global batch, by its data index.
* ``all_reduce_mean`` is the gradient all-reduce over the data group: the
  leaves flattened into buckets of at most ``BUCKET_BYTES``, one
  ``all_reduce`` a bucket, divided by the data-parallel size.  The
  collectives sum each element in one order and hand every rank the
  result, so every rank ends with the same bytes.  The steps are
  functions over parameter trees, not ``nn.Module``s, so
  ``DistributedDataParallel``'s wrapper, which hooks a module's
  parameters, does not apply: this is its bucketing on a tree.
* ``flip_partners`` gives the rows that a flip of the global batch (the
  mixup partner) puts beside this rank's; ``sum_across`` sums a few
  scalars over the data group (the eval totals).

Without a process group (one process), every function here is the
identity on one rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from uvc_tpu_torch.utils.tree import tree_leaves, tree_unflatten

# DistributedDataParallel's default bucket size
BUCKET_BYTES = 25 * 2 ** 20
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group as a ``(data, model)``
    mesh: ``size`` of them (``dp * mp``), this process ``rank``, at data
    index ``rank // mp`` and model index ``rank % mp``.  ``data_group`` /
    ``model_group`` are this rank's column and row (None: the default
    group, and no model group, when ``mp`` is 1)."""

    size: int
    rank: int
    mp: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def dp(self) -> int:
        return self.size // self.mp

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.mp}


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
    """The ranks of the process group (one rank without one) as a ``dp x
    mp`` mesh laid out as JAX's ``reshape(dp, mp)``; ``dp`` defaults to
    the world size over ``mp``, and ``dp * mp`` other than the world size
    raises ValueError.  With ``mp > 1`` every rank forms every model group
    (row) and data group (column), in order, as ``new_group`` asks."""
    up = dist.is_initialized()
    n = dist.get_world_size() if up else 1
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp({dp}) * mp({mp}) != device count ({n})")
    rank = dist.get_rank() if up else 0
    groups = {}
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if d == rank // mp:
                groups["model_group"] = g
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if m == rank % mp:
                groups["data_group"] = g
    return Mesh(size=n, rank=rank, mp=mp, **groups)


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


# ---------------------------------------------------------------------------
# tensor parallelism: the model axis
# ---------------------------------------------------------------------------


def _keyed_leaves(tree, path: str = "") -> List[tuple]:
    """(key string, leaf) pairs of a tree of dicts, lists and tuples, the
    key string as ``jax.tree_util.keystr`` writes it
    (``['blocks']['qkv']['kernel']``, ``[3]`` for an index)."""
    if isinstance(tree, dict):
        return [kl for k, v in tree.items()
                for kl in _keyed_leaves(v, f"{path}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _keyed_leaves(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def param_partition_spec(path: str, leaf, mp: int) -> tuple:
    """Megatron-style tensor-parallel partition spec of the leaf at
    ``path`` (a ``keystr``), as the tuple of a JAX ``PartitionSpec``:
    ``()`` replicated, else ``"model"`` at the sharded axis.

    Stacked block tensors carry a leading layer axis:
      qkv.kernel [L, D, 3D] -> shard 3D (column parallel)
      fc1.kernel [L, D, F]  -> shard F  (column parallel)
      proj.kernel [L, D, D] -> shard input D (row parallel)
      fc2.kernel [L, F, D]  -> shard F  (row parallel)
    and the qkv / fc1 biases [L, 3D] / [L, F] on their last axis.
    Everything else is replicated (``'ablation_blocks'`` does not match
    ``'blocks'``)."""
    if mp <= 1:
        return ()
    if "'blocks'" in path:
        if "qkv" in path and "kernel" in path:
            return (None, None, "model")
        if "fc1" in path and "kernel" in path:
            return (None, None, "model")
        if "qkv" in path and "bias" in path:
            return (None, "model")
        if "fc1" in path and "bias" in path:
            return (None, "model")
        if "proj" in path and "kernel" in path:
            return (None, "model", None)
        if "fc2" in path and "kernel" in path:
            return (None, "model", None)
    return ()


def _tp_leaves(tree, mp: int) -> List[tuple]:
    """(leaf index, tensor, sharded axis) of the tree's tensor-parallel
    leaves, in the tree's leaf order."""
    out = []
    for i, (path, leaf) in enumerate(_keyed_leaves(tree)):
        spec = param_partition_spec(path, leaf, mp)
        if "model" in spec:
            out.append((i, leaf, spec.index("model")))
    return out


def tensor_parallel_leaves(tree, mp: int) -> List[torch.Tensor]:
    """The tree's leaves that ``param_partition_spec`` shards at ``mp``."""
    return [leaf for _, leaf, _ in _tp_leaves(tree, mp)]


def _replace_leaves(tree, new: dict):
    """The tree with its leaves at the indices of ``new`` replaced."""
    return tree_unflatten(tree, [new.get(i, leaf) for i, leaf
                                 in enumerate(tree_leaves(tree))])


def shard_params(params, mesh: Optional[Mesh], mp: int = 1):
    """This rank's shard of a parameter-shaped tree: at each
    tensor-parallel leaf (``param_partition_spec``) the contiguous chunk
    ``model_index`` of ``mp`` along the sharded axis, in a tensor of its
    own (the whole leaf is not kept alive); every other leaf as it is.
    The tree itself when ``mp`` is 1 or there is no mesh."""
    if mesh is None or mp <= 1:
        return params
    check_model_axis(mesh, mp)
    new = {}
    for i, leaf, axis in _tp_leaves(params, mp):
        size = leaf.shape[axis]
        if size % mp:
            raise ValueError(f"axis {axis} of a {tuple(leaf.shape)} leaf "
                             f"does not split into {mp} shards")
        c = size // mp
        new[i] = leaf.narrow(axis, mesh.model_index * c, c).clone(
            memory_format=torch.contiguous_format)
    return _replace_leaves(params, new)


def check_model_axis(mesh: Optional[Mesh], mp: int) -> None:
    """A driver's ``mp`` must be its mesh's model axis (the steps read it
    from the mesh); without a mesh ``mp`` is not read, as in the JAX
    drivers."""
    if mesh is not None and mp != mesh.mp:
        raise ValueError(f"mp({mp}) is not the mesh's model axis "
                         f"({mesh.mp})")


def gather_params(params, mesh: Optional[Mesh]):
    """The whole tree from the ranks' shards (``shard_params``'s inverse):
    one ``all_gather`` over the model group of every tensor-parallel
    shard's bytes, each leaf then concatenated in model order along its
    sharded axis.  The tree itself without a model group."""
    if mesh is None or mesh.mp <= 1 or not _joined(mesh):
        return params
    leaves = _tp_leaves(params, mesh.mp)
    if not leaves:
        return params
    t0 = time.perf_counter()
    flats = [leaf.contiguous().reshape(-1).view(torch.uint8)
             for _, leaf, _ in leaves]
    timed = _GATHER.events and flats[0].is_cuda
    if timed:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
    # each shard's bytes at a 16-byte offset, so that every slice views
    # back as its dtype
    pads = [-f.numel() % 16 for f in flats]
    flat = torch.cat([piece for f, pad in zip(flats, pads)
                      for piece in (f, f.new_zeros(pad))])
    parts = [torch.empty_like(flat) for _ in range(mesh.mp)]
    dist.all_gather(parts, flat, group=mesh.model_group)
    new, start = {}, 0
    for (i, leaf, axis), f, pad in zip(leaves, flats, pads):
        stop = start + f.numel()
        new[i] = torch.cat([p[start:stop].view(leaf.dtype).view(leaf.shape)
                            for p in parts], dim=axis)
        start = stop + pad
    if timed:
        pair[1].record()
        _GATHER.pairs.append(pair)
    _GATHER.calls += 1
    _GATHER.host_s += time.perf_counter() - t0
    return _replace_leaves(params, new)


def _check_divisible(rows: int, dp: int) -> None:
    if rows % dp != 0:
        raise ValueError(
            f"batch {rows} is not divisible by the "
            f"data-parallel mesh size {dp}; pick --train_batch_size "
            f"as a multiple of it")


def shard_batch(batch, mesh: Mesh, axis: int = 0):
    """This rank's rows (along ``axis``) of every tensor of a global-batch
    tree; the rows of data index d are the d-th of ``mesh.dp`` equal runs,
    so the global batch is the data shards in order, and the ranks of a
    model group hold the same rows.  A batch the data-parallel size does
    not divide raises ValueError."""
    leaves: List[torch.Tensor] = []
    _tensors(batch, leaves)
    out = []
    for t in leaves:
        _check_divisible(t.shape[axis], mesh.dp)
        b = t.shape[axis] // mesh.dp
        out.append(t.narrow(axis, mesh.data_index * b, b))
    return _rebuild(batch, iter(out))


class _Clock:
    """A collective's calls and host seconds, and, with ``events`` on (a
    card run), a CUDA event pair around each call for its device time."""

    def __init__(self):
        self.reset()

    def reset(self, events: bool = False):
        self.calls, self.host_s, self.events = 0, 0.0, events
        self.pairs: list = []

    def read(self) -> dict:
        dev = None
        if self.pairs:
            self.pairs[-1][1].synchronize()
            dev = sum(a.elapsed_time(b) for a, b in self.pairs)
        return {"calls": self.calls, "host_ms": self.host_s * 1e3,
                "device_ms": dev}


# the gradient all-reduce's and the weights' all-gather's
_CLOCK = _Clock()
_GATHER = _Clock()


def reset_reduce_clock(events: bool = False) -> None:
    """Zero the all-reduce's and the all-gather's clocks; ``events`` also
    times each call on the card."""
    _CLOCK.reset(events)
    _GATHER.reset(events)


def reduce_clock() -> dict:
    """``{"calls", "host_ms", "device_ms"}`` of the all-reduces since the
    last reset (``device_ms`` None unless events were on)."""
    return _CLOCK.read()


def gather_clock() -> dict:
    """``reduce_clock`` of the weights' all-gathers (``gather_params``)."""
    return _GATHER.read()


def all_reduce_mean(tree, mesh: Optional[Mesh],
                    loss: Optional[torch.Tensor] = None):
    """``(tree, loss)`` averaged over the data group: the leaves flattened
    into buckets of at most ``BUCKET_BYTES``, the loss in the last bucket
    of its dtype, one ``all_reduce`` a bucket, then divided by the
    data-parallel size.  The identity without a process group."""
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
        dist.all_reduce(flat, group=mesh.data_group)
        flat.div_(mesh.dp)
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
    """``values`` summed over the data group in one ``all_reduce`` (f64,
    on the card under NCCL); the values themselves without a process
    group."""
    if not _joined(mesh):
        return [float(v) for v in values]
    if device is None:
        nccl = dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) \
            if nccl else torch.device("cpu")
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, group=mesh.data_group)
    return t.tolist()


def flip_partners(x: torch.Tensor, labels: torch.Tensor,
                  mesh: Optional[Mesh]):
    """The images and labels that a flip of the global batch puts beside
    this rank's rows, row j's partner at j: row j of data index d pairs
    with row ``b - 1 - j`` of data index ``dp - 1 - d``.  One
    ``all_gather`` of the images and one of the labels over the data
    group; the local flip without a process group."""
    if not _joined(mesh):
        return x.flip(0), labels.flip(0)
    xs = [torch.empty_like(x) for _ in range(mesh.dp)]
    ys = [torch.empty_like(labels) for _ in range(mesh.dp)]
    dist.all_gather(xs, x.contiguous(), group=mesh.data_group)
    dist.all_gather(ys, labels.contiguous(), group=mesh.data_group)
    partner = mesh.dp - 1 - mesh.data_index
    return xs[partner].flip(0), ys[partner].flip(0)


def is_writer() -> bool:
    """True on the rank that writes files: rank 0 of the process group
    (every process without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
