"""The device mesh of the port: the ``('data', 'model')`` mesh.

Counterpart of ``dmf_tpu/parallel/mesh.py`` (:1-76).  JAX runs one process
that drives every chip and lets GSPMD insert the collectives; the port runs
one process a rank (``python -m torch.distributed.run``), a
``torch.distributed`` process group and a
``torch.distributed.device_mesh.DeviceMesh`` named ``('data', 'model')``.
Backends: NCCL where every rank has a card of its own, gloo on the CPU and
where the caller pins several ranks to one card (NCCL refuses that).  The
ranks are laid out as JAX's ``reshape(n_data, n_model)`` (:34-35): global
rank ``d * n_model + m`` is data index ``d`` and model index ``m``.  The
ranks of one data index form its model group (tensor parallelism,
``parallel/tensor.py``); the ranks of one model index form its data group,
over which the data axis below runs.  Global rank 0 alone writes files
(:attr:`Mesh.writer`).

A global batch of ``n`` rows is split over the data ranks in contiguous
shares of ``ceil(n / n_data)`` rows, the last ones short or empty
(:meth:`Mesh.rows`), as the JAX package's padded batch is sharded.  While a
:class:`RowShard` is active (:func:`shard_rows`), the train route computes
the global batch's results from each rank's rows: BatchNorm's batch
statistics over every rank's rows (``models/layers.py``), dropout and
augmentation masks drawn for the whole global batch with this rank's rows
kept (so a mesh run draws what one process draws), each rank's loss as its
share of the global mean, and the gradients summed over the data group
(``train/single.py``, ``train/fusion.py``).  The collectives are
``all_reduce`` and ``broadcast`` alone, the ones gloo also runs on CUDA
tensors; the model group's channel gather (:meth:`Mesh.model_gather`) is
NCCL's all-gather, or under gloo an all-reduce of zeros and each rank's
slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

def row_shares(n: int, n_data: int) -> List[Tuple[int, int]]:
    """``(start, stop)`` of every data rank's rows of a global batch of
    ``n``: contiguous shares of ``ceil(n / n_data)``, the last short or
    empty (JAX's batch padded to a multiple of ``n_data`` and sharded,
    without the padding)."""
    per = -(-n // n_data)
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(n_data)]


class Mesh:
    """A ``('data', 'model')`` mesh of this process group.

    ``rank`` is this process's index on the data axis and ``model_rank`` on
    the model axis, ``device`` its device, ``group`` the data group of its
    model index (the ranks with the same ``model_rank``), ``model_group``
    the model group of its data index, ``shape`` the axes' sizes by name (as
    ``jax.sharding.Mesh.shape``).
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.n_data, self.n_model = (device_mesh.size(0), device_mesh.size(1))
        self.shape = {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}
        self.group = device_mesh.get_group(DATA_AXIS)
        self.model_group = device_mesh.get_group(MODEL_AXIS)
        self.rank = device_mesh.get_local_rank(DATA_AXIS)
        self.model_rank = device_mesh.get_local_rank(MODEL_AXIS)
        self.backend = dist.get_backend(self.group)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank}, "
                f"model_rank={self.model_rank}, device={self.device}, "
                f"backend={self.backend})")

    def __deepcopy__(self, memo):
        # modules hold the mesh: a copy of a model shares its process groups
        return self

    @property
    def writer(self) -> bool:
        """Whether this rank writes files: global rank 0 alone."""
        return self.rank == 0 and self.model_rank == 0

    # ---- rows of a global batch
    def shares(self, n: int) -> List[Tuple[int, int]]:
        """:func:`row_shares` of a global batch of ``n`` over the data axis."""
        return row_shares(n, self.n_data)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        return slice(*self.shares(n)[self.rank])

    # ---- folds over the data axis
    def folds(self, k: int) -> range:
        """This rank's folds of ``k``, ``k / n_data`` contiguous ones; ``k``
        must be a multiple of the data axis's size (as ``shard_map`` needs)."""
        if k % self.n_data:
            raise ValueError(f"{k} folds do not divide over the {self.n_data}-way data axis")
        per = k // self.n_data
        return range(self.rank * per, (self.rank + 1) * per)

    def fold_owner(self, i: int, k: int) -> int:
        """The data rank that steps fold ``i`` of ``k``."""
        return i // (k // self.n_data)

    # ---- collectives (no autograd)
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from data rank ``src`` on every rank, in place, whatever its
        dtype."""
        return exact_broadcast(t, src, self.group)

    def broadcast_object(self, obj, src: int = 0):
        """A picklable object from data rank ``src``."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, group_src=src, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        """Every rank of the mesh (the writer's files are then there)."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def gather_rows(self, t: torch.Tensor, total: int, dim: int = 0) -> torch.Tensor:
        """The global tensor of which ``t`` holds this rank's rows along
        ``dim`` (shares of a global ``total``), on every rank, exactly (an
        all-reduce of zeros and each rank's rows).  Not differentiable: see
        :meth:`RowShard.gather_head`."""
        start, stop = self.shares(total)[self.rank]
        shape = list(t.shape)
        shape[dim] = total
        wire = _wire_dtype(t.dtype)
        full = torch.zeros(shape, dtype=wire, device=t.device)
        full.narrow(dim, start, stop - start).copy_(t)
        return self.all_reduce(full).to(t.dtype)

    # ---- the model group (no autograd: parallel/tensor.py wraps them)
    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model group, in place."""
        if self.n_model > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    def model_broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from model rank ``src`` on every rank of the model group,
        in place, whatever its dtype."""
        if self.n_model > 1:
            exact_broadcast(t, src, self.model_group)
        return t

    def model_broadcast_object(self, obj, src: int = 0):
        """A picklable object from model rank ``src``."""
        if self.n_model == 1:
            return obj
        box = [obj if self.model_rank == src else None]
        dist.broadcast_object_list(box, group_src=src, group=self.model_group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def model_gather(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The tensor of which each model rank holds an equal slice along
        ``dim`` (rank ``m`` the ``m``-th), on every rank, exactly: NCCL's
        all-gather, or under gloo (which gathers no CUDA tensor) an
        all-reduce of zeros and each rank's slice.  Keeps ``t``'s memory
        format."""
        if self.n_model == 1:
            return t
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.n_model
        fmt = memory_format_of(t)
        if self.backend == "nccl":
            parts = t.movedim(dim, 0).contiguous()
            full = torch.empty((n * self.n_model,) + tuple(parts.shape[1:]), dtype=t.dtype,
                               device=t.device)
            dist.all_gather_into_tensor(full, parts, group=self.model_group)
            out = full.movedim(0, dim)
        else:
            out = torch.zeros(shape, dtype=_wire_dtype(t.dtype),
                              device=t.device).contiguous(memory_format=fmt)
            out.narrow(dim, self.model_rank * n, n).copy_(t)
            dist.all_reduce(out, group=self.model_group)
            out = out.to(t.dtype)
        return out.contiguous(memory_format=fmt)


def memory_format_of(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` for a 4-D tensor in that layout (NHWC memory),
    else the contiguous format."""
    return (torch.channels_last if t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor of ``dtype`` is summed in exactly (every rank but
    one adds zeros): floats at least fp32, integers and bools as int64."""
    if dtype.is_floating_point:
        return torch.float64 if dtype == torch.float64 else torch.float32
    return torch.int64


def exact_broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from rank ``src`` of ``group``, in place, whatever its dtype (a
    wire copy where the backend has no collective of that dtype)."""
    if t.dtype == _wire_dtype(t.dtype) and t.is_contiguous():
        dist.broadcast(t, group_src=src, group=group)
        return t
    buf = t.detach().to(_wire_dtype(t.dtype)).contiguous()
    dist.broadcast(buf, group_src=src, group=group)
    t.copy_(buf)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data group, whose gradient is again the sum over the
    data group of each rank's gradient (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``.

    While it is active (:func:`shard_rows`), the train route computes the
    global batch's results from these rows (this module's docstring)."""

    mesh: Mesh
    start: int
    stop: int
    total: int

    @property
    def n(self) -> int:
        return self.stop - self.start

    @property
    def size(self) -> int:
        return self.mesh.n_data

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, differentiable."""
        return _AllReduceSum.apply(t, self.mesh)

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's share of a global per-row mean from ``t``, the mean of
        its own rows: ``t * n / total``; 0 for an empty share (whose mean is
        NaN), still on the autograd graph so that the rank's backward runs
        the same collectives as the others'."""
        if self.n:
            return t * (self.n / self.total)
        return t.nan_to_num(0.0) * 0.0

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor], summed: Sequence[str] = (),
                       replicated: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """Global values of a step's scalar metrics in one all-reduce: the
        sum over ranks for the ``summed`` keys (shares already), the value as
        it is for the ``replicated`` ones (equal on every rank), the global
        mean for the others (means over this rank's rows)."""
        keys = [k for k in metrics if k not in replicated]
        if not keys:
            return dict(metrics)
        vals = [metrics[k].detach().float().reshape(()).to(self.mesh.device) for k in keys]
        vec = torch.stack([v if k in summed else self.share(v) for k, v in zip(keys, vals)])
        self.mesh.all_reduce(vec)
        out = dict(metrics)
        out.update({k: vec[i] for i, k in enumerate(keys)})
        return out

    def gather_head(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """Rows ``0..k-1`` of the global batch of which ``t`` holds this
        rank's rows, on every rank, differentiable (each rank's gradient of
        its rows is the sum of every rank's gradient of them)."""
        full = torch.zeros((k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        lo, hi = min(self.start, k), min(self.stop, k)
        if hi > lo:
            full = full.index_copy(0, torch.arange(lo, hi, device=t.device),
                                   t[:hi - lo].contiguous())
        else:  # keep this rank's rows on the graph: the backward all-reduces here too
            full = full + t.sum() * 0.0
        return self.all_reduce(full)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of which ``t`` holds this rank's rows (no
        gradient)."""
        return self.mesh.gather_rows(t.detach(), self.total)

    def uniform_rows(self, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Uniform [0, 1) fp32 draws for this rank's rows of ``like``: the
        draw of the whole global batch (``like``'s trailing shape and memory
        format) from ``generator``, as one process draws it, of which this
        rank keeps its rows."""
        if like.shape[0] != self.n:
            raise ValueError(f"a draw for {like.shape[0]} rows under a shard of {self.n}")
        fmt = memory_format_of(like)
        full = torch.empty((self.total,) + tuple(like.shape[1:]), dtype=torch.float32,
                           device=like.device, memory_format=fmt)
        return full.uniform_(generator=generator)[self.start:self.stop]

    def rand_rows(self, cols: int, generator: torch.Generator, device) -> torch.Tensor:
        """``torch.rand((total, cols))`` from ``generator``, this rank's rows."""
        return torch.rand((self.total, cols), generator=generator,
                          device=device)[self.start:self.stop]


_ACTIVE: Optional[RowShard] = None


def active_shard() -> Optional[RowShard]:
    """The :class:`RowShard` of the step being run, if any."""
    return _ACTIVE


@contextlib.contextmanager
def shard_rows(mesh: Optional[Mesh], total: int) -> Iterator[Optional[RowShard]]:
    """Run the train route on this rank's rows of a global batch of
    ``total`` (nothing changes with ``mesh=None``)."""
    global _ACTIVE
    if mesh is None:
        yield None
        return
    prev = _ACTIVE
    start, stop = mesh.shares(total)[mesh.rank]
    _ACTIVE = RowShard(mesh, start, stop, total)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _rank_device(devices, rank: int, local_rank: int, local_world: int) -> torch.device:
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < local_world:
            raise ValueError(f"a mesh of {local_world} ranks needs {local_world} cards on "
                             f"this host, have {have} (pin the ranks to devices with "
                             f"devices=, or pass devices='cpu')")
        return torch.device("cuda", local_rank)
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


_MESHES: Dict[tuple, Tuple[object, Mesh]] = {}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Union[None, str, torch.device, Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """The ``('data', 'model')`` mesh over this process group's ranks.

    ``devices``: ``None`` puts each rank on the card of its local rank (the
    host must have a card per local rank); ``'cpu'`` (or ``'cuda:0'``) puts
    every rank there; a sequence gives each rank's device.  ``backend``
    defaults to NCCL where every rank has a card of its own, gloo otherwise.
    The process group is initialised from the environment that
    ``torch.distributed.run`` sets, unless it already is.  Raises
    ``ValueError`` when the host has fewer cards than ranks (``devices=None``)
    or the world size is not ``n_data * n_model``.
    """
    world = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)
    rank = dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0)
    n_data = world // n_model if n_data is None else n_data
    size = n_data * n_model
    # this host's ranks: torch.distributed.run says; a process it did not
    # launch stands for all of them
    local_world = _env_int("LOCAL_WORLD_SIZE", size if world == 1 else world)
    local_rank = _env_int("LOCAL_RANK", rank % local_world)
    device = _rank_device(devices, rank, local_rank, local_world)
    if size != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs {size} ranks, have {world} "
                         f"(launch them with python -m torch.distributed.run "
                         f"--nproc-per-node {size})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    if devices is None:
        own_cards = True
    elif isinstance(devices, (str, torch.device)):
        own_cards = device.type == "cuda" and world == 1
    else:
        own_cards = device.type == "cuda" and len({str(torch.device(d)) for d in devices}) == world
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"backend {backend!r}: the process group runs {have!r}")
        backend = have
    else:
        backend = backend or ("nccl" if own_cards else "gloo")
    if backend == "nccl" and not own_cards:
        raise ValueError("NCCL needs a card of its own for every rank; pin several ranks to "
                         "one card with backend='gloo'")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    # one mesh per shape, device and process group (a group destroyed and
    # made anew gets a mesh of its own)
    key = (n_data, n_model, str(device), backend)
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is dist.group.WORLD:
        return hit[1]
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh = Mesh(dm, device)
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def auto_mesh_shape(n_devices: int, prefer_model: int = 1) -> Tuple[int, int]:
    """Pick ``(n_data, n_model)``: the model axis only if it divides evenly."""
    n_model = prefer_model if n_devices % max(prefer_model, 1) == 0 else 1
    return n_devices // n_model, n_model


def local_mesh(device="cuda") -> Mesh:
    """A 1x1 mesh of this process alone on ``device`` (NCCL on a card, gloo
    on the CPU), initialising a one-rank process group if there is none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(1, 1, devices=[device])


def mesh_from_config(cfg, device="cuda") -> Optional[Mesh]:
    """The production mesh from ``cfg.parallel.mesh_shape`` on ``device``'s
    kind (a card per rank on ``cuda``; every rank on the CPU on ``cpu``).

    ``None`` (the single-process path) for no shape or a 1x1 shape, as the
    JAX function; raises ``ValueError`` when more ranks (or cards) are asked
    for than exist.
    """
    shape = cfg.parallel.mesh_shape
    if shape is None or shape[0] * shape[1] <= 1:
        return None
    device = torch.device(device)
    return make_mesh(*shape, devices=None if device.type == "cuda" else device)
