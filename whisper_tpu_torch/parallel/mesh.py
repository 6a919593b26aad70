"""The ("data", "model") device mesh over torch.distributed.

Counterpart of ``whisper_tpu/parallel/mesh.py``.  whisper_tpu builds a
``jax.sharding.Mesh`` in one controller process and XLA's GSPMD inserts the
collectives; here there is one process per device (SPMD: ``torchrun``, or
:func:`~whisper_tpu_torch.parallel.launch.run_ranks`), each holding its own
shard, and the collectives are written out:

- "data": every rank is given the whole batch and decodes (or trains on)
  its data group's contiguous block of rows (:meth:`Mesh.rows`); results
  are gathered as objects on a CPU gloo group;
- "model": Megatron tensor parallelism.  Column-parallel projections (q, k,
  v, fc1, xq, xk, xv) hold H / model heads and F / model hidden units;
  row-parallel ones (o, fc2, xo) give partial products, summed over the
  model group before the bias and the residual (:func:`reduce_from_model`).

Ranks are laid out data-major, as whisper_tpu's ``reshape(shape)`` of its
device list: rank = data index * model + model index, so that a model
group is adjacent ranks.  ``with mesh:`` puts a mesh in scope for the model
code's reductions and the entry points' row split, as ``with mesh:`` does
for GSPMD in whisper_tpu.  The scope is process-wide, not per thread: a
backward pass (the reductions' gradients, ``torch.utils.checkpoint``'s
recomputation) runs on autograd's own threads.
"""

import datetime
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
_SCOPE: List["Mesh"] = []  # the meshes in scope, innermost last


class Mesh:
    """One rank's view of a (data, model) mesh: its ``shape`` ({"data": D,
    "model": M}), ``coords`` (this rank's index on each axis), ``device``,
    the ``backend`` of its process groups, ``groups`` (the backend's group
    of each axis, for tensors on ``device``) and ``cpu_groups`` (gloo groups
    of each axis and of the world, for host objects).  An axis of size 1
    has no group.  Build it with :func:`make_mesh`."""

    def __init__(self, shape: Tuple[int, int], axis_names: Sequence[str], rank: int,
                 coords: Tuple[int, int], device: torch.device, backend: str,
                 groups: Dict[str, Any], cpu_groups: Dict[str, Any]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank  # in the world
        self.coords = dict(zip(self.axis_names, coords))
        self.device = device
        self.backend = backend
        self.groups = groups
        self.cpu_groups = cpu_groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend!r})")

    def __enter__(self) -> "Mesh":
        _SCOPE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        for i in range(len(_SCOPE) - 1, -1, -1):
            if _SCOPE[i] is self:
                del _SCOPE[i]
                break

    # -- the data axis ------------------------------------------------------

    def rows(self, n: int) -> range:
        """This rank's rows of an n-row batch: its data group's contiguous
        block, the first n % D groups one row longer (``numpy.array_split``;
        GSPMD's data sharding is contiguous too).  A group may get none."""
        D, i = self.shape["data"], self.coords["data"]
        base, extra = divmod(n, D)
        start = i * base + min(i, extra)
        return range(start, start + base + (i < extra))

    def model_only(self) -> "Mesh":
        """This rank's model group as a mesh of its own, (1, model): what a
        data group runs its own rows under, so that nothing inside splits
        them again."""
        if self.shape["data"] == 1:
            return self
        return Mesh((1, self.shape["model"]), self.axis_names, self.rank, (0, self.coords["model"]),
                    self.device, self.backend, {"data": None, "model": self.groups["model"]},
                    {"data": None, "model": self.cpu_groups["model"],
                     "world": self.cpu_groups["model"]})

    # -- collectives --------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """Sum x over an axis in place (nothing on an axis of size 1)."""
        if self.groups[axis] is not None:
            dist.all_reduce(x, group=self.groups[axis])
        return x

    def gather_objects(self, obj: Any, axis: str = "data") -> List[Any]:
        """Every index's ``obj`` along an axis, in index order, on the CPU
        gloo group (pickled: send host objects)."""
        group = self.cpu_groups[axis]
        if group is None:
            return [obj]
        out: List[Any] = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, obj, group=group)
        return out

    def broadcast_object(self, obj: Any = None, axis: str = "world") -> Any:
        """Index 0's ``obj`` along an axis (the world: rank 0's) on every
        rank of it."""
        group = self.cpu_groups[axis]
        if group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
        return box[0]


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh in scope (``with mesh:``), or None."""
    return _SCOPE[-1] if _SCOPE else None


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_of(devices, rank: int) -> torch.device:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device, and a mesh runs on the card unless it is asked for "
                "the CPU (devices=['cpu'] * n, backend 'gloo')")
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        device = torch.device(devices)
    else:
        devices = list(devices)
        if rank >= len(devices):
            raise ValueError(f"make_mesh: {len(devices)} devices for rank {rank}")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {device} asked for on a host without a CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = AXES,
    devices=None,
    *,
    backend: Optional[str] = None,
    timeout: float = 600.0,
) -> Mesh:
    """Build this rank's view of a 2-D ("data", "model") mesh.

    shape: (data, model) sizes; defaults to every rank on "data" (pure DP),
    as whisper_tpu's.  ``devices``: each rank's torch device, indexed by
    rank (one device or device name: all ranks on it); None takes
    ``cuda:LOCAL_RANK``, and raises on a host without CUDA.  ``backend``:
    the process groups' backend, "nccl" for a CUDA mesh and "gloo" for the
    CPU unless named (several ranks on one card need "gloo": NCCL refuses a
    GPU shared by two ranks).  Nothing switches backend or device by itself.

    Starts the default process group from the usual environment variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them; a lone process without them is a world of one)
    when none exists, and its groups, with ``timeout`` seconds on every
    collective, so that a rank that died brings the others down instead of
    hanging them.  The
    mesh must hold the whole world: a mesh larger than the world raises, as
    whisper_tpu's does, and so does a smaller one (a process outside the
    mesh would have nothing to run).
    """
    if tuple(axis_names) != AXES:
        raise ValueError(f"make_mesh: axis names {tuple(axis_names)}; the port's model code reads {AXES}")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
    if shape is None:
        shape = (world, 1)
    shape = (int(shape[0]), int(shape[1]))
    n = shape[0] * shape[1]
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n != world:
        raise ValueError(f"mesh shape {shape} holds {n} of the world's {world} ranks: "
                         "launch one process per device of the mesh")
    device = _device_of(devices, rank)
    limit = datetime.timedelta(seconds=timeout)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: backend 'nccl' carries CUDA tensors, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if "MASTER_ADDR" in os.environ:
            init = "env://"
        elif world == 1:
            init = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise RuntimeError("make_mesh: a world of several ranks needs MASTER_ADDR and MASTER_PORT")
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=limit)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()!r}, "
                         f"the mesh asked for {backend!r}")
    D, M = shape
    grid = [[d * M + m for m in range(M)] for d in range(D)]
    along = {"model": grid, "data": [list(col) for col in zip(*grid)]}
    groups: Dict[str, Any] = {"data": None, "model": None}
    cpu_groups: Dict[str, Any] = {"data": None, "model": None}
    # every rank creates every group, in the same order
    for axis in AXES:
        for ranks in along[axis]:
            mine = rank in ranks
            g = dist.new_group(ranks, timeout=limit) if len(ranks) > 1 else None
            cg = g if backend == "gloo" or g is None else dist.new_group(ranks, timeout=limit, backend="gloo")
            if mine:
                groups[axis], cpu_groups[axis] = g, cg
    cpu_groups["world"] = (None if world == 1 else dist.group.WORLD if backend == "gloo"
                           else dist.new_group(timeout=limit, backend="gloo"))
    return Mesh(shape, axis_names, rank, divmod(rank, M), device, backend, groups, cpu_groups)


# ---------------------------------------------------------------------------
# Megatron's two operators on the model axis
# ---------------------------------------------------------------------------


def _model_group(what: str):
    mesh = current_mesh()
    if mesh is None or mesh.shape["model"] == 1:
        raise RuntimeError(
            f"{what}: these parameters are a model shard, whose products are partial; run it "
            "under `with mesh:`, the mesh they were sharded for (parallel.shard_params)")
    return mesh.groups["model"]


class _SumForward(torch.autograd.Function):
    """The sum over a group forward, the identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward, the sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group  # backward runs on autograd's thread
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's partial product summed over the model
    group (Megatron's g).  Without gradients it sums y in place; in a pass
    that takes them the backward is the identity: every rank's output
    gradient is already the whole one.  (``torch.distributed.nn``'s
    all_reduce would sum it again, multiplying it by the model size.)"""
    return _sum(y, _model_group("reduce_from_model"))


def _sum(y: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and y.requires_grad:
        return _SumForward.apply(y, group)
    dist.all_reduce(y, group=group)
    return y


def reduce_over_data(y: torch.Tensor) -> torch.Tensor:
    """y summed over the data group of the mesh in scope (none: y), with
    the identity backward: a data group's part of a loss over the global
    batch, whose gradients the optimizer then sums over "data"."""
    mesh = current_mesh()
    if mesh is None or mesh.groups["data"] is None:
        return y
    return _sum(y, mesh.groups["data"])


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel projection (Megatron's f): x itself,
    and in a pass that takes gradients, its gradient summed over the model
    group (each rank's heads give a part of it)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, _model_group("copy_to_model"))
    return x
