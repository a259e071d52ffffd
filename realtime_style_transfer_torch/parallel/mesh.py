"""The data mesh: one rank a device in a ``torch.distributed`` group.

Port of ``realtime_style_transfer_tpu/parallel/mesh.py``.  The JAX mesh is
``(data, spatial)`` over one process's devices, and GSPMD inserts its
collectives; the port's :class:`Mesh` wraps the data group instead: its size,
this rank, this rank's device (``cuda:<local rank>``, or the CPU when the
caller asks, with gloo) and ``shape == {"data": n, "spatial": 1}``.
Parameters are replicated by a broadcast from rank 0 and a batch is sharded
by giving each rank its slice of the leading axis; the steps that need a
collective make it themselves (:mod:`.train`, :mod:`.infer`).

``spatial > 1`` (H sharded over devices, with a halo exchange around every
conv) is not ported: ROADMAP.md Queue 1 item 4b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..data.pipeline import _tree_map
from . import distributed

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
SPATIAL_REFUSAL = ("the spatial mesh axis (H sharded over devices) is not ported; it is "
                   "ROADMAP.md Queue 1 item 4b: build the mesh with spatial=1")


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its gradient is the sum of the ranks'
    gradients (each rank's output feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data group of ``size`` ranks; this process is ``rank`` on
    ``device``.  ``group`` is None for a mesh of one process without a
    process group, where every collective is the identity."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.size, SPATIAL_AXIS: 1}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in place (and returned)."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_sum_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks as a new tensor whose gradient is
        the sum of the ranks' gradients."""
        if self.group is None:
            return t
        return _AllReduceSum.apply(t, self.group)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place (and returned)."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0), group=self.group)
        return t

    def broadcast_module_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers of ``module`` on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast_(t.data)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (one shape on every rank) concatenated along the
        leading axis in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_devices: Optional[int] = None, *, spatial: int = 1, device=None) -> Mesh:
    """The data mesh over the ranks of the process group (one process and no
    group: a mesh of one).  ``n_devices`` must be the group's size; on CUDA
    every rank needs a card of its own.  ``device="cpu"`` runs the ranks on
    the CPU (a gloo group)."""
    world = distributed.process_count()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"requested a {n}-device mesh but only {world} rank(s) are running (start "
            f"{n} ranks with torchrun, or call parallel.distributed.initialize in each)")
    if n < world:
        raise ValueError(f"requested a {n}-device mesh in a group of {world} ranks: "
                         "the data mesh spans the whole group")
    if n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    if spatial != 1:
        raise NotImplementedError(SPATIAL_REFUSAL)
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        local = distributed.local_rank()
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"requested a {n}-device mesh but only {torch.cuda.device_count()} "
                "device(s) are visible to this machine's ranks")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(n, distributed.process_index(), dev, group)


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors of ``tree`` (nested dicts, tuples, dataclasses such
    as a ``TrainState``) on every rank, on the mesh's device."""
    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        return mesh.broadcast_(x.detach().to(mesh.device).clone())

    return _tree_map(place, tree)


def host_shard(batch, mesh: Mesh):
    """This rank's slice of the leading axis of every array or tensor of the
    global ``batch``, where it is (a view)."""
    def part(x):
        n = x.shape[0]
        per = n // mesh.size
        if per * mesh.size != n:
            raise ValueError(f"global batch {n} not divisible by {mesh.size} ranks")
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _tree_map(part, batch)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of the global ``batch`` (:func:`host_shard`) on the
    mesh's device."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), host_shard(batch, mesh))


def replicated(mesh: Mesh) -> Callable:
    """The placement of parameters and optimizer state: :func:`replicate`
    on ``mesh``."""
    return lambda tree: replicate(tree, mesh)


def batch_sharding(mesh: Mesh) -> Callable:
    """The placement of a batch: :func:`shard_batch` on ``mesh``."""
    return lambda batch: shard_batch(batch, mesh)
