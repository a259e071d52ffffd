"""The ``(data, spatial)`` mesh: one rank a device in a ``torch.distributed`` group.

Port of ``realtime_style_transfer_tpu/parallel/mesh.py``.  The JAX mesh is
the devices reshaped to ``(n // spatial, spatial)``, and GSPMD inserts its
collectives; the port's :class:`Mesh` lays the ranks out on the same grid,
rank ``r`` at data index ``r // spatial`` and spatial index ``r % spatial``,
and holds this rank's groups: its data group (the ranks of its spatial
index, over which a batch is sharded) and its spatial group (the ranks of
its data index, over which a frame's rows are sharded, :mod:`.spatial`).
Every rank creates every group, in the same order.  Parameters are
replicated by a broadcast from rank 0 over the whole mesh, a batch is
sharded by giving each data index its slice of the leading axis, and
:meth:`Mesh.rows` gives a rank its rows of a frame (the twin of
``activation_spec``); the steps that need a collective make it themselves
(:mod:`.train`, :mod:`.infer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..data.pipeline import _tree_map
from . import distributed
from .spatial import RowShard, row_split

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process on ``device``: data index ``rank`` of ``size`` in the data
    group ``group``, spatial index ``spatial_rank`` of ``spatial`` in the
    spatial group ``spatial_group`` (None when ``spatial`` is 1), and
    ``world``, the group of the whole mesh.  ``group`` and ``world`` are None
    for a mesh of one process without a process group, where every
    collective is the identity."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    spatial: int = 1
    spatial_rank: int = 0
    spatial_group: Optional[Any] = None
    world: Optional[Any] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.size, SPATIAL_AXIS: self.spatial}

    @property
    def is_main(self) -> bool:
        return self.rank == 0 and self.spatial_rank == 0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, in place (and returned)."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank of the mesh, in place (and returned)."""
        if self.world is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.world, 0), group=self.world)
        return t

    def broadcast_module_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers of ``module`` on every rank."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self.broadcast_(t.data)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's ``t`` (one shape on every rank) concatenated along
        the leading axis in rank order."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def rows(self, height: int, align: int) -> Optional[RowShard]:
        """This rank's rows of an ``height``-row frame, the boundaries at
        multiples of ``align`` (``2 ** contracts``, so that every stride-2
        stage's shard is whole rows); None when the spatial axis is 1."""
        if self.spatial == 1:
            return None
        return RowShard(self.spatial_group, self.spatial_rank,
                        row_split(height, self.spatial, align))


def make_mesh(n_devices: Optional[int] = None, *, spatial: int = 1, device=None) -> Mesh:
    """The ``(n // spatial, spatial)`` mesh over the ranks of the process
    group (one process and no group: a mesh of one).  ``n_devices`` must be
    the group's size; on CUDA every rank needs a card of its own, unless
    ``device`` names one (``"cuda:0"``), which every rank then shares.
    ``device="cpu"`` runs the ranks on the CPU (a gloo group)."""
    world = distributed.process_count()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"requested a {n}-device mesh but only {world} rank(s) are running (start "
            f"{n} ranks with torchrun, or call parallel.distributed.initialize in each)")
    if n < world:
        raise ValueError(f"requested a {n}-device mesh in a group of {world} ranks: "
                         "the mesh spans the whole group")
    if n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    want = None if device is None else torch.device(device)
    if want is not None and want.type == "cpu":
        dev = want
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if want is not None and want.index is not None:
            dev = want
        else:
            local = distributed.local_rank()
            if local >= torch.cuda.device_count():
                raise ValueError(
                    f"requested a {n}-device mesh but only {torch.cuda.device_count()} "
                    "device(s) are visible to this machine's ranks")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    rank = distributed.process_index()
    if not dist.is_initialized():
        return Mesh(n, 0, dev)
    if spatial == 1:
        return Mesh(n, rank, dev, dist.group.WORLD, world=dist.group.WORLD)
    n_data = n // spatial
    data_group = spatial_group = None
    # every rank makes every group, in one order: the data groups, then the spatial ones
    for s in range(spatial):
        g = dist.new_group([d * spatial + s for d in range(n_data)])
        if rank % spatial == s:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * spatial + s for s in range(spatial)])
        if rank // spatial == d:
            spatial_group = g
    return Mesh(n_data, rank // spatial, dev, data_group, spatial, rank % spatial,
                spatial_group, dist.group.WORLD)


def frame_rows(mesh: Mesh, plan) -> Optional[RowShard]:
    """This rank's rows of the frames of the transfer net of ``plan`` (a
    ``TransferPlan``): :meth:`Mesh.rows` at the input's height, aligned to
    ``2 ** contracts``; None when the spatial axis is 1."""
    return mesh.rows(plan.input_shape[0], 2 ** plan.num_contract_blocks)


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors of ``tree`` (nested dicts, tuples, dataclasses such
    as a ``TrainState``) on every rank, on the mesh's device."""
    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        return mesh.broadcast_(x.detach().to(mesh.device).clone())

    return _tree_map(place, tree)


def host_shard(batch, mesh: Mesh):
    """This rank's slice (its data index's) of the leading axis of every array
    or tensor of the global ``batch``, where it is (a view)."""
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
