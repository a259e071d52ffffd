"""Process-group start-up and the per-rank slice of a global batch.

Port of ``realtime_style_transfer_tpu/parallel/distributed.py``.  JAX's data
mesh is one process over N devices; the port runs one process a device in a
``torch.distributed`` group (NCCL on the card, gloo where the caller asks for
the CPU), so the rank plays the part of JAX's host: each rank loads only its
slice of every global batch.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# how long a rank waits for the others to join the group or a collective
TIMEOUT = datetime.timedelta(seconds=600)


def free_port() -> int:
    """A free TCP port on localhost, for a group started on one machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group: ``coordinator_address`` (``host:port`` or an
    ``init_method`` URL such as ``tcp://localhost:29500``), ``num_processes``
    ranks, this one ``process_id``; NCCL unless ``backend`` says otherwise
    (``"gloo"`` for the CPU).  Without an address the group comes from the
    environment ``torchrun`` sets.  Does nothing for one process when no
    group is wanted (no address, no backend), as JAX skips
    ``jax.distributed.initialize`` on one process."""
    if (num_processes is not None and num_processes <= 1 and coordinator_address is None
            and backend is None):
        log.info("single process: no process group")
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend or "nccl", init_method=init_method, timeout=TIMEOUT,
                            **kwargs)
    log.info("process group initialized: rank %d / %d (%s)", dist.get_rank(),
             dist.get_world_size(), dist.get_backend())


class _Sum(torch.autograd.Function):
    """The sum over a group by ``reduce_`` (an in-place sum over the group);
    its gradient is the sum of the ranks' gradients (each rank's output feeds
    that rank's loss)."""

    @staticmethod
    def forward(ctx, t, reduce_):
        ctx.reduce_ = reduce_
        out = t.clone(memory_format=torch.contiguous_format)
        reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        ctx.reduce_(grad)
        return grad, None


def sum_autograd(t: torch.Tensor, reduce_: Callable[[torch.Tensor], object]) -> torch.Tensor:
    """The sum of ``t`` over a group, ``reduce_`` summing a tensor over it in
    place, as a new tensor whose gradient is the sum of the ranks' gradients."""
    return _Sum.apply(t, reduce_)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place (and returned)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_moments(sums: torch.Tensor, count: int, reduce_: Callable[[torch.Tensor], object]):
    """A train-mode batch norm's (2, C) sums over this rank's ``count``
    elements a channel -> (the group's sums, the group's count), in one
    differentiable sum by ``reduce_`` (see :func:`sum_autograd`)."""
    flat = torch.cat([sums.reshape(-1), sums.new_tensor([float(count)])])
    flat = sum_autograd(flat, reduce_)
    return flat[:-1].reshape(sums.shape), flat[-1]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its machine (``LOCAL_RANK`` under ``torchrun``)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def host_batch_slice(global_batch_size: int) -> slice:
    """This rank's slice of a globally indexed batch."""
    count = process_count()
    per_host = global_batch_size // count
    if per_host * count != global_batch_size:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {count} processes")
    start = process_index() * per_host
    return slice(start, start + per_host)


def global_array_from_host_batch(mesh, host_batch):
    """This rank's shard of the global batch, ``host_batch`` (a tree of
    arrays or tensors whose leading axis is this rank's slice), on the
    mesh's device.  The global batch is the concatenation of the ranks'
    shards in rank order; no rank holds it whole."""
    from ..data.pipeline import _tree_map

    def place(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return t.to(mesh.device)

    return _tree_map(place, host_batch)
