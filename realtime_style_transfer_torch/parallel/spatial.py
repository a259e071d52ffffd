"""The spatial mesh axis: a frame's rows sharded over the ranks of a group.

In the JAX package GSPMD shards H over the ``spatial`` mesh axis
(``activation_spec``) and inserts each conv's halo exchange itself.  Here a
rank of a spatial group holds the rows :func:`row_split` gives it of every
activation, and the transfer net's layers take a :class:`RowShard` that makes
the exchanges by hand:

* a SAME conv (:meth:`RowShard.halo_same`) takes the rows its window reaches
  above and below this rank's rows from the neighbouring ranks; TF SAME's
  zero rows come only at the frame's top and bottom, their count from the
  frame's height at that level (``same_pads``), not the shard's;
* the stride-2 transpose conv (``ops.conv.conv_transpose_2x``) takes the rows
  its parity-packed kernel reaches: for an odd kernel, the row above;
* the CIN moments (``ops.cin.cin_split``, ``ops.normalization``) and the
  train-mode batch norm moments (:meth:`RowShard.reduce_moments`) come from
  sums all-reduced over the group;
* the output is gathered along H (:meth:`RowShard.gather`), so every rank of
  the group holds the whole frame; the gradient of the gather hands each rank
  its own rows' gradient only, since each rank's loss is the same loss.

The row boundaries are multiples of ``2 ** contracts`` at full resolution,
so that each stride-2 stage's shard is whole rows; the last ranks may hold
fewer rows than the first.  GSPMD pads H to a multiple of the group's size
instead; the port splits unevenly (ROADMAP Queue 3, kept by design).

The exchanges are ``all_gather`` over the group, which gloo (the CPU) and
NCCL both take.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from ..ops.conv import same_pads
from .distributed import all_reduce_, all_reduce_moments, sum_autograd


def row_split(height: int, parts: int, align: int) -> Tuple[Tuple[int, int], ...]:
    """``parts`` ranks' ``[start, stop)`` rows of an ``height``-row frame,
    each boundary a multiple of ``align``; the first ranks take one block of
    ``align`` rows more where the blocks do not share out evenly."""
    if height % align:
        raise ValueError(f"a frame of {height} rows cannot be sharded on the spatial axis: "
                         f"its height must be a multiple of {align} (2 ** the contract stages)")
    blocks = height // align
    if blocks < parts:
        raise ValueError(f"a frame of {height} rows has {blocks} blocks of {align} rows, fewer "
                         f"than the {parts} ranks of the spatial axis")
    base, extra = divmod(blocks, parts)
    bounds, start = [], 0
    for r in range(parts):
        stop = start + (base + (r < extra)) * align
        bounds.append((start, stop))
        start = stop
    return tuple(bounds)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of a frame sharded over ``group``: every rank's
    ``[start, stop)`` at full resolution in ``bounds``, this one at
    ``index``."""

    group: Any
    index: int
    bounds: Tuple[Tuple[int, int], ...]

    @property
    def size(self) -> int:
        return len(self.bounds)

    @property
    def height(self) -> int:
        return self.bounds[-1][1]

    def level(self, rows: int) -> Tuple[int, int]:
        """(the frame's height, this rank's first row) at the level where this
        rank holds ``rows`` rows."""
        start, stop = self.bounds[self.index]
        factor = (stop - start) // rows
        if rows * factor != stop - start:
            raise ValueError(f"{rows} rows are no level of this rank's {stop - start}")
        return self.height // factor, start // factor

    def pixels(self, rows: int, width: int) -> int:
        """The frame's pixels an image at the level of ``rows`` rows."""
        return self.level(rows)[0] * width

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-frame (B, H, W, C) tensor."""
        if t.shape[1] != self.height:
            raise ValueError(f"a frame of {t.shape[1]} rows, not the mesh's {self.height}")
        start, stop = self.bounds[self.index]
        return t[:, start:stop]

    # ---- collectives: the two the exchanges are made of ------------------------

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of ``t``, in place (and returned)."""
        return all_reduce_(t, self.group)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    # ---- built on them ---------------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of ``t`` as a new tensor whose gradient is the sum
        of the ranks' gradients."""
        return sum_autograd(t, self.all_reduce_)

    def reduce_moments(self, sums: torch.Tensor, count: int):
        """A train-mode batch norm's (2, C) sums of x and x^2 over this rank's
        ``count`` elements -> (the group's sums, the group's count)."""
        return all_reduce_moments(sums, count, self.all_reduce_)

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """(B, top + h + bottom, W, C): the ``top`` rows above this rank's
        ``h`` rows and the ``bottom`` rows below it, from the neighbouring
        ranks, zeros beyond the frame's edges; differentiable."""
        if top == 0 and bottom == 0:
            return x
        if max(top, bottom) > x.shape[1]:
            raise ValueError(f"a halo of {top} + {bottom} rows reaches past a neighbour's "
                             f"{x.shape[1]} rows")
        return _Halo.apply(x, top, bottom, self)

    def halo_same(self, x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
        """This rank's rows with the rows a TF ``SAME`` conv of ``kernel`` rows
        and ``stride`` reads around them: the conv of the result, VALID along
        H, gives this rank's rows of the conv of the whole frame."""
        h = x.shape[1]
        height, start = self.level(h)
        if start % stride:
            raise ValueError(f"row {start} is not on a stride-{stride} boundary")
        top, _ = same_pads(height, kernel, stride)
        out_rows = -(-(start + h) // stride) - start // stride
        return self.halo(x, top, (out_rows - 1) * stride - top + kernel - h)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole frame from every rank's rows of it (each rank's ``x``);
        the gradient is this rank's rows of the frame's gradient."""
        return _GatherRows.apply(x, self)


class _Halo(torch.autograd.Function):
    """Forward: each rank gives its first ``bottom`` rows to the rank above
    and its last ``top`` rows to the rank below (one ``all_gather``).
    Backward: each halo's gradient goes back to the rank that owns its rows
    and is added there."""

    @staticmethod
    def forward(ctx, x, top, bottom, shard):
        ctx.top, ctx.bottom, ctx.shard, ctx.h = top, bottom, shard, x.shape[1]
        h, i, n = x.shape[1], shard.index, shard.size
        parts = shard.all_gather(torch.cat([x[:, :bottom], x[:, h - top:]], 1))
        zeros = x.new_zeros((x.shape[0], max(top, bottom)) + tuple(x.shape[2:]))
        above = parts[i - 1][:, bottom:] if i > 0 else zeros[:, :top]
        below = parts[i + 1][:, :bottom] if i < n - 1 else zeros[:, :bottom]
        return torch.cat([above, x, below], 1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, shard, h = ctx.top, ctx.bottom, ctx.shard, ctx.h
        i, n = shard.index, shard.size
        parts = shard.all_gather(torch.cat([g[:, :top], g[:, top + h:]], 1))
        dx = g[:, top:top + h].clone()
        if i < n - 1:   # the rank below read my last rows as its top halo
            dx[:, h - top:] += parts[i + 1][:, :top]
        if i > 0:       # the rank above read my first rows as its bottom halo
            dx[:, :bottom] += parts[i - 1][:, top:]
        return dx, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        h = x.shape[1]
        height, start = shard.level(h)
        factor = shard.height // height
        ctx.rows = (start, start + h)
        spans = [(a // factor, -(-b // factor)) for a, b in shard.bounds]
        most = max(b - a for a, b in spans)
        padded = torch.cat([x, x.new_zeros((x.shape[0], most - h) + tuple(x.shape[2:]))], 1)
        parts = shard.all_gather(padded)
        return torch.cat([p[:, :b - a] for p, (a, b) in zip(parts, spans)], 1)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.rows
        return g[:, start:stop].contiguous(), None
