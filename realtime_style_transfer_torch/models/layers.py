"""Small NHWC layers shared by the port's models.

Parameter names follow the weight bridge (:mod:`..weights`): a conv holds an
OIHW ``weight`` and an optional ``bias``; a transpose conv holds an HWIO
``weight``; a batch norm holds ``weight``/``bias`` and the buffers
``running_mean``/``running_var``.  Initialisers draw from an explicit
``torch.Generator`` so that a seed fixes every weight.

Parameters stay f32; a layer computes in the dtype of its input (flax's
``dtype``/``param_dtype``): a bf16 input casts the weights to bf16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.conv import conv2d_same, conv_transpose_2x


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.randn(t.shape, generator=gen) * std)


def uniform_(t: torch.Tensor, lo: float, hi: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's default conv init: truncated normal (+-2 sd), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        x = torch.randn(t.shape, generator=gen)
        bad = x.abs() > 2.0
        while bad.any():
            x[bad] = torch.randn(int(bad.sum()), generator=gen)
            bad = x.abs() > 2.0
        return t.copy_(x * std)


class Conv(nn.Module):
    """``SAME`` conv on NHWC input; OIHW ``weight``; lecun-normal by default."""

    def __init__(self, cin: int, cout: int, kernel: int, *, gen: torch.Generator,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 init: Optional[Callable] = None):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        if init is None:
            lecun_normal_(self.weight, kernel * kernel * (cin // groups), gen)
        else:
            init(self.weight, gen)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """``rows``: ``x`` is this rank's rows of a frame sharded along H
        (:class:`..parallel.spatial.RowShard`)."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d_same(x, self.weight.to(x.dtype), bias, stride=self.stride,
                           groups=self.groups, rows=rows)


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose`` ('SAME', ``transpose_kernel=False``), HWIO weight.

    Stride 2 runs :func:`conv_transpose_2x`; stride 1 with an odd kernel is a
    plain ``SAME`` conv with the same (unflipped) kernel.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, *,
                 gen: torch.Generator, init):
        super().__init__()
        if stride not in (1, 2) or kernel % 2 == 0:
            raise ValueError("ConvTranspose supports odd kernels, stride 1 or 2")
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(kernel, kernel, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        init(self.weight, gen)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.stride == 2:
            return (conv_transpose_2x(x, w, rows) + self.bias).to(x.dtype)
        return conv2d_same(x, w.permute(3, 2, 0, 1), self.bias.to(x.dtype), rows=rows)


# the cross-replica reduction of train-mode batch moments (see batch_moments_reduced)
Reduce = Callable[[torch.Tensor, int], Tuple[torch.Tensor, Union[int, torch.Tensor]]]
_MOMENTS_REDUCE: Optional[Reduce] = None


@contextlib.contextmanager
def batch_moments_reduced(reduce: Reduce) -> Iterator[None]:
    """Inside the block, a train-mode :class:`BatchNorm` forms its moments
    over the global batch: ``reduce(sums, count)`` takes the (2, C)
    per-channel f32 sums of x and x^2 over this replica's ``count``
    elements a channel and returns the sums over all replicas
    (differentiably) and the global element count (all-reduced with them
    where the replicas hold uneven row shards, a spatial axis).  A
    parallel step runs its forward and backward inside, so that each replica
    normalizes as one device would on the whole batch."""
    global _MOMENTS_REDUCE
    previous, _MOMENTS_REDUCE = _MOMENTS_REDUCE, reduce
    try:
        yield
    finally:
        _MOMENTS_REDUCE = previous


class BatchNorm(nn.Module):
    """Batch norm on NHWC input with flax's ``nn.BatchNorm`` rules, in its
    arithmetic order ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    f32, cast back to the input's dtype.

    ``train=False`` uses the running statistics.  ``train=True`` uses the
    batch's: mean and ``max(E[x^2] - E[x]^2, 0)`` over (B, H, W) in f32
    (flax's ``use_fast_variance``), over every replica's batch inside
    :func:`batch_moments_reduced`, and leaves the updated running
    statistics, ``m * running + (1 - m) * batch`` with the biased variance,
    in :attr:`batch_update` without touching the buffers (``F.batch_norm``
    would update with the unbiased variance).  A rerun of the forward, as
    ``torch.utils.checkpoint`` does, computes the same update again; the
    caller commits it once, as flax returns its ``batch_stats``.
    """

    def __init__(self, c: int, eps: float, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.batch_update = None

    def forward(self, x: torch.Tensor, train: bool = False, rows=None) -> torch.Tensor:
        """``rows``: ``x`` is this rank's rows of a frame sharded along H; the
        batch moments are then the frame's (over the rank's spatial group,
        or over :func:`batch_moments_reduced`'s replicas when set)."""
        if train:
            xf = x.float()
            reduce = _MOMENTS_REDUCE or (None if rows is None else rows.reduce_moments)
            if reduce is None:
                mean = torch.mean(xf, dim=(0, 1, 2))
                mean2 = torch.mean(xf * xf, dim=(0, 1, 2))
            else:
                sums, count = reduce(
                    torch.stack([xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))]),
                    xf[..., 0].numel())
                mean, mean2 = sums / count
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.batch_update = (m * self.running_mean + (1 - m) * mean,
                                     m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(x.dtype)
