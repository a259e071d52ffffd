"""Small NHWC layers shared by the port's models.

Parameter names follow the weight bridge (:mod:`..weights`): a conv holds an
OIHW ``weight`` and an optional ``bias``; a transpose conv holds an HWIO
``weight``; a batch norm holds ``weight``/``bias`` and the buffers
``running_mean``/``running_var``.  Initialisers draw from an explicit
``torch.Generator`` so that a seed fixes every weight.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, stride=self.stride,
                           groups=self.groups)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            return conv_transpose_2x(x, self.weight) + self.bias
        return conv2d_same(x, self.weight.permute(3, 2, 0, 1), self.bias)


class BatchNorm(nn.Module):
    """Inference batch norm on NHWC input, flax's arithmetic order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias
