"""MobileNetV3-Small feature extractor (no classifier head), NHWC.

Port of ``realtime_style_transfer_tpu/models/backbones/mobilenetv3.py``.
Inputs are expected in [-1, 1].  Module names are the flax ones
(``stem_conv``, ``expanded_conv``, ``expanded_conv_<i>``, ``last_conv`` ...),
so the weight bridge maps them one to one.  Batch norms use eps 1e-3;
depthwise convs are grouped convs with ``groups = C``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..layers import BatchNorm, Conv

# (kernel, expansion, out_filters, use_se, activation, stride) per inverted residual.
MOBILENETV3_SMALL_BLOCKS: Tuple[Tuple[int, int, int, bool, str, int], ...] = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
)
BN_EPS = 1e-3
STEM_FILTERS = 16
LAST_FILTERS = 576


def _depth(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Keras ``_depth``: round channel counts to multiples of ``divisor``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


_ACTS = {"relu": torch.relu, "hswish": hard_swish}


class SqueezeExcite(nn.Module):
    """GAP -> 1x1 conv (relu) -> 1x1 conv (hard sigmoid) -> scale."""

    def __init__(self, filters: int, se_filters: int, gen: torch.Generator):
        super().__init__()
        self.se_reduce = Conv(filters, se_filters, 1, gen=gen)
        self.se_expand = Conv(se_filters, filters, 1, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(1, 2), keepdim=True)
        s = torch.relu(self.se_reduce(s))
        return x * hard_sigmoid(self.se_expand(s))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, kernel: int, expansion: int, out_filters: int,
                 use_se: bool, activation: str, stride: int, block_index: int,
                 gen: torch.Generator):
        super().__init__()
        self.act = _ACTS[activation]
        self.has_expand = block_index > 0  # Keras skips it on the first block
        width = cin
        if self.has_expand:
            self.expand = Conv(cin, expansion, 1, bias=False, gen=gen)
            self.expand_bn = BatchNorm(expansion, BN_EPS)
            width = expansion
        self.depthwise = Conv(width, width, kernel, stride=stride, groups=width,
                              bias=False, gen=gen)
        self.depthwise_bn = BatchNorm(width, BN_EPS)
        self.se = (SqueezeExcite(width, _depth(expansion * 0.25), gen)
                   if use_se else None)
        self.project = Conv(width, out_filters, 1, bias=False, gen=gen)
        self.project_bn = BatchNorm(out_filters, BN_EPS)
        self.has_add = stride == 1 and cin == out_filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_expand:
            x = self.act(self.expand_bn(self.expand(x)))
        x = self.act(self.depthwise_bn(self.depthwise(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.project_bn(self.project(x))
        return x + shortcut if self.has_add else x


class MobileNetV3Small(nn.Module):
    """Feature extractor; ``forward`` returns (features, taps) where taps holds
    the residual-add outputs named in ``capture`` (``expanded_conv_<i>/Add``)."""

    def __init__(self, capture: Sequence[str] = (), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.capture = tuple(capture)
        self.stem_conv = Conv(3, STEM_FILTERS, 3, stride=2, bias=False, gen=gen)
        self.stem_bn = BatchNorm(STEM_FILTERS, BN_EPS)
        cin = STEM_FILTERS
        self.block_names = []
        for i, (k, exp, out, se, act, stride) in enumerate(MOBILENETV3_SMALL_BLOCKS):
            name = "expanded_conv" if i == 0 else f"expanded_conv_{i}"
            self.add_module(name, InvertedResidual(
                cin, k, exp, out, se, act, stride, i, gen))
            self.block_names.append(name)
            cin = out
        self.last_conv = Conv(cin, LAST_FILTERS, 1, bias=False, gen=gen)
        self.last_bn = BatchNorm(LAST_FILTERS, BN_EPS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        x = hard_swish(self.stem_bn(self.stem_conv(x.float())))
        for name in self.block_names:
            block = getattr(self, name)
            x = block(x)
            tap_name = f"{name}/Add"
            if block.has_add and tap_name in self.capture:
                taps[tap_name] = x
        x = hard_swish(self.last_bn(self.last_conv(x)))
        return x, taps
