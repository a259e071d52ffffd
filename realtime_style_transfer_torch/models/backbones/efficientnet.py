"""EfficientNet backbones, NHWC: B3 (a loss tower) and V2-S (the style
predictor's backbone and a loss tower).

Port of ``realtime_style_transfer_tpu/models/backbones/efficientnet.py``.
Module names are the flax ones (``normalization``, ``stem_conv``,
``stem_bn``, ``block2c/expand``, ``.../depthwise``, ``.../se_reduce``,
``.../project_bn``, ``top_conv`` ...), so the weight bridge maps them one to
one.  Convs are TF-``SAME`` (asymmetric padding at stride 2), the depthwise
convs grouped convs with ``groups = C``; batch norms use eps 1e-3 and
momentum 0.99.  ``forward(x, train=False)`` returns ``(features, taps)``:

* B3 rescales its input by 1/255 and applies :class:`Normalization`, as the
  Keras v1 graph does, and taps the residual adds ``block{n}{letter}_add``
  (only blocks at stride 1 whose input and output widths agree add);
* V2-S takes its input as it is and taps every named block, without the
  ``_add`` suffix.

``dtype`` is the compute dtype over f32 parameters; ``train=True`` runs the
batch norms on batch statistics.  ImageNet weights are not in the repository:
weights come from a seed or through :mod:`...weights`.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..layers import BatchNorm, Conv

# B0 stage definitions: (expand_ratio, kernel, stride, repeats, out_filters)
EFFICIENTNET_V1_BLOCKS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 3, 1, 1, 16),
    (6, 3, 2, 2, 24),
    (6, 5, 2, 2, 40),
    (6, 3, 2, 3, 80),
    (6, 5, 1, 3, 112),
    (6, 5, 2, 4, 192),
    (6, 3, 1, 1, 320),
)
B3_WIDTH, B3_DEPTH = 1.2, 1.4
STYLE_TAPS_B3 = ("block2c_add", "block3c_add", "block4e_add")
CONTENT_TAPS_B3 = ("block5e_add", "block6f_add", "block7b_add")

# (block_type, expand, kernel, stride, repeats, out_filters, se_ratio)
EFFICIENTNET_V2S_BLOCKS: Tuple[Tuple[str, int, int, int, int, int, float], ...] = (
    ("fused", 1, 3, 1, 2, 24, 0.0),
    ("fused", 4, 3, 2, 4, 48, 0.0),
    ("fused", 4, 3, 2, 4, 64, 0.0),
    ("mbconv", 4, 3, 2, 6, 128, 0.25),
    ("mbconv", 6, 3, 1, 9, 160, 0.25),
    ("mbconv", 6, 3, 2, 15, 256, 0.25),
)
STYLE_TAPS_V2S = ("block1b", "block2d", "block3d", "block4f")
CONTENT_TAPS_V2S = ("block5i",)

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
V2S_STEM_FILTERS = 24
V2S_TOP_FILTERS = 1280


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded in the input's dtype as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM)


class Normalization(nn.Module):
    """Keras ``layers.Normalization``: ``(x - mean) / max(sqrt(variance),
    1e-7)`` in f32.  Its statistics are buffers that the weight bridge maps to
    ``batch_stats/.../mean`` and ``batch_stats/.../variance``; un-adapted they
    are 0 and 1, the identity."""

    def __init__(self, channels: int = 3):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_variance", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.float() - self.running_mean) / torch.clamp(
            torch.sqrt(self.running_variance), min=1e-7)


class MBConv(nn.Module):
    """EfficientNet v1 inverted bottleneck: expand -> depthwise -> SE -> project.
    The squeeze width comes from the block's input channels."""

    def __init__(self, cin: int, expand_ratio: int, kernel: int, stride: int,
                 out_filters: int, se_ratio: float, gen: torch.Generator):
        super().__init__()
        width = cin * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = Conv(cin, width, 1, bias=False, gen=gen)
            self.expand_bn = _bn(width)
        self.depthwise = Conv(width, width, kernel, stride=stride, groups=width, bias=False,
                              gen=gen)
        self.depthwise_bn = _bn(width)
        self.has_se = bool(se_ratio)
        if self.has_se:
            se_filters = max(1, int(cin * se_ratio))
            self.se_reduce = Conv(width, se_filters, 1, gen=gen)
            self.se_expand = Conv(se_filters, width, 1, gen=gen)
        self.project = Conv(width, out_filters, 1, bias=False, gen=gen)
        self.project_bn = _bn(out_filters)
        self.has_add = stride == 1 and cin == out_filters

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        if self.has_expand:
            h = silu(self.expand_bn(self.expand(h), train))
        h = silu(self.depthwise_bn(self.depthwise(h), train))
        if self.has_se:
            s = torch.mean(h, dim=(1, 2), keepdim=True)
            s = self.se_expand(silu(self.se_reduce(s)))
            h = h * torch.sigmoid(s)
        h = self.project_bn(self.project(h), train)
        return h + x if self.has_add else h


class FusedMBConv(nn.Module):
    """V2 fused block.  With an expansion: a full kxk expand conv (BN, SiLU),
    then a 1x1 project with BN and no activation; without one, the kxk conv
    is the project, followed by BN and SiLU."""

    def __init__(self, cin: int, expand_ratio: int, kernel: int, stride: int,
                 out_filters: int, gen: torch.Generator):
        super().__init__()
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            width = cin * expand_ratio
            self.expand = Conv(cin, width, kernel, stride=stride, bias=False, gen=gen)
            self.expand_bn = _bn(width)
            self.project = Conv(width, out_filters, 1, bias=False, gen=gen)
        else:
            self.project = Conv(cin, out_filters, kernel, stride=stride, bias=False, gen=gen)
        self.project_bn = _bn(out_filters)
        self.has_add = stride == 1 and cin == out_filters

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.has_expand:
            h = silu(self.expand_bn(self.expand(x), train))
            h = self.project_bn(self.project(h), train)
        else:
            h = silu(self.project_bn(self.project(x), train))
        return h + x if self.has_add else h


def _block_name(stage: int, unit: int) -> str:
    return f"block{stage}{chr(ord('a') + unit)}"


class EfficientNetB3(nn.Module):
    """B3 feature extractor; taps the residual adds named in ``capture``."""

    def __init__(self, capture: Sequence[str] = (), *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.capture = tuple(capture)
        self.dtype = dtype
        self.normalization = Normalization(3)
        cin = round_filters(32, B3_WIDTH)
        self.stem_conv = Conv(3, cin, 3, stride=2, bias=False, gen=gen)
        self.stem_bn = _bn(cin)
        self.block_names = []
        for stage, (exp, k, s, r, f) in enumerate(EFFICIENTNET_V1_BLOCKS, start=1):
            filters = round_filters(f, B3_WIDTH)
            for unit in range(round_repeats(r, B3_DEPTH)):
                name = _block_name(stage, unit)
                self.add_module(name, MBConv(cin, exp, k, s if unit == 0 else 1, filters,
                                             0.25, gen))
                self.block_names.append(name)
                cin = filters
        top = round_filters(1280, B3_WIDTH)
        self.top_conv = Conv(cin, top, 1, bias=False, gen=gen)
        self.top_bn = _bn(top)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        h = self.normalization(x.to(self.dtype) / 255.0).to(self.dtype)
        h = silu(self.stem_bn(self.stem_conv(h), train))
        for name in self.block_names:
            block = getattr(self, name)
            h = block(h, train)
            tap = f"{name}_add"
            if block.has_add and tap in self.capture:
                taps[tap] = h
        h = silu(self.top_bn(self.top_conv(h), train))
        return h, taps


class EfficientNetV2S(nn.Module):
    """V2-S feature extractor; taps the blocks named in ``capture``."""

    def __init__(self, capture: Sequence[str] = (), *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.capture = tuple(capture)
        self.dtype = dtype
        cin = V2S_STEM_FILTERS
        self.stem_conv = Conv(3, cin, 3, stride=2, bias=False, gen=gen)
        self.stem_bn = _bn(cin)
        self.block_names = []
        for stage, (kind, exp, k, s, r, f, se) in enumerate(EFFICIENTNET_V2S_BLOCKS, start=1):
            for unit in range(r):
                name = _block_name(stage, unit)
                stride = s if unit == 0 else 1
                block = (FusedMBConv(cin, exp, k, stride, f, gen) if kind == "fused"
                         else MBConv(cin, exp, k, stride, f, se, gen))
                self.add_module(name, block)
                self.block_names.append(name)
                cin = f
        self.top_conv = Conv(cin, V2S_TOP_FILTERS, 1, bias=False, gen=gen)
        self.top_bn = _bn(V2S_TOP_FILTERS)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        h = silu(self.stem_bn(self.stem_conv(x.to(self.dtype)), train))
        for name in self.block_names:
            h = getattr(self, name)(h, train)
            if name in self.capture:
                taps[name] = h
        h = silu(self.top_bn(self.top_conv(h), train))
        return h, taps
