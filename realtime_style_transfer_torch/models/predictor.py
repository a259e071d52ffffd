"""Style prediction network: style image -> flat style-parameter vector.

Port of ``realtime_style_transfer_tpu/models/predictor.py``: backbone (dummy
conv / MobileNetV3-Small / EfficientNetV2-S) -> global average pool -> 1x1
conv to a 100-dim bottleneck -> 1x1 conv to the transfer net's parameter
count.  The MobileNet and EfficientNet backbones rescale [0, 1] inputs to
[-1, 1].  Head convs use
VarianceScaling(1/3, fan_out, uniform) kernels and 0.5 biases.  ``dtype`` is
the compute dtype over f32 parameters; the output is f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .backbones.efficientnet import V2S_TOP_FILTERS, EfficientNetV2S
from .backbones.mobilenetv3 import LAST_FILTERS, MobileNetV3Small
from .layers import Conv, uniform_

DUMMY = "dummy"
MOBILE_NET = "mobilenet"
EFFICIENT_NET = "efficientnet"


def _head_init(fan_out: int):
    limit = math.sqrt(3.0 * (1.0 / 3.0) / fan_out)

    def init(t, gen):
        return uniform_(t, -limit, limit, gen)

    return init


class StylePredictor(nn.Module):
    """Maps (B, H, W, 3) style images in [0, 1] to (B, num_top_parameters)."""

    def __init__(self, num_top_parameters: int, feature_extractor: str = MOBILE_NET,
                 num_style_parameters: int = 100, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.feature_extractor = feature_extractor
        self.dtype = dtype
        if feature_extractor == DUMMY:
            self.dummy_conv = Conv(3, 1, 9, stride=5, gen=gen)
            width = 1
        elif feature_extractor == MOBILE_NET:
            self.backbone = MobileNetV3Small(dtype=dtype, generator=gen)
            width = LAST_FILTERS
        elif feature_extractor == EFFICIENT_NET:
            self.backbone = EfficientNetV2S(dtype=dtype, generator=gen)
            width = V2S_TOP_FILTERS
        else:
            raise ValueError(f"unknown feature_extractor {feature_extractor!r}")
        self.StylePredictor = Conv(width, num_style_parameters, 1, gen=gen,
                                   init=_head_init(num_style_parameters))
        self.StyleNormPredictor = Conv(num_style_parameters, num_top_parameters, 1,
                                       gen=gen, init=_head_init(num_top_parameters))
        with torch.no_grad():
            self.StylePredictor.bias.fill_(0.5)
            self.StyleNormPredictor.bias.fill_(0.5)

    def forward(self, style_image: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = style_image.to(self.dtype)
        if self.feature_extractor == DUMMY:
            x = self.dummy_conv(x)
        else:
            x, _ = self.backbone(x * 2.0 - 1.0, train)
        x = torch.mean(x, dim=(1, 2), keepdim=True)
        x = self.StyleNormPredictor(self.StylePredictor(x))
        return x[:, 0, 0, :].float()
