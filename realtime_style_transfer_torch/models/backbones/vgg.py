"""VGG16 feature extractor (the perceptual-loss tower), NHWC.

Port of ``realtime_style_transfer_tpu/models/backbones/vgg.py``: 13 ``SAME``
3x3 convs with ReLU in 5 blocks, each block ending in a 2x2 stride-2 max
pool, named ``block{i}_conv{j}`` so the reference's tap names and the weight
bridge work as they are.  Callers apply the caffe preprocessing
(:func:`..losses.vgg_preprocess`).  ImageNet weights are not in the
repository: weights come from a seed or through :mod:`...weights`.  The
convs are plain large convolutions that the JAX package leaves to XLA, so
here they are ``F.conv2d``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv

# filters per block; block i has len(entry) convs
VGG16_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)

STYLE_TAPS = ("block1_conv2", "block2_conv2", "block3_conv3", "block4_conv3")
CONTENT_TAPS = ("block5_conv3",)


class VGG16Features(nn.Module):
    """``forward(x)`` -> (final features, taps) for the layer names in
    ``capture``; computes in ``dtype``."""

    def __init__(self, capture: Sequence[str] = STYLE_TAPS + CONTENT_TAPS, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.capture = tuple(capture)
        self.dtype = dtype
        self.blocks = []
        cin = 3
        for bi, filters in enumerate(VGG16_BLOCKS, start=1):
            names = []
            for ci, f in enumerate(filters, start=1):
                names.append(f"block{bi}_conv{ci}")
                self.add_module(names[-1], Conv(cin, f, 3, gen=gen))
                cin = f
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps: Dict[str, torch.Tensor] = {}
        x = x.to(self.dtype)
        for names in self.blocks:
            for name in names:
                x = torch.relu(getattr(self, name)(x))
                if name in self.capture:
                    taps[name] = x
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x, taps
