"""Monocular depth network and the depth loss term.

Port of ``realtime_style_transfer_tpu/models/depth.py``:

* ``MidasLite``: a compact encoder/decoder depth net, (B, 384, 384, 3) in
  [0, 1] -> (B, 384, 384) non-negative inverse depth.  The repository's
  synthetic-pretrained weights are the port's own copy,
  ``assets/midas_lite_synthetic.npz`` (:func:`load_bundled_depth`).
* ``resize_for_depth``: bilinear resize to 384 x 384.  ``jax.image.resize``
  antialiases when it shrinks and renormalises the triangle filter at the
  image edges; ``F.interpolate(antialias=True, align_corners=False)`` does
  the same, up and down.
* ``make_depth_loss_fn``: mean L2 of the depth difference, per sample.
* ``normalize_depth`` / ``ssitrim_loss``: the scale/shift-invariant trimmed
  loss (median by linear interpolation, as ``jnp.percentile``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image_ops import mean_l2_loss_on_batch
from .layers import Conv

DEPTH_RESOLUTION = 384
BUNDLED_DEPTH_CHECKPOINT = Path(__file__).resolve().parent.parent / "assets" / \
    "midas_lite_synthetic.npz"


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """NHWC bilinear resize with ``jax.image.resize`` semantics, in f32."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class _ResBlock(nn.Module):
    def __init__(self, filters: int, gen: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(filters, filters, 3, gen=gen)
        self.Conv_1 = Conv(filters, filters, 3, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.Conv_1(torch.relu(self.Conv_0(x))))


class MidasLite(nn.Module):
    """4-stage encoder + fused decoder; module names are the flax ones."""

    def __init__(self, *, dtype: torch.dtype = torch.float32, base_filters: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        f, cin = base_filters, 3
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"enc{i}_down", Conv(cin, f * mult, 3, stride=2, gen=gen))
            self.add_module(f"enc{i}_res", _ResBlock(f * mult, gen))
            cin = f * mult
        for i, mult in enumerate((4, 2, 1)):
            self.add_module(f"dec{i}_conv", Conv(cin, f * mult, 3, gen=gen))
            self.add_module(f"dec{i}_res", _ResBlock(f * mult, gen))
            cin = f * mult
        self.head = Conv(cin, 1, 3, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        skips = []
        for i in range(4):
            h = torch.relu(getattr(self, f"enc{i}_down")(h))
            h = getattr(self, f"enc{i}_res")(h)
            skips.append(h)
        h = skips[-1]
        for i in range(3):
            h = resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]))
            h = torch.relu(getattr(self, f"dec{i}_conv")(h) + skips[-2 - i])
            h = getattr(self, f"dec{i}_res")(h)
        h = resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]))
        return torch.relu(self.head(h)[..., 0]).float()


def depth_base_filters(variables) -> int:
    """MidasLite's ``base_filters`` from flax variables (the first encoder
    conv's output channels)."""
    return int(np.asarray(variables["params"]["enc0_down"]["kernel"]).shape[-1])


def load_depth_checkpoint(path) -> dict:
    """Flax variables of MidasLite from an ``.npz`` keyed by ``/``-joined
    flax paths, as the JAX package saves them."""
    from ..tracing.checkpoint import read_tree

    tree = read_tree(path)
    return tree if "params" in tree else {"params": tree}


def make_midas(variables=None, *, dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None) -> MidasLite:
    """MidasLite filled from flax ``variables`` (its width follows them), or
    of the default width from ``generator`` when there are none."""
    from ..weights import load_flax

    if variables is None:
        return MidasLite(dtype=dtype, generator=generator)
    return load_flax(MidasLite(dtype=dtype, base_filters=depth_base_filters(variables)),
                     variables)


def load_bundled_depth(dtype: torch.dtype = torch.float32) -> MidasLite:
    """MidasLite with the repository's synthetic-pretrained weights."""
    return make_midas(load_depth_checkpoint(BUNDLED_DEPTH_CHECKPOINT), dtype=dtype)


def resize_for_depth(images: torch.Tensor) -> torch.Tensor:
    """Bilinear resize NHWC images to the depth net's 384 x 384 input."""
    return resize_bilinear(images, (DEPTH_RESOLUTION, DEPTH_RESOLUTION))


def normalize_depth(d: torch.Tensor) -> torch.Tensor:
    """Scale/shift-invariant normalization (median + mean abs deviation)."""
    t = torch.quantile(d.flatten().float(), 0.5)
    s = torch.mean(torch.abs(d - t))
    return (d - t) / s


def ssitrim_loss(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Trimmed scale/shift-invariant loss: the errors at or above their
    80th percentile count zero."""
    err = torch.abs(normalize_depth(d1) - normalize_depth(d2))
    p80 = torch.quantile(err.flatten(), 0.8)
    trimmed = torch.where(err < p80, err, torch.zeros_like(err))
    return 0.5 * torch.sum(trimmed) / err.numel()


def make_depth_loss_fn(depth_apply: Callable[[torch.Tensor], torch.Tensor]):
    """Depth loss: mean L2 of the depth difference per sample -> (B,);
    ``depth_apply`` maps (B, 384, 384, 3) -> (B, 384, 384)."""

    def depth_loss(ground_truth_image: torch.Tensor, predicted_image: torch.Tensor):
        pred_depth = depth_apply(resize_for_depth(predicted_image))
        gt_depth = depth_apply(resize_for_depth(ground_truth_image))
        return mean_l2_loss_on_batch(gt_depth - pred_depth)

    return depth_loss
