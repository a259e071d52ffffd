"""Flat style-parameter vector slicing and per-pixel style blending.

Port of ``realtime_style_transfer_tpu/ops/style_params.py``.  Every conditional
instance norm slices two consecutive ranges (scale, bias) out of one flat
style vector per style.  The slice order is the on-disk / engine buffer layout
(2662 floats for the 128-filter flagship), so it is part of the ABI.
"""

from __future__ import annotations

from typing import Optional

import torch


class StyleParamCursor:
    """Cursor over the flat style-parameter axis (the last axis).

    ``style_params`` has shape (..., num_styles, P).  ``take(n)`` returns the
    next ``n`` parameters and advances.
    """

    def __init__(self, style_params: torch.Tensor):
        self.style_params = style_params
        self.offset = 0

    def take(self, num_params: int) -> torch.Tensor:
        lo = self.offset
        hi = lo + num_params
        if hi > self.style_params.shape[-1]:
            raise ValueError(
                f"style param cursor overflow: want [{lo}:{hi}] of "
                f"{self.style_params.shape[-1]}"
            )
        self.offset = hi
        return self.style_params[..., lo:hi]

    def assert_consumed(self) -> None:
        if self.offset != self.style_params.shape[-1]:
            raise ValueError(
                f"style params not fully consumed: used {self.offset} of "
                f"{self.style_params.shape[-1]}"
            )


def apply_style_weights(
    style_weights: Optional[torch.Tensor], style_params: torch.Tensor
) -> torch.Tensor:
    """Blend per-style parameter slices by a per-pixel weight map.

    ``style_params``: (B, 1, S, C); ``style_weights``: (B, H, W, S).  Only the
    exactly-two-styles case blends; anything else passes through.  Returns
    (B, H, W, C) when blending, else the input unchanged.
    """
    if style_weights is None or style_params.shape[-2] != 2:
        return style_params
    params = style_params[:, :, None, :, :]      # (B, 1, 1, S, C)
    weights = style_weights[..., None]            # (B, H, W, S, 1)
    return torch.sum(params * weights, dim=-2)    # (B, H, W, C)


def concat_implicit_weight(style_weights: torch.Tensor) -> torch.Tensor:
    """Prepend the implicit first-style weight ``1 - sum(w)``."""
    sum_of_weights = torch.sum(style_weights, dim=-1, keepdim=True)
    return torch.cat([1.0 - sum_of_weights, style_weights], dim=-1)
