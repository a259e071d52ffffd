"""Conditional instance normalization (CIN).

Port of ``realtime_style_transfer_tpu/ops/normalization.py``: per-(batch,
channel) spatial moments over (H, W) in f32, with the variance taken as
``E[x^2] - E[x]^2`` (not ``torch.var``), then
``bias + (x * rsqrt(var + eps) - mean * rsqrt(var + eps)) * scale``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .style_params import StyleParamCursor, apply_style_weights

NUM_PARAMS_PER_FEATURE = 2  # scale + bias
CIN_EPS = 1e-5


def instance_moments(x: torch.Tensor):
    """Spatial mean/variance per (batch, channel) of NHWC ``x``, in f32."""
    xf = x.float()
    mean = torch.mean(xf, dim=(1, 2), keepdim=True)
    var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
    return mean, var


def conditional_instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    epsilon: float = CIN_EPS,
) -> torch.Tensor:
    """Normalize NHWC ``x`` per instance and apply the style affine.

    ``scale``/``bias`` broadcast against (B, H, W, C): (B, 1, C) slices for a
    single style, or per-pixel (B, H, W, C) maps after two-style blending.
    """
    mean, var = instance_moments(x)
    inv = torch.rsqrt(var + epsilon)
    x = x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)
    return bias.to(x.dtype) + x * scale.to(x.dtype)


def cin_from_cursor(
    x: torch.Tensor,
    cursor: StyleParamCursor,
    style_weights: Optional[torch.Tensor],
    *,
    epsilon: float = CIN_EPS,
) -> torch.Tensor:
    """Slice (scale, bias) for ``x``'s channel count off ``cursor``; apply CIN.

    Slice order: scale first, then bias.
    """
    num_features = x.shape[-1]
    scale = apply_style_weights(style_weights, cursor.take(num_features))
    bias = apply_style_weights(style_weights, cursor.take(num_features))
    return conditional_instance_norm(x, scale, bias, epsilon=epsilon)
