"""Conditional instance normalization (CIN).

Port of ``realtime_style_transfer_tpu/ops/normalization.py``: per-(batch,
channel) spatial moments over (H, W) in f32, with the variance taken as
``E[x^2] - E[x]^2`` (not ``torch.var``), then
``bias + (x * rsqrt(var + eps) - mean * rsqrt(var + eps)) * scale``.
With ``use_pallas`` and one style, :func:`cin_from_cursor` takes the CUDA
kernel of :mod:`.cin` (the TPU package's ``cin_pallas``).

``rows`` (a :class:`..parallel.spatial.RowShard`) says that ``x`` is this
rank's rows of a frame sharded along H: the moments are then the frame's,
from f32 sums of x and x^2 all-reduced over the rank's spatial group (whose
backward sums the ranks' gradients) over the frame's pixel count.
"""

from __future__ import annotations

from typing import Optional

import torch

from .style_params import StyleParamCursor, apply_style_weights

NUM_PARAMS_PER_FEATURE = 2  # scale + bias
CIN_EPS = 1e-5


def instance_moments(x: torch.Tensor, rows=None):
    """Spatial mean/variance per (batch, channel) of NHWC ``x``, in f32; over
    the whole frame of ``rows``' group where given."""
    xf = x.float()
    if rows is None:
        mean = torch.mean(xf, dim=(1, 2), keepdim=True)
        var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
        return mean, var
    sums = rows.all_reduce_sum(torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))]))
    mean, mean2 = (sums / rows.pixels(x.shape[1], x.shape[2]))[:, :, None, None, :]
    return mean, mean2 - mean * mean


def conditional_instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    epsilon: float = CIN_EPS,
    rows=None,
) -> torch.Tensor:
    """Normalize NHWC ``x`` per instance and apply the style affine.

    ``scale``/``bias`` broadcast against (B, H, W, C): (B, 1, C) slices for a
    single style, or per-pixel (B, H, W, C) maps after two-style blending.
    """
    mean, var = instance_moments(x, rows)
    inv = torch.rsqrt(var + epsilon)
    x = x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)
    return bias.to(x.dtype) + x * scale.to(x.dtype)


def cin_from_cursor(
    x: torch.Tensor,
    cursor: StyleParamCursor,
    style_weights: Optional[torch.Tensor],
    *,
    epsilon: float = CIN_EPS,
    use_pallas: bool = False,
    plain: bool = False,
    rows=None,
) -> torch.Tensor:
    """Slice (scale, bias) for ``x``'s channel count off ``cursor``; apply CIN.

    Slice order: scale first, then bias.  ``use_pallas`` with one style
    (``style_weights is None``) takes :func:`.cin.cin`, or with ``plain`` its
    plain version :func:`.cin.cin_plain`; with ``rows``, :func:`.cin.cin_split`.
    """
    num_features = x.shape[-1]
    scale = apply_style_weights(style_weights, cursor.take(num_features))
    bias = apply_style_weights(style_weights, cursor.take(num_features))
    if rows is not None:
        if use_pallas and style_weights is None:
            from .cin import cin_split

            return cin_split(x, scale, bias, rows, epsilon=epsilon, plain=plain)
        return conditional_instance_norm(x, scale, bias, epsilon=epsilon, rows=rows)
    if use_pallas and style_weights is None:
        from .cin import cin, cin_plain

        return (cin_plain if plain else cin)(x, scale, bias, epsilon=epsilon)
    return conditional_instance_norm(x, scale, bias, epsilon=epsilon)
