"""Space-to-depth ``pack`` / ``unpack`` (the f4 frame layout of the fused path).

Port of ``pack``/``unpack`` in ``realtime_style_transfer_tpu/ops/packed_conv.py``.
A tensor of logical shape (B, H, W, C) is carried as (B, H/f, W/f, f*f*C) with
channel order (dy, dx, c).  The packed-domain conv algebra of that module is
not part of this package.
"""

from __future__ import annotations

import torch


def pack(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C), channel order (dy, dx, c)."""
    if f == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def unpack(p: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    if f == 1:
        return p
    b, hh, ww, _ = p.shape
    x = p.reshape(b, hh, ww, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * f, ww * f, c)
