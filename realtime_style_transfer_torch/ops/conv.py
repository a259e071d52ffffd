"""Convolution helpers with TF / flax ``SAME`` semantics.

Port of ``realtime_style_transfer_tpu/ops/conv.py``.  Activations are NHWC as
in the JAX package; regular kernels are OIHW (the layout of the port's
``state_dict``), transpose-conv kernels stay HWIO (see :mod:`..weights`).

``SAME`` padding is asymmetric when the stride does not divide evenly:
``total = max((ceil(H/s) - 1) * s + k - H, 0)``, ``total // 2`` before and the
rest after (3x3 stride 2 on even H pads 0 before and 1 after).  So every conv
here is ``F.pad`` followed by a VALID ``F.conv2d``.

The stride-2 transpose conv is ``lax.conv_transpose(..., 'SAME',
transpose_kernel=False)``.  It is computed as one dense stride-1 conv with a
parity-packed kernel (:func:`pack_transpose_kernel`) plus depth-to-space,
exactly as the JAX package does; for odd k, with ``pad_lo = k//2 + 1`` the
input-dilated conv reads cell ``2i + d - pad_lo + t`` for tap t and only even
cells hit real pixels, so parity class d uses taps ``t = (pad_lo - d) mod 2``
stepping by 2.

``rows`` (a :class:`..parallel.spatial.RowShard`) says that ``x`` is this
rank's rows of a frame sharded along H: the rows a conv's window reaches
above and below them come from the neighbouring ranks
(:meth:`~..parallel.spatial.RowShard.halo`), and zero rows pad only the
frame's top and bottom.  For the stride-2 transpose conv of an odd kernel
the parity-packed kernel reads the row above each input row and none below.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME`` (before, after) padding of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias=None, *,
                stride: int = 1, groups: int = 1, rows=None) -> torch.Tensor:
    """``SAME`` conv of NHWC ``x`` with an OIHW ``weight`` -> NHWC."""
    kh, kw = weight.shape[2:]
    px = same_pads(x.shape[2], kw, stride)
    if rows is None:
        py = same_pads(x.shape[1], kh, stride)
    else:
        x, py = rows.halo_same(x, kh, stride), (0, 0)
    x = F.pad(x.permute(0, 3, 1, 2), (px[0], px[1], py[0], py[1]))
    return F.conv2d(x, weight, bias, stride=stride, groups=groups).permute(0, 2, 3, 1)


def _axis_classes(k: int) -> List[Tuple[List[int], int]]:
    """Per parity class d: (tap_indices, window_start_offset)."""
    pad_lo = k // 2 + 1
    out = []
    for d in range(2):
        first = (pad_lo - d) % 2
        taps = list(range(first, k, 2))
        if not taps:
            out.append(([], 0))
            continue
        start = (d - pad_lo + taps[0]) // 2
        out.append((taps, start))
    return out


def pack_transpose_kernel(kernel: torch.Tensor):
    """HWIO (kh, kw, I, O) -> packed HWIO (T_h, T_w, I, 4*O) + padding.

    Returns ``(packed, (pad_y, pad_x))``; output channel block
    ``(dy * 2 + dx)`` holds parity class (dy, dx).
    """
    kh, kw, cin, cout = kernel.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("pack_transpose_kernel expects odd kernel sizes")
    cls_y = _axis_classes(kh)
    cls_x = _axis_classes(kw)
    t_h = max(len(t) for t, _ in cls_y)
    t_w = max(len(t) for t, _ in cls_x)
    o_y = min(s for _, s in cls_y)
    o_x = min(s for _, s in cls_x)

    packed = kernel.new_zeros((t_h, t_w, cin, 4 * cout))
    for dy, (taps_y, sy) in enumerate(cls_y):
        for dx, (taps_x, sx) in enumerate(cls_x):
            if not taps_y or not taps_x:
                continue
            sub = kernel[taps_y[0]::2, taps_x[0]::2]
            cls = dy * 2 + dx
            py, px = sy - o_y, sx - o_x
            packed[py:py + len(taps_y), px:px + len(taps_x), :,
                   cls * cout:(cls + 1) * cout] = sub

    def axis_pad(origin, t_count) -> Tuple[int, int]:
        return (max(0, -origin), max(0, origin + t_count - 1))

    return packed, (axis_pad(o_y, t_h), axis_pad(o_x, t_w))


def depth_to_space_2x(y: torch.Tensor, cout: int) -> torch.Tensor:
    """(B, h, w, 4*cout) parity classes -> (B, 2h, 2w, cout)."""
    b, h, w, _ = y.shape
    y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, cout)


def conv_transpose_2x(x: torch.Tensor, kernel: torch.Tensor, rows=None) -> torch.Tensor:
    """Stride-2 ``SAME`` transpose conv: NHWC ``x``, HWIO ``kernel`` -> NHWC.

    Equals ``lax.conv_transpose(x, kernel, (2, 2), 'SAME',
    transpose_kernel=False)`` for odd kernels.
    """
    b, h, w, _ = x.shape
    cout = kernel.shape[3]
    packed, (pad_y, pad_x) = pack_transpose_kernel(kernel)
    if rows is not None:
        x, pad_y = rows.halo(x, *pad_y), (0, 0)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad_x[0], pad_x[1], pad_y[0], pad_y[1]))
    y = F.conv2d(xp, packed.permute(3, 2, 0, 1))
    y = y[:, :, :h, :w].permute(0, 2, 3, 1)
    return depth_to_space_2x(y, cout)
