"""Image-space ops: gram matrices, total variation, L2 batch losses, mip pyramids.

Port of ``realtime_style_transfer_tpu/ops/image_ops.py`` (NHWC throughout).
The gram matrix takes f32 products of (possibly bf16) features, as the JAX
one does with ``Precision.HIGHEST``: an f32 matmul on CUDA stays full f32 as
long as ``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False.
"""

from __future__ import annotations

from typing import Dict

import torch


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) gram matrix normalized by H*W, in f32."""
    b, h, w, c = features.shape
    f = features.reshape(b, h * w, c).float()
    return torch.einsum("bic,bid->bcd", f, f) / float(h * w)


def mean_l2_loss_on_batch(t: torch.Tensor) -> torch.Tensor:
    """Mean of 0.5 * t^2 over all non-batch axes -> (B,)."""
    tf = t.float()
    return torch.mean(0.5 * (tf * tf), dim=tuple(range(1, t.ndim)))


def total_variation(images: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation summed per image -> (B,)
    (``tf.image.total_variation``)."""
    x = images.float()
    dh = torch.abs(x[:, 1:, :, :] - x[:, :-1, :, :])
    dw = torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :])
    return dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID average pool of NHWC ``x``."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.sum(dim=(2, 4)) * 0.25


def style_weight_mips(style_weights: torch.Tensor, num_mips: int) -> Dict[int, torch.Tensor]:
    """AvgPool mip pyramid of the per-pixel weight map, keyed by width."""
    mips: Dict[int, torch.Tensor] = {style_weights.shape[-2]: style_weights}
    last = style_weights
    for _ in range(num_mips):
        last = avg_pool_2x(last)
        mips[last.shape[-2]] = last
    return mips
