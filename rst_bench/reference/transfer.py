"""Plain PyTorch reference of the style-transfer net's inference, in float32.

Written from the published description of the network (the reference
implementation's ``StyleTransferNetwork``): a 9x9 stem and stride-2
contracts, each conv -> ReLU -> batch norm (running statistics) -> ReLU;
residual blocks of two (3x3 conv -> ReLU -> conditional instance norm), a
ReLU after the first norm and the input added on every block but the first;
stride-2 transpose convs (TF ``SAME``, the kernel not flipped) -> CIN -> ReLU;
a final 9x9 conv -> CIN -> sigmoid.  Each CIN takes its scale and then its
bias from the flat style vector, in layer order.

It imports nothing of the program and takes only the variables, the content
and the style vector that the benchmark hands both sides: no pack, no folded
affine and no style table of the program's.  Convolutions run with TF32 off,
so float32 means float32 on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convs inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _same(size: int, k: int, s: int):
    """TF ``SAME`` padding of one axis: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int):
    """NCHW ``x``, HWIO ``kernel``: TF ``SAME`` cross-correlation."""
    k = kernel.shape[0]
    py, px = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    x = F.pad(x, (px[0], px[1], py[0], py[1]))
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=stride)


def conv_transpose_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        stride: int):
    """TF ``SAME`` transpose conv with an odd HWIO kernel that is not flipped:
    the input dilated by the stride, padded, then cross-correlated."""
    n, c, h, w = x.shape
    k = kernel.shape[0]
    pad_len = k + stride - 2
    lo = k - 1 if stride > k - 1 else -(-pad_len // 2)
    hi = pad_len - lo
    xd = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    xd[:, :, ::stride, ::stride] = x
    xd = F.pad(xd, (lo, hi, lo, hi))
    return F.conv2d(xd, kernel.permute(3, 2, 0, 1), bias)


def batch_norm(x: torch.Tensor, p: Dict, stats: Dict, eps: float) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(stats["var"] + eps) * p["scale"]
    return (x - stats["mean"].view(shape)) * inv.view(shape) + p["bias"].view(shape)


def cin(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Instance norm over (H, W) per channel with a style's scale and bias."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def stylize(cfg: dict, variables: Dict, content: torch.Tensor,
            style: torch.Tensor) -> torch.Tensor:
    """(1, H, W, C) content and a (P,) style vector -> (1, H, W, 3) in [0, 1].

    ``variables`` is the flax-style tree ``{"params", "batch_stats"}`` of
    float32 tensors: conv ``kernel`` HWIO and ``bias``, batch norm ``scale``,
    ``bias``, ``mean`` and ``var``.
    """
    params, stats = variables["params"], variables["batch_stats"]
    cin_eps, bn_eps = cfg["cin_epsilon"], cfg["bn_epsilon"]
    style = style.reshape(-1).float()
    offset = 0

    def norm(x):
        nonlocal offset
        c = x.shape[1]
        scale, bias = style[offset:offset + c], style[offset + c:offset + 2 * c]
        offset += 2 * c
        return cin(x, scale, bias, cin_eps)

    with full_f32():
        x = content.float().permute(0, 3, 1, 2)
        for bi, (_f, _k, s) in enumerate([cfg["stem"]] + cfg["contracts"]):
            p = params[f"contract_{bi}_conv"]
            x = torch.relu(conv_same(x, p["kernel"], p["bias"], s))
            name = f"contract_{bi}_bn"
            x = torch.relu(batch_norm(x, params[name], stats[name], bn_eps))
        for ri in range(cfg["residual_blocks"]):
            fx = x
            for ci in range(2):
                p = params[f"residual_{ri}_conv{ci}"]
                fx = norm(torch.relu(conv_same(fx, p["kernel"], p["bias"], 1)))
                if ci == 0:
                    fx = torch.relu(fx)
            x = fx if ri == 0 else x + fx
        for ei, (_f, _k, s) in enumerate(cfg["expands"]):
            p = params[f"expand_{ei}_conv"]
            x = torch.relu(norm(conv_transpose_same(x, p["kernel"], p["bias"], s)))
        p = params[f"expand_{len(cfg['expands'])}_conv"]
        x = torch.sigmoid(norm(conv_same(x, p["kernel"], p["bias"], cfg["final"][2])))
    if offset != style.numel():
        raise ValueError(f"style vector has {style.numel()} values, the net takes {offset}")
    return x.permute(0, 2, 3, 1).contiguous()
