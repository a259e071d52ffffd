"""Plain PyTorch reference of the style-transfer net blending two styles per
pixel, in float32.

Written from the published description of the dual-style network (the
reference implementation's ``StyleTransferNetwork`` with ``num_styles`` 2:
``realtime_style_transfer/models/styleTransfer.py:36-44`` and ``:288-303``,
and the ``style_weights`` input of ``num_styles - 1`` channels of
``shape_config.py:26-27``).  A (1, H, W, 1) map ``w`` gives the second
style's weight at each pixel; the implicit first weight is ``1 - w``.  The
two weight channels are average-pooled 2x2 into a pyramid keyed by width,
and every conditional instance norm takes the level of its own output
resolution: with ``x^`` the instance-normalised activation and each style's
(scale, bias) rows cut from its own vector in layer order,

    y = x^ * (w0 * scale0 + w1 * scale1) + (w0 * bias0 + w1 * bias1)

per pixel.  The net around the norms is the one-style reference's
(:mod:`.transfer`), whose convolutions, transpose convolutions and batch
norms this module takes from there.

Departures from ``styleTransfer.py``, each also the one-style reference's:
the batch norms apply their running statistics (inference); the transpose
convs are TF ``SAME`` with the kernel not flipped; the weights, content,
style vectors and map come from the benchmark's seed, not from a checkpoint,
a predictor and a shadow mask.  Two styles only: the map has one channel.

It imports nothing of the program and takes only the variables, the content,
the two style vectors and the map that the benchmark hands both sides: it
works out its own pyramid and blend, with no pack, style table or weight
plane of the program's.  TF32 is off, so float32 means float32 on the card.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .transfer import batch_norm, conv_same, conv_transpose_same, full_f32


def weight_pyramid(weights: torch.Tensor, levels: int) -> Dict[int, torch.Tensor]:
    """(1, H, W, 1) second-style weights -> {width: (1, 2, h, w)} of both
    styles' weights, the implicit first prepended, at full size and
    ``levels`` 2x2 average pools below it."""
    w = weights.float().permute(0, 3, 1, 2)
    level = torch.cat([1.0 - w, w], dim=1)
    pyramid = {level.shape[-1]: level}
    for _ in range(levels):
        level = F.avg_pool2d(level, 2)
        pyramid[level.shape[-1]] = level
    return pyramid


def blended_cin(x: torch.Tensor, weights: torch.Tensor, scales: torch.Tensor,
                biases: torch.Tensor, eps: float) -> torch.Tensor:
    """Instance norm of NCHW ``x`` over (H, W), then each pixel's blend of
    the styles' affines: ``weights`` (1, S, H, W), ``scales`` and
    ``biases`` (S, C)."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + eps)
    scale = torch.einsum("bshw,sc->bchw", weights, scales)
    bias = torch.einsum("bshw,sc->bchw", weights, biases)
    return xn * scale + bias


def stylize_dual(cfg: dict, variables: Dict, content: torch.Tensor, styles: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """(1, H, W, C) content, (2, P) style vectors and the (1, H, W, 1) map of
    the second style's weight -> (1, H, W, 3) in [0, 1].  ``variables`` is
    the one-style reference's tree (:func:`.transfer.stylize`)."""
    params, stats = variables["params"], variables["batch_stats"]
    cin_eps, bn_eps = cfg["cin_epsilon"], cfg["bn_epsilon"]
    styles = styles.reshape(2, -1).float()
    h, w, _ = cfg["output_shape"]
    if tuple(weights.shape) != (1, h, w, 1):
        raise ValueError(f"weight map: want (1, {h}, {w}, 1), got {tuple(weights.shape)}")
    offset = 0

    def norm(x, pyramid):
        nonlocal offset
        c = x.shape[1]
        scales, biases = styles[:, offset:offset + c], styles[:, offset + c:offset + 2 * c]
        offset += 2 * c
        return blended_cin(x, pyramid[x.shape[-1]], scales, biases, cin_eps)

    with full_f32():
        pyramid = weight_pyramid(weights, len(cfg["expands"]) + 1)
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
                fx = norm(torch.relu(conv_same(fx, p["kernel"], p["bias"], 1)), pyramid)
                if ci == 0:
                    fx = torch.relu(fx)
            x = fx if ri == 0 else x + fx
        for ei, (_f, _k, s) in enumerate(cfg["expands"]):
            p = params[f"expand_{ei}_conv"]
            x = torch.relu(norm(conv_transpose_same(x, p["kernel"], p["bias"], s), pyramid))
        p = params[f"expand_{len(cfg['expands'])}_conv"]
        x = torch.sigmoid(norm(conv_same(x, p["kernel"], p["bias"], cfg["final"][2]), pyramid))
    if offset != styles.shape[1]:
        raise ValueError(f"style vectors have {styles.shape[1]} values, the net takes {offset}")
    return x.permute(0, 2, 3, 1).contiguous()
