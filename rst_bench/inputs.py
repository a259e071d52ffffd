"""Inputs and weights of a run, made on the device from ``--seed``.

Each kind of input draws from its own ``torch.Generator``, seeded from the
run's seed and a fixed tag, so one seed gives the same weights, style vector
and frames on every run, and a frame can be made again after the window for
the reference.  Every seed gives tensors of the same shapes: the seed
changes values, never the work.  The distributions are the configuration
file's ``assumed`` entries.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

_TAGS = {"weights": 1, "style": 2, "content": 3, "sample": 4}


def derived_seed(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed for one kind of input (and one frame of it)."""
    return (int(seed) * 1_000_003 + _TAGS[tag] * 65_537 + index) % (1 << 63)


def generator(seed: int, tag: str, device, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, tag, index))


def transfer_leaves(cfg: dict) -> List[Tuple[str, str, str, Tuple[int, ...]]]:
    """(collection, module, leaf, shape) of every variable of the transfer
    net, flax names, conv kernels HWIO."""
    out = []
    cin = cfg["input_shape"][2]

    def conv(name, k, ci, co):
        out.extend([("params", name, "kernel", (k, k, ci, co)), ("params", name, "bias", (co,))])

    for bi, (f, k, _s) in enumerate([cfg["stem"]] + cfg["contracts"]):
        conv(f"contract_{bi}_conv", k, cin, f)
        bn = f"contract_{bi}_bn"
        out.extend([("params", bn, "scale", (f,)), ("params", bn, "bias", (f,)),
                    ("batch_stats", bn, "mean", (f,)), ("batch_stats", bn, "var", (f,))])
        cin = f
    fb = cfg["bottleneck_num_filters"]
    for ri in range(cfg["residual_blocks"]):
        for ci in range(2):
            conv(f"residual_{ri}_conv{ci}", 3, cin, fb)
            cin = fb
    for ei, (f, k, _s) in enumerate(cfg["expands"] + [cfg["final"]]):
        conv(f"expand_{ei}_conv", k, cin, f)
        cin = f
    return out


def transfer_variables(cfg: dict, seed: int, device) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """The transfer net's float32 variables ``{"params", "batch_stats"}``,
    from two draws on the device (a normal and a uniform one) cut into
    leaves."""
    leaves = transfer_leaves(cfg)
    sizes = [int(torch.Size(shape).numel()) for *_, shape in leaves]
    g = generator(seed, "weights", device)
    normal = torch.randn(sum(sizes), generator=g, device=device).split(sizes)
    uniform = torch.rand(sum(sizes), generator=g, device=device).split(sizes)
    tree: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {"params": {}, "batch_stats": {}}
    for (coll, module, leaf, shape), n, u in zip(leaves, normal, uniform):
        if leaf == "kernel":
            fan_in = shape[0] * shape[1] * shape[2]
            v = n * (2.0 / fan_in) ** 0.5
        elif leaf == "scale":
            v = 0.8 + 0.4 * u
        elif leaf == "var":
            v = 0.5 + u
        elif leaf == "bias" and module.endswith("_bn"):
            v = 0.1 * n
        elif leaf == "mean":
            v = 0.1 * n
        else:  # a conv bias
            v = 0.05 * n
        tree[coll].setdefault(module, {})[leaf] = v.reshape(shape).contiguous()
    return tree


def cin_channels(cfg: dict) -> List[int]:
    """Channels of each CIN, in the style vector's order."""
    fb = cfg["bottleneck_num_filters"]
    return [fb] * (2 * cfg["residual_blocks"]) + [f for f, *_ in cfg["expands"]] \
        + [cfg["final"][0]]


def style_vector(cfg: dict, seed: int, device) -> torch.Tensor:
    """(P,) float32: each CIN's scales U(0.5, 1.5), then its biases
    U(-0.5, 0.5)."""
    is_scale = torch.cat([torch.tensor([1.0] * c + [0.0] * c) for c in cin_channels(cfg)])
    if is_scale.numel() != cfg["num_style_parameters"]:
        raise ValueError(f"{cfg['name']}: the CINs take {is_scale.numel()} style values, "
                         f"the file says {cfg['num_style_parameters']}")
    u = torch.rand(is_scale.numel(), generator=generator(seed, "style", device), device=device)
    return u - 0.5 + is_scale.to(device)


def content_frame(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """(1, H, W, C) float32 G-buffer frame ``index`` of the run's pool: a
    smooth field (a bilinear upsample of a 1/16 resolution one) and a little
    per-pixel noise, in [0, 1)."""
    h, w, c = cfg["input_shape"]
    g = generator(seed, "content", device, index)
    low = torch.rand((1, c, -(-h // 16), -(-w // 16)), generator=g, device=device)
    noise = torch.rand((1, c, h, w), generator=g, device=device)
    smooth = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return (0.85 * smooth + 0.15 * noise).permute(0, 2, 3, 1).contiguous()
