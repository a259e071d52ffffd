"""Packed-layout inference path for the transfer net (deploy only).

Port of ``realtime_style_transfer_tpu/models/transfer_packed.py``.  The same
math as :class:`.transfer.StyleTransferNet` on the same flax variables, but
every activation outside the residual core stays in space-to-depth layout
(:mod:`..ops.packed_conv`), with the schedule derived from the plan:

    content (B,H,W,C)        -> pack f2            (B,H/2,W/2,4C)
    stem 9x9 s1              fin2 -> fout2
    contract 3x3 s2 (xC-1)   fin2 -> fout2
    last contract 3x3 s2     fin2 -> fout1         bottleneck, dense
    res core (5 blocks)      dense
    expand convT2x (i=0..E)  fin 2^i -> fout 2^(i+1)
    final 9x9 s1             fin 2^E -> fout 2^E
    unpack 2^E + sigmoid     -> (B, H, W, 3)

BatchNorm runs in inference form (eps 1e-3); CIN takes f32 moments per
logical channel across the packed parity groups.  Two styles blend per pixel:
the weight map's mip pyramid is built in the logical domain and the blended
affine maps are packed beside the activations.  It serves the plans that
:class:`..ops.fused_transfer.FusedTransfer` refuses, such as
rst-1920-120-128-17 with two styles (:func:`..video.choose_path`).

``conv_backend``: ``"auto"`` (means ``"xla"``), ``"xla"`` (every conv is a
library ``F.conv2d``) or ``"pallas"`` (the packed stem with its contract tail
fused, and the packed final conv when its packed height is even, run the
hand-written tap-matmul kernel ``csrc/conv_matmul.cu``: two launches a frame).
The names are the JAX package's, so call sites port unchanged.

:class:`PackedTransfer` assembles the packed kernels once (host loops) and
keeps them on the device, the two the tap-matmul kernel runs also packed for
it (:meth:`..ops.packed_conv.PackedConv.with_taps`); :func:`stylize_packed`
builds one when handed raw variables, and the video loop reuses one across
frames.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.conv import conv2d_same
from ..ops.conv_matmul import conv_valid_matmul, conv_valid_matmul_plain
from ..ops.image_ops import style_weight_mips
from ..ops.normalization import CIN_EPS, conditional_instance_norm
from ..ops.packed_conv import (
    PackedConv,
    assemble_conv,
    assemble_conv_transpose,
    pack,
    run_fused_contract,
    run_packed_conv,
    tiled_contract,
    unpack,
)
from ..ops.style_params import StyleParamCursor, apply_style_weights, concat_implicit_weight
from .transfer import NUM_RESIDUAL_BLOCKS, TransferPlan

BN_EPS = 1e-3
CONV_BACKENDS = ("auto", "xla", "pallas")


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.from_numpy(np.array(v, np.float32))


def _bn_affine(params_bn, stats_bn):
    inv = torch.rsqrt(_f32(stats_bn["var"]) + BN_EPS)
    eff_scale = _f32(params_bn["scale"]) * inv
    eff_bias = _f32(params_bn["bias"]) - _f32(stats_bn["mean"]) * eff_scale
    return eff_scale, eff_bias


def _packed_cin(p: torch.Tensor, scale, bias, f: int, c: int, *, epsilon: float, dtype):
    """CIN on a packed tensor: logical per-channel moments across the f^2
    parity groups, in f32.  ``scale``/``bias`` are (B, 1, 1, C) slices (one
    style) or packed per-pixel maps (B, Hp, Wp, f*f*C) after blending."""
    b, hp, wp, _ = p.shape
    x = p.float().reshape(b, hp, wp, f * f, c)
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    var = torch.mean(x * x, dim=(1, 2, 3), keepdim=True) - mean * mean
    inv = torch.rsqrt(var + epsilon)

    def fit(m):
        m = m.float()
        if m.ndim == 4 and m.shape[1] == 1 and m.shape[2] == 1:
            return m.reshape(b, 1, 1, 1, c)
        return m.reshape(b, hp, wp, f * f, c)

    out = fit(bias) + (x - mean) * inv * fit(scale)
    return out.reshape(b, hp, wp, f * f * c).to(dtype)


def _take_affine(cursor: StyleParamCursor, mip, channels: int):
    """The next (scale, bias) slices in cursor order, blended to per-pixel
    (B, H, W, C) maps for two styles, else (B, 1, 1, C)."""
    scale = apply_style_weights(mip, cursor.take(channels))
    bias = apply_style_weights(mip, cursor.take(channels))
    if scale.ndim == 4 and mip is not None and scale.shape[1] == mip.shape[1]:
        return scale, bias
    return (scale.reshape(scale.shape[0], 1, 1, channels),
            bias.reshape(bias.shape[0], 1, 1, channels))


def _packed_maps(scale, bias, f: int):
    """Blended logical maps packed to factor f; (B, 1, 1, C) slices as they are."""
    if scale.ndim == 4 and scale.shape[1] > 1:
        return pack(scale, f), pack(bias, f)
    return scale, bias


class _Contract(NamedTuple):
    conv: PackedConv
    bias: torch.Tensor       # (fout^2 * C,) in dtype
    scale: torch.Tensor      # BN affine, tiled, in dtype
    shift: torch.Tensor
    fused: Optional[dict]    # the contract epilogue's f32 rows, stride-1 fin == fout only


class _Expand(NamedTuple):
    conv: PackedConv
    bias: torch.Tensor       # tiled, in dtype
    filters: int             # logical channels of the CIN that follows
    fout: int


class PackedTransfer:
    """The packed path for a fixed plan and variables: the packed kernels
    assembled once, on ``device`` (default CUDA), in ``dtype``.

    ``variables`` is the flax tree of the transfer net (``{"params",
    "batch_stats"}``, optionally nested under ``"transfer"``) of numpy arrays
    or tensors.  Calling it runs one batch of frames.
    """

    def __init__(self, variables, plan: TransferPlan, *, num_styles: int = 1,
                 dtype=torch.bfloat16, cin_epsilon: float = CIN_EPS, device=None):
        if plan.num_contract_blocks < 1:
            raise ValueError("packed path needs >=1 contract block (fin=2 stem)")
        self.device = resolve_device(device)
        self.plan = plan
        self.num_styles = num_styles
        self.dtype = dtype
        self.eps = float(cin_epsilon)
        params = variables["params"]
        stats = variables["batch_stats"]
        # the full inference model's variables or the bare transfer net's
        params = params.get("transfer", params)
        stats = stats.get("transfer", stats)
        dev = self.device

        def conv_params(name):
            """The kernel (f32, CPU, for assembly) and the bias in dtype."""
            return (_f32(params[name]["kernel"]).to(dtype).float(),
                    _f32(params[name]["bias"]).to(dtype))

        def on_device(t):
            return t.to(dev, dtype)

        schedule = [("contract_0_conv", "contract_0_bn", 1, 2, 2)]
        for ci in range(plan.num_contract_blocks):
            last = ci == plan.num_contract_blocks - 1
            schedule.append((f"contract_{ci + 1}_conv", f"contract_{ci + 1}_bn", 2, 2,
                             1 if last else 2))
        self.contracts: List[_Contract] = []
        for conv_name, bn_name, stride, fin, fout in schedule:
            kernel, bias = conv_params(conv_name)
            eff_scale, eff_bias = _bn_affine(params[bn_name], stats[bn_name])
            ff = fout * fout
            fused = None
            conv = assemble_conv(kernel, stride=stride, fin=fin, fout=fout).to(dev, dtype)
            if stride == 1 and fin == fout:
                fused = tiled_contract(bias.float(), eff_scale, eff_bias, fout, dev)
                conv = conv.with_taps()
            self.contracts.append(_Contract(
                conv,
                on_device(bias.repeat(ff)), on_device(eff_scale.repeat(ff)),
                on_device(eff_bias.repeat(ff)), fused))
        self.residual = []
        for ri in range(NUM_RESIDUAL_BLOCKS):
            for ci in range(2):
                kernel, bias = conv_params(f"residual_{ri}_conv{ci}")
                self.residual.append((on_device(kernel.permute(3, 2, 0, 1).contiguous()),
                                      on_device(bias)))
        self.expands: List[_Expand] = []
        for ei in range(plan.num_expand_blocks):
            fin, fout = 2 ** ei, 2 ** (ei + 1)
            kernel, bias = conv_params(f"expand_{ei}_conv")
            self.expands.append(_Expand(
                assemble_conv_transpose(kernel, fin=fin, fout=fout).to(dev, dtype),
                on_device(bias.repeat(fout * fout)), plan.expand_blocks[ei][0], fout))
        f_final = 2 ** plan.num_expand_blocks
        kernel, bias = conv_params(f"expand_{plan.num_expand_blocks}_conv")
        final = assemble_conv(kernel, stride=1, fin=f_final, fout=f_final).to(dev, dtype)
        self.final = _Expand(
            final.with_taps(),
            on_device(bias.repeat(f_final * f_final)), plan.expand_blocks[-1][0], f_final)

    def __call__(self, content: torch.Tensor, style_params: torch.Tensor,
                 style_weights: Optional[torch.Tensor] = None, *,
                 conv_backend: str = "auto", plain: bool = False) -> torch.Tensor:
        """content (B, H, W, C), style_params (B, S, P), style_weights (B, H,
        W, S-1) when S == 2 -> (B, H, W, 3) f32.  ``plain=True`` runs the
        tap-matmul kernel's plain version at its seams (the oracle the
        kernel is held against on the card)."""
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"conv_backend must be one of {CONV_BACKENDS}, got {conv_backend!r}")
        backend = "xla" if conv_backend == "auto" else conv_backend
        matmul = conv_valid_matmul_plain if plain else conv_valid_matmul
        plan, dtype, dev, eps = self.plan, self.dtype, self.device, self.eps
        num_styles = style_params.shape[1]
        if num_styles != self.num_styles:
            raise ValueError(f"a {self.num_styles}-style engine got {num_styles} styles")
        cursor = StyleParamCursor(style_params[:, None, :, :].to(dev, torch.float32))
        mips = None
        if num_styles > 1:
            if style_weights is None:
                raise ValueError("style_weights required when num_styles > 1")
            weights_full = concat_implicit_weight(style_weights.to(dev, torch.float32))
            mips = style_weight_mips(weights_full, plan.num_mips)

        def pick_mip(logical_width: int):
            return None if mips is None else mips[logical_width]

        x = pack(content.to(dev, dtype), 2)

        # ---- contract stack: stem f2f2, middles f2f2 s2, last f2f1 s2 --------
        for layer in self.contracts:
            if backend == "pallas" and layer.fused is not None:
                x = run_fused_contract(x, layer.conv, layer.fused, matmul=matmul)
            else:
                x = run_packed_conv(x, layer.conv, backend="xla") + layer.bias
                x = torch.relu(x)
                x = torch.relu(x * layer.scale + layer.shift)

        # ---- residual core (dense) ---------------------------------------------
        filters = plan.bottleneck_num_filters
        res_mip = pick_mip(x.shape[-2])
        for ri in range(NUM_RESIDUAL_BLOCKS):
            fx = x
            for ci in range(2):
                weight, bias = self.residual[2 * ri + ci]
                fx = torch.relu(conv2d_same(fx, weight) + bias)
                scale, bias_c = _take_affine(cursor, res_mip, filters)
                fx = conditional_instance_norm(fx, scale, bias_c, epsilon=eps).to(dtype)
                if ci == 0:
                    fx = torch.relu(fx)
            x = fx if ri == 0 else x + fx

        # ---- expand stack: convT2x at growing pack factors, then final s1 ------
        wp = x.shape[2]
        for layer in self.expands:
            x = run_packed_conv(x, layer.conv) + layer.bias
            scale, bias_c = _packed_maps(
                *_take_affine(cursor, pick_mip(wp * layer.fout), layer.filters), layer.fout)
            x = torch.relu(_packed_cin(x, scale, bias_c, layer.fout, layer.filters,
                                       epsilon=eps, dtype=dtype))

        final = self.final
        x = run_packed_conv(x, final.conv, backend=backend, matmul=matmul) + final.bias
        scale, bias_c = _packed_maps(
            *_take_affine(cursor, pick_mip(wp * final.fout), final.filters), final.fout)
        x = torch.sigmoid(_packed_cin(x, scale, bias_c, final.fout, final.filters,
                                      epsilon=eps, dtype=dtype))
        cursor.assert_consumed()
        return unpack(x, final.fout, final.filters).float()


def stylize_packed(variables, content: torch.Tensor, style_params: torch.Tensor,
                   style_weights: Optional[torch.Tensor] = None, *, plan: TransferPlan,
                   dtype=torch.bfloat16, cin_epsilon: float = CIN_EPS,
                   conv_backend: str = "auto") -> torch.Tensor:
    """Packed-layout equivalent of ``StyleTransferNet.forward``.

    ``variables``: the flax tree (a :class:`PackedTransfer` is built on
    content's device) or a :class:`PackedTransfer` of the same plan, dtype
    and epsilon.  ``style_params``: (B, S, P); ``style_weights``: (B, H, W,
    S-1) when S == 2.  ``conv_backend``: 'auto' ('xla'), 'xla' or 'pallas'.
    """
    if isinstance(variables, PackedTransfer):
        engine = variables
        if (engine.plan, engine.dtype, engine.eps) != (plan, dtype, float(cin_epsilon)):
            raise ValueError("the PackedTransfer was built for another plan, dtype or epsilon")
    else:
        engine = PackedTransfer(variables, plan, num_styles=style_params.shape[1], dtype=dtype,
                                cin_epsilon=cin_epsilon, device=content.device)
    return engine(content, style_params, style_weights, conv_backend=conv_backend)
