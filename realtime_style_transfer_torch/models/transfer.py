"""The real-time style-transfer network (encoder -> residual core -> decoder).

Port of ``realtime_style_transfer_tpu/models/transfer.py``.  The block-count
math, filter schedules and the flat style-parameter slicing order (the engine
ABI) are the same.  This eager f32 net is the plain oracle for the fused
kernel path in :mod:`..ops.fused_transfer`.

* a 9x9 stem and ``ceil(log2(in_y) - log2(bottleneck_y))`` stride-2 contracts,
  each conv -> ReLU -> BN (eps 1e-3, running stats) -> ReLU
* 5 residual blocks of 2x(3x3 conv -> ReLU -> CIN), ReLU only after the first
  CIN, skip-add on every block except #0
* ``ceil(log2(out_y) - log2(bottleneck_y))`` stride-2 transpose expands
  (-> CIN -> ReLU), then a final 9x9 stride-1 expand -> CIN -> sigmoid
* multi-style: implicit weight ``1 - sum(w)`` is prepended and an AvgPool mip
  pyramid of the weight map (keyed by width) feeds each resolution
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.image_ops import style_weight_mips
from ..ops.normalization import CIN_EPS, NUM_PARAMS_PER_FEATURE, cin_from_cursor
from ..ops.style_params import StyleParamCursor, concat_implicit_weight
from .layers import BatchNorm, Conv, ConvTranspose, normal_, uniform_

CONTRACT_FILTER_SIZES: Tuple[Tuple[int, int, int], ...] = (
    (16, 3, 2),
    (32, 3, 2),
    (32, 3, 2),
    (32, 3, 2),
)
EXPAND_FILTER_SIZES: Tuple[Tuple[int, int, int], ...] = (
    (32, 3, 2),
    (16, 3, 2),
    (8, 3, 2),
    (4, 3, 2),
    (3, 3, 2),
    (3, 3, 2),
    (3, 3, 2),
    (3, 3, 2),
)
NUM_RESIDUAL_BLOCKS = 5
STEM_FILTERS = 32
BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """Static block schedule + the flat style-vector segment layout (the ABI)."""

    input_shape: Tuple[int, int, int]
    output_shape: Tuple[int, int, int]
    bottleneck_res_y: int
    bottleneck_num_filters: int
    num_contract_blocks: int
    num_expand_blocks: int
    # (filters, kernel, stride) per expand block including the final sigmoid block
    expand_blocks: Tuple[Tuple[int, int, int], ...]
    # style params consumed per residual block / per expand block, in slice order
    residual_param_counts: Tuple[int, ...]
    expand_param_counts: Tuple[int, ...]

    @property
    def num_style_parameters(self) -> int:
        return sum(self.residual_param_counts) + sum(self.expand_param_counts)

    @property
    def num_mips(self) -> int:
        return self.num_expand_blocks + 1

    @property
    def contract_schedule(self) -> Tuple[Tuple[int, int, int], ...]:
        """(filters, kernel, stride) of the stem and each contract block."""
        return ((STEM_FILTERS, 9, 1),) + CONTRACT_FILTER_SIZES[:self.num_contract_blocks]


def make_transfer_plan(
    input_shape: Sequence[int],
    output_shape: Sequence[int],
    bottleneck_res_y: int,
    bottleneck_num_filters: int,
) -> TransferPlan:
    num_contract = math.ceil(math.log2(input_shape[0]) - math.log2(bottleneck_res_y))
    num_expand = math.ceil(math.log2(output_shape[0]) - math.log2(bottleneck_res_y))
    expand_blocks = tuple(EXPAND_FILTER_SIZES[i] for i in range(num_expand)) + ((3, 9, 1),)
    res_counts = tuple(
        NUM_PARAMS_PER_FEATURE * 2 * bottleneck_num_filters
        for _ in range(NUM_RESIDUAL_BLOCKS)
    )
    exp_counts = tuple(NUM_PARAMS_PER_FEATURE * f for f, _, _ in expand_blocks)
    return TransferPlan(
        input_shape=tuple(input_shape),
        output_shape=tuple(output_shape),
        bottleneck_res_y=bottleneck_res_y,
        bottleneck_num_filters=bottleneck_num_filters,
        num_contract_blocks=num_contract,
        num_expand_blocks=num_expand,
        expand_blocks=expand_blocks,
        residual_param_counts=res_counts,
        expand_param_counts=exp_counts,
    )


def style_param_count(
    input_shape: Sequence[int],
    output_shape: Sequence[int],
    bottleneck_res_y: int,
    bottleneck_num_filters: int,
) -> int:
    """Size of the flat style vector (2662 for rst-960-120-128-*)."""
    return make_transfer_plan(
        input_shape, output_shape, bottleneck_res_y, bottleneck_num_filters
    ).num_style_parameters


class StyleTransferNet(nn.Module):
    """Encoder-decoder stylization net conditioned on a flat style vector.

    ``forward(content (B, H, W, C), style_params (B, S, P)[, style_weights
    (B, H, W, S-1)])`` -> (B, H, W, 3) in [0, 1], f32.  Weights are drawn from
    ``generator`` (normal(0.02) convs, uniform[0, 0.05) residual convs, zero
    biases) and may be replaced through :func:`..weights.from_flax`.
    """

    def __init__(self, plan: TransferPlan, num_styles: int = 1, *,
                 cin_epsilon: float = CIN_EPS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.plan = plan
        self.num_styles = num_styles
        self.cin_epsilon = cin_epsilon
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def conv_init(t, g):
            return normal_(t, 0.02, g)

        def res_init(t, g):
            return uniform_(t, 0.0, 0.05, g)

        cin = plan.input_shape[-1]
        for bi, (filters, kernel, stride) in enumerate(plan.contract_schedule):
            self.add_module(f"contract_{bi}_conv", Conv(
                cin, filters, kernel, stride=stride, gen=gen, init=conv_init))
            self.add_module(f"contract_{bi}_bn", BatchNorm(filters, BN_EPS))
            cin = filters
        filters = plan.bottleneck_num_filters
        for ri in range(NUM_RESIDUAL_BLOCKS):
            for ci in range(2):
                self.add_module(f"residual_{ri}_conv{ci}", Conv(
                    cin, filters, 3, gen=gen, init=res_init))
                cin = filters
        for ei, (f, kernel, stride) in enumerate(plan.expand_blocks):
            self.add_module(f"expand_{ei}_conv", ConvTranspose(
                cin, f, kernel, stride, gen=gen, init=conv_init))
            cin = f

    def forward(self, content: torch.Tensor, style_params: torch.Tensor,
                style_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        plan = self.plan
        if style_params.shape[-1] != plan.num_style_parameters:
            raise ValueError(
                f"style_params last dim {style_params.shape[-1]} != plan "
                f"{plan.num_style_parameters}")
        mips = None
        if self.num_styles > 1:
            if style_weights is None:
                raise ValueError("style_weights required when num_styles > 1")
            weights_full = concat_implicit_weight(style_weights.float())
            mips = style_weight_mips(weights_full, plan.num_mips)

        x = content.float()
        for bi in range(len(plan.contract_schedule)):
            x = torch.relu(getattr(self, f"contract_{bi}_conv")(x))
            x = torch.relu(getattr(self, f"contract_{bi}_bn")(x))

        # (B, S, P) -> (B, 1, S, P)
        cursor = StyleParamCursor(style_params[:, None, :, :].float())

        def pick_mip(width: int):
            return None if mips is None else mips[width]

        for ri in range(NUM_RESIDUAL_BLOCKS):
            block_weights = pick_mip(x.shape[-2])
            fx = x
            for ci in range(2):
                fx = torch.relu(getattr(self, f"residual_{ri}_conv{ci}")(fx))
                fx = cin_from_cursor(fx, cursor, block_weights,
                                     epsilon=self.cin_epsilon)
                if ci == 0:
                    fx = torch.relu(fx)
            x = fx if ri == 0 else x + fx

        num_blocks = len(plan.expand_blocks)
        for ei, (_f, _k, stride) in enumerate(plan.expand_blocks):
            block_weights = pick_mip(x.shape[-2] * stride)
            x = getattr(self, f"expand_{ei}_conv")(x)
            x = cin_from_cursor(x, cursor, block_weights, epsilon=self.cin_epsilon)
            x = torch.sigmoid(x) if ei == num_blocks - 1 else torch.relu(x)

        cursor.assert_consumed()
        return x.float()
