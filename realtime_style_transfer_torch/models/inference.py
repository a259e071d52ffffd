"""Deployable inference graph: style predictor + transfer net in one module.

Port of ``realtime_style_transfer_tpu/models/inference.py``.  Styles are
folded into the batch axis so the predictor runs once for all of them.

* ``forward(content, style[, style_weights])``: full inference
* ``predict_style_params(style_images)``: predictor only (once per style)
* ``stylize(content, style_params[, style_weights])``: transfer only
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import ShapeConfig
from .predictor import StylePredictor
from .transfer import StyleTransferNet, TransferPlan, make_transfer_plan


def plan_from_config(config: ShapeConfig) -> TransferPlan:
    return make_transfer_plan(
        config.content_shape,
        config.output_shape,
        config.bottleneck_res_y,
        config.bottleneck_num_filters,
    )


class StyleTransferInference(nn.Module):
    """content (B,H,W,C) + style (B,S,H,W,3) [+ weights (B,H,W,S-1)] -> (B,H,W,3)."""

    def __init__(self, plan: TransferPlan, num_styles: int = 1,
                 feature_extractor: str = "mobilenet", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.plan = plan
        self.style_predictor = StylePredictor(
            plan.num_style_parameters, feature_extractor, generator=gen)
        self.transfer = StyleTransferNet(plan, num_styles, generator=gen)

    def predict_style_params(self, style_images: torch.Tensor) -> torch.Tensor:
        """(B, S, H, W, 3) or (B, H, W, 3) -> (B, S, P) or (B, P)."""
        if style_images.ndim == 4:
            return self.style_predictor(style_images)
        b, s = style_images.shape[:2]
        flat = style_images.reshape((b * s,) + tuple(style_images.shape[2:]))
        return self.style_predictor(flat).reshape(b, s, -1)

    def stylize(self, content: torch.Tensor, style_params: torch.Tensor,
                style_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.transfer(content, style_params, style_weights)

    def forward(self, content: torch.Tensor, style: torch.Tensor,
                style_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        style_params = self.predict_style_params(style)
        return self.stylize(content, style_params, style_weights)


def make_inference_model(config: ShapeConfig, *,
                         feature_extractor: Optional[str] = None,
                         device=None, seed: int = 0) -> StyleTransferInference:
    """Build the inference model with weights drawn from ``seed``, in eval
    mode on ``device`` (default CUDA; raises when CUDA is missing)."""
    dev = resolve_device(device)
    model = StyleTransferInference(
        plan_from_config(config),
        num_styles=config.num_styles,
        feature_extractor=feature_extractor or config.feature_extractor,
        generator=torch.Generator().manual_seed(seed),
    )
    return model.eval().to(dev)
