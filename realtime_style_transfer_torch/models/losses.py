"""Perceptual style/content loss tower.

Port of ``realtime_style_transfer_tpu/models/losses.py``.  Each extractor
maps [0, 1] RGB images (B, H, W, 3) to ``{'content': {layer: features},
'style': {layer: features}}`` and carries its loss factors:

* VGG16: style ``block1_conv2, block2_conv2, block3_conv3, block4_conv3``,
  content ``block5_conv3``; caffe preprocessing (x255, RGB -> BGR, mean
  subtract); factors content 1e4 / style 1e-3 / tv 1e-1 / depth 1e-2
* MobileNetV3-Small: residual-add taps, batch norms on running statistics;
  factors 1e-3 / 1 / 1e-3 / 1e-4
* EfficientNet B3 (``efficientnet``): residual-add taps, style
  ``block{2c,3c,4e}_add``, content ``block{5e,6f,7b}_add``; the input
  rescaled to [-1, 1] (B3 then rescales by 1/255 and normalizes); factors 1
* EfficientNetV2-S (``efficientnet_v2s``): block taps, style
  ``block1b, block2d, block3d, block4f``, content ``block5i``; factors 1
* Dummy: two 3x3 convs, for fast offline tests; factors 1

:func:`make_style_loss_function` composes the per-sample (B,) components
``loss = content L2 * f + gram-difference L2 * f + total variation * f
[+ depth * f]``, running the three extractor calls (ground-truth content,
style, prediction) as three calls (``split``), one call on the batch of 3B
(``batched``) or 3B calls of one image (``scan``): the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..ops.image_ops import gram_matrix, mean_l2_loss_on_batch, total_variation
from .backbones import efficientnet as effnet
from .backbones import mobilenetv3 as mnv3_mod
from .backbones import vgg as vgg_mod
from .layers import Conv

# Caffe-style means of tf.keras.applications.vgg16.preprocess_input (BGR order).
VGG_BGR_MEANS = (103.939, 116.779, 123.68)
TOWER_MODES = ("split", "batched", "scan")


@dataclasses.dataclass(frozen=True)
class LossFactors:
    content: float = 1.0
    style: float = 1.0
    total_variation: float = 1.0
    depth: float = 1.0


def vgg_preprocess(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB -> caffe BGR, f32."""
    x = images01.float() * 255.0
    x = x.flip(-1)  # RGB -> BGR
    return x - x.new_tensor(VGG_BGR_MEANS)


class VGGLossExtractor(nn.Module):
    factors = LossFactors(1e4, 1e-3, 1e-1, 1e-2)

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vgg16 = vgg_mod.VGG16Features(vgg_mod.STYLE_TAPS + vgg_mod.CONTENT_TAPS,
                                           dtype=dtype, generator=generator)

    def forward(self, images01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        _, taps = self.vgg16(vgg_preprocess(images01))
        return {"content": {n: taps[n] for n in vgg_mod.CONTENT_TAPS},
                "style": {n: taps[n] for n in vgg_mod.STYLE_TAPS}}


class MobileNetLossExtractor(nn.Module):
    factors = LossFactors(1e-3, 1.0, 1e-3, 1e-4)

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mobilenetv3 = mnv3_mod.MobileNetV3Small(
            mnv3_mod.STYLE_TAPS + mnv3_mod.CONTENT_TAPS, dtype=dtype, generator=generator)

    def forward(self, images01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        _, taps = self.mobilenetv3(images01 * 2.0 - 1.0)
        return {"content": {n: taps[n] for n in mnv3_mod.CONTENT_TAPS},
                "style": {n: taps[n] for n in mnv3_mod.STYLE_TAPS}}


class DummyLossExtractor(nn.Module):
    """Two tiny convs; fast, offline, used by tests."""

    factors = LossFactors(1.0, 1.0, 1.0, 1.0)

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.dummy_conv1 = Conv(3, 3, 3, gen=gen)
        self.dummy_conv2 = Conv(3, 3, 3, gen=gen)

    def forward(self, images01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        out1 = self.dummy_conv1(images01.to(self.dtype))
        out2 = self.dummy_conv2(out1)
        return {"content": {"dummy_conv2": out2}, "style": {"dummy_conv1": out1}}


class EfficientNetLossExtractor(nn.Module):
    """EfficientNet B3 residual-add taps, batch norms on running statistics."""

    factors = LossFactors(1.0, 1.0, 1.0, 1.0)

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.efficientnetb3 = effnet.EfficientNetB3(
            effnet.STYLE_TAPS_B3 + effnet.CONTENT_TAPS_B3, dtype=dtype, generator=generator)

    def forward(self, images01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        _, taps = self.efficientnetb3(images01 * 2.0 - 1.0)
        return {"content": {n: taps[n] for n in effnet.CONTENT_TAPS_B3},
                "style": {n: taps[n] for n in effnet.STYLE_TAPS_B3}}


class EfficientNetV2SLossExtractor(nn.Module):
    """EfficientNetV2-S block taps, batch norms on running statistics."""

    factors = LossFactors(1.0, 1.0, 1.0, 1.0)

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.efficientnetv2s = effnet.EfficientNetV2S(
            effnet.STYLE_TAPS_V2S + effnet.CONTENT_TAPS_V2S, dtype=dtype, generator=generator)

    def forward(self, images01: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        _, taps = self.efficientnetv2s(images01 * 2.0 - 1.0)
        return {"content": {n: taps[n] for n in effnet.CONTENT_TAPS_V2S},
                "style": {n: taps[n] for n in effnet.STYLE_TAPS_V2S}}


LOSS_EXTRACTORS = {
    "vgg": VGGLossExtractor,
    "mobilenet": MobileNetLossExtractor,
    "efficientnet": EfficientNetLossExtractor,
    "efficientnet_v2s": EfficientNetV2SLossExtractor,
    "dummy": DummyLossExtractor,
}


def loss_extractor(name: str, **kwargs) -> nn.Module:
    """The loss tower ``name``, one of :data:`LOSS_EXTRACTORS`."""
    if name not in LOSS_EXTRACTORS:
        raise ValueError(f"unknown loss extractor {name!r}")
    return LOSS_EXTRACTORS[name](**kwargs)


def make_style_loss_function(
    extractor_apply: Callable[[torch.Tensor], Dict[str, Dict[str, torch.Tensor]]],
    factors: LossFactors,
    depth_loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    *,
    tower_mode: str = "split",
):
    """Build ``compute_loss(prediction, ground_truth) -> dict of (B,)
    components``; ``ground_truth`` is ``{'content': (B, H, W, 3), 'style':
    (B, 1, H, W, 3)}`` (one style only)."""
    if tower_mode not in TOWER_MODES:
        raise ValueError(f"unknown tower_mode {tower_mode!r}")

    def scan_apply(images: torch.Tensor):
        parts = [extractor_apply(images[i:i + 1]) for i in range(images.shape[0])]
        return {kind: {layer: torch.cat([p[kind][layer] for p in parts])
                       for layer in parts[0][kind]} for kind in parts[0]}

    def compute_loss(prediction: torch.Tensor,
                     ground_truth: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        input_style = ground_truth["style"]
        if input_style.ndim == 5:
            if input_style.shape[1] != 1:
                raise ValueError(f"loss model does not support multiple styles; got "
                                 f"{input_style.shape[1]}")
            input_style = input_style[:, 0]
        content = ground_truth["content"]

        if tower_mode == "batched":
            b = prediction.shape[0]
            stacked = extractor_apply(torch.cat([content, input_style, prediction]))
            data_content, data_style, data_prediction = (
                {kind: {layer: v[i * b:(i + 1) * b] for layer, v in taps.items()}
                 for kind, taps in stacked.items()} for i in range(3))
        else:
            apply = scan_apply if tower_mode == "scan" else extractor_apply
            data_content = apply(content)
            data_style = apply(input_style)
            data_prediction = apply(prediction)

        content_terms = [
            mean_l2_loss_on_batch(data_prediction["content"][layer].float()
                                  - data_content["content"][layer].float())
            for layer in data_content["content"]]
        feature_loss = torch.stack(content_terms).mean(dim=0) * factors.content
        style_terms = [
            mean_l2_loss_on_batch(gram_matrix(data_prediction["style"][layer])
                                  - gram_matrix(data_style["style"][layer]))
            for layer in data_style["style"]]
        style_loss = torch.stack(style_terms).mean(dim=0) * factors.style
        tv_loss = total_variation(prediction) * factors.total_variation

        total = feature_loss + style_loss + tv_loss
        out = {"feature_loss": feature_loss, "style_loss": style_loss,
               "total_variation_loss": tv_loss}
        if depth_loss_fn is not None:
            depth = depth_loss_fn(content, prediction) * factors.depth
            out["depth_loss"] = depth
            total = total + depth
        out["loss"] = total
        return out

    return compute_loss
