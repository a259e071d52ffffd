"""Shape / architecture configuration (the port's own copy).

Mirrors ``realtime_style_transfer_tpu/config.py``: one frozen dataclass is the
single source of truth for every tensor shape.  The port keeps its own copy so
that it never imports the JAX package.

* channel-list derivation from a channel count (``channels_from_count``)
* ``rst-<res_x>-<bottleneck_y>-<filters>-<channels>`` spec strings
* base resolution 1920x960 divided by ``resolution_divider``
* ``style_weights`` input of ``num_styles - 1`` channels when multi-style
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

DEFAULT_FEATURE_EXTRACTOR = "mobilenet"
BASE_RESOLUTION = (960, 1920)  # (height, width) of the full-resolution frame


def channels_from_count(num_channels: int) -> Tuple[Tuple[str, int], ...]:
    """Derive the named G-buffer channel list from a bare channel count.

    3 -> FinalImage only; >3 adds BaseColor; >=18 adds ShadowMask; >=17 adds
    the remaining G-buffer planes.
    """
    channels = [("FinalImage", 3)]
    if num_channels > 3:
        channels += [("BaseColor", 3)]
    if num_channels >= 18:
        channels += [("ShadowMask", 1)]
    if num_channels >= 17:
        channels += [
            ("AmbientOcclusion", 1),
            ("Metallic", 1),
            ("Specular", 1),
            ("Roughness", 1),
            ("ViewNormal", 3),
            ("SceneDepth", 1),
            ("LightingModel", 3),
        ]
    return tuple(channels)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """All tensor shapes derived from a handful of knobs."""

    num_styles: int = 1
    hdr: bool = True
    bottleneck_res_y: int = 120
    bottleneck_num_filters: int = 128
    resolution_divider: int = 2
    num_channels: int = 18
    feature_extractor: str = DEFAULT_FEATURE_EXTRACTOR
    with_depth_loss: bool = False

    @property
    def channels(self) -> Tuple[Tuple[str, int], ...]:
        return channels_from_count(self.num_channels)

    @property
    def total_channels(self) -> int:
        return sum(c for _, c in self.channels)

    @property
    def input_dimensions(self) -> Tuple[int, int]:
        return (
            BASE_RESOLUTION[0] // self.resolution_divider,
            BASE_RESOLUTION[1] // self.resolution_divider,
        )

    @property
    def output_dimensions(self) -> Tuple[int, int]:
        return self.input_dimensions

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return self.output_dimensions + (3,)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.input_dimensions + (3,)

    @property
    def content_shape(self) -> Tuple[int, int, int]:
        """Per-sample content input shape (H, W, C)."""
        if self.hdr:
            return self.input_dimensions + (self.total_channels,)
        return self.image_shape

    @property
    def style_shape(self) -> Tuple[int, int, int, int]:
        """Per-sample style input shape (num_styles, H, W, 3)."""
        return (self.num_styles,) + self.output_shape

    @property
    def style_weights_shape(self) -> Optional[Tuple[int, int, int]]:
        """Per-sample style-weight-map shape, or None when single-style."""
        if self.num_styles > 1:
            return self.output_dimensions + (self.num_styles - 1,)
        return None

    @property
    def input_shape(self) -> Dict[str, Tuple[int, ...]]:
        shapes: Dict[str, Tuple[int, ...]] = {
            "content": self.content_shape,
            "style": self.style_shape,
        }
        if self.num_styles > 1:
            shapes["style_weights"] = self.style_weights_shape
        return shapes

    @staticmethod
    def from_spec(spec: str, num_styles: int = 1, hdr: bool = True, **kwargs) -> "ShapeConfig":
        """Parse ``rst-<res_x>-<bottleneck_y>-<filters>-<channels>``,
        e.g. ``rst-960-120-128-17``."""
        parts = spec.split("-")
        if len(parts) != 5 or parts[0] != "rst":
            raise ValueError(f"bad spec {spec!r}: want rst-<resx>-<by>-<bf>-<ch>")
        res_x = int(parts[1])
        return ShapeConfig(
            num_styles=num_styles,
            hdr=hdr,
            bottleneck_res_y=int(parts[2]),
            bottleneck_num_filters=int(parts[3]),
            resolution_divider=BASE_RESOLUTION[1] // res_x,
            num_channels=int(parts[4]),
            **kwargs,
        )

    def to_spec(self) -> str:
        return (
            f"rst-{BASE_RESOLUTION[1] // self.resolution_divider}-"
            f"{self.bottleneck_res_y}-{self.bottleneck_num_filters}-{self.num_channels}"
        )
