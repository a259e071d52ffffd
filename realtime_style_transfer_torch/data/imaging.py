"""Image primitives: cover-resize, center crop/pad, load, uint8 round trip.

The port's copy of ``realtime_style_transfer_tpu/data/imaging.py``, which
follows the original TensorFlow project's resize/crop pipeline
(``dataloaders/common.py:23-96``):
images are aspect-preserving "cover"-resized to at least the target size, then
center-cropped (or zero-padded) to it, and scaled to float32 in [0, 1].
Everything here is numpy/PIL only — the data plane never dispatches
accelerator work.
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

IMAGE_SUFFIXES = frozenset(
    {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".webp"}
)


def cover_resize_shape(
    in_hw: Sequence[int], target_hw: Sequence[int]
) -> Tuple[int, int]:
    """Smallest aspect-preserving (h, w) that covers ``target_hw``.

    One dimension lands exactly on the target; the other is ceil-rounded up
    (reference ``common.py:46-52`` — its ``should_scale_to_target_y`` branch).
    """
    h, w = int(in_hw[0]), int(in_hw[1])
    th, tw = int(target_hw[0]), int(target_hw[1])
    if h * tw > th * w:  # image is taller than the target: match width
        return math.ceil(tw * h / w), tw
    return th, math.ceil(th * w / h)


def resize_bilinear(image: np.ndarray, target_hw: Sequence[int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) array with half-pixel centers.

    numpy twin of the ``tf.image.resize`` call in ``common.py:53``; identity
    when the size already matches and exact for constant images.
    """
    h, w = image.shape[:2]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if (h, w) == (th, tw):
        return np.asarray(image, np.float32)
    img = np.asarray(image, np.float32)
    # half-pixel-center source coordinates, clamped to the valid range
    ys = (np.arange(th, dtype=np.float64) + 0.5) * (h / th) - 0.5
    xs = (np.arange(tw, dtype=np.float64) + 0.5) * (w / tw) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def center_crop_or_pad(image: np.ndarray, target_hw: Sequence[int]) -> np.ndarray:
    """Center crop to, or zero-pad up to, ``target_hw``.

    numpy twin of ``tf.image.resize_with_crop_or_pad`` (``common.py:56``).
    """
    h, w = image.shape[:2]
    th, tw = int(target_hw[0]), int(target_hw[1])
    out = image
    if h > th:
        off = (h - th) // 2
        out = out[off:off + th]
    if w > tw:
        off = (w - tw) // 2
        out = out[:, off:off + tw]
    h, w = out.shape[:2]
    if h < th or w < tw:
        pad_top = (th - h) // 2 if h < th else 0
        pad_left = (tw - w) // 2 if w < tw else 0
        padded = np.zeros((th, tw) + out.shape[2:], out.dtype)
        padded[pad_top:pad_top + h, pad_left:pad_left + w] = out
        out = padded
    return out


def preprocess_numpy_image(
    image: np.ndarray, shape: Sequence[int]
) -> np.ndarray:
    """Cover-resize + center crop an (H, W, C) array to ``shape`` (h, w, c).

    Parity with ``common.py:44-57`` (``preprocess_numpy_image``); channel
    count is passed through untouched.
    """
    rh, rw = cover_resize_shape(image.shape[:2], shape[:2])
    resized = resize_bilinear(image, (rh, rw))
    return center_crop_or_pad(resized, shape[:2]).astype(np.float32)


def load_image(path, shape: Sequence[int]) -> np.ndarray:
    """Load an image file as float32 (h, w, c) in [0, 1] at ``shape``.

    PIL decode + LANCZOS cover-resize + center crop, matching the reference's
    ``_load_image_from_file`` / ``_image_to_tensor`` (``common.py:60-96``:
    lanczos interpolation, /255 scaling, mode from the channel count).
    """
    import PIL.Image

    if len(shape) != 3:
        raise ValueError(f"load_image wants an (h, w, c) shape, got {shape}")
    mode = {1: "L", 3: "RGB"}.get(int(shape[2]), "RGBA")
    with PIL.Image.open(path) as img:
        img = img.convert(mode)
        rh, rw = cover_resize_shape((img.height, img.width), shape[:2])
        img = img.resize((rw, rh), PIL.Image.LANCZOS)
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = center_crop_or_pad(arr, shape[:2])
    if arr.shape[2] != shape[2]:
        raise ValueError(
            f"{path}: decoded {arr.shape[2]} channels, config wants {shape[2]}"
        )
    return np.ascontiguousarray(arr, np.float32)


def list_image_paths(image_dir) -> List[Path]:
    """All image files under ``image_dir`` (recursive walk, sorted).

    Parity with ``common.py:69-88`` (``_load_image_paths_from_directory``);
    sorted so frame sequences and dataset orders are deterministic.
    """
    image_dir = Path(image_dir)
    found: List[Path] = []
    for root, _dirs, filenames in os.walk(image_dir):
        for filename in filenames:
            p = Path(root) / filename
            if p.suffix.lower() in IMAGE_SUFFIXES:
                found.append(p)
    return sorted(found)


def image_to_uint8(image01: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8, clipping out-of-range and non-finite."""
    arr = np.nan_to_num(np.asarray(image01, np.float32), nan=0.0)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def tensor_to_image(tensor01: np.ndarray):
    """[0, 1] float (h, w, c) array -> PIL image (reference ``renderers/image.py:5-11``)."""
    import PIL.Image

    arr = image_to_uint8(tensor01)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    return PIL.Image.fromarray(arr)
