"""Unreal HDR G-buffer screenshot sets: discovery, decode, preprocessing.

The port's copy of ``realtime_style_transfer_tpu/data/hdr_screenshots.py``,
after the original project's ``dataloaders/hdrScreenshots.py``: a "screenshot"
is a base ``X.png`` plus one ``X_<Channel>.exr`` sibling per configured
G-buffer channel (``hdrScreenshots.py:14-29``).  Decoding goes through the
native threaded batch loader (all EXRs of a set in parallel) instead of
per-file pyroexr; unreadable sets are log-and-skipped
(``hdrScreenshots.py:57-59``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .imaging import load_image, preprocess_numpy_image
from .native import exr_info, read_gbuffer_planes

log = logging.getLogger(__name__)


def find_screenshots(directory) -> List[Path]:
    """All base screenshot PNGs in a dump directory (sorted).

    (Reference ``hdrScreenshots.py:33``: ``content_image_dir.glob('*.png')``.)
    """
    return sorted(Path(directory).glob("*.png"))


def gbuffer_paths(
    base_png: Path, channels: Sequence[Tuple[str, int]]
) -> List[Path]:
    """EXR sibling paths for a base PNG, one per configured channel group."""
    base_png = Path(base_png)
    return [
        base_png.parent / f"{base_png.stem}_{name}.exr"
        for name, _count in channels
    ]


def load_unreal_hdr_screenshot(
    base_png: Path,
    channels: Sequence[Tuple[str, int]],
    num_threads: int = 4,
) -> np.ndarray:
    """Stack a screenshot's G-buffer EXRs into one (h, w, total) float32 array.

    Channel order and R/G,B plane selection match the reference
    (``hdrScreenshots.py:14-29``); decode runs in the native thread pool.
    Raises ``ExrError``/``FileNotFoundError`` when the set is incomplete.
    """
    paths = gbuffer_paths(base_png, channels)
    for p in paths:
        if not p.exists():
            raise FileNotFoundError(f"missing G-buffer channel file {p}")
    counts = [count for _name, count in channels]
    width, height, _names = exr_info(paths[0])
    planes = read_gbuffer_planes(
        paths, counts, height, width, num_threads=num_threads
    )
    return np.ascontiguousarray(np.moveaxis(planes, 0, -1))


def load_preprocessed_gbuffer(
    png: Path,
    channels: Sequence[Tuple[str, int]],
    content_shape: Sequence[int],
    num_threads: int = 4,
) -> np.ndarray:
    """One screenshot set, stacked + cover-resized/cropped + channel-checked
    (shared by the streaming iterator and the wikiart content datasets)."""
    stacked = load_unreal_hdr_screenshot(png, channels, num_threads=num_threads)
    content = preprocess_numpy_image(stacked, content_shape)
    if content.shape[-1] != content_shape[-1]:
        raise ValueError(
            f"{png}: stacked {content.shape[-1]} channels, config "
            f"wants {content_shape[-1]}"
        )
    return content


def iter_hdr_screenshots(
    screenshot_pngs: Sequence[Path],
    channels: Sequence[Tuple[str, int]],
    content_shape: Sequence[int],
    output_shape: Optional[Sequence[int]] = None,
    num_threads: int = 4,
) -> Iterator[Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]]:
    """Yield preprocessed G-buffer tensors (plus PNG ground truth if asked).

    Parity with ``get_unreal_hdr_screenshot_dataset_from_filepaths``
    (``hdrScreenshots.py:37-72``): each set is stacked, cover-resized and
    center-cropped to ``content_shape``; with an ``output_shape`` the base
    PNG is loaded as the (content, ground_truth) pair's second element.
    Corrupt or incomplete sets are logged and skipped.
    """
    for png in screenshot_pngs:
        try:
            content = load_preprocessed_gbuffer(
                png, channels, content_shape, num_threads=num_threads
            )
            if output_shape is not None:
                ground_truth = load_image(png, output_shape)
                yield content, ground_truth
            else:
                yield content
        except Exception as e:  # noqa: BLE001 — log-and-skip parity
            log.warning("skipping %s: %s", png, e)
