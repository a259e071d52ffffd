"""Fused frame loop (the video path without file IO), one or two styles.

Port of the ``--path fused`` loop of ``predict_video_using_checkpoint.py``:
the style params are predicted once and ``prepare_style`` runs once; then per
frame the host pack runs on the prefetcher's worker (pinned memory, side-stream
copy), ``stylize_prepacked`` runs the stage kernels, and the frame comes back
to the host for ``sink``.  One zero frame warms the path first, as the JAX
loop does, so the first timed frame does not pay set-up.  Two styles are
blended per pixel by a static (H, W, 1) weight map of the second style, all
zeros (the first style everywhere) unless one is given, as in the JAX CLI.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .data.pipeline import DevicePrefetcher
from .models.inference import StyleTransferInference
from .ops.fused_transfer import FusedTransfer


def stylize_video(model: StyleTransferInference, fused: FusedTransfer,
                  style_image: Union[np.ndarray, Sequence[np.ndarray]],
                  frames: Iterable[np.ndarray],
                  sink: Callable[[int, np.ndarray], None], *,
                  style_weights: Optional[np.ndarray] = None, depth: int = 3,
                  max_frames: Optional[int] = None) -> Dict[str, object]:
    """Stream (H, W, C) f32 ``frames`` through ``fused`` with the style of the
    (H, W, 3) ``style_image`` (a sequence of two for a dual engine, blended by
    the (H, W, 1) ``style_weights``); ``sink(i, frame)`` gets each (H, W, 3)
    f32 result.  Returns the (1, S, P) style params and each frame's host
    latency (seconds, stylize + device-to-host copy)."""
    dev = fused.device
    styles = np.asarray(style_image, np.float32)
    if styles.ndim == 3:
        styles = styles[None]
    n_styles = fused.num_styles
    if styles.shape[0] != n_styles:
        raise ValueError(f"a {n_styles}-style engine takes {n_styles} style images, "
                         f"got {styles.shape[0]}")
    if n_styles == 1 and style_weights is not None:
        raise ValueError("style_weights need two styles to blend")
    weights = None
    if n_styles == 2:
        h, w, _ = fused.plan.output_shape
        weights = (np.zeros((h, w, 1), np.float32) if style_weights is None
                   else np.asarray(style_weights, np.float32))[None]
    with torch.no_grad():
        style = torch.as_tensor(styles, device=dev)
        style_params = model.predict_style_params(style[None])  # (1, S, P)
    prepared = fused.prepare_style(style_params, weights)

    warm = fused.pack_frame_np(np.zeros((1,) + fused.plan.input_shape, np.float32))
    fused.stylize_prepacked(warm, prepared).cpu()

    def batched():
        for i, frame in enumerate(frames):
            if max_frames is not None and i >= max_frames:
                return
            yield np.asarray(frame, np.float32)[None]

    latencies = []
    prefetcher = DevicePrefetcher(batched(), depth, device=dev,
                                  prepare=fused.pack_frame_np)
    for i, packed in enumerate(prefetcher):
        start = time.perf_counter()
        frame = fused.stylize_prepacked(packed, prepared)[0].cpu().numpy()
        latencies.append(time.perf_counter() - start)
        sink(i, frame)
    return {"style_params": style_params, "latency_s": latencies}
