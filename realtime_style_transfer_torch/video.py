"""Single-style fused frame loop (the video path without file IO).

Port of the ``--path fused`` loop of ``predict_video_using_checkpoint.py``:
the style params are predicted once and ``prepare_style`` runs once; then per
frame the host pack runs on the prefetcher's worker (pinned memory, side-stream
copy), ``stylize_prepacked`` runs the stage kernels, and the frame comes back
to the host for ``sink``.  One zero frame warms the path first, as the JAX
loop does, so the first timed frame does not pay set-up.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .data.pipeline import DevicePrefetcher
from .models.inference import StyleTransferInference
from .ops.fused_transfer import FusedTransfer


def stylize_video(model: StyleTransferInference, fused: FusedTransfer,
                  style_image: np.ndarray, frames: Iterable[np.ndarray],
                  sink: Callable[[int, np.ndarray], None], *, depth: int = 3,
                  max_frames: Optional[int] = None) -> Dict[str, object]:
    """Stream (H, W, C) f32 ``frames`` through ``fused`` with the style of the
    (H, W, 3) ``style_image``; ``sink(i, frame)`` gets each (H, W, 3) f32
    result.  Returns the style params and each frame's host latency (seconds,
    stylize + device-to-host copy)."""
    dev = fused.device
    with torch.no_grad():
        style = torch.as_tensor(np.asarray(style_image, np.float32), device=dev)
        style_params = model.predict_style_params(style[None, None])  # (1, 1, P)
    prepared = fused.prepare_style(style_params)

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
