"""The frame loop of the video path without file IO, fused or packed, one or
two styles.

Port of the loop of ``predict_video_using_checkpoint.py``: the style params
are predicted once; then per frame the host preparation runs on the
prefetcher's worker (pinned memory, side-stream copy), the engine stylizes,
and the frame comes back to the host for ``sink``.  One zero frame warms the
path first, as the JAX loop does, so the first timed frame does not pay
set-up.  Two styles are blended per pixel by a static (H, W, 1) weight map of
the second style, all zeros (the first style everywhere) unless one is given,
as in the JAX CLI.

Two engines: ``--path fused`` is :class:`..ops.fused_transfer.FusedTransfer`
(``prepare_style`` once, the host frame pack per frame, the stage kernels);
``--path packed`` is :class:`..models.transfer_packed.PackedTransfer` (the
frame as it is, the packed path with its ``conv_backend``).
:func:`choose_path` is the CLI's ``--path auto`` rule.

``quant="int8"`` is the CLI's ``--quant int8`` deploy flow
(``predict_video_using_checkpoint.py:159-258``) without file IO, fused path
only: the first ``calibration_frames`` frames calibrate the int8 scales on the
given bf16 engine, or, given ``act_scales`` (say from :func:`..ops.
fused_transfer.load_act_scales`), saturation-check them; then an int8 engine
is built and every frame, the calibration frames first, streams through it.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .config import ShapeConfig
from .data.pipeline import DevicePrefetcher
from .models.inference import StyleTransferInference
from .models.transfer import TransferPlan
from .models.transfer_packed import CONV_BACKENDS, PackedTransfer
from .ops.fused_transfer import FusedTransfer


def choose_path(config: ShapeConfig, plan: TransferPlan, device) -> str:
    """The CLI's ``--path auto`` rule (``predict_video_using_checkpoint.py``):
    ``"fused"`` for the 2-contract / 2-expand and 3-contract / 3-expand
    families whose packed width (W / 4, or W / 8 on the 3-contract plan) is a
    multiple of 8, with at most 128 bottleneck filters and at most one style
    on the 3-contract plan (two otherwise), on a CUDA device; else
    ``"packed"``."""
    fused_ok = (
        (plan.num_contract_blocks, plan.num_expand_blocks) in ((2, 2), (3, 3))
        and (plan.input_shape[1] // (4 * plan.num_contract_blocks - 4)) % 8 == 0
        and plan.bottleneck_num_filters <= 128
        and config.num_styles <= (1 if plan.num_contract_blocks == 3 else 2)
        and torch.device(device).type == "cuda"
    )
    return "fused" if fused_ok else "packed"


def stylize_video(model: StyleTransferInference,
                  engine: Union[FusedTransfer, PackedTransfer],
                  style_image: Union[np.ndarray, Sequence[np.ndarray]],
                  frames: Iterable[np.ndarray],
                  sink: Callable[[int, np.ndarray], None], *,
                  style_weights: Optional[np.ndarray] = None, depth: int = 3,
                  max_frames: Optional[int] = None, variables=None,
                  quant: Optional[str] = None, act_scales=None,
                  calibration_frames: int = 4, conv_backend: str = "auto") -> Dict[str, object]:
    """Stream (H, W, C) f32 ``frames`` through ``engine`` with the style of
    the (H, W, 3) ``style_image`` (a sequence of two for a dual engine,
    blended by the (H, W, 1) ``style_weights``); ``sink(i, frame)`` gets each
    (H, W, 3) f32 result.  Returns the (1, S, P) style params and each frame's
    host latency (seconds, stylize + device-to-host copy).

    ``engine`` is a :class:`FusedTransfer` (the fused path) or a
    :class:`PackedTransfer` (the packed path, whose convs ``conv_backend``
    selects: 'auto', 'xla' or 'pallas').  ``quant="int8"`` needs the fused
    path, the transfer ``variables`` and a bf16 engine; the result also holds
    the ``act_scales`` deployed, ``saturation`` (the report of
    ``check_act_saturation`` on given scales, else None) and the int8
    ``engine``."""
    packed_path = isinstance(engine, PackedTransfer)
    dev = engine.device
    styles = np.asarray(style_image, np.float32)
    if styles.ndim == 3:
        styles = styles[None]
    n_styles = engine.num_styles
    if styles.shape[0] != n_styles:
        raise ValueError(f"a {n_styles}-style engine takes {n_styles} style images, "
                         f"got {styles.shape[0]}")
    if n_styles == 1 and style_weights is not None:
        raise ValueError("style_weights need two styles to blend")
    if quant not in (None, "int8"):
        raise ValueError(f"quant must be None or 'int8', got {quant!r}")
    if quant and packed_path:
        raise ValueError("quant='int8' requires the fused path (got 'packed'); pass a "
                         "FusedTransfer on a fused-family config")
    if quant and (variables is None or engine.quant):
        raise ValueError("quant='int8' needs the transfer variables and a bf16 engine "
                         "to calibrate or check on")
    if conv_backend not in CONV_BACKENDS or (conv_backend != "auto" and not packed_path):
        raise ValueError(f"conv_backend selects the packed path's convs ({CONV_BACKENDS}); "
                         f"the fused path takes 'auto', got {conv_backend!r}")
    weights = None
    if n_styles == 2:
        h, w, _ = engine.plan.output_shape
        weights = (np.zeros((h, w, 1), np.float32) if style_weights is None
                   else np.asarray(style_weights, np.float32))[None]
    with torch.no_grad():
        style = torch.as_tensor(styles, device=dev)
        style_params = model.predict_style_params(style[None])  # (1, S, P)
    frames = iter(frames) if max_frames is None else itertools.islice(frames, max_frames)
    result: Dict[str, object] = {}

    if packed_path:
        weights_t = None if weights is None else torch.as_tensor(weights, device=dev)
        pin = dev.type == "cuda"

        def prepare(frame: np.ndarray) -> torch.Tensor:
            host = torch.from_numpy(np.ascontiguousarray(frame))
            return host.pin_memory() if pin else host

        def stylize(content: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return engine(content, style_params, weights_t, conv_backend=conv_backend)
    else:
        fused = engine
        prepared = fused.prepare_style(style_params, weights)
        if quant:
            calibration = [np.asarray(f, np.float32) for f in
                           itertools.islice(frames, calibration_frames)]
            if not calibration:
                raise ValueError("no frames to calibrate quant='int8' on")
            frames = itertools.chain(calibration, frames)  # no frame is lost
            packs = [fused.pack_frame_np(f[None]) for f in calibration]
            report = None
            if act_scales is None:
                act_scales = fused.calibrate_act_scales(packs, prepared)
            else:
                report = fused.check_act_saturation(packs, prepared, act_scales)
            fused = FusedTransfer(variables, fused.plan, num_styles=n_styles,
                                  cin_epsilon=fused.eps, device=dev, quant="int8",
                                  act_scales=act_scales)
            prepared = fused.prepare_style(style_params, weights)
            result.update(act_scales=np.asarray(act_scales, np.float32), saturation=report,
                          engine=fused)
        prepare = fused.pack_frame_np

        def stylize(packed: torch.Tensor) -> torch.Tensor:
            return fused.stylize_prepacked(packed, prepared)

    warm = prepare(np.zeros((1,) + engine.plan.input_shape, np.float32))
    stylize(warm.to(dev)).cpu()

    def batched():
        for frame in frames:
            yield np.asarray(frame, np.float32)[None]

    latencies = []
    prefetcher = DevicePrefetcher(batched(), depth, device=dev, prepare=prepare)
    for i, item in enumerate(prefetcher):
        start = time.perf_counter()
        frame = stylize(item)[0].cpu().numpy()
        latencies.append(time.perf_counter() - start)
        sink(i, frame)
    return dict(result, style_params=style_params, latency_s=latencies)
