"""Driver of the served-frame traffic with two styles blended per pixel.

The engine is ``FusedTransfer(num_styles=2)``; set-up draws the second style
vector and the blend map from the seed (the configuration's ``assumed``) and
prepares both styles with the map through ``prepare_style``; the window is
:func:`.frames.window`'s, the traffic file's keys are :mod:`.frames`' and so
is every end-to-end metric.  The sampled frames are compared with
:func:`..reference.transfer_dual.stylize_dual`.

Besides :mod:`.frames`' readings it hands ``blend_launches_per_frame``: the
chunk graph's recorded ``blends`` over its frames, or None where the program
counts no blends.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import inputs
from ..outcome import Outcome
from ..reference.transfer_dual import stylize_dual
from ..tracer import Tracer
from .frames import Frames, window, worst

SECOND_STYLE, BLEND_MAP = 1, 2  # indices under the style tag of the two draws


@dataclasses.dataclass
class DualFrames(Frames):
    """:class:`.frames.Frames` whose ``style`` is (2, P), with the map."""

    weights: Optional[torch.Tensor] = None  # (1, H, W, 1) f32 second-style weight


def second_style(cfg: dict, seed: int, device) -> torch.Tensor:
    """(P,) float32, drawn as :func:`..inputs.style_vector` draws the first."""
    is_scale = torch.cat([torch.tensor([1.0] * c + [0.0] * c)
                          for c in inputs.cin_channels(cfg)])
    g = inputs.generator(seed, "style", device, SECOND_STYLE)
    return torch.rand(is_scale.numel(), generator=g, device=device) - 0.5 + is_scale.to(device)


def styles(cfg: dict, seed: int, device) -> torch.Tensor:
    """(2, P) float32: the run's two style vectors."""
    return torch.stack([inputs.style_vector(cfg, seed, device),
                        second_style(cfg, seed, device)])


def blend_map(cfg: dict, seed: int, device) -> torch.Tensor:
    """(1, H, W, 1) float32 weight of the second style: a bilinear upsample
    of a 1/16 resolution U(0, 1) field, steepened around 0.5 and clipped to
    [0, 1], so that broad regions take one style alone."""
    h, w, _ = cfg["output_shape"]
    g = inputs.generator(seed, "style", device, BLEND_MAP)
    low = torch.rand((1, 1, -(-h // 16), -(-w // 16)), generator=g, device=device)
    field = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return (4.0 * (field - 0.5) + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def setup(cfg: dict, traffic: dict, seed: int, device, *,
          quant: Optional[str] = None) -> DualFrames:
    """:func:`.frames.setup` for two styles: the dual engine on the seeded
    weights, both styles prepared with the map, the pool on the device.
    ``quant="int8"`` builds the program's dual int8 engine instead, its
    scales calibrated on the pool by the dual bf16 engine."""
    from realtime_style_transfer_torch.config import ShapeConfig
    from realtime_style_transfer_torch.models.inference import plan_from_config
    from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer

    n_styles = cfg["num_styles"]
    plan = plan_from_config(ShapeConfig.from_spec(cfg["spec"], num_styles=n_styles))
    if (list(plan.input_shape) != cfg["input_shape"]
            or plan.num_style_parameters != cfg["num_style_parameters"]):
        raise ValueError(f"{cfg['name']}: the program's plan of {cfg['spec']} differs from "
                         "the configuration file")
    variables = inputs.transfer_variables(cfg, seed, device)
    style = styles(cfg, seed, device)
    weights = blend_map(cfg, seed, device)
    engine = FusedTransfer(variables, plan, num_styles=n_styles, device=device)
    pool = [engine.pack_frame(inputs.content_frame(cfg, seed, i, device))
            for i in range(traffic["pool_frames"])]
    if quant is not None:
        scales = engine.calibrate_act_scales(pool, engine.prepare_style(style, weights))
        engine = FusedTransfer(variables, plan, num_styles=n_styles, device=device,
                               quant=quant, act_scales=scales)
    n = traffic["frames_per_call"]
    stacked = None
    if n > 1:  # one tensor, so that every chunk is a slice of it
        stacked = torch.stack(pool + pool[:n - 1])
        pool = list(stacked[:len(pool)].unbind(0))
    return DualFrames(cfg, traffic, seed, torch.device(device), variables, style, engine,
                      engine.prepare_style(style, weights), pool, stacked, weights)


def blend_launches_per_frame(st: DualFrames) -> Optional[float]:
    """The chunk graph's recorded blends over its frames; None without a
    chunk graph or where its ``captured`` counts no blends."""
    graphs = getattr(st.engine, "chunk_graphs", {})
    n = st.traffic["frames_per_call"]
    if n not in graphs or "blends" not in graphs[n].captured:
        return None
    return graphs[n].captured["blends"] / n


def compare(st: DualFrames, samples) -> List[Dict[str, float]]:
    """Each sampled output's root mean square difference from the dual
    reference's frame (a NaN stays a NaN), as :func:`.frames.compare`."""
    gaps = []
    for _n, index, out in samples:
        content = inputs.content_frame(st.cfg, st.seed, index, st.device)
        ref = stylize_dual(st.cfg, st.variables, content, st.style, st.weights)
        gaps.append({"rms_err": (out.float() - ref).square().mean().sqrt().item()})
    return gaps


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, quant: Optional[str] = None) -> Outcome:
    """:func:`.frames.run` with two styles: set-up, a warm-up twice round the
    pool, the timed window, the traced one, the comparison of the sampled
    frames with the dual reference."""
    st = setup(cfg, traffic, seed, device, quant=quant)
    window(st, calls=2 * len(st.pool) // traffic["frames_per_call"])
    gc.collect()
    gc.freeze()
    win = window(st, seconds=seconds, keep=traffic["check_frames"])
    summary = None
    readings = {"frames": win.frames, "window_s": win.seconds, "host_s": win.host_s,
                "launches": sum(win.launches.values()),
                "blend_launches_per_frame": blend_launches_per_frame(st)}
    if trace:
        tracer = Tracer()
        with tracer:
            traced = window(st, seconds=seconds)
        summary = tracer.summary(traced.seconds)
        readings.update(traced_frames=traced.frames, traced_window_s=traced.seconds)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(st.device) if st.device.type == "cuda" else 0
    st.engine = st.prepared = st.stacked = None
    st.pool = []
    gaps = compare(st, win.samples)
    lim = cfg["limits"]["frames"]
    checks = {name: (value, lim.get(name)) for name, value in worst(gaps).items()}
    failed = sum(1 for g in gaps
                 if any(lim.get(k) is None or not v <= lim[k] for k, v in g.items()))
    e2e = {"frames_per_s": win.frames / win.seconds, "peak_mem_gib": peak / 2 ** 30}
    if win.latencies_ms:
        e2e["frame_p95_ms"] = float(np.percentile(win.latencies_ms, 95))
    return Outcome(cfg, attempted=win.frames, failed=failed, window_start=win.start,
                   memory_peak_bytes=peak, end_to_end=e2e, readings=readings, checks=checks,
                   trace=summary)
