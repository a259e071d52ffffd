"""Driver of the served-frame traffic through ``FusedTransfer``.

A traffic file gives ``pool_frames`` (distinct seeded G-buffer frames, packed
on the device in set-up and cycled through), ``frames_per_call`` (1: one
``stylize_prepacked`` call a frame, 17 launches from Python; N > 1: one
``stylize_prepacked_chunk`` call of N frames, one CUDA graph replay),
``in_flight`` (calls dispatched ahead: above 1 each call waits on the event
of the call that many before it, as an engine's render-ahead queue does; 1
is a closed loop, ``torch.cuda.synchronize()`` after every call) and
``check_frames`` (frames of the window whose outputs are compared with the
reference: a uniform sample, drawn from the seed, of every frame the window
produced).

End-to-end: ``frames_per_s`` (frames over the window, closed by a
synchronize), ``peak_mem_gib`` and, in a closed loop of single frames,
``frame_p95_ms``: each frame from its submit until its output is ready,
timed by CUDA events on the stream.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import inputs
from ..outcome import Outcome
from ..reference import transfer as reference
from ..tracer import Tracer


@dataclasses.dataclass
class Frames:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    variables: dict
    style: torch.Tensor
    engine: object
    prepared: object
    pool: List[torch.Tensor]
    stacked: Optional[torch.Tensor] = None  # chunks: the pool and its first N - 1 again

    def call(self, k: int) -> torch.Tensor:
        """Call ``k`` of the window: (N, H, W, 3) f32 frames on the device."""
        n = self.traffic["frames_per_call"]
        if n == 1:
            return self.engine.stylize_prepacked(self.pool[k % len(self.pool)], self.prepared)
        start = k * n % len(self.pool)
        return self.engine.stylize_prepacked_chunk(self.stacked[start:start + n], self.prepared)


def setup(cfg: dict, traffic: dict, seed: int, device, *, quant: Optional[str] = None) -> Frames:
    """The engine on the seeded weights, the style prepared and the pool of
    frame packs on the device.  ``quant="int8"`` builds the program's int8
    engine instead, its scales calibrated on the pool by the bf16 engine."""
    from realtime_style_transfer_torch.config import ShapeConfig
    from realtime_style_transfer_torch.models.inference import plan_from_config
    from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer

    plan = plan_from_config(ShapeConfig.from_spec(cfg["spec"]))
    if (list(plan.input_shape) != cfg["input_shape"]
            or plan.num_style_parameters != cfg["num_style_parameters"]):
        raise ValueError(f"{cfg['name']}: the program's plan of {cfg['spec']} differs from "
                         "the configuration file")
    variables = inputs.transfer_variables(cfg, seed, device)
    style = inputs.style_vector(cfg, seed, device)
    engine = FusedTransfer(variables, plan, device=device)
    pool = [engine.pack_frame(inputs.content_frame(cfg, seed, i, device))
            for i in range(traffic["pool_frames"])]
    if quant is not None:
        scales = engine.calibrate_act_scales(pool, engine.prepare_style(style))
        engine = FusedTransfer(variables, plan, device=device, quant=quant, act_scales=scales)
    n = traffic["frames_per_call"]
    stacked = None
    if n > 1:  # one tensor, so that every chunk is a slice of it
        stacked = torch.stack(pool + pool[:n - 1])
        pool = list(stacked[:len(pool)].unbind(0))
    return Frames(cfg, traffic, seed, torch.device(device), variables, style, engine,
                  engine.prepare_style(style), pool, stacked)


def _launches() -> Dict[str, int]:
    from realtime_style_transfer_torch.ops import kernels

    return {"conv_stage": kernels.conv_stage.launches, "finish": kernels.finish.launches,
            "replay_graph": kernels.replay_graph.replays}


@dataclasses.dataclass
class Window:
    frames: int
    start: float                      # perf_counter as the first call was made
    seconds: float
    host_s: float                     # time inside the engine's calls, host clock
    latencies_ms: List[float]         # closed loop: each call by CUDA events
    samples: List[Tuple[int, int, torch.Tensor]]  # (frame, pool index, output)
    launches: Dict[str, int]


def window(st: Frames, *, seconds: Optional[float] = None, calls: Optional[int] = None,
           keep: int = 0) -> Window:
    """Call the engine until ``seconds`` have passed (or ``calls`` are
    made), end with a synchronize; keep ``keep`` output frames, a uniform
    sample drawn from the seed (reservoir sampling)."""
    per_call, depth = st.traffic["frames_per_call"], st.traffic["in_flight"]
    cuda = st.device.type == "cuda"
    events = [torch.cuda.Event() for _ in range(depth)] if cuda and depth > 1 else []
    timing = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
        if cuda and depth == 1 else None
    rng = random.Random(inputs.derived_seed(st.seed, "sample"))
    samples: List[Tuple[int, int, torch.Tensor]] = []
    latencies: List[float] = []
    n_pool = len(st.pool)
    before = _launches()
    host = 0.0
    k = n = 0
    start = time.perf_counter()
    deadline = math.inf if seconds is None else start + seconds
    while (k < calls) if calls is not None else (time.perf_counter() < deadline):
        if events and k >= depth:
            events[k % depth].synchronize()
        if timing:
            timing[0].record()
        t = time.perf_counter()
        out = st.call(k)
        host += time.perf_counter() - t
        if timing:
            timing[1].record()
            torch.cuda.synchronize()
            latencies.append(timing[0].elapsed_time(timing[1]))
        elif events:
            events[k % depth].record()
        for j in range(per_call):
            slot = (n if n < keep else rng.randrange(n + 1)) if keep else keep
            if slot < keep:
                # a chunk's frames are views of one output: keep a copy of the one
                entry = (n, n % n_pool, out[j:j + 1] if per_call == 1 else out[j:j + 1].clone())
                if slot == len(samples):
                    samples.append(entry)
                else:
                    samples[slot] = entry
            n += 1
        k += 1
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    after = _launches()
    return Window(n, start, elapsed, host, latencies, samples,
                  {key: after[key] - before[key] for key in after})


def compare(st: Frames, samples) -> List[Dict[str, float]]:
    """Each sampled output's root mean square difference from the
    reference's frame (a NaN stays a NaN).  The widest difference of one
    value is not compared: sound bf16 frames read 0.11-0.50 on it and the
    int8 control 0.50-0.91, no limit between the two."""
    gaps = []
    for _n, index, out in samples:
        content = inputs.content_frame(st.cfg, st.seed, index, st.device)
        ref = reference.stylize(st.cfg, st.variables, content, st.style)
        gaps.append({"rms_err": (out.float() - ref).square().mean().sqrt().item()})
    return gaps


def worst(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each gap over the samples; NaN where any is NaN."""
    return {name: max((g[name] for g in gaps), key=lambda v: math.inf if math.isnan(v) else v)
            for name in gaps[0]}


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, quant: Optional[str] = None) -> Outcome:
    """Set-up, a warm-up twice round the pool, the timed window and the
    comparison of its sampled frames.  ``trace`` adds a second window of the
    same length under the profiler: the device metrics come from it, the
    spans and counters from the untraced one, so the tracer's cost on the
    host (a tenth to a fifth of a host-paced frame) stays out of them.
    ``quant="int8"`` serves the control in the program's place (see
    :func:`setup`)."""
    st = setup(cfg, traffic, seed, device, quant=quant)
    window(st, calls=2 * len(st.pool) // traffic["frames_per_call"])
    # set-up's objects out of the collector's way: a full collection of the
    # interpreter's every object would otherwise land in the window at random
    gc.collect()
    gc.freeze()
    win = window(st, seconds=seconds, keep=traffic["check_frames"])
    summary = None
    readings = {"frames": win.frames, "window_s": win.seconds, "host_s": win.host_s,
                "launches": sum(win.launches.values())}
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
