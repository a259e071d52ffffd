"""Device time of a call on one CUDA card, for the measurement scripts."""

from __future__ import annotations

import torch


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of ``reps`` calls,
    replayed 5 times, over 5 * reps (the host's launch cost left out)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def device_share(fn, n: int = 5):
    """torch.profiler over n calls of ``fn``: (CUDA activities, their summed
    device time, the host wall time with the profiler on) a call in ms, and
    the idle share, or the reason it measured nothing."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except (RuntimeError, AttributeError) as exc:  # a measurement, not a check
        return f"not measured: {str(exc)[:120]}"
    if not acts:
        return "not measured: the profiler recorded no device activity"
    busy = sum(e.time_range.elapsed_us() for e in acts) / 1e3
    return dict(activities=len(acts) / n, busy_ms=busy / n, wall_ms=wall / n,
                idle_share=1.0 - busy / wall)
