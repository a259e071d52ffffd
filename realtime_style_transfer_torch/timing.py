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

