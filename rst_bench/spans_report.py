"""Per-stage device time and the split of the card's idle time in one cell,
from the program's spans over a traced window.

    python3 rst_bench/spans_report.py --workload NAME --seed N --seconds S [--cost_seconds C]

The cell is set up as ``run.py`` sets it up (``drivers.frames``' set-up
and warm-up, the same seed), then one window of ``S`` seconds runs under the
profiler with the spans recorded (``realtime_style_transfer_torch.tracing.
spans``).  Standard error gets the per-stage table (launches a frame, device
ms a launch against the frozen bound of ``yardstick.stages``, host ms a frame
in the stage's span outside its launch, idle ms a frame opened inside the
stage's span), the idle gaps split by span, the host ms of each span, the
kernels a frame that belong to no stage, and how the launch spans line up
with the runtime calls.  Standard output gets one JSON line of the same, with
``frame_py_ms`` (ms a frame of the ``frame`` span outside its ``launch``
spans) and ``frame_idle_share`` (% of the window idle while a ``frame`` span
was open) beside the trace's ``idle_share``.

``--cost_seconds C`` first runs four rounds of four untraced windows of
``C`` seconds, with the recorder off, on, on, off, and reports each window's
frames/s: what recording the spans costs the frame loop, against a host
whose speed swings by a tenth from one window to the next.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)  # the checkout's root

from rst_bench import run  # noqa: E402
from rst_bench.attribution import SpanTrace  # noqa: E402
from rst_bench.tracer import Tracer  # noqa: E402


def setup(workload: str, seed: int, device):
    """The cell's configuration and its ``frames.setup`` state, warmed up
    as ``frames.run`` warms it."""
    from rst_bench.drivers import frames
    from rst_bench.yardstick import load_config

    bench = run.manifest()
    cell = {c["name"]: c for c in bench["workloads"]}[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_config(config["file"])
    traffic = json.loads((run.ROOT / "rst_bench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    st = frames.setup(cfg, traffic, seed, device)
    frames.window(st, calls=2 * len(st.pool) // traffic["frames_per_call"])
    return cfg, st


def traced(st, seconds: float) -> SpanTrace:
    """One window of ``frames.window``'s calls under the profiler, with the spans
    recorded."""
    from rst_bench.drivers import frames
    from realtime_style_transfer_torch.tracing import spans

    tracer = Tracer()
    with spans.recording() as record:
        with tracer:
            win = frames.window(st, seconds=seconds)
    n = st.traffic["frames_per_call"]
    order = st.engine.chunk_graphs[n].stages if n > 1 else ()
    return SpanTrace.from_tracer(tracer, win.seconds, record, order)


def cost(st, seconds: float):
    """Frames/s of untraced windows in turns: the recorder off, on, on, off,
    four times."""
    from rst_bench.drivers import frames
    from realtime_style_transfer_torch.tracing import spans

    out = []
    for on in (False, True, True, False) * 4:
        if on:
            with spans.recording():
                win = frames.window(st, seconds=seconds)
        else:
            win = frames.window(st, seconds=seconds)
        out.append(["on" if on else "off", win.frames / win.seconds])
    return out


def report(cfg: dict, trace: SpanTrace) -> dict:
    idle = 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s else None
    table = trace.stage_table(cfg)
    conv = sum(trace.kernel(k)[0] for k in ("conv_window_kernel", "conv_halo_kernel"))
    staged = sum(a.event[1] - a.event[0] for a in trace.assigned if a.stage != "finish") / 1e9
    return {"frames": trace.frames(), "window_s": trace.window_s, "idle_share": idle,
            "frame_py_ms": trace.frame_py_ms(), "frame_idle_share": trace.frame_idle_share(),
            "stages": table, "conv_kernel_s": conv, "staged_conv_s": staged,
            "idle_gaps": trace.idle_gaps(top=64), "other_kernels": trace.other_kernels(),
            "span_ms": trace.span_ms(), "launch_alignment": trace.launch_alignment()}


def print_report(r: dict, out=sys.stderr) -> None:
    print(f"{'stage':<8} {'launches/frame':>14} {'device ms':>10} {'bound ms':>9} "
          f"{'share %':>8} {'host ms/frame':>13} {'idle ms/frame':>13}", file=out)
    for row in r["stages"]:
        cells = [f"{row['launches_per_frame']:14.3f}"]
        for key, width, fmt in (("device_ms", 10, ".4f"), ("bound_ms", 9, ".4f"),
                                ("share", 8, ".2f"), ("host_ms", 13, ".4f"),
                                ("idle_ms_per_frame", 13, ".4f")):
            cells.append(f"{row[key]:{width}{fmt}}" if row[key] is not None else f"{'-':>{width}}")
        print(f"{row['stage']:<8} " + " ".join(cells), file=out)
    print(f"conv kernels {r['conv_kernel_s']:.6f} s in the trace, {r['staged_conv_s']:.6f} s put "
          "to stages", file=out)
    for name, seconds in r["idle_gaps"]:
        print(f"idle {seconds:.6f} s {name}", file=out)
    for name, n, ms in r["other_kernels"]:
        print(f"other kernel {n:.3f} a frame, {ms:.6f} ms a frame: {name[:100]}", file=out)
    for name, ms in r["span_ms"].items():
        print(f"span {name}: {ms:.4f} ms of host time outside launches, mean", file=out)
    print(f"launch spans: {r['launch_alignment']}", file=out)
    print(f"frame_py_ms {r['frame_py_ms']}, frame_idle_share {r['frame_idle_share']}, "
          f"idle_share {r['idle_share']}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost_seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("spans_report: needs a CUDA device", file=sys.stderr)
        return 2
    cfg, st = setup(args.workload, args.seed, torch.device("cuda"))
    gc.collect()
    gc.freeze()
    turns = cost(st, args.cost_seconds) if args.cost_seconds else []
    r = report(cfg, traced(st, args.seconds))
    gc.unfreeze()
    r.update(workload=args.workload, seed=args.seed, cost_frames_per_s=turns,
             device=torch.cuda.get_device_name(0), **run.card())
    print_report(r)
    for on, fps in turns:
        print(f"cost: recorder {on}, {fps} frames/s untraced", file=sys.stderr)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
