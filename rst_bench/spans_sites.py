"""Host cost of one served frame's span sites while the recorder is off.

    python3 rst_bench/spans_sites.py

Times, with ``timeit``, the tests that ``stylize_prepacked`` makes on
``spans.on`` with the recorder off (one in ``stylize_prepacked``, one in
``stylize_prepacked_raw``, one in the stage loop, one in each of the 17
launches' wrappers, and the local tests after them), written out in the same
shape as the frame path, against the same loop without them.  Runs on the
CPU; it needs no card.
"""

from __future__ import annotations

import sys
import timeit
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)  # the checkout's root

from realtime_style_transfer_torch.tracing import spans  # noqa: E402

STEPS = range(16)


def with_sites(hook=None) -> None:
    on = spans.on                       # stylize_prepacked
    if on:
        spans.begin_frame("frame")
    on2 = spans.on                      # stylize_prepacked_raw
    if on2:
        spans.begin("frame.prep")
    if on2:
        spans.end()
    on3 = spans.on and hook is None     # _run_stages
    for _ in STEPS:
        if on3:
            spans.begin("stage")
        on4 = spans.on                  # launch_conv_stage
        if on4:
            spans.begin("launch")
        if on4:
            spans.end()
        if on3:
            spans.end()
    if on3:
        spans.begin("stage.finish")
    on4 = spans.on                      # finish
    if on4:
        spans.begin("launch")
    if on4:
        spans.end()
    if on3:
        spans.end()
    if on:
        spans.begin("frame.unpack")
    if on:
        spans.end()
        spans.end()


def without(hook=None) -> None:
    for _ in STEPS:
        pass


def main() -> int:
    n = 200_000
    for _ in range(2):
        sites = min(timeit.repeat(with_sites, number=n, repeat=5)) / n * 1e9
        bare = min(timeit.repeat(without, number=n, repeat=5)) / n * 1e9
        print(f"sites off: {sites:.1f} ns a frame, the bare loop {bare:.1f} ns: "
              f"the sites cost {sites - bare:.1f} ns a frame", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
