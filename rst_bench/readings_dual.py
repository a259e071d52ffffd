"""Readings that the two-style configuration's limit of ``correct`` is set
from, many seeds in one process: :mod:`.readings` through the dual frame
driver.

    python3 rst_bench/readings_dual.py --seeds 1,2,3 [--control 4,5,6]
        [--seconds 2]

For each seed of ``--seeds`` one run of the ``dual-stream`` traffic at
``rst-960-120-128-17-dual`` (:func:`rst_bench.drivers.frames_dual.run`, as a
benchmark run makes it); for each seed of ``--control`` the same run with the
program's dual int8 engine in its place.  One JSON line a run, with its
``correct`` and each compared number beside its limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

CONFIG, TRAFFIC = "rst-960-120-128-17-dual", "dual-stream"


def main(argv=None) -> int:
    import torch

    from rst_bench.drivers import frames_dual
    from rst_bench.yardstick import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cfg = load_config(f"rst_bench/configs/{CONFIG}.json")
    traffic = json.loads((ROOT / "rst_bench" / "traffic" / f"{TRAFFIC}.json").read_text())
    for side, seeds, quant in (("program", args.seeds, None), ("control int8", args.control, "int8")):
        for seed in [int(s) for s in seeds.split(",") if s]:
            o = frames_dual.run(cfg, traffic, seed=seed, seconds=args.seconds, trace=False,
                                device=torch.device("cuda"), quant=quant)
            checks = {k: {"value": v, "limit": lim} for k, (v, lim) in o.checks.items()}
            print(json.dumps({"config": CONFIG, "side": side, "seed": seed,
                              "correct": o.correct, "frames": o.attempted, "failed": o.failed,
                              "checks": checks,
                              "blend_launches_per_frame": o.readings["blend_launches_per_frame"],
                              "frames_per_s": o.end_to_end["frames_per_s"],
                              "peak_mem_gib": o.end_to_end["peak_mem_gib"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
