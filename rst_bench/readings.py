"""Readings that the limits of ``correct`` are set from, many seeds in one
process.

    python3 rst_bench/readings.py CONFIG TRAFFIC --seeds 1,2,3 [--control 4,5,6]
        [--seconds 2]

For each seed of ``--seeds`` it makes one run of the cell's traffic through
the frame driver (set-up, warm-up, a short window, the comparison with the
reference: :func:`rst_bench.drivers.frames.run`, as a benchmark run does);
for each seed of ``--control`` the same run with the control in the
program's place: the program's own int8 engine (``FusedTransfer(quant=
"int8")``, its scales calibrated on the seed's pool), the nearest precision
below the configuration's bfloat16.  Each line gives the run's ``correct``
and each compared number beside its limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import torch

    from rst_bench.drivers import frames
    from rst_bench.yardstick import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("traffic")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cfg = load_config(f"rst_bench/configs/{args.config}.json")
    traffic = json.loads((ROOT / "rst_bench" / "traffic" / f"{args.traffic}.json").read_text())
    for side, seeds, quant in (("program", args.seeds, None), ("control int8", args.control, "int8")):
        for seed in [int(s) for s in seeds.split(",") if s]:
            o = frames.run(cfg, traffic, seed=seed, seconds=args.seconds, trace=False,
                           device=torch.device("cuda"), quant=quant)
            checks = {k: {"value": v, "limit": lim} for k, (v, lim) in o.checks.items()}
            print(json.dumps({"config": args.config, "side": side, "seed": seed,
                              "correct": o.correct, "frames": o.attempted, "failed": o.failed,
                              "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
