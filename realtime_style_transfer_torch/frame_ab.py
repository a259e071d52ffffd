"""Time the fused frame of two checkouts of the port in turns, on one card.

``python -m realtime_style_transfer_torch.frame_ab ROOT_A ROOT_B`` runs, in
turns A, B, B, A, one process a turn that imports ``realtime_style_transfer_torch``
from that root (a checkout or a ``git archive`` of another commit), builds its
kernels into the root's own ``build/`` and times, with CUDA events, the
single-style ``stylize_prepacked_raw`` frame of seeded full-width engines:
rst-960-120-128-17 and rst-1920-120-128-17, bf16 and int8 (seeded scales),
and a frame of the replay of an 8-frame chunk's CUDA graph (recorded by
``stylize_prepacked_chunk``), the frame's device time without the host's
launch costs.  Each figure is the median of 3 windows of 30 calls after 5
warm-up calls.
Each turn also counts the elements in which two calls on one frame differ.
Prints one JSON line a turn, then the median of each root's turns beside the
card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.weights import to_flax

torch.backends.cudnn.allow_tf32 = False
kernels.build()
dev = torch.device("cuda")
out = {"root": sys.argv[1]}


def window_ms(fn, reps=30, windows=3):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


for spec in ("rst-960-120-128-17", "rst-1920-120-128-17"):
    model = make_inference_model(ShapeConfig.from_spec(spec), seed=0)
    plan = model.plan
    variables = to_flax(model.transfer.state_dict())
    rng = np.random.default_rng(0)
    h, w = plan.input_shape[:2]
    style = torch.from_numpy(rng.random((1, 1, h, w, 3), dtype=np.float32)).to(dev)
    frame = rng.random((1,) + tuple(plan.input_shape), dtype=np.float32)
    with torch.no_grad():
        params = model.predict_style_params(style)
    bf16 = FusedTransfer(variables, plan)
    scales = (np.random.default_rng(1).random((bf16.n_conv_stages, 128)) * 2.5
              + 0.5).astype(np.float32)
    for kind, engine in (("bf16", bf16),
                         ("int8", FusedTransfer(variables, plan, quant="int8",
                                                act_scales=scales))):
        prep = engine.prepare_style(params)
        packed = engine.pack_frame_np(frame).to(dev)
        with torch.no_grad():
            first = engine.stylize_prepacked_raw(packed, prep).clone()
            second = engine.stylize_prepacked_raw(packed, prep)
            torch.cuda.synchronize()
            out[f"{spec} {kind} differing"] = int((first != second).sum())
            out[f"{spec} {kind} ms"] = window_ms(
                lambda: engine.stylize_prepacked_raw(packed, prep))
            packs = torch.stack([packed] * 8)
            engine.stylize_prepacked_chunk(packs, prep)
            out[f"{spec} {kind} chunk replay ms"] = window_ms(
                engine.chunk_graphs[8].graph.replay) / 8
    del model, bf16
print("FRAME_AB " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    roots = [str(Path(r).resolve()) for r in (argv if argv is not None else sys.argv[1:])]
    if len(roots) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        run = subprocess.run([sys.executable, "-c", _CHILD, root], capture_output=True,
                             text=True, timeout=900)
        line = next((ln for ln in run.stdout.splitlines() if ln.startswith("FRAME_AB ")), None)
        if run.returncode != 0 or line is None:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(line[len("FRAME_AB "):]))
        print(line, flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for root in roots:
        mine = [t for t in turns if t["root"] == root]
        figures = {k: sorted(t[k] for t in mine) for k in mine[0] if k != "root"}
        print(f"[{card}] {root}: " + ", ".join(
            f"{k} {v[0]:.4f}/{v[1]:.4f}" if k.endswith(" ms") else f"{k} {max(v)}"
            for k, v in figures.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
