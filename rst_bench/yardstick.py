"""The benchmark's frozen yardstick: operations and bytes from a configuration.

Worked out from a configuration file's shapes alone, so that no change to the
program can move it.  The counting rule is the one the port's kernel table
has used since its bounds were first written: a conv stage's operations are
its multiply-adds over the non-zero weights (padding and the transpose's
structural zeros are free), twice; its bytes are each input read once (the
skip read, or written, once more), each output written once and each weight
read once, bf16.  A bound is the larger of operations over the bf16 peak and
bytes over the HBM rate, at the NVIDIA H100 SXM data sheet's dense peaks.

A frame of the fused engine is one ``conv_stage`` launch a stage, in the
order :func:`stages` lists them, and one ``finish`` launch.  The stem and
the final conv take the kernel's ``window`` path (stride 1, more than 9
taps), the stride-2 contracts the ``strided`` path, every other stage the
``halo`` path; the strided path runs the halo path's kernel.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

PEAK_FLOPS = {"bf16": 989e12}   # dense tensor-core rate, NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
PACK_LANE = 128   # channel padding of the frame pack and of the packed output
ROOT = Path(__file__).resolve().parent


class Stage(NamedTuple):
    name: str
    path: str                       # "window", "halo" or "strided"
    in_shape: Tuple[int, int, int]  # what the launch reads (the stem: the frame pack)
    out_shape: Tuple[int, int, int]
    macs: int
    weights: int
    skip_in: bool
    skip_out: bool

    @property
    def ops(self) -> float:
        return 2.0 * self.macs

    @property
    def bytes(self) -> float:
        n_in = self.in_shape[0] * self.in_shape[1] * self.in_shape[2]
        n_out = self.out_shape[0] * self.out_shape[1] * self.out_shape[2]
        return float(2 * (n_in * (1 + self.skip_in + self.skip_out) + n_out)
                     + 2 * self.weights)


def load_config(path) -> dict:
    """A configuration file, by its path from the checkout's root."""
    return json.loads((ROOT.parent / path).read_text())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stages(cfg: dict) -> List[Stage]:
    """Every conv stage of one frame, in launch order."""
    h, w, c = cfg["input_shape"]
    f, k, _ = cfg["stem"]
    out = [Stage("stem", "window", (h // 4, w // 4, _round_up(16 * c, PACK_LANE)),
                 (h, w, f), h * w * k * k * c * f, k * k * c * f, False, False)]
    c = f
    for i, (f, k, s) in enumerate(cfg["contracts"]):
        oh, ow = -(-h // s), -(-w // s)
        out.append(Stage(f"c{i + 1}", "strided", (h, w, c), (oh, ow, f),
                         oh * ow * k * k * c * f, k * k * c * f, False, False))
        h, w, c = oh, ow, f
    fb = cfg["bottleneck_num_filters"]
    for ri in range(cfg["residual_blocks"]):
        for ci in range(2):
            out.append(Stage(f"res{ri}{'ab'[ci]}", "halo", (h, w, c), (h, w, fb),
                             h * w * 9 * c * fb, 9 * c * fb,
                             ci == 0 and ri >= 2, ci == 0 and ri >= 1))
            c = fb
    for ei, (f, k, s) in enumerate(cfg["expands"]):
        # a stride-2 transpose conv: every input pixel meets every tap once
        out.append(Stage(f"e{ei}", "halo", (h, w, c), (s * h, s * w, f),
                         h * w * k * k * c * f, k * k * c * f, ei == 0, False))
        h, w, c = s * h, s * w, f
    f, k, _ = cfg["final"]
    out.append(Stage("final", "window", (h, w, c), (h, w, f),
                     h * w * k * k * c * f, k * k * c * f, False, False))
    return out


def finish_work(cfg: dict) -> Tuple[float, float]:
    """(f32 operations, bytes) of the ``finish`` launch: the final stage's
    (H, W, 3) bf16 output read, the packed (H/4, W/4, 128) bf16 frame
    written; a multiply, an add, an exp and a divide a value."""
    h, w, c = cfg["output_shape"]
    n = h * w * c
    return 4.0 * n, float(2 * (n + (h // 4) * (w // 4) * PACK_LANE))


def bound_s(ops: float, n_bytes: float) -> float:
    """Least seconds of a bf16 launch on the data sheet's card."""
    return max(ops / PEAK_FLOPS["bf16"], n_bytes / HBM_BYTES_PER_S)


def frame_flops(cfg: dict) -> float:
    """Operations of one frame through the whole net (the stages' sum)."""
    return sum(st.ops for st in stages(cfg))


def path_bounds(cfg: dict) -> Dict[str, Tuple[float, int]]:
    """Per kernel of ``conv_stage.cu``: (least seconds of its launches in one
    frame, its launches a frame).  ``conv_window_kernel`` runs the window
    path, ``conv_halo_kernel`` the halo and strided paths."""
    out = {"conv_window_kernel": (0.0, 0), "conv_halo_kernel": (0.0, 0)}
    for st in stages(cfg):
        kernel = "conv_window_kernel" if st.path == "window" else "conv_halo_kernel"
        total, n = out[kernel]
        out[kernel] = (total + bound_s(st.ops, st.bytes), n + 1)
    return out
