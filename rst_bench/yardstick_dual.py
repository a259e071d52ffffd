"""The frozen yardstick of a frame that blends two styles per pixel.

:mod:`.yardstick`'s counts of the same stages, plus what the blend reads:
each stage that applies a CIN to its input (every conv stage from the second
residual conv on) reads the second style's weight at its input resolution
once, a bf16 plane, and the second style's scale and bias rows, f32; the
``finish`` reads the full-size plane and its rows as well.  Operations are
unchanged: the blend's few multiply-adds a value are not tensor-core work.
At rst-960 the planes are ten of 120x240, one of 240x480 and two of 480x960:
2,649,600 bytes a frame.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .yardstick import Stage, bound_s, finish_work, stages


def blend_bytes(hw: Tuple[int, int], channels: int) -> int:
    """Bytes one blending launch reads beyond one style's: the bf16 weight
    plane at ``hw`` and the second style's two f32 rows of ``channels``."""
    return 2 * hw[0] * hw[1] + 2 * 4 * channels


def blending(cfg: dict) -> List[Stage]:
    """The conv stages that blend: those whose input comes out of a CIN,
    from the second residual conv on."""
    return stages(cfg)[len(cfg["contracts"]) + 2:]


def stage_bytes(cfg: dict) -> Dict[str, float]:
    """Every conv stage's bytes, by name, the blend's included."""
    out = {st.name: st.bytes for st in stages(cfg)}
    for st in blending(cfg):
        out[st.name] += blend_bytes(st.in_shape[:2], st.in_shape[2])
    return out


def plane_bytes(cfg: dict) -> int:
    """Bytes of the weight planes a frame reads: one a blending stage and
    the finish's."""
    h, w, _ = cfg["output_shape"]
    return sum(2 * st.in_shape[0] * st.in_shape[1] for st in blending(cfg)) + 2 * h * w


def finish_work_dual(cfg: dict) -> Tuple[float, float]:
    """(f32 operations, bytes) of the dual ``finish``: the one-style
    launch's and its blend's reads."""
    ops, n_bytes = finish_work(cfg)
    h, w, _ = cfg["output_shape"]
    return ops, n_bytes + blend_bytes((h, w), cfg["final"][0])


def path_bounds(cfg: dict) -> Dict[str, Tuple[float, int]]:
    """:func:`.yardstick.path_bounds` with the blend's bytes: per kernel of
    ``conv_stage.cu``, (least seconds of its launches in one frame, its
    launches a frame)."""
    bytes_of = stage_bytes(cfg)
    out = {"conv_window_kernel": (0.0, 0), "conv_halo_kernel": (0.0, 0)}
    for st in stages(cfg):
        kernel = "conv_window_kernel" if st.path == "window" else "conv_halo_kernel"
        total, n = out[kernel]
        out[kernel] = (total + bound_s(st.ops, bytes_of[st.name]), n + 1)
    return out
