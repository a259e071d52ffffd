"""Least H100 times for the work of the repository's TPU kernels, from shapes.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate for their type (NVIDIA H100 SXM data sheet,
dense, at the 700 W limit).  Nothing here runs on a device.

``python -m realtime_style_transfer_torch.ops.bounds`` prints the bound of each
row of the kernel table in ``PERF.md``; ``chip_smoke.py`` uses
:func:`conv_stage_work` and :func:`finish_work` for the per-launch bounds of
the two kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..config import ShapeConfig
from ..models.inference import plan_from_config
from ..models.transfer import NUM_RESIDUAL_BLOCKS, TransferPlan

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
LANE = 128
CHUNK = 8  # frames of the chunk whose per-frame bound row 1b gives


def bound_ms(ops: float, n_bytes: float, kind: str = "bf16") -> Tuple[float, str]:
    """(least time in ms, 'operations' or 'bytes')."""
    ops_ms = ops / PEAK_FLOPS[kind] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def conv_stage_work(st, *, skip_in: bool, skip_out: bool,
                    dual: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``conv_stage`` launch: MACs over the non-zero
    weights only (padding and the transpose's structural zeros are free);
    bytes of the input, the non-zero weights, the output and skips and, dual,
    the (H, W) weight plane, bf16.  The prologue's few f32 operations per
    input value are left out: the MACs outnumber them by the conv's K."""
    oh, ow = st.out_hw
    n_weights = int((st.w != 0).sum().item())
    macs = oh * ow * n_weights
    n_in = 1
    for d in st.in_shape:
        n_in *= d
    n_out = 1
    for d in st.out_shape:
        n_out *= d
    n_plane = st.in_hw[0] * st.in_hw[1] if dual else 0
    n_bytes = 2 * (n_in * (1 + int(skip_in) + int(skip_out)) + n_weights + n_out + n_plane)
    return 2.0 * macs, float(n_bytes)


def finish_work(h: int, w: int, c: int, out_c: int, *,
                dual: bool = False) -> Tuple[float, float]:
    """(f32 operations, bytes) of one ``finish`` launch: read the (H, W, C)
    bf16 input and, dual, the (H, W) bf16 weight plane; write the packed
    (H/4, W/4, out_c) bf16 frame.  Per value: mul, add, exp, divide, and
    mul, add, mul, add more for the blend."""
    n = h * w * c
    n_bytes = 2 * (n + (h // 4) * (w // 4) * out_c + (h * w if dual else 0))
    return float((8 if dual else 4) * n), float(n_bytes)


def dual_plane_bytes(plan: TransferPlan) -> int:
    """Bytes of the bf16 weight planes one dual frame reads: one plane per
    consumer of a CIN, at that consumer's input resolution (the residual
    convs after res0a and e0 at the bottleneck, then e1, the final conv and
    the finish)."""
    h, w, _ = plan.output_shape
    hb, wb = h >> plan.num_expand_blocks, w >> plan.num_expand_blocks
    n = 2 * NUM_RESIDUAL_BLOCKS * hb * wb  # res0b..res4b, e0
    for ei in range(1, plan.num_expand_blocks):
        n += (hb << ei) * (wb << ei)
    n += 2 * h * w
    return 2 * n


def plan_macs(plan: TransferPlan) -> Dict[str, int]:
    """Multiply-adds of each conv of the transfer net (true, unpadded)."""
    h, w, c = plan.input_shape
    macs: Dict[str, int] = {}
    for bi, (f, k, s) in enumerate(plan.contract_schedule):
        h, w = -(-h // s), -(-w // s)
        macs[f"contract_{bi}"] = h * w * k * k * c * f
        c = f
    for ri in range(NUM_RESIDUAL_BLOCKS):
        for ci in range(2):
            macs[f"residual_{ri}_conv{ci}"] = h * w * 9 * c * plan.bottleneck_num_filters
            c = plan.bottleneck_num_filters
    for ei, (f, k, s) in enumerate(plan.expand_blocks):
        macs[f"expand_{ei}"] = h * w * k * k * c * f  # per input pixel, all taps
        h, w, c = h * s, w * s, f
    return macs


def frame_work(plan: TransferPlan, *, weight_bytes: int = 2,
               frames: int = 1) -> Tuple[float, float]:
    """(ops, bytes) of one frame through the whole net in one launch: the
    frame pack in, the packed frame out, every weight once per ``frames``
    frames (a chunk reads them once for all its frames)."""
    h, w, c = plan.input_shape
    macs = plan_macs(plan)
    n_weights = 0
    cin = c
    for f, k, _ in plan.contract_schedule:
        n_weights += k * k * cin * f
        cin = f
    n_weights += NUM_RESIDUAL_BLOCKS * 2 * 9 * plan.bottleneck_num_filters ** 2
    for f, k, _ in plan.expand_blocks:
        n_weights += k * k * cin * f
        cin = f
    pack_in = (h // 4) * (w // 4) * (-(-16 * c // LANE) * LANE) * 2
    pack_out = (h // 4) * (w // 4) * LANE * 2
    return 2.0 * sum(macs.values()), float(pack_in + pack_out
                                           + weight_bytes * n_weights / frames)


def table() -> Dict[str, Tuple[float, str, str]]:
    """Row -> (bound ms, bound by, what was counted)."""
    flagship = plan_from_config(ShapeConfig.from_spec("rst-960-120-128-17"))
    divider1 = plan_from_config(ShapeConfig.from_spec("rst-1920-120-128-17"))
    rows: Dict[str, Tuple[float, str, str]] = {}
    ops, n_bytes = frame_work(flagship)
    rows["1a"] = bound_ms(ops, n_bytes) + (
        f"rst-960-120-128-17 frame: {ops / 1e9:.1f} GFLOP bf16, {n_bytes / 1e6:.1f} MB",)
    ops_b, bytes_b = frame_work(flagship, frames=CHUNK)
    rows["1b"] = bound_ms(ops_b, bytes_b) + (
        f"per frame of a {CHUNK}-frame chunk: weights read once a chunk, "
        f"{bytes_b / 1e6:.2f} MB a frame",)
    planes = dual_plane_bytes(flagship)
    rows["1c"] = bound_ms(ops, n_bytes + planes) + (
        f"as 1a plus {planes / 1e6:.2f} MB of bf16 weight planes",)
    ops8, bytes8 = frame_work(flagship, weight_bytes=1)
    rows["1d"] = bound_ms(ops8, bytes8, "int8") + (
        f"{ops8 / 1e9:.1f} GOP int8, {bytes8 / 1e6:.1f} MB",)
    ops1, bytes1 = frame_work(divider1)
    rows["1e"] = bound_ms(ops1, bytes1) + (
        f"rst-1920-120-128-17 frame: {ops1 / 1e9:.1f} GFLOP bf16, {bytes1 / 1e6:.1f} MB",)
    hb, wb, fb = 120, 240, flagship.bottleneck_num_filters
    act = hb * wb * fb
    rows["2"] = bound_ms(4 * act, 2 * 4 * act, "f32") + (
        f"CIN of one ({hb}, {wb}, {fb}) f32 activation",)
    res_macs = act * 9 * fb
    rows["3"] = bound_ms(2 * res_macs, 2 * (2 * act + 9 * fb * fb)) + (
        f"one {hb}x{wb}x{fb} 3x3 conv, bf16",)
    m, k, n = 2400, 128, 128
    rows["4"] = bound_ms(2 * m * k * n, m * k + k * n + 4 * m * n, "int8") + (
        f"({m}, {k}) x ({k}, {n}) int8 matmul, s32 out",)
    return rows


def main() -> None:
    for row, (ms, by, what) in table().items():
        print(f"{row}: {ms:.4f} ms ({by}; {what})")


if __name__ == "__main__":
    main()
