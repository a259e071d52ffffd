"""Least H100 times for the work of the repository's TPU kernels, from shapes.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate for their type (NVIDIA H100 SXM data sheet,
dense, at the 700 W limit).  Nothing here runs on a device.

``python -m realtime_style_transfer_torch.ops.bounds`` prints the bound of each
row of the kernel table in ``PERF.md``; ``chip_smoke.py`` uses
:func:`conv_stage_work` for the per-launch bounds of the stage kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..config import ShapeConfig
from ..models.inference import plan_from_config
from ..models.transfer import NUM_RESIDUAL_BLOCKS, TransferPlan

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
LANE = 128


def bound_ms(ops: float, n_bytes: float, kind: str = "bf16") -> Tuple[float, str]:
    """(least time in ms, 'operations' or 'bytes')."""
    ops_ms = ops / PEAK_FLOPS[kind] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def conv_stage_work(st, *, skip_in: bool, skip_out: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``conv_stage`` launch: MACs over the non-zero
    weights only (padding and the transpose's structural zeros are free);
    bytes of the input, the non-zero weights, the output and skips, bf16."""
    oh, ow = st.out_hw
    n_weights = int((st.w != 0).sum().item())
    macs = oh * ow * n_weights
    n_in = 1
    for d in st.in_shape:
        n_in *= d
    n_out = 1
    for d in st.out_shape:
        n_out *= d
    n_bytes = 2 * (n_in * (1 + int(skip_in) + int(skip_out)) + n_weights + n_out)
    return 2.0 * macs, float(n_bytes)


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


def frame_work(plan: TransferPlan, *, weight_bytes: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one frame through the whole net in one launch: the
    frame pack in, the packed frame out, every weight once."""
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
    return 2.0 * sum(macs.values()), float(pack_in + pack_out + weight_bytes * n_weights)


def table() -> Dict[str, Tuple[float, str, str]]:
    """Row -> (bound ms, bound by, what was counted)."""
    flagship = plan_from_config(ShapeConfig.from_spec("rst-960-120-128-17"))
    divider1 = plan_from_config(ShapeConfig.from_spec("rst-1920-120-128-17"))
    rows: Dict[str, Tuple[float, str, str]] = {}
    ops, n_bytes = frame_work(flagship)
    rows["1a"] = bound_ms(ops, n_bytes) + (
        f"rst-960-120-128-17 frame: {ops / 1e9:.1f} GFLOP bf16, {n_bytes / 1e6:.1f} MB",)
    rows["1b"] = rows["1a"][:2] + ("per frame, as 1a",)
    h, w, _ = flagship.input_shape
    rows["1c"] = bound_ms(ops, n_bytes + h * w * 4) + (
        "as 1a plus the f32 weight map",)
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
