"""Least H100 times for the work of the repository's TPU kernels, from shapes.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate for their type (NVIDIA H100 SXM data sheet,
dense, at the 700 W limit).  Nothing here runs on a device.

``python -m realtime_style_transfer_torch.ops.bounds`` prints the bound of each
row of the kernel table in ``PERF.md``, and of each launch of the divider-1
frame (bf16 and int8), each repack probe case, each ``conv_matmul`` launch of
a packed frame and the shared-memory probe's workload; ``chip_smoke.py`` uses
:func:`conv_stage_work`, :func:`finish_work`, :func:`act_stats_work`,
:func:`probe_work`, :func:`repack_work`, :func:`conv_matmul_work`,
:func:`smem_work` and :func:`cin_work` for the per-launch bounds of the
kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ShapeConfig
from ..models.inference import plan_from_config
from ..models.transfer import NUM_RESIDUAL_BLOCKS, StyleTransferNet, TransferPlan
from ..weights import to_flax
from .fused_transfer import FusedTransfer
from .packed_conv import _axis_plan, _pads
from .probe_repack import CASES, out_shape
from .probe_smem import C as SMEM_C, M as SMEM_M, TAPS as SMEM_TAPS

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# Dense tensor-core operations an SM retires a clock: the data sheet's peaks
# are these at 132 SMs and 1830 MHz, so a card whose SMs clock higher beats
# PEAK_FLOPS (the matmul probes' repetitions, whose bound is read at the
# card's own clock).
OPS_PER_SM_CLOCK = {"bf16": 4096, "int8": 8192}
HBM_BYTES_PER_S = 3.35e12
LANE = 128
CHUNK = 8  # frames of the chunk whose per-frame bound row 1b gives


def bound_ms(ops: float, n_bytes: float, kind: str = "bf16") -> Tuple[float, str]:
    """(least time in ms, 'operations' or 'bytes')."""
    ops_ms = ops / PEAK_FLOPS[kind] * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def clock_bound_ms(ops: float, kind: str, sms: int, mhz: float) -> float:
    """Least time in ms of ``ops`` dense tensor-core operations on ``sms``
    SMs at ``mhz`` (a card's max SM clock, as ``nvidia-smi`` reads it)."""
    return ops / (OPS_PER_SM_CLOCK[kind] * sms * mhz * 1e6) * 1e3


def conv_stage_work(st, *, skip_in: bool, skip_out: bool, dual: bool = False,
                    weight_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one ``conv_stage`` launch: MACs over the
    non-zero weights only (padding and the transpose's structural zeros are
    free); bytes of the input, the non-zero weights (``weight_bytes`` each: 1
    for an int8 stage, whose input stays bf16 in device memory), the output
    and skips and, dual, the (H, W) weight plane, bf16.  The prologue's few
    f32 operations per input value are left out: the MACs outnumber them by
    the conv's K."""
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
    n_bytes = (2 * (n_in * (1 + int(skip_in) + int(skip_out)) + n_out + n_plane)
               + weight_bytes * n_weights)
    return 2.0 * macs, float(n_bytes)


def act_stats_work(h: int, w: int, c: int, *, affine: bool, skip_in: bool = False,
                   dual: bool = False, check: bool = False) -> Tuple[float, float]:
    """(f32 operations, bytes) of one ``act_stats`` launch over an (H, W, C)
    bf16 stage input: read it (the stem reads the C logical channels of the
    pack) and the skip and, dual, the (H, W) weight plane; write the C f32
    maxima and, checking, the C int64 clip counts.
    Per value: the affine (2), the blend (4), relu, skip, abs, max (1 each),
    and the clip test (2)."""
    n = h * w * c
    ops = n * (2 * int(affine) + 4 * int(dual) + 2 * int(affine) + int(skip_in) + 2
               + 2 * int(check))
    n_bytes = 2 * n * (1 + int(skip_in)) + (2 * h * w if dual else 0) + (12 if check else 4) * c
    return float(ops), float(n_bytes)


def stage_inputs(plan: TransferPlan):
    """(name, (H, W, C), affine, skip_in) of each conv stage's input, in order."""
    h, w, c = plan.input_shape
    out = []
    for bi, (f, _k, s) in enumerate(plan.contract_schedule):
        out.append((("stem", "c1", "c2", "c3")[bi], (h, w, c), False, False))
        h, w, c = -(-h // s), -(-w // s), f
    fb = plan.bottleneck_num_filters
    for ri in range(NUM_RESIDUAL_BLOCKS):
        for ci in range(2):
            out.append((f"res{ri}{'ab'[ci]}", (h, w, c), ri + ci > 0, ci == 0 and ri >= 2))
            c = fb
    for ei, (f, _k, s) in enumerate(plan.expand_blocks[:-1]):
        out.append((f"e{ei}", (h, w, c), True, ei == 0))
        h, w, c = h * s, w * s, f
    out.append(("final", (h, w, c), True, False))
    return out


def calibrate_frame_work(plan: TransferPlan, *, check: bool = False) -> Tuple[float, float]:
    """(ops, bytes) of the ``act_stats`` launches of one calibrate (or
    check) frame: one over each conv stage's input."""
    ops = n_bytes = 0.0
    for _name, (h, w, c), affine, skip in stage_inputs(plan):
        o, b = act_stats_work(h, w, c, affine=affine, skip_in=skip, check=check)
        ops, n_bytes = ops + o, n_bytes + b
    return ops, n_bytes


def probe_work(ks: int, nrep: int, quant: bool) -> Tuple[float, float]:
    """(operations, bytes) of one probe launch: nrep times a (2400, 128) x
    (128, 128) product per tap; the operands read once (the band reads its
    12-row halo, bf16), the s32 or f32 result written once."""
    m, c = 2400, 128
    ops = 2.0 * m * c * c * ks * ks * nrep
    if ks == 1:
        n_in = m * c * (1 if quant else 2)
    else:
        n_in = 12 * 240 * c * 2
    return ops, float(n_in + ks * ks * c * c * (1 if quant else 2) + 4 * m * c)


def conv_matmul_work(hp: int, wp: int, kh: int, kw: int, cin: int, cout: int,
                     itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one ``conv_matmul`` launch on a padded (hp, wp,
    cin) image: the dense packed product ``2 h w kh kw cin cout`` (the TPU
    kernel's ``CostEstimate``, structural zeros of the packed kernel
    included); the padded input, the output and the weights once."""
    h, w = hp - kh + 1, wp - kw + 1
    ops = 2.0 * h * w * kh * kw * cin * cout
    return ops, float((hp * wp * cin + h * w * cout + kh * kw * cin * cout) * itemsize)


def cin_work(b: int, h: int, w: int, c: int, itemsize: int) -> Dict[str, Tuple[float, float]]:
    """(f32 operations, bytes) of a CIN of a (B, H, W, C) tensor:
    ``function``, x read once and the output written once (the least any
    design moves); ``forward``, the one launch of ``csrc/cin.cu``, which also
    writes the (B, 2, C) moments; ``backward``, its gradient, x and g read
    once, dx written once, the moments and the scale row read, dscale and
    dbias written.  Operations: an add, a square and an add a value for the
    moments, a multiply and an add for the affine; the backward's sums take
    a subtract, a multiply and two adds, dx three subtracts and two
    multiplies.

    The split mode (a frame's rows over a spatial group) is two launches a
    pass, each its own function: ``forward_sums`` reads x and writes the
    (B, 2, C) sums; ``forward_apply`` reads x, the sums, the scale and bias
    rows and writes the output and the moments; ``backward_sums`` reads x, g
    and the moments and writes the sums; ``backward_apply`` reads x, g, the
    moments, the sums and the scale row and writes dx.  ``split_forward`` and
    ``split_backward`` are each pass's two launches: x read twice and the
    output written once; x and g read twice and dx written once."""
    n = b * h * w * c
    moments, row = 8 * b * c, 4 * b * c   # (B, 2, C) f32; one (B, C) f32 row
    out = {"function": (5.0 * n, 2.0 * n * itemsize + 2 * row),
           "forward": (5.0 * n, 2.0 * n * itemsize + 2 * row + moments),
           "backward": (9.0 * n, 3.0 * n * itemsize + moments + 3 * row),
           "forward_sums": (3.0 * n, n * itemsize + moments),
           "forward_apply": (2.0 * n, 2.0 * n * itemsize + 2 * moments + 2 * row),
           "backward_sums": (4.0 * n, 2.0 * n * itemsize + 2 * moments),
           "backward_apply": (5.0 * n, 3.0 * n * itemsize + 2 * moments + row)}
    for name in ("forward", "backward"):
        sums, apply = out[f"{name}_sums"], out[f"{name}_apply"]
        out[f"split_{name}"] = (sums[0] + apply[0], sums[1] + apply[1])
    return out


def conv_matmul_launches(plan: TransferPlan) -> Dict[str, Tuple[int, ...]]:
    """(hp, wp, kh, kw, cin, cout) of the two ``conv_matmul`` launches of
    one packed frame with ``conv_backend='pallas'``: the packed stem (fin =
    fout = 2) and the packed final conv (fin = fout = 2^E)."""
    h, w, c = plan.input_shape
    out = {}
    seams = (("stem", plan.contract_schedule[0], 2, c),
             ("final", plan.expand_blocks[-1], 2 ** plan.num_expand_blocks,
              plan.expand_blocks[-2][0] if plan.num_expand_blocks else
              plan.bottleneck_num_filters))
    for name, (cout, k, _s), f, cin in seams:
        _, lo, extent, _ = _axis_plan(k, 1, f, f)
        hp, wp = h // f, w // f
        pads_y, pads_x = _pads(lo, extent, 1, hp, hp), _pads(lo, extent, 1, wp, wp)
        out[name] = (hp + sum(pads_y), wp + sum(pads_x), extent, extent, f * f * cin,
                     f * f * cout)
    return out


def smem_work(reps: int) -> Tuple[float, float]:
    """(operations, bytes) of one launch of the shared-memory probe's
    workload: ``reps`` times three (2400, 128) x (128, 128) bf16 products;
    x and the weights read once, the f32 result written once."""
    ops = 2.0 * SMEM_M * SMEM_C * SMEM_C * SMEM_TAPS * reps
    return ops, float(2 * SMEM_M * SMEM_C + 2 * SMEM_TAPS * SMEM_C * SMEM_C
                      + 4 * SMEM_M * SMEM_C)


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


def cpu_engine(plan: TransferPlan, **kw) -> FusedTransfer:
    """``FusedTransfer`` of ``plan`` on the CPU with seeded weights (all
    non-zero), e.g. to read its stages' geometry and launch shapes."""
    torch.manual_seed(0)
    return FusedTransfer(to_flax(StyleTransferNet(plan).state_dict()), plan, device="cpu", **kw)


def plan_stage_work(spec: str, *, weight_bytes: int = 2) -> Dict[str, Tuple[float, float]]:
    """(operations, bytes) of each ``conv_stage`` launch of one frame of
    ``spec`` and of its ``finish``, single style, from the stages that
    ``FusedTransfer`` builds on the CPU with seeded weights (all non-zero but
    for the layout's padding); ``weight_bytes=1`` counts int8 weights."""
    plan = plan_from_config(ShapeConfig.from_spec(spec))
    engine = cpu_engine(plan)
    work = {step.stage.name: conv_stage_work(
        step.stage, skip_in=step.skip_in is not None, skip_out=step.skip_out is not None,
        weight_bytes=weight_bytes) for step in engine.steps}
    h, w, c = plan.output_shape
    work["finish"] = finish_work(h, w, c, LANE)
    return work


def repack_work(case) -> float:
    """Bytes of one batch of a repack probe case (``ops.probe_repack.Case``):
    each input read once, each output written once, bf16; no operations."""
    h, w, c = case.in_shape
    oh, ow, oc = out_shape(case.op, case.in_shape, case.out_c)
    n_inputs = 2 if case.op == "interleave" else 1
    return float(2 * case.n * (n_inputs * h * w * c + oh * ow * oc))


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
    ops_c, bytes_c = calibrate_frame_work(flagship)
    rows["1d-cal"] = bound_ms(ops_c, bytes_c, "f32") + (
        f"calibrate pass of one frame: 16 act_stats launches, {bytes_c / 1e6:.1f} MB",)
    ops1, bytes1 = frame_work(divider1)
    rows["1e"] = bound_ms(ops1, bytes1) + (
        f"rst-1920-120-128-17 frame: {ops1 / 1e9:.1f} GFLOP bf16, {bytes1 / 1e6:.1f} MB",)
    ops18, bytes18 = frame_work(divider1, weight_bytes=1)
    rows["1e-int8"] = bound_ms(ops18, bytes18, "int8") + (
        f"rst-1920-120-128-17 int8 frame: {ops18 / 1e9:.1f} GOP int8, "
        f"{bytes18 / 1e6:.1f} MB",)
    ops_c1, bytes_c1 = calibrate_frame_work(divider1)
    rows["1e-cal"] = bound_ms(ops_c1, bytes_c1, "f32") + (
        f"rst-1920 calibrate pass of one frame: {len(stage_inputs(divider1))} act_stats "
        f"launches, {bytes_c1 / 1e6:.1f} MB",)
    for kind, weight_bytes in (("bf16", 2), ("int8", 1)):
        work = plan_stage_work("rst-1920-120-128-17", weight_bytes=weight_bytes)
        fin_ops, fin_bytes = work.pop("finish")  # the finish is bf16 in every mode
        for name, (ops_s, bytes_s) in work.items():
            rows[f"1e {name} {kind}"] = bound_ms(ops_s, bytes_s, kind) + (
                f"one launch: {ops_s / 1e9:.3f} G{'OP int8' if kind == 'int8' else 'FLOP'}, "
                f"{bytes_s / 1e6:.2f} MB",)
    rows["1e finish"] = bound_ms(fin_ops, fin_bytes, "f32") + (
        f"one launch: {fin_bytes / 1e6:.2f} MB",)
    hb, wb, fb = 120, 240, flagship.bottleneck_num_filters
    ops_f, bytes_f = cin_work(1, hb, wb, fb, 4)["function"]
    rows["2"] = bound_ms(ops_f, bytes_f, "f32") + (
        f"CIN of one ({hb}, {wb}, {fb}) f32 activation, one read + one write",)
    slice_work = cin_work(4, hb, wb, fb, 2)
    ops_s, bytes_s = slice_work["function"]
    rows["2 train"] = bound_ms(ops_s, bytes_s, "f32") + (
        f"CIN of the training step's (4, {hb}, {wb}, {fb}) bf16 activation, one read + "
        f"one write, {bytes_s / 2e6:.1f} MB each way",)
    ops_fw, bytes_fw = slice_work["forward"]
    rows["2 train, forward"] = bound_ms(ops_fw, bytes_fw, "f32") + (
        "the same CIN as cin.cu's one forward launch moves it: the moments written too",)
    ops_bw, bytes_bw = slice_work["backward"]
    rows["2' train, backward"] = bound_ms(ops_bw, bytes_bw, "f32") + (
        f"its gradient, one launch: x and g read, dx written, {bytes_bw / 1e6:.1f} MB",)
    half = cin_work(4, hb // 2, wb, fb, 2)   # a rank's rows on a 2-rank spatial axis
    for name in ("forward", "backward"):
        ops_h, bytes_h = half[f"split_{name}"]
        rows[f"2{chr(39) if name == 'backward' else ''} spatial, {name}"] = bound_ms(
            ops_h, bytes_h, "f32") + (
            f"cin.cu's split {name} (sums, then apply) on a rank's (4, {hb // 2}, {wb}, {fb}) "
            f"bf16 rows of a 2-rank spatial axis, {bytes_h / 1e6:.1f} MB",)
    for label, plan in (("rst-960", flagship), ("rst-1920", divider1)):
        for seam, shape in conv_matmul_launches(plan).items():
            ops_m, bytes_m = conv_matmul_work(*shape)
            rows[f"3 {label} {seam}"] = bound_ms(ops_m, bytes_m) + (
                f"packed {seam}: ({shape[0]}, {shape[1]}, {shape[4]}) -> {shape[5]}, "
                f"{shape[2]}x{shape[3]}, {ops_m / 1e9:.2f} GFLOP bf16, {bytes_m / 1e6:.1f} MB",)
    m, k, n = 2400, 128, 128
    rows["4"] = bound_ms(2 * m * k * n, m * k + k * n + 4 * m * n, "int8") + (
        f"({m}, {k}) x ({k}, {n}) int8 matmul, s32 out",)
    for name, case in CASES.items():
        n_bytes = repack_work(case)
        rows[f"6 {name}"] = bound_ms(0.0, n_bytes) + (
            f"{case.op} of {case.n} x {case.in_shape} bf16, {n_bytes / 1e6:.1f} MB",)
    for reps in (8, 32):
        ops_w, bytes_w = smem_work(reps)
        rows[f"5 work x{reps}"] = bound_ms(ops_w, bytes_w) + (
            f"{reps} x 3 ({SMEM_M}, {SMEM_C}) x ({SMEM_C}, {SMEM_C}) bf16 products, "
            f"{ops_w / 1e9:.2f} GFLOP",)
    return rows


def main() -> None:
    for row, (ms, by, what) in table().items():
        print(f"{row}: {ms:.4f} ms ({by}; {what})")


if __name__ == "__main__":
    main()
