#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (needs one CUDA device).

Run from the repository root: ``python3 chip_smoke.py``.

1. Builds the CUDA kernels (``nvcc``, one process per source: conv_stage,
   finish, act_stats, probe_int8, probe_repack, conv_matmul, probe_smem) and
   prints the build time and the ptxas report (registers, shared memory,
   spills) of every instantiation.
2. Holds every stage kernel of the rst-960-120-128-17 frame against its plain
   PyTorch version on the card, on seeded inputs at the stage's real shapes:
   bf16 outputs within rtol 1.6e-2 (two bf16 ulps) + atol 1e-2 * max|ref|,
   moment sums within rtol 1e-3 + atol 1e-3 * max|ref| (the two sides share
   their rounding points and differ only in summation order).  Times each
   kernel, its plain version and one library ``F.conv2d`` in bf16 on the same
   input, with CUDA events.  Then every stage with a CIN prologue and the
   finish again in dual-style form (seeded second-style rows, a seeded weight
   plane in [0, 1]), with the same limits, timed beside the single-style time.
   Then every stage in int8 form (an int8 engine built from a seeded scales
   table), single and, where it takes a prologue, dual: outputs and
   ``skip_out`` within one bf16 ulp of the plain int8 version (expected equal:
   the int32 sums are exact; the count of differing elements is printed),
   moments within rtol 1e-3; ``act_stats`` on the same input against its plain
   version, maxima and clip counts exactly.  Each int8 launch is timed beside
   the bf16 time of the same stage and its int8 bound.
3. Drives the main path: seeded full-width weights from the port's own
   initialisers, ``predict_style_params`` on a seeded 480x960 style image,
   ``prepare_style``, then 8 seeded frames through ``video.stylize_video``
   (prefetcher + ``stylize_prepacked``).  Every frame is compared with the
   eager f32 ``StyleTransferNet`` (TF32 off; rtol 0.08, atol 0.03) and with the
   plain bf16 stage composition (rtol 0.05, atol 0.02, median < 5e-3), and the
   launch counters must show every stage kernel launched for every frame.
   The dual path does the same with two seeded style images, the vertical
   ramp weight map of ``bench.py``'s dual mode and 8 more frames; one frame
   with an all-zero map must match the single-style kernel path with style 0
   within the kernel-vs-plain limits of phase 2 (the moment atomics make
   the summation order vary from run to run, so not bit for bit).
   Chunk mode: 8 frame packs through ``stylize_prepacked_chunk``, single and
   dual style.  The CUDA graph must hold 8 x 16 ``conv_stage`` and 8
   ``finish`` launches and be replayed once per call, and its frames must
   match 8 single calls within the kernel-vs-plain limits.
   int8: the bf16 engine is calibrated on 4 frames with the kernels and with
   the plain versions (scales within rtol 0.05 + atol 0.02, the frame limit:
   each side's maxima come from its own stage chain); 8 frames stream through
   ``stylize_video(quant="int8")`` and each is held against the bf16 kernel
   path with the JAX package's int8 bar (max < 0.06, median < 0.01, PSNR >
   35 dB) and against the plain int8 stage composition (rtol 0.05, atol 0.02,
   median < 5e-3); the same for dual int8 with the ramp map; the saturation
   check must pass the matching style (max_ratio <= 1.05, the chain's
   run-to-run spread; clip fraction <= 1e-6) and flag one with its style
   params x 3 (max_ratio > 1.25, clips > 0); an 8-frame int8 chunk must match
   8 single int8 calls; the launch counts of ``conv_stage``, ``finish`` and
   ``act_stats`` must match the frames.
   Probe: the int8 matmul probe's plain product and band pattern, bf16 and
   int8 arms, checked against float64 (int8 exactly, bf16 within 2^-8 of the
   largest value), timed, with the int8/bf16 time ratio, TOPS and share of the
   dense peak; ``torch._int_mm`` on the residual conv's im2col GEMM and on the
   probe's shape is timed as the int8 library yardstick (its error is printed
   in its place if this build refuses the shape).
4. Prints per-frame times of the kernel path (single, dual, chunk), the plain
   paths, the predictor's time for one and two styles, the int8 and dual int8
   frame, the int8 chunk per frame, calibration a frame and the int8 video
   loop's host latency, each beside the card's name and power limit.
5. The divider-1 plan, rst-1920-120-128-17 (960x1920x17 frames, a 120x240x128
   bottleneck, 2678 style params), at full width and depth with seeded
   weights: the engine must be ``three_seg`` with 18 conv stages and refuse
   two styles with the JAX package's ValueError.  Every stage (stem, c1, c2,
   c3, the residual core, e0, e1, e2, final) and the finish is held against
   its plain version with phase 2's limits, bf16 and int8, and timed beside
   its bound and ``F.conv2d`` bf16.  Then the main path at 1920 as in phase 3,
   single style: 8 frames through ``stylize_video`` in bf16 (held against the
   eager f32 net and the plain bf16 composition), calibration on 4 frames
   (kernels against plain), 8 frames through ``stylize_video(quant="int8")``
   (the JAX int8 bar against the bf16 kernel path, the plain int8
   composition), the saturation check, 8-frame chunks in bf16 (phase 2's
   limits) and int8 (the frame limit, rtol 0.05 + atol 0.02, median < 5e-3:
   two runs of the int8 chain differ by whole int8 steps where a float-atomic
   moment flips a rounding, up to 10 bf16 ulps at this size), the
   launch counts (18 ``conv_stage`` and 1 ``finish`` a frame; 18 ``act_stats``
   a calibrate or check frame), and its times: frame, chunk, calibration,
   predictor, and the video loop's host latency, bf16 and int8.
6. The repack probe (``ops/probe_repack.py``): deinterleave, interleave,
   fold2 and unfold2 at the TPU probe's shapes and fold2 / unfold2 of the
   rst-1920 c2 output, each bit-equal to its plain version and timed beside
   its bytes bound and one strided PyTorch copy; then ``F.instance_norm`` at
   the bottleneck's shape, timed as the library yardstick of TPU kernel row 2.
7. The packed path (``models/transfer_packed.py``) and its tap-matmul kernel
   ``conv_matmul`` (``csrc/conv_matmul.cu``).  The kernel against its plain
   version at ``tests/test_pallas_conv.py``'s shapes, at the four launches of
   the path (the packed stem, 5x5 68->128 with the contract epilogue, and the
   packed final conv, 3x3 256->48 and 512->192, at rst-960 and rst-1920) in
   bf16 with phase 2's limits, and once in f32 at rtol 1e-4 + atol 1e-4 (the
   JAX f32 tests' limit); each launch timed beside its bound, the plain version
   and ``F.conv2d`` on the same padded input.  Then 8 flagship frames, one
   style and two (the ramp map), through ``video.stylize_video`` on a
   ``PackedTransfer`` with ``conv_backend="pallas"``: 2 ``conv_matmul``
   launches a frame and none of the fused kernels; each frame held against the
   eager f32 net (rtol 0.08, atol 0.03), the packed path with the kernel's
   plain version and ``FusedTransfer``'s frame on the same weights (rtol 0.05,
   atol 0.02, median < 5e-3).  Then rst-1920-120-128-17 with two styles:
   ``choose_path`` must give ``"packed"``, ``FusedTransfer`` must refuse the
   plan with the JAX message, and 8 frames go through ``stylize_video`` with
   the same checks (no fused frame exists to compare).  Frame times of the
   packed path (``pallas`` and ``xla``) beside the fused frame, and the video
   loop's host latency.  Last, the shared-memory probe (``ops/probe_smem.py``):
   (a) every size of the sweep up to the card's opt-in cap fills and reads
   back its buffer, and 1 KB above the cap is refused; (b) the fixed tap-matmul
   workload at 8 and 32 repetitions under each reservation, within 1e-3 of the
   largest value of its f32 plain version, timed with its blocks per SM.

Any failed phase exits non-zero.  The last lines are the kernel table as one
JSON object, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SPEC = "rst-960-120-128-17"
SPEC_1920 = "rst-1920-120-128-17"
N_FRAMES = 8
N_CAL = 4
SEED = 0
TPU_KERNEL = "realtime_style_transfer_tpu/ops/pallas/fused_transfer.py"
SOURCES = "realtime_style_transfer_torch/csrc"
PROBE = "tools/probe_int8_mxu.py"
REPACK_PROBE = "tools/probe_repack_ops.py"
DUAL_REFUSAL = "dual-style is not yet supported on the 3-contract"
CONV_MATMUL = "realtime_style_transfer_tpu/ops/pallas/conv_matmul.py"
SMEM_PROBE = "tools/probe_vmem_cap.py"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from realtime_style_transfer_torch.config import ShapeConfig
    from realtime_style_transfer_torch.models.inference import make_inference_model
    from realtime_style_transfer_torch.models.transfer_packed import PackedTransfer
    from realtime_style_transfer_torch.ops import (
        conv_matmul, kernels, probe_int8, probe_repack, probe_smem)
    from realtime_style_transfer_torch.ops.bounds import (
        PEAK_FLOPS, act_stats_work, bound_ms, conv_matmul_launches, conv_matmul_work,
        conv_stage_work, finish_work, probe_work, repack_work, smem_work)
    from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
    from realtime_style_transfer_torch.ops.kernels import (
        Prologue, act_stats, act_stats_plain, conv_stage, conv_stage_plain, finish,
        finish_plain, unpack_frame)
    from realtime_style_transfer_torch.video import choose_path, stylize_video
    from realtime_style_transfer_torch.weights import to_flax

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(f"card: {gpu}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    failures = []
    t_start = time.perf_counter()

    def note(line: str) -> None:
        print(f"[{gpu}] {line}", flush=True)

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def close(name, got, ref, rtol, atol_frac) -> float:
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        atol = atol_frac * ref.abs().max().item()
        ok = bool((err <= atol + rtol * ref.abs()).all()) and bool(torch.isfinite(got).all())
        print(f"  {name}: max_abs_err={err.max().item():.3e} "
              f"median={err.median().item():.3e} limit=rtol {rtol} + atol {atol:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        return err.max().item()

    def close_ulp(name, got, ref) -> float:
        """Within one bf16 ulp of the larger magnitude (an int8 stage is
        expected to equal its plain version bit for bit)."""
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        ok = bool((err <= ulp).all()) and bool(torch.isfinite(got).all())
        print(f"  {name}: max_abs_err={err.max().item():.3e}, {int((err > 0).sum())} of "
              f"{err.numel()} elements differ, limit one bf16 ulp {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)
        return err.max().item()

    def close_frame(name, got, ref) -> float:
        """The port's kernel-vs-plain frame limit: rtol 0.05 + atol 0.02,
        median < 5e-3."""
        got, ref = got.float(), ref.float()
        err = (got - ref).abs()
        ok = bool((err <= 0.02 + 0.05 * ref.abs()).all()) and err.median().item() < 5e-3 \
            and bool(torch.isfinite(got).all())
        print(f"  {name}: max_abs_err={err.max().item():.3e} median={err.median().item():.3e} "
              f"limit=rtol 0.05 + atol 0.02, median < 5e-3 {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        return err.max().item()

    def check_launches(label, per_frame, frames, extra=None):
        launches = {"conv_stage": kernels.conv_stage.launches, "finish": kernels.finish.launches,
                    "act_stats": kernels.act_stats.launches}
        want = dict({"act_stats": 0}, **{k: v * frames for k, v in per_frame.items()})
        want.update(extra or {})
        print(f"{label} launches: {launches}, expected {want} "
              f"({frames} frames, {per_frame} per frame)")
        if launches != want:
            failures.append(f"{label} launch counts")
        return launches

    def failed(phase: str) -> bool:
        if failures:
            print(f"FAILED {phase}: {failures}")
        return bool(failures)

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'cached'}",
          flush=True)
    for source, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Compiling entry" in line):
                print(f"  {source}: {line.strip()}")

    # ---- engine at full width ---------------------------------------------
    cfg = ShapeConfig.from_spec(SPEC)
    t0 = time.perf_counter()
    model = make_inference_model(cfg, seed=SEED)
    plan = model.plan
    fused = FusedTransfer(to_flax(model.transfer.state_dict()), plan)
    print(f"engine {SPEC}: {len(fused.steps)} conv stages + finish, "
          f"{plan.num_style_parameters} style params, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if plan.num_style_parameters != 2662:
        print(f"FAILED: style vector ABI {plan.num_style_parameters} != 2662")
        return 1

    # ---- phase 2: each stage kernel against its plain version ---------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    eps = fused.eps

    def prologue_for(x, cin, relu, hw, dual=False):
        xf = x.float().reshape(-1, cin)
        stats = torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous()
        scale = torch.rand(cin, generator=gen, device=dev) * 0.4 + 0.8
        bias = torch.rand(cin, generator=gen, device=dev) * 0.4 - 0.2
        second = ()
        if dual:
            second = (torch.rand(cin, generator=gen, device=dev) * 0.4 + 0.8,
                      torch.rand(cin, generator=gen, device=dev) * 0.4 - 0.2,
                      torch.rand(hw, generator=gen, device=dev).to(bf16))
        return Prologue(stats, float(xf.shape[0]), scale, bias, eps, relu, *second)

    def check_stage(engine, label, step, relu_override=None, dual=False):
        """One stage of ``engine`` against its plain version on seeded inputs
        at its real shapes, then timed beside its plain version, its bound
        and (bf16, single style) ``F.conv2d``."""
        st = step.stage
        if st.pack_c:
            x = engine.pack_frame(torch.rand((1,) + engine.plan.input_shape, generator=gen,
                                             device=dev))
        else:
            x = torch.rand(st.in_shape, generator=gen, device=dev).to(bf16)
        relu = step.in_relu if relu_override is None else relu_override
        pro = prologue_for(x, st.cin, relu, st.in_hw, dual) if step.src >= 0 else None
        skip_in = (torch.randn(st.in_shape, generator=gen, device=dev) * 0.5).to(bf16) \
            if step.skip_in is not None else None
        kw = dict(prologue=pro, skip_in=skip_in)
        outs = {}
        for side, fn in (("kernel", conv_stage), ("plain", conv_stage_plain)):
            out = torch.empty(st.out_shape, dtype=bf16, device=dev)
            skip_out = torch.empty(st.in_shape, dtype=bf16, device=dev) \
                if step.skip_out is not None else None
            stats = torch.zeros((2, st.c_log), dtype=f32, device=dev) if step.slot >= 0 else None
            fn(x, st, out, skip_out=skip_out, stats_out=stats, **kw)
            outs[side] = (out, skip_out, stats)
        torch.cuda.synchronize()
        print(f"{label}: in {st.in_shape} -> out {st.out_shape}, k {st.kh}x{st.kw} "
              f"s{st.stride}{' transpose' if st.transpose else ''} epi={st.epi} "
              f"prologue={'affine' if pro else 'none'}{'+dual' if dual else ''}"
              f"{'+relu' if relu and pro else ''}"
              f"{'+skip_in' if skip_in is not None else ''}"
              f"{'+skip_out' if step.skip_out is not None else ''}"
              f"{'+moments' if step.slot >= 0 else ''}")
        (ko, ks, kst), (po, ps, pst) = outs["kernel"], outs["plain"]
        if st.quant:
            err = close_ulp(f"{label} out", ko, po)
            if ks is not None:
                err = max(err, close_ulp(f"{label} skip_out", ks, ps))
        else:
            err = close(f"{label} out", ko, po, 1.6e-2, 1e-2)
            if ks is not None:
                err = max(err, close(f"{label} skip_out", ks, ps, 1.6e-2, 1e-2))
        moments_rel = None
        if kst is not None:
            close(f"{label} sums", kst[0], pst[0], 1e-3, 1e-3)
            close(f"{label} sums of squares", kst[1], pst[1], 1e-3, 1e-3)
            # sums of squares are positive: relative to each; sums relative to the largest
            moments_rel = (((kst[1] - pst[1]).abs() / pst[1].abs().clamp_min(1e-30)).max().item(),
                           (kst[0] - pst[0]).abs().max().item()
                           / max(pst[0].abs().max().item(), 1e-30))
            print(f"  {label} moments: {int(st.out_hw[0] * st.out_hw[1] * st.n / st.c_log)} "
                  f"values a channel; max relative difference: sums of squares "
                  f"{moments_rel[0]:.3e}, sums {moments_rel[1]:.3e} (of the largest)")
        stats_row = None
        if st.quant:
            # act_stats on the same input, prologue and skip, under the stage's act_inv
            got = act_stats(x, st, pro, skip_in, st.act_inv)
            want = act_stats_plain(x, st, pro, skip_in, st.act_inv)
            torch.cuda.synchronize()
            stats_err = (got[0] - want[0]).abs().max().item()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            print(f"  {label} act_stats: max |x'| max_abs_err={stats_err:.3e}, clips "
                  f"{int(got[1].sum())} vs {int(want[1].sum())} {'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"{label} act_stats")
            a_ms = cuda_ms(lambda: act_stats(x, st, pro, skip_in, st.act_inv), 20)
            a_plain_ms = cuda_ms(lambda: act_stats_plain(x, st, pro, skip_in, st.act_inv), 3)
            h, w = st.in_hw
            a_ops, a_bytes = act_stats_work(h, w, st.cin, affine=pro is not None,
                                            skip_in=skip_in is not None, dual=dual, check=True)
            stats_row = dict(err=stats_err, ms=a_ms, plain_ms=a_plain_ms,
                             ops_ms=bound_ms(a_ops, 0.0, "f32")[0],
                             bytes_ms=bound_ms(0.0, a_bytes)[0])

        scratch = torch.zeros((2, st.c_log), dtype=f32, device=dev) if step.slot >= 0 else None
        skip_scratch = torch.empty(st.in_shape, dtype=bf16, device=dev) \
            if step.skip_out is not None else None
        out = torch.empty(st.out_shape, dtype=bf16, device=dev)
        kernel_ms = cuda_ms(lambda: conv_stage(x, st, out, skip_out=skip_scratch,
                                               stats_out=scratch, **kw), 20)
        plain_ms = cuda_ms(lambda: conv_stage_plain(x, st, out, skip_out=skip_scratch,
                                                    stats_out=scratch, **kw), 3)
        library_ms = None
        if not dual and not st.quant:
            h, w = st.in_hw
            logical = unpack_frame(x, st.cin) if st.pack_c else x
            oh, ow = st.out_hw
            pad_b = (oh - 1) * st.stride + st.kh - h - st.pad_top
            pad_r = (ow - 1) * st.stride + st.kw - w - st.pad_left
            xp = F.pad(logical.permute(2, 0, 1)[None], (st.pad_left, pad_r, st.pad_top, pad_b))
            xp = xp.contiguous(memory_format=torch.channels_last)
            wt = st.weight_oihw().to(bf16).contiguous(memory_format=torch.channels_last)
            library_ms = cuda_ms(lambda: F.conv2d(xp, wt, stride=st.stride), 20)

        flops, n_bytes = conv_stage_work(st, skip_in=skip_in is not None,
                                         skip_out=step.skip_out is not None, dual=dual,
                                         weight_bytes=1 if st.quant else 2)
        ops_ms, _ = bound_ms(flops, 0.0, "int8" if st.quant else "bf16")
        bytes_ms, _ = bound_ms(0.0, n_bytes)
        note(f"{label}{' dual' if dual else ''}: kernel {kernel_ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, "
             + (f"F.conv2d bf16 {library_ms:.4f} ms, " if library_ms is not None else "")
             + f"bound {max(ops_ms, bytes_ms):.4f} ms "
             f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; {flops / 1e9:.2f} "
             f"{'GOP int8' if st.quant else 'GFLOP'}, {n_bytes / 1e6:.1f} MB)"
             + (f"; act_stats {stats_row['ms']:.4f} ms, plain {stats_row['plain_ms']:.4f} ms, "
                f"bound {max(stats_row['ops_ms'], stats_row['bytes_ms']):.4f} ms"
                if stats_row else ""))
        return dict(err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    ops_ms=ops_ms, bytes_ms=bytes_ms, stats=stats_row, moments_rel=moments_rel)

    def check_finish(label, xf, pro):
        """The finish on the (H, W, 3) ``xf`` against its plain version, timed."""
        h, w = xf.shape[:2]
        fin = {}
        for side, fn in (("kernel", finish), ("plain", finish_plain)):
            fin[side] = torch.empty((h // 4, w // 4, 128), dtype=bf16, device=dev)
            fn(xf, pro, fin[side])
        torch.cuda.synchronize()
        print(f"{label}: in {tuple(xf.shape)} -> out {tuple(fin['kernel'].shape)}")
        err = close(f"{label} out", fin["kernel"], fin["plain"], 1.6e-2, 1e-2)
        scratch = torch.empty_like(fin["kernel"])
        ms = cuda_ms(lambda: finish(xf, pro, scratch), 50)
        plain_ms = cuda_ms(lambda: finish_plain(xf, pro, scratch), 10)
        ops, n_bytes = finish_work(h, w, 3, scratch.shape[2], dual=pro.dual)
        ops_ms, _ = bound_ms(ops, 0.0, "f32")
        bytes_ms, _ = bound_ms(0.0, n_bytes)
        note(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{max(bytes_ms, ops_ms):.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
        return dict(err=err, ms=ms, plain_ms=plain_ms, ops_ms=ops_ms, bytes_ms=bytes_ms)

    def seeded_scales(engine):
        return (np.random.default_rng(SEED + 1).random((engine.n_conv_stages, 128))
                * 2.5 + 0.5).astype(np.float32)

    print("phase 2: stage kernels vs plain versions", flush=True)
    rows = [check_stage(fused, step.stage.name, step) for step in fused.steps]
    res2a = next(s for s in fused.steps if s.stage.name == "res2a")
    extra = check_stage(fused, "res2a with affine+relu+skip", res2a, relu_override=True)

    h, w = plan.input_shape[:2]
    xf = (torch.randn((h, w, 3), generator=gen, device=dev) * 2.0).to(bf16)
    fin = check_finish("finish", xf, prologue_for(xf, 3, False, (h, w)))

    print("phase 2, dual: every stage with a CIN prologue, and the finish", flush=True)
    dual_rows = {}
    for i, step in enumerate(fused.steps):
        if step.src >= 0:
            dual_rows[i] = check_stage(fused, step.stage.name, step, dual=True)
            note(f"{step.stage.name}: dual {dual_rows[i]['ms']:.4f} ms vs single "
                 f"{rows[i]['ms']:.4f} ms")
    dual_extra = check_stage(fused, "res2a with affine+relu+skip", res2a, relu_override=True,
                             dual=True)
    fin_dual = check_finish("finish dual", xf, prologue_for(xf, 3, False, (h, w), dual=True))
    note(f"finish: dual {fin_dual['ms']:.4f} ms vs single {fin['ms']:.4f} ms")
    if failed("phase 2"):
        return 1

    print("phase 2, int8: every stage in int8 form (seeded scales), single and dual",
          flush=True)
    variables = to_flax(model.transfer.state_dict())
    fused_seeded = FusedTransfer(variables, plan, quant="int8", act_scales=seeded_scales(fused))
    int8_rows, int8_dual_rows = {}, {}
    for i, step in enumerate(fused_seeded.steps):
        int8_rows[i] = check_stage(fused_seeded, f"{step.stage.name} int8", step)
        if step.src >= 0:
            int8_dual_rows[i] = check_stage(fused_seeded, f"{step.stage.name} int8", step,
                                            dual=True)
        note(f"{step.stage.name}: int8 {int8_rows[i]['ms']:.4f} ms vs bf16 {rows[i]['ms']:.4f} ms"
             + (f"; dual int8 {int8_dual_rows[i]['ms']:.4f} ms vs dual bf16 "
                f"{dual_rows[i]['ms']:.4f} ms" if i in int8_dual_rows else ""))
    if failed("phase 2, int8"):
        return 1

    # ---- phase 3: the main path, single and dual style ------------------------
    print(f"phase 3: {N_FRAMES} frames of {SPEC} through video.stylize_video", flush=True)
    rng = np.random.default_rng(SEED)
    style_image = rng.random((h, w, 3), dtype=np.float32)
    frames = [rng.random(plan.input_shape, dtype=np.float32) for _ in range(N_FRAMES)]
    per_frame = {"conv_stage": len(fused.steps), "finish": 1}

    def check_frames(label, engine, net, results, frames, style_params, prepared,
                     weights=None):
        """Each delivered frame against the eager f32 net and the plain
        bf16 stage composition."""
        oh, ow, _ = engine.plan.output_shape
        if sorted(results) != list(range(len(frames))):
            failures.append(f"{label} frames delivered")
        errs_f32, errs_plain = [], []
        with torch.no_grad():
            for i, frame in enumerate(frames):
                got = torch.from_numpy(results[i]).to(dev)
                if tuple(got.shape) != (oh, ow, 3) or not bool(torch.isfinite(got).all()):
                    failures.append(f"{label} frame {i} shape/finite")
                    continue
                content = torch.from_numpy(frame)[None].to(dev)
                want32 = net(content, style_params, weights)[0]
                raw = engine.stylize_prepacked_raw(engine.pack_frame_np(frame[None]), prepared,
                                                   plain=True)
                want_bf = unpack_frame(raw, 3).float()
                e32 = (got - want32).abs()
                ebf = (got - want_bf).abs()
                ok32 = bool((e32 <= 0.03 + 0.08 * want32.abs()).all())
                okbf = bool((ebf <= 0.02 + 0.05 * want_bf.abs()).all()) \
                    and ebf.median().item() < 5e-3
                errs_f32.append(e32.max().item())
                errs_plain.append(ebf.max().item())
                print(f"  {label} frame {i}: vs eager f32 max {e32.max().item():.3e} median "
                      f"{e32.median().item():.3e} {'ok' if ok32 else 'FAIL'}; vs plain bf16 "
                      f"max {ebf.max().item():.3e} median {ebf.median().item():.3e} "
                      f"{'ok' if okbf else 'FAIL'}", flush=True)
                if not (ok32 and okbf):
                    failures.append(f"{label} frame {i}")
        return errs_f32, errs_plain

    results = {}
    kernels.reset_launch_counts()
    run = stylize_video(model, fused, style_image, frames,
                        lambda i, frame: results.__setitem__(i, frame))
    torch.cuda.synchronize()
    launches = check_launches("single", per_frame, N_FRAMES + 1)  # + warm-up
    style_params = run["style_params"]
    if tuple(style_params.shape) != (1, 1, 2662) or not torch.isfinite(style_params).all():
        failures.append("style params")
    prepared = fused.prepare_style(style_params)
    errs_f32, errs_plain = check_frames("single", fused, model.transfer, results, frames,
                                        style_params, prepared)
    if failed("phase 3"):
        return 1

    print(f"phase 3, dual: {N_FRAMES} frames, two styles, vertical ramp weight map",
          flush=True)
    cfg2 = ShapeConfig.from_spec(SPEC, num_styles=2)
    model2 = make_inference_model(cfg2, seed=SEED)
    variables2 = to_flax(model2.transfer.state_dict())
    fused2 = FusedTransfer(variables2, plan, num_styles=2)
    style_images = [rng.random((h, w, 3), dtype=np.float32) for _ in range(2)]
    ramp = np.broadcast_to(np.linspace(0, 1, h, dtype=np.float32)[:, None, None],
                           (h, w, 1)).copy()
    frames2 = [rng.random(plan.input_shape, dtype=np.float32) for _ in range(N_FRAMES)]
    results2 = {}
    kernels.reset_launch_counts()
    run2 = stylize_video(model2, fused2, style_images, frames2,
                         lambda i, frame: results2.__setitem__(i, frame), style_weights=ramp)
    torch.cuda.synchronize()
    launches2 = check_launches("dual", per_frame, N_FRAMES + 1)
    style_params2 = run2["style_params"]
    if tuple(style_params2.shape) != (1, 2, 2662) or not torch.isfinite(style_params2).all():
        failures.append("dual style params")
    ramp_t = torch.from_numpy(ramp)[None].to(dev)
    prepared2 = fused2.prepare_style(style_params2, ramp_t)
    errs2_f32, errs2_plain = check_frames("dual", fused2, model2.transfer, results2, frames2,
                                          style_params2, prepared2, ramp_t)
    # all-zero map: the first style everywhere, as the single-style engine gives it
    single2 = FusedTransfer(variables2, plan)
    packed0 = fused2.pack_frame_np(frames2[0][None]).to(dev)
    blend0 = fused2.stylize_prepacked_raw(
        packed0, fused2.prepare_style(style_params2, torch.zeros_like(ramp_t)))
    style0 = single2.stylize_prepacked_raw(packed0, single2.prepare_style(style_params2[:, :1]))
    torch.cuda.synchronize()
    zero_err = close("dual, all-zero map vs single style 0 (kernels)", blend0, style0,
                     1.6e-2, 1e-2)
    if failed("phase 3, dual"):
        return 1

    # ---- phase 3, chunk: one CUDA graph replay for N frames -------------------
    def check_chunk(label, engine, packs, prep, compare=None):
        """An N-frame chunk: the graph's recorded launches, one replay a
        call, the frames against N single calls (within phase 2's
        kernel-vs-plain limits unless ``compare`` is given); then timed."""
        if compare is None:
            def compare(name, got, ref):
                return close(name, got, ref, 1.6e-2, 1e-2)
        n = packs.shape[0]
        n_st = len(engine.steps)
        kernels.reset_launch_counts()
        got = engine.stylize_prepacked_chunk(packs, prep)
        torch.cuda.synchronize()
        graph = engine.chunk_graphs[n]
        want_captured = {"conv_stage": n_st * n, "finish": n}
        replays = kernels.replay_graph.replays
        print(f"chunk {label}: graph holds {graph.captured} (expected {want_captured}), "
              f"replays {replays} (expected 1), launches on the way "
              f"{kernels.conv_stage.launches} + {kernels.finish.launches} "
              f"(one warm-up frame + the recorded ones)")
        if graph.captured != want_captured or replays != 1:
            failures.append(f"chunk {label} graph")
        singles = torch.cat([engine.stylize_prepacked(packs[i], prep) for i in range(n)])
        oh, ow, _ = engine.plan.output_shape
        if tuple(got.shape) != (n, oh, ow, 3):
            failures.append(f"chunk {label} shape {tuple(got.shape)}")
        err = compare(f"chunk {label} vs {n} single calls", got, singles)
        kernels.reset_launch_counts()
        again = engine.stylize_prepacked_chunk(packs, prep)
        torch.cuda.synchronize()
        if (kernels.replay_graph.replays, kernels.conv_stage.launches,
                kernels.finish.launches) != (1, 0, 0):
            failures.append(f"chunk {label} second call")
        compare(f"chunk {label}, second call vs first", again, got)
        with torch.no_grad():
            chunk_ms = cuda_ms(lambda: engine.stylize_prepacked_chunk(packs, prep), 10)
            singles_ms = cuda_ms(lambda: [engine.stylize_prepacked(packs[i], prep)
                                          for i in range(n)], 10)
            replay_ms = cuda_ms(lambda: kernels.replay_graph(graph.graph), 10)
            raw_ms = cuda_ms(lambda: [engine.stylize_prepacked_raw(packs[i], prep)
                                      for i in range(n)], 10)
        res = dict(err=err, ms=chunk_ms / n, singles_ms=singles_ms / n, replay_ms=replay_ms / n,
                   raw_ms=raw_ms / n, captured=graph.captured)
        note(f"chunk {label}, per frame: stylize_prepacked_chunk({n}) {res['ms']:.4f} ms vs "
             f"{n} stylize_prepacked calls {res['singles_ms']:.4f} ms; graph replay alone "
             f"{res['replay_ms']:.4f} ms vs {n} stylize_prepacked_raw calls "
             f"{res['raw_ms']:.4f} ms")
        return res

    print(f"phase 3, chunk: chunks of {N_FRAMES} frame packs, single and dual", flush=True)
    packs = torch.stack([fused.pack_frame_np(f[None]) for f in frames]).to(dev)
    chunk = {"single": check_chunk("single", fused, packs, prepared),
             "dual": check_chunk("dual", fused2, packs, prepared2)}
    if failed("phase 3, chunk"):
        return 1

    # ---- phase 3, int8: calibrate, stream, check, chunk ---------------------------
    def check_calibration(label, engine, cal_packs, prep):
        """Kernel calibration (launch counts) against plain calibration."""
        n_st = engine.n_conv_stages
        kernels.reset_launch_counts()
        cal_kernel = engine.calibrate_act_scales(cal_packs, prep)
        torch.cuda.synchronize()
        check_launches(f"{label} calibrate", {"conv_stage": n_st, "act_stats": n_st},
                       len(cal_packs), {"finish": 0})
        cal_plain = engine.calibrate_act_scales(cal_packs, prep, plain=True)
        # each side takes its maxima over its own stage chain, and the two chains'
        # activations differ as their frames do (moment atomics and conv summation
        # order flip bf16 roundings, which compound stage by stage): the port's
        # kernel-vs-plain frame limit, rtol 0.05 + atol 0.02
        cal_err = np.abs(cal_kernel - cal_plain)
        cal_ok = bool((cal_err <= 0.02 + 0.05 * np.abs(cal_plain)).all())
        rel = cal_err / np.maximum(np.abs(cal_plain), 1e-6)
        print(f"{label} calibrated scales, kernels vs plain: max_abs_err {cal_err.max():.3e}, "
              f"max rel {rel.max():.3e} (limit rtol 0.05 + atol 0.02) "
              f"{'ok' if cal_ok else 'FAIL'}; max rel by stage: "
              + ", ".join(f"{s.stage.name} {rel[i].max():.1e}"
                          for i, s in enumerate(engine.steps)))
        if not cal_ok:
            failures.append(f"{label} calibration kernels vs plain")
        return cal_kernel

    def check_int8_frames(label, bf16_engine, engine, results, frames, prep_bf16, prep_q):
        """Each int8 frame against the bf16 kernel path (the JAX package's
        int8 bar) and the plain int8 stage composition."""
        oh, ow, _ = engine.plan.output_shape
        if sorted(results) != list(range(len(frames))):
            failures.append(f"{label} frames delivered")
        errs_bf16, errs_plain, psnrs = [], [], []
        for i, frame in enumerate(frames):
            got = torch.from_numpy(results[i]).to(dev)
            if tuple(got.shape) != (oh, ow, 3) or not bool(torch.isfinite(got).all()):
                failures.append(f"{label} frame {i} shape/finite")
                continue
            pk = bf16_engine.pack_frame_np(frame[None])
            want_bf = unpack_frame(bf16_engine.stylize_prepacked_raw(pk, prep_bf16), 3).float()
            want_q = unpack_frame(engine.stylize_prepacked_raw(pk, prep_q, plain=True), 3).float()
            eb, eq = (got - want_bf).abs(), (got - want_q).abs()
            psnr = 10 * np.log10(1.0 / max(float((eb * eb).mean()), 1e-12))
            okb = eb.max().item() < 0.06 and eb.median().item() < 0.01 and psnr > 35.0
            okq = bool((eq <= 0.02 + 0.05 * want_q.abs()).all()) and eq.median().item() < 5e-3
            errs_bf16.append(eb.max().item())
            errs_plain.append(eq.max().item())
            psnrs.append(psnr)
            print(f"  {label} frame {i}: vs bf16 kernels max {eb.max().item():.3e} median "
                  f"{eb.median().item():.3e} PSNR {psnr:.2f} dB {'ok' if okb else 'FAIL'}; "
                  f"vs plain int8 max {eq.max().item():.3e} median {eq.median().item():.3e} "
                  f"{'ok' if okq else 'FAIL'}", flush=True)
            if not (okb and okq):
                failures.append(f"{label} frame {i}")
        return errs_bf16, errs_plain, psnrs

    def run_int8_video(label, bf16_engine, mdl, styles_in, frs, weights_map, sp, prep,
                       weights_t=None):
        """``stylize_video(quant='int8')``: calibration on the first frames,
        then every frame through the int8 engine; launch counts and frames
        checked."""
        res = {}
        n_st = bf16_engine.n_conv_stages
        kernels.reset_launch_counts()
        run_q = stylize_video(mdl, bf16_engine, styles_in, frs,
                              lambda i, frame: res.__setitem__(i, frame),
                              style_weights=weights_map, quant="int8",
                              variables=to_flax(mdl.transfer.state_dict()),
                              calibration_frames=N_CAL)
        torch.cuda.synchronize()
        counts = check_launches(label, {"conv_stage": n_st, "finish": 1}, len(frs) + 1,
                                {"conv_stage": n_st * (len(frs) + 1 + N_CAL),
                                 "act_stats": n_st * N_CAL})
        engine = run_q["engine"]
        prep_q = engine.prepare_style(sp, weights_t)
        errs = check_int8_frames(label, bf16_engine, engine, res, frs, prep, prep_q)
        return dict(run=run_q, engine=engine, prep=prep_q, launches=counts, errs=errs)

    def check_saturation(label, engine, cal_packs, prep, sp, scales_q, cal_kernel):
        """The saturation check on the deployed scales: the matching style
        passes, a stronger one is flagged; the check's launch counts."""
        n_st = engine.n_conv_stages
        kernels.reset_launch_counts()
        match = engine.check_act_saturation(cal_packs, prep, scales_q)
        torch.cuda.synchronize()
        check_launches(f"{label} check", {"conv_stage": n_st, "act_stats": n_st},
                       len(cal_packs), {"finish": 0})
        strong = engine.check_act_saturation(cal_packs, engine.prepare_style(sp * 3), scales_q)
        sat = {}
        for name, report in (("matching style", match), ("style params x 3", strong)):
            ratio = max(r["max_ratio"] for r in report)
            clips = sum(r["clip_events"] for r in report)
            frac = clips / sum(r["n_quantized"] for r in report)
            sat[name] = (ratio, clips, frac)
            print(f"{label} saturation check, {name}: max_ratio {ratio:.4f} (stage "
                  f"{max(report, key=lambda r: r['max_ratio'])['stage']}), clip events "
                  f"{clips}, clip fraction {frac:.3e}")
        # the check's stage chain is a new run of the calibration's: the CIN
        # moments are float atomics, so bf16 roundings of x' flip and the maxima
        # move between two runs on the same frames (two kernel calibrations of
        # this run are compared below); hence the chain's rtol 0.05, far below
        # the CLI guard's 1.25
        drift = float(np.max(np.maximum(cal_kernel, scales_q)
                             / np.maximum(np.minimum(cal_kernel, scales_q), 1e-6)))
        print(f"{label} kernel calibrations run to run (calibrate_act_scales vs "
              f"stylize_video): max ratio {drift:.4f}; matching-style limit max_ratio <= 1.05")
        if not (sat["matching style"][0] <= 1.05 and sat["matching style"][2] <= 1e-6):
            failures.append(f"{label} saturation check, matching style")
        if not (sat["style params x 3"][0] > 1.25 and sat["style params x 3"][1] > 0):
            failures.append(f"{label} saturation check, stronger style")
        return sat

    print(f"phase 3, int8: calibrate on {N_CAL} frames, {N_FRAMES} frames through "
          "stylize_video(quant='int8'), single and dual", flush=True)
    cal_packs = list(packs[:N_CAL])
    cal_kernel = check_calibration("flagship", fused, cal_packs, prepared)
    int8_runs = {
        "int8": run_int8_video("int8", fused, model, style_image, frames, None, style_params,
                               prepared),
        "dual int8": run_int8_video("dual int8", fused2, model2, style_images, frames2, ramp,
                                    style_params2, prepared2, ramp_t)}
    eng_q, prep_q = int8_runs["int8"]["engine"], int8_runs["int8"]["prep"]
    check_saturation("flagship", fused, cal_packs, prepared, style_params,
                     int8_runs["int8"]["run"]["act_scales"], cal_kernel)
    chunk["int8"] = check_chunk("int8", eng_q, packs, prep_q)
    if failed("phase 3, int8"):
        return 1

    # ---- probe: int8 against bf16 mma.sync at the residual conv's shapes -------------
    print(f"probe: {PROBE} on Hopper, nrep {probe_int8.NREP}", flush=True)
    probe = {}
    for arm, fn in (("mm", probe_int8.probe_mm), ("band", probe_int8.probe_band)):
        for quant in (False, True):
            x_p, w_p, inv_p = probe_int8.make_inputs(arm, quant, dev, SEED)
            args = (x_p, w_p, probe_int8.NREP) + ((inv_p,) if arm == "band" else ())
            fn.launches = 0
            got = fn(*args)
            launches_p = fn.launches
            want = probe_int8.probe_plain(x_p, w_p, probe_int8.NREP, inv_p)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().max().item()
            limit = 0.0 if quant else 2.0 ** -8 * want.abs().max().item()
            ok = err <= limit
            kind = "int8" if quant else "bf16"
            ms = cuda_ms(lambda: fn(*args), 20)
            plain_ms = cuda_ms(lambda: probe_int8.probe_plain(x_p, w_p, probe_int8.NREP, inv_p), 3)
            ops, n_bytes = probe_work(1 if arm == "mm" else 3, probe_int8.NREP, quant)
            bound, by = bound_ms(ops, n_bytes, kind)
            tops = ops / ms / 1e9
            probe[(arm, kind)] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound, by=by,
                                      tops=tops, launches=launches_p)
            note(f"probe {arm} {kind}: max_abs_err {err:.3e} (limit {limit:.3e}) "
                 f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms a launch, {tops:.1f} TOPS, "
                 f"{tops * 1e12 / PEAK_FLOPS[kind]:.2%} of the dense {kind} peak; plain "
                 f"float64 {plain_ms:.4f} ms; bound {bound:.4f} ms ({by})")
            if not ok:
                failures.append(f"probe {arm} {kind}")
        ratio = probe[(arm, "int8")]["ms"] / probe[(arm, "bf16")]["ms"]
        probe[(arm, "ratio")] = ratio
        note(f"probe {arm}: int8/bf16 time ratio {ratio:.3f}")
    if failed("probe"):
        return 1

    def yardstick(label, fn):
        """A library call's time, or why this build refused it."""
        try:
            return cuda_ms(fn, 20)
        except RuntimeError as exc:  # a yardstick, not a check: report what refused
            return f"{label} refused: {str(exc)[:160]}"

    def int_mm_ms(m, k, n):
        """torch._int_mm on an (m, k) x (k, n) int8 product, or its error."""
        a = torch.randint(-127, 127, (m, k), dtype=torch.int8, device=dev)
        b = torch.randint(-127, 127, (n, k), dtype=torch.int8, device=dev).t()
        return yardstick(f"torch._int_mm ({m}, {k}) x ({k}, {n})", lambda: torch._int_mm(a, b))

    res_hw = fused.steps[4].stage.in_hw
    lib_res = int_mm_ms(res_hw[0] * res_hw[1], 9 * 128, 128)
    lib_probe = int_mm_ms(probe_int8.M, 128, 128)
    xa = torch.randn((probe_int8.M, 128), device=dev).to(bf16)
    wb = torch.randn((128, 128), device=dev).to(bf16)
    lib_probe_bf16 = cuda_ms(lambda: torch.mm(xa, wb), 20)
    note(f"library yardsticks: torch._int_mm residual im2col GEMM "
         f"({res_hw[0] * res_hw[1]} x 1152 x 128, im2col left out): {lib_res}; "
         f"probe shape (2400 x 128 x 128): {lib_probe}; torch.mm bf16 at the probe shape "
         f"{lib_probe_bf16:.4f} ms")

    # ---- phase 4: end-to-end times -------------------------------------------
    packed = fused.pack_frame_np(frames[0][None]).to(dev)
    content = torch.from_numpy(frames[0])[None].to(dev)
    style = torch.from_numpy(style_image)[None, None].to(dev)
    styles2 = torch.from_numpy(np.stack(style_images))[None].to(dev)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: fused.stylize_prepacked_raw(packed, prepared), 20)
        plain_frame_ms = cuda_ms(
            lambda: fused.stylize_prepacked_raw(packed, prepared, plain=True), 3)
        eager_ms = cuda_ms(lambda: model.transfer(content, style_params), 3)
        predictor_ms = cuda_ms(lambda: model.predict_style_params(style), 10)
        dual_frame_ms = cuda_ms(lambda: fused2.stylize_prepacked_raw(packed, prepared2), 20)
        dual_plain_frame_ms = cuda_ms(
            lambda: fused2.stylize_prepacked_raw(packed, prepared2, plain=True), 3)
        dual_eager_ms = cuda_ms(lambda: model2.transfer(content, style_params2, ramp_t), 3)
        dual_predictor_ms = cuda_ms(lambda: model2.predict_style_params(styles2), 10)
        eng_q2, prep_q2 = int8_runs["dual int8"]["engine"], int8_runs["dual int8"]["prep"]
        int8_frame_ms = cuda_ms(lambda: eng_q.stylize_prepacked_raw(packed, prep_q), 20)
        dual_int8_frame_ms = cuda_ms(lambda: eng_q2.stylize_prepacked_raw(packed, prep_q2), 20)
        calibrate_ms = cuda_ms(lambda: fused.calibrate_act_scales([packed], prepared), 5)
    int8_chunk_ms = chunk["int8"]["ms"]
    lat = sorted(run["latency_s"])
    lat2 = sorted(run2["latency_s"])
    note(f"frame, kernel path (stylize_prepacked_raw): {frame_ms:.4f} ms")
    note(f"frame, plain bf16 stage composition: {plain_frame_ms:.4f} ms")
    note(f"frame, eager f32 StyleTransferNet: {eager_ms:.4f} ms")
    note(f"style predictor (MobileNetV3-Small, 480x960): {predictor_ms:.4f} ms")
    note(f"video loop host latency per frame (stylize + D2H, {len(lat)} frames): "
         f"median {lat[len(lat) // 2] * 1e3:.4f} ms, max {lat[-1] * 1e3:.4f} ms")
    note(f"stage kernels summed: {sum(r['ms'] for r in rows):.4f} ms; "
         f"max err vs eager f32 {max(errs_f32):.3e}, vs plain bf16 {max(errs_plain):.3e}")
    note(f"dual frame, kernel path (stylize_prepacked_raw): {dual_frame_ms:.4f} ms")
    note(f"dual frame, plain bf16 stage composition: {dual_plain_frame_ms:.4f} ms")
    note(f"dual frame, eager f32 StyleTransferNet: {dual_eager_ms:.4f} ms")
    note(f"style predictor, two styles (1, 2, 480, 960, 3): {dual_predictor_ms:.4f} ms")
    note(f"dual video loop host latency per frame ({len(lat2)} frames): "
         f"median {lat2[len(lat2) // 2] * 1e3:.4f} ms, max {lat2[-1] * 1e3:.4f} ms")
    note(f"dual: max err vs eager f32 {max(errs2_f32):.3e}, vs plain bf16 "
         f"{max(errs2_plain):.3e}; all-zero map vs single style 0 {zero_err:.3e}")
    for label, c in chunk.items():
        note(f"chunk {label}: {c['ms']:.4f} ms a frame (graph replay {c['replay_ms']:.4f} ms), "
             f"single calls {c['singles_ms']:.4f} ms (stage loop {c['raw_ms']:.4f} ms)")
    note(f"int8 frame, kernel path (stylize_prepacked_raw): {int8_frame_ms:.4f} ms "
         f"({int8_frame_ms / frame_ms:.3f} of bf16 {frame_ms:.4f} ms)")
    note(f"dual int8 frame, kernel path: {dual_int8_frame_ms:.4f} ms "
         f"({dual_int8_frame_ms / dual_frame_ms:.3f} of dual bf16 {dual_frame_ms:.4f} ms)")
    note(f"int8 chunk of {N_FRAMES}, per frame: {int8_chunk_ms:.4f} ms; calibration "
         f"(calibrate_act_scales, one frame): {calibrate_ms:.4f} ms")
    for label, r in int8_runs.items():
        lat_q = sorted(r["run"]["latency_s"])
        eb, eq, ps = r["errs"]
        note(f"{label} video loop host latency per frame ({len(lat_q)} frames): median "
             f"{lat_q[len(lat_q) // 2] * 1e3:.4f} ms, max {lat_q[-1] * 1e3:.4f} ms; vs bf16 "
             f"kernels max {max(eb):.3e}, min PSNR {min(ps):.2f} dB; vs plain int8 max "
             f"{max(eq):.3e}")
    note(f"stage kernels summed, int8: {sum(r['ms'] for r in int8_rows.values()):.4f} ms "
         f"vs bf16 {sum(r['ms'] for r in rows):.4f} ms")

    # ---- phase 5: the divider-1 plan at full width -------------------------------
    print(f"phase 5: {SPEC_1920}, the divider-1 (three_seg) plan", flush=True)
    t0 = time.perf_counter()
    model1 = make_inference_model(ShapeConfig.from_spec(SPEC_1920), seed=SEED)
    plan1 = model1.plan
    variables1 = to_flax(model1.transfer.state_dict())
    fused1 = FusedTransfer(variables1, plan1)
    names1 = [s.stage.name for s in fused1.steps]
    print(f"engine {SPEC_1920}: three_seg {fused1.three_seg}, {len(fused1.steps)} conv "
          f"stages + finish ({', '.join(names1)}), {plan1.num_style_parameters} style "
          f"params, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    if plan1.num_style_parameters != 2678 or not fused1.three_seg or len(fused1.steps) != 18:
        print(f"FAILED: {SPEC_1920} engine: style vector ABI {plan1.num_style_parameters} "
              f"(want 2678), three_seg {fused1.three_seg}, {len(fused1.steps)} stages (want 18)")
        return 1
    try:
        FusedTransfer(variables1, plan1, num_styles=2)
        failures.append(f"{SPEC_1920}: two styles accepted")
    except ValueError as exc:
        print(f"{SPEC_1920}, num_styles=2 refused: {exc}")
        if DUAL_REFUSAL not in str(exc):
            failures.append(f"{SPEC_1920}: two styles refused with another message")

    print(f"phase 5, stages: every {SPEC_1920} stage kernel vs its plain version, bf16",
          flush=True)
    rows1 = [check_stage(fused1, f"rst1920 {s.stage.name}", s) for s in fused1.steps]
    h1, w1 = plan1.input_shape[:2]
    xf1 = (torch.randn((h1, w1, 3), generator=gen, device=dev) * 2.0).to(bf16)
    fin1 = check_finish("rst1920 finish", xf1, prologue_for(xf1, 3, False, (h1, w1)))
    print(f"phase 5, stages: every {SPEC_1920} stage in int8 form (seeded scales)", flush=True)
    fused1_seeded = FusedTransfer(variables1, plan1, quant="int8",
                                  act_scales=seeded_scales(fused1))
    int8_rows1 = [check_stage(fused1_seeded, f"rst1920 {s.stage.name} int8", s)
                  for s in fused1_seeded.steps]
    for name, r, q in zip(names1, rows1, int8_rows1):
        note(f"rst1920 {name}: bf16 {r['ms']:.4f} ms, int8 {q['ms']:.4f} ms "
             f"({q['ms'] / r['ms']:.3f}), bound {max(r['ops_ms'], r['bytes_ms']):.4f} / "
             f"{max(q['ops_ms'], q['bytes_ms']):.4f} ms, F.conv2d bf16 {r['library_ms']:.4f} ms")
    if failed("phase 5, stages"):
        return 1

    print(f"phase 5, frames: {N_FRAMES} frames of {SPEC_1920} through video.stylize_video",
          flush=True)
    rng1 = np.random.default_rng(SEED + 2)
    style_image1 = rng1.random((h1, w1, 3), dtype=np.float32)
    frames1 = [rng1.random(plan1.input_shape, dtype=np.float32) for _ in range(N_FRAMES)]
    per_frame1 = {"conv_stage": len(fused1.steps), "finish": 1}
    results1 = {}
    kernels.reset_launch_counts()
    run1 = stylize_video(model1, fused1, style_image1, frames1,
                         lambda i, frame: results1.__setitem__(i, frame))
    torch.cuda.synchronize()
    launches1 = check_launches("rst1920", per_frame1, N_FRAMES + 1)  # + warm-up
    style_params1 = run1["style_params"]
    if tuple(style_params1.shape) != (1, 1, 2678) or not torch.isfinite(style_params1).all():
        failures.append("rst1920 style params")
    prepared1 = fused1.prepare_style(style_params1)
    errs1_f32, errs1_plain = check_frames("rst1920", fused1, model1.transfer, results1,
                                          frames1, style_params1, prepared1)
    if failed("phase 5, frames"):
        return 1

    print(f"phase 5, int8: calibrate on {N_CAL} frames, {N_FRAMES} frames through "
          "stylize_video(quant='int8')", flush=True)
    packs1 = torch.stack([fused1.pack_frame_np(f[None]) for f in frames1]).to(dev)
    cal_packs1 = list(packs1[:N_CAL])
    cal_kernel1 = check_calibration("rst1920", fused1, cal_packs1, prepared1)
    int8_run1 = run_int8_video("rst1920 int8", fused1, model1, style_image1, frames1, None,
                               style_params1, prepared1)
    eng_q1, prep_q1 = int8_run1["engine"], int8_run1["prep"]
    check_saturation("rst1920", fused1, cal_packs1, prepared1, style_params1,
                     int8_run1["run"]["act_scales"], cal_kernel1)
    if failed("phase 5, int8"):
        return 1

    print(f"phase 5, chunk: chunks of {N_FRAMES} {SPEC_1920} frame packs, bf16 and int8",
          flush=True)
    # two runs of the int8 chain differ where a float-atomic moment flips a
    # rounding that moves a quantized input by one int8 step: at 960x1920 two
    # replays of one graph differ by up to 10 bf16 ulps (PERF.md), so the
    # int8 chunk is held to the frame limit that holds its frames to the plain
    # int8 composition
    chunk1 = {"bf16": check_chunk("rst1920", fused1, packs1, prepared1),
              "int8": check_chunk("rst1920 int8", eng_q1, packs1, prep_q1, close_frame)}
    if failed("phase 5, chunk"):
        return 1

    packed1 = packs1[0]
    content1 = torch.from_numpy(frames1[0])[None].to(dev)
    style1 = torch.from_numpy(style_image1)[None, None].to(dev)
    with torch.no_grad():
        frame1_ms = cuda_ms(lambda: fused1.stylize_prepacked_raw(packed1, prepared1), 20)
        int8_frame1_ms = cuda_ms(lambda: eng_q1.stylize_prepacked_raw(packed1, prep_q1), 20)
        plain_frame1_ms = cuda_ms(
            lambda: fused1.stylize_prepacked_raw(packed1, prepared1, plain=True), 3)
        int8_plain_frame1_ms = cuda_ms(
            lambda: eng_q1.stylize_prepacked_raw(packed1, prep_q1, plain=True), 3)
        eager1_ms = cuda_ms(lambda: model1.transfer(content1, style_params1), 3)
        predictor1_ms = cuda_ms(lambda: model1.predict_style_params(style1), 10)
        calibrate1_ms = cuda_ms(lambda: fused1.calibrate_act_scales([packed1], prepared1), 5)
    lat1 = sorted(run1["latency_s"])
    lat1_q = sorted(int8_run1["run"]["latency_s"])
    stage1_ms = sum(r["ms"] for r in rows1)
    note(f"rst1920 frame, kernel path (stylize_prepacked_raw): bf16 {frame1_ms:.4f} ms, "
         f"int8 {int8_frame1_ms:.4f} ms ({int8_frame1_ms / frame1_ms:.3f} of bf16)")
    note(f"rst1920 stage kernels summed: bf16 {stage1_ms:.4f} ms (stem "
         f"{rows1[0]['ms'] / stage1_ms:.1%}) + finish {fin1['ms']:.4f} ms; int8 "
         f"{sum(r['ms'] for r in int8_rows1):.4f} ms (stem "
         f"{int8_rows1[0]['ms'] / sum(r['ms'] for r in int8_rows1):.1%}); 18 x F.conv2d bf16 "
         f"{sum(r['library_ms'] for r in rows1):.4f} ms")
    note(f"rst1920 frame, plain stage composition: bf16 {plain_frame1_ms:.4f} ms, int8 "
         f"{int8_plain_frame1_ms:.4f} ms; eager f32 StyleTransferNet {eager1_ms:.4f} ms")
    for label, c in chunk1.items():
        note(f"rst1920 chunk {label}: {c['ms']:.4f} ms a frame (graph replay "
             f"{c['replay_ms']:.4f} ms), single calls {c['singles_ms']:.4f} ms (stage loop "
             f"{c['raw_ms']:.4f} ms)")
    note(f"rst1920 calibration (calibrate_act_scales, one frame): {calibrate1_ms:.4f} ms")
    note(f"style predictor (MobileNetV3-Small, 960x1920): {predictor1_ms:.4f} ms")
    eb1, eq1, ps1 = int8_run1["errs"]
    note(f"rst1920 video loop host latency per frame (stylize + D2H): bf16 median "
         f"{lat1[len(lat1) // 2] * 1e3:.4f} ms, max {lat1[-1] * 1e3:.4f} ms; int8 median "
         f"{lat1_q[len(lat1_q) // 2] * 1e3:.4f} ms, max {lat1_q[-1] * 1e3:.4f} ms")
    note(f"rst1920: max err vs eager f32 {max(errs1_f32):.3e}, vs plain bf16 "
         f"{max(errs1_plain):.3e}; int8 vs bf16 kernels max {max(eb1):.3e}, min PSNR "
         f"{min(ps1):.2f} dB, vs plain int8 max {max(eq1):.3e}")
    moments1 = {r_name: r["moments_rel"] for r_name, r in zip(names1, rows1)
                if r["moments_rel"] is not None}
    note("rst1920 CIN moments, kernel vs plain, max relative difference of the sums of "
         "squares (of the sums, to the largest): "
         + ", ".join(f"{k} {v[0]:.2e} ({v[1]:.2e})" for k, v in moments1.items()))

    # ---- phase 6: the repack probe and the library yardstick of row 2 ---------
    print(f"phase 6: {REPACK_PROBE} on Hopper", flush=True)
    repack = {}
    for name, case in probe_repack.CASES.items():
        a, b = probe_repack.make_inputs(case, dev, SEED)
        fn = probe_repack.KERNELS[case.op]
        fn.launches = 0
        got = probe_repack.run(case, a, b)
        launches_r = fn.launches
        want = probe_repack.run(case, a, b, plain=True)
        lib = probe_repack.run(case, a, b, lib=True)
        torch.cuda.synchronize()
        same = got.shape == want.shape and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))
        lib_same = torch.equal(lib.view(torch.int16), want.view(torch.int16))
        ms = cuda_ms(lambda: probe_repack.run(case, a, b), 20)
        plain_ms = cuda_ms(lambda: probe_repack.run(case, a, b, plain=True), 5)
        lib_ms = cuda_ms(lambda: probe_repack.run(case, a, b, lib=True), 20)
        n_bytes = repack_work(case)
        bound, _ = bound_ms(0.0, n_bytes)
        repack[name] = dict(launches=launches_r, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound=bound, gbs=n_bytes / ms / 1e6)
        note(f"repack {name}: {case.n} x {case.in_shape} -> "
             f"{tuple(got.shape[1:])}, bit-equal to plain {'ok' if same else 'FAIL'} "
             f"(library copy {'equal' if lib_same else 'DIFFERS'}); kernel {ms:.4f} ms "
             f"({repack[name]['gbs']:.0f} GB/s, {bound / ms:.1%} of the HBM rate), plain "
             f"{plain_ms:.4f} ms, permute().contiguous() copy {lib_ms:.4f} ms, bound "
             f"{bound:.4f} ms (bytes, {n_bytes / 1e6:.1f} MB)")
        if not (same and lib_same and launches_r == 1):
            failures.append(f"repack {name}")
    frame_case = probe_repack.CASES["fold2_rst1920_c2"]
    a, _ = probe_repack.make_inputs(frame_case, dev, SEED)
    back = probe_repack.unfold2(probe_repack.fold2(a), frame_case.in_shape[2])
    torch.cuda.synchronize()
    round_trip = torch.equal(back.view(torch.int16), a.view(torch.int16))
    print(f"repack: unfold2(fold2(x)) == x on the rst1920 c2 output "
          f"{'ok' if round_trip else 'FAIL'}")
    if not round_trip:
        failures.append("repack round trip")
    if failed("phase 6, repack"):
        return 1

    hb, wb_, fb = plan.bottleneck_res_y, 2 * plan.bottleneck_res_y, plan.bottleneck_num_filters
    x_cin = torch.randn((1, fb, hb, wb_), generator=gen, device=dev).to(bf16)
    g_cin = torch.rand(fb, generator=gen, device=dev) * 0.4 + 0.8
    b_cin = torch.rand(fb, generator=gen, device=dev) * 0.4 - 0.2
    lib_cin = yardstick("F.instance_norm", lambda: F.instance_norm(x_cin, weight=g_cin,
                                                                   bias=b_cin, eps=eps))
    note(f"library yardstick, row 2: F.instance_norm bf16 (1, {fb}, {hb}, {wb_}) with a "
         f"per-channel affine: {lib_cin if isinstance(lib_cin, str) else f'{lib_cin:.4f} ms'}")

    # ---- phase 7: the packed path with conv_matmul; the shared-memory probe -----
    print(f"phase 7: the packed path (stylize_packed) with {CONV_MATMUL}", flush=True)
    t7 = time.perf_counter()
    cmm = conv_matmul.conv_valid_matmul

    def close_f32(name, got, ref) -> float:
        """JAX's f32 limit for the tap-matmul conv: rtol 1e-4 + atol 1e-4."""
        err = (got - ref).abs()
        ok = bool((err <= 1e-4 + 1e-4 * ref.abs()).all()) and bool(torch.isfinite(got).all())
        print(f"  {name}: max_abs_err={err.max().item():.3e} limit=rtol 1e-4 + atol 1e-4 "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        return err.max().item()

    def check_conv_matmul(label, padded, k, cout, dtype=bf16, epilogue="none", timed=False):
        """conv_matmul on a seeded (Hp, Wp, Cin) image against its plain
        version; timed beside its bound, the plain version and F.conv2d."""
        cin = padded[2]
        x = torch.randn(padded, generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, k, cin, cout), generator=gen, device=dev)
             * (1.0 / (k * k * cin) ** 0.5)).to(dtype)
        epi = dict(bias=torch.randn(cout, generator=gen, device=dev) * 0.1,
                   scale=torch.rand(cout, generator=gen, device=dev) + 0.5,
                   shift=torch.randn(cout, generator=gen, device=dev) * 0.1, epilogue=epilogue)
        got = cmm(x, w, **epi)
        want = conv_matmul.conv_valid_matmul_plain(x, w, **epi)
        torch.cuda.synchronize()
        print(f"conv_matmul {label}: {tuple(padded)} x {k}x{k} -> {tuple(got.shape)} "
              f"{str(dtype)[6:]} epilogue={epilogue}")
        if dtype == bf16:
            err = close(f"conv_matmul {label}", got, want, 1.6e-2, 1e-2)
        else:
            err = close_f32(f"conv_matmul {label}", got, want)
        row = dict(err=err)
        if timed:
            xp = x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ops, n_bytes = conv_matmul_work(*padded[:2], k, k, cin, cout, w.element_size())
            bound, by = bound_ms(ops, n_bytes, "bf16" if dtype == bf16 else "f32")
            row.update(ms=cuda_ms(lambda: cmm(x, w, **epi), 20),
                       plain_ms=cuda_ms(lambda: conv_matmul.conv_valid_matmul_plain(x, w, **epi), 3),
                       library_ms=cuda_ms(lambda: F.conv2d(xp, wl), 20), bound=bound, by=by)
            note(f"conv_matmul {label}: kernel {row['ms']:.4f} ms "
                 f"({ops / row['ms'] / 1e9:.1f} TFLOP/s, {bound / row['ms']:.1%} of the bound), "
                 f"plain {row['plain_ms']:.4f} ms, F.conv2d {str(dtype)[6:]} VALID "
                 f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP, "
                 f"{n_bytes / 1e6:.1f} MB)")
        return row

    # tests/test_pallas_conv.py's shapes (padded input, k, cout) and its epilogue case
    for label, padded, k, cout, epilogue in (
            ("test (12, 20, 8) k5", (16, 24, 8), 5, 6, "none"),
            ("test (16, 16, 4) k3", (18, 18, 4), 3, 6, "none"),
            ("test (8, 24, 17) k9", (16, 32, 17), 9, 6, "none"),
            ("test contract (10, 12, 4) k3", (10, 12, 4), 3, 6, "contract"),
            ("test bias, cout 7", (14, 18, 5), 3, 7, "bias")):
        check_conv_matmul(label, padded, k, cout, epilogue=epilogue)
    xs = torch.randn((2, 12, 16, 5), generator=gen, device=dev).to(bf16)
    ws = (torch.randn((3, 3, 5, 7), generator=gen, device=dev) * 0.2).to(bf16)
    got_same = conv_matmul.conv_same_batched(xs, ws)
    xs_pad = F.pad(xs, (0, 0, 1, 1, 1, 1))
    close("conv_same_batched (2, 12, 16, 5) k3 -> 7", got_same,
          torch.stack([conv_matmul.conv_valid_matmul_plain(xs_pad[i], ws) for i in range(2)]),
          1.6e-2, 1e-2)
    launch_rows = {}
    for label, spec_plan in (("rst960", plan), ("rst1920", plan1)):
        for seam, shape in conv_matmul_launches(spec_plan).items():
            hp, wp, k, _, cin, cout = shape
            launch_rows[f"{label} {seam}"] = check_conv_matmul(
                f"{label} packed {seam}", (hp, wp, cin), k, cout,
                epilogue="contract" if seam == "stem" else "none", timed=True)
    hp, wp, k, _, cin, cout = conv_matmul_launches(plan)["final"]
    f32_row = check_conv_matmul("rst960 packed final, f32", (hp, wp, cin), k, cout,
                                dtype=f32, timed=True)
    if failed("phase 7, conv_matmul"):
        return 1

    def check_packed_frames(label, engine, net, results, frames, sp, weights_t=None,
                            fused_engine=None, fused_prep=None):
        """Each packed frame against the eager f32 net, the packed path with
        conv_matmul's plain version and, where given, the fused kernel path."""
        oh, ow, _ = engine.plan.output_shape
        if sorted(results) != list(range(len(frames))):
            failures.append(f"{label} frames delivered")
        errs = {"f32": [], "plain": [], "fused": []}
        with torch.no_grad():
            for i, frame in enumerate(frames):
                got = torch.from_numpy(results[i]).to(dev)
                if tuple(got.shape) != (oh, ow, 3) or not bool(torch.isfinite(got).all()):
                    failures.append(f"{label} frame {i} shape/finite")
                    continue
                content = torch.from_numpy(frame)[None].to(dev)
                want32 = net(content, sp, weights_t)[0]
                e32 = (got - want32).abs()
                ok32 = bool((e32 <= 0.03 + 0.08 * want32.abs()).all())
                refs = [("plain", engine(content, sp, weights_t, conv_backend="pallas",
                                         plain=True)[0])]
                if fused_engine is not None:
                    refs.append(("fused", fused_engine.stylize_prepacked(
                        fused_engine.pack_frame_np(frame[None]), fused_prep)[0]))
                errs["f32"].append(e32.max().item())
                line = (f"  {label} frame {i}: vs eager f32 max {e32.max().item():.3e} "
                        f"{'ok' if ok32 else 'FAIL'}")
                ok = ok32
                for name, ref in refs:
                    e = (got - ref).abs()
                    okr = bool((e <= 0.02 + 0.05 * ref.abs()).all()) and e.median().item() < 5e-3
                    errs[name].append(e.max().item())
                    line += (f"; vs {name} max {e.max().item():.3e} median "
                             f"{e.median().item():.3e} {'ok' if okr else 'FAIL'}")
                    ok = ok and okr
                print(line, flush=True)
                if not ok:
                    failures.append(f"{label} frame {i}")
        return errs

    def run_packed_video(label, mdl, engine, styles_in, frs, weights_map=None):
        """``stylize_video`` on the packed engine with conv_matmul: 2 launches
        a frame (the stem and the final conv), the warm-up frame included."""
        res = {}
        cmm.launches = 0
        kernels.reset_launch_counts()
        run_p = stylize_video(mdl, engine, styles_in, frs, lambda i, fr: res.__setitem__(i, fr),
                              style_weights=weights_map, conv_backend="pallas")
        torch.cuda.synchronize()
        counts = {"conv_matmul": cmm.launches, "conv_stage": kernels.conv_stage.launches,
                  "finish": kernels.finish.launches}
        want = {"conv_matmul": 2 * (len(frs) + 1), "conv_stage": 0, "finish": 0}
        print(f"{label} launches: {counts}, expected {want} ({len(frs)} frames and a warm-up, "
              f"2 conv_matmul a frame)")
        if counts != want:
            failures.append(f"{label} launch counts")
        return run_p, res, counts["conv_matmul"]

    packed_engine = PackedTransfer(variables, plan)
    run_ps, res_ps, launches_ps = run_packed_video("packed", model, packed_engine, style_image,
                                                   frames)
    sp_ps = run_ps["style_params"]
    errs_ps = check_packed_frames("packed", packed_engine, model.transfer, res_ps, frames, sp_ps,
                                  fused_engine=fused, fused_prep=fused.prepare_style(sp_ps))
    packed_engine2 = PackedTransfer(variables2, plan, num_styles=2)
    run_pd, res_pd, launches_pd = run_packed_video("packed dual", model2, packed_engine2,
                                                   style_images, frames2, ramp)
    sp_pd = run_pd["style_params"]
    errs_pd = check_packed_frames("packed dual", packed_engine2, model2.transfer, res_pd, frames2,
                                  sp_pd, ramp_t, fused2, fused2.prepare_style(sp_pd, ramp_t))
    if failed("phase 7, flagship packed frames"):
        return 1

    print(f"phase 7, {SPEC_1920} with two styles: choose_path and the packed path", flush=True)
    cfg12 = ShapeConfig.from_spec(SPEC_1920, num_styles=2)
    model12 = make_inference_model(cfg12, seed=SEED)
    variables12 = to_flax(model12.transfer.state_dict())
    path12 = choose_path(cfg12, plan1, dev)
    print(f"{SPEC_1920}, two styles: choose_path -> {path12!r} (want 'packed'); "
          f"single style -> {choose_path(ShapeConfig.from_spec(SPEC_1920), plan1, dev)!r}")
    if path12 != "packed" or choose_path(cfg, plan, dev) != "fused":
        failures.append("choose_path")
    try:
        FusedTransfer(variables12, plan1, num_styles=2)
        failures.append(f"{SPEC_1920}: FusedTransfer accepted two styles")
    except ValueError as exc:
        print(f"  FusedTransfer refuses it: {exc}")
        if DUAL_REFUSAL not in str(exc):
            failures.append(f"{SPEC_1920}: two styles refused with another message")
    packed12 = PackedTransfer(variables12, plan1, num_styles=2)
    rng12 = np.random.default_rng(SEED + 3)
    styles12 = [rng12.random((h1, w1, 3), dtype=np.float32) for _ in range(2)]
    frames12 = [rng12.random(plan1.input_shape, dtype=np.float32) for _ in range(N_FRAMES)]
    ramp12 = np.broadcast_to(np.linspace(0, 1, h1, dtype=np.float32)[:, None, None],
                             (h1, w1, 1)).copy()
    ramp12_t = torch.from_numpy(ramp12)[None].to(dev)
    run_p12, res_p12, launches_p12 = run_packed_video("rst1920 dual packed", model12, packed12,
                                                      styles12, frames12, ramp12)
    sp12 = run_p12["style_params"]
    if tuple(sp12.shape) != (1, 2, 2678) or not torch.isfinite(sp12).all():
        failures.append("rst1920 dual style params")
    errs_p12 = check_packed_frames("rst1920 dual packed", packed12, model12.transfer, res_p12,
                                   frames12, sp12, ramp12_t)
    if failed("phase 7, rst1920 dual"):
        return 1

    content_p = torch.from_numpy(frames[0])[None].to(dev)
    content_p2 = torch.from_numpy(frames2[0])[None].to(dev)
    content_p12 = torch.from_numpy(frames12[0])[None].to(dev)
    packed_p = fused.pack_frame_np(frames[0][None]).to(dev)
    packed_p2 = fused2.pack_frame_np(frames2[0][None]).to(dev)
    prep_ps, prep_pd = fused.prepare_style(sp_ps), fused2.prepare_style(sp_pd, ramp_t)
    with torch.no_grad():
        frame_times = {
            "packed pallas": cuda_ms(lambda: packed_engine(content_p, sp_ps,
                                                           conv_backend="pallas"), 10),
            "packed xla": cuda_ms(lambda: packed_engine(content_p, sp_ps, conv_backend="xla"), 10),
            "fused": cuda_ms(lambda: fused.stylize_prepacked(packed_p, prep_ps), 10),
            "dual packed pallas": cuda_ms(lambda: packed_engine2(
                content_p2, sp_pd, ramp_t, conv_backend="pallas"), 10),
            "dual packed xla": cuda_ms(lambda: packed_engine2(
                content_p2, sp_pd, ramp_t, conv_backend="xla"), 10),
            "dual fused": cuda_ms(lambda: fused2.stylize_prepacked(packed_p2, prep_pd), 10),
            "rst1920 dual packed pallas": cuda_ms(lambda: packed12(
                content_p12, sp12, ramp12_t, conv_backend="pallas"), 5),
            "rst1920 dual packed xla": cuda_ms(lambda: packed12(
                content_p12, sp12, ramp12_t, conv_backend="xla"), 5),
            "rst1920 dual packed plain": cuda_ms(lambda: packed12(
                content_p12, sp12, ramp12_t, conv_backend="pallas", plain=True), 2),
        }
    for label, ms_ in frame_times.items():
        note(f"frame, {label} ({'fused stylize_prepacked, pack on the card' if 'fused' in label else 'PackedTransfer, content in, (1, H, W, 3) f32 out'}): "
             f"{ms_:.4f} ms")
    def device_share(fn, n=5):
        """torch.profiler over n calls of ``fn``: (CUDA activities, their
        summed device time, the host wall time with the profiler on) in ms,
        or the reason it measured nothing."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        except (RuntimeError, AttributeError) as exc:  # a measurement, not a check
            return f"not measured: {str(exc)[:120]}"
        if not acts:
            return "not measured: the profiler recorded no device activity"
        busy = sum(e.time_range.elapsed_us() for e in acts) / 1e3
        return dict(activities=len(acts) / n, busy_ms=busy / n, wall_ms=wall / n,
                    idle_share=1.0 - busy / wall)

    with torch.no_grad():
        profiles = {
            "packed pallas": device_share(lambda: packed_engine(content_p, sp_ps,
                                                                conv_backend="pallas")),
            "fused": device_share(lambda: fused.stylize_prepacked(packed_p, prep_ps)),
            "rst1920 dual packed pallas": device_share(lambda: packed12(
                content_p12, sp12, ramp12_t, conv_backend="pallas")),
        }
    for label, prof_ in profiles.items():
        if isinstance(prof_, str):
            note(f"profile, {label}: {prof_}")
        else:
            note(f"profile, {label} (torch.profiler on, 5 frames): {prof_['activities']:.0f} "
                 f"device activities a frame, device busy {prof_['busy_ms']:.4f} ms of "
                 f"{prof_['wall_ms']:.4f} ms host wall: idle share {prof_['idle_share']:.1%}")
    for label, run_ in (("packed", run_ps), ("dual packed", run_pd), ("rst1920 dual packed", run_p12)):
        lat_ = sorted(run_["latency_s"])
        note(f"{label} video loop host latency per frame ({len(lat_)} frames, conv_backend "
             f"'pallas'): median {lat_[len(lat_) // 2] * 1e3:.4f} ms, max {lat_[-1] * 1e3:.4f} ms")
    note("packed frames: max err vs eager f32 / packed plain / fused: "
         + "; ".join(f"{label} {max(e['f32']):.3e} / {max(e['plain']):.3e} / "
                     f"{max(e['fused']) if e['fused'] else float('nan'):.3e}"
                     for label, e in (("single", errs_ps), ("dual", errs_pd),
                                      ("rst1920 dual", errs_p12))))

    print("phase 7, probe: Hopper's opt-in dynamic shared memory a block "
          f"({SMEM_PROBE} on Hopper)", flush=True)
    first = probe_smem.try_alloc(48 * 1024, dev)
    optin = first["optin"]
    sizes = probe_smem.sweep_bytes(optin)
    probe_smem.try_alloc.launches = probe_smem.work.launches = 0
    smem_rows = []
    for nb in sizes:
        r = probe_smem.try_alloc(nb, dev)
        want_ok = nb <= optin
        good = r["alloc_ok"] == want_ok and (want_ok or r["error"] != 0)
        smem_rows.append(r)
        note(f"smem probe (a) {nb} bytes ({nb / 1024:.0f} KB): alloc_ok {r['alloc_ok']}, "
             f"{r['blocks_per_sm']} blocks/SM, CUDA error {r['error']} "
             f"(expected {'to run' if want_ok else 'a refusal'}) {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(f"smem probe alloc {nb}")
    xw, ww = probe_smem.make_work_inputs(dev, SEED)
    work_rows = []
    for nb in [0] + sizes[:-1]:
        got = probe_smem.work(xw, ww, probe_smem.REPS[0], nb)
        bps = probe_smem.work.blocks_per_sm
        want = probe_smem.work_plain(xw, ww, probe_smem.REPS[0])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = err <= 1e-3 * want.abs().max().item()
        t_lo = cuda_ms(lambda: probe_smem.work(xw, ww, probe_smem.REPS[0], nb), 20)
        t_hi = cuda_ms(lambda: probe_smem.work(xw, ww, probe_smem.REPS[1], nb), 20)
        slope = (t_hi - t_lo) / (probe_smem.REPS[1] - probe_smem.REPS[0])
        work_rows.append(dict(bytes=nb, blocks_per_sm=bps, err=err, ms_lo=t_lo, ms_hi=t_hi,
                              slope_ms=slope))
        note(f"smem probe (b) {nb / 1024:.0f} KB reserved: {bps} blocks/SM, x{probe_smem.REPS[0]} "
             f"{t_lo:.4f} ms, x{probe_smem.REPS[1]} {t_hi:.4f} ms, slope {slope * 1e3:.3f} us a "
             f"repetition; max_abs_err {err:.3e} (limit 1e-3 x max) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"smem probe work {nb}")
    work_plain_ms = cuda_ms(lambda: probe_smem.work_plain(xw, ww, probe_smem.REPS[1]), 5)
    ops_w, bytes_w = smem_work(probe_smem.REPS[1])
    bound_w, by_w = bound_ms(ops_w, bytes_w)
    base = work_rows[0]
    note(f"smem probe (b): the slowest reservation takes "
         f"{max(r['ms_hi'] for r in work_rows) / base['ms_hi']:.3f}x the unreserved x"
         f"{probe_smem.REPS[1]} launch; the bound of one x{probe_smem.REPS[1]} launch "
         f"{bound_w:.4f} ms ({by_w}), plain f32 {work_plain_ms:.4f} ms")
    if failed("phase 7, probe"):
        return 1
    note(f"phase 7 total: {time.perf_counter() - t7:.1f} s")

    # ---- the kernel table -------------------------------------------------------
    def dual_sum(key):
        """A frame's conv_stage total in dual form: the prologue stages' dual
        figures, the others' single-style ones (they take no prologue)."""
        return sum(dual_rows.get(i, r)[key] for i, r in enumerate(rows))

    def bound_sum(rs):
        return sum(max(r["ops_ms"], r["bytes_ms"]) for r in rs)

    def bound_by(rs):
        ops = sum(r["ops_ms"] for r in rs)
        return "operations" if ops >= sum(r["bytes_ms"] for r in rs) else "bytes"

    def rst1920(rs, prefix="rst1920_"):
        return {f"{prefix}max_abs_err": max(r["err"] for r in rs),
                f"{prefix}ms": sum(r["ms"] for r in rs),
                f"{prefix}plain_ms": sum(r["plain_ms"] for r in rs),
                f"{prefix}bound_ms": bound_sum(rs), f"{prefix}bound_by": bound_by(rs)}

    def conv_matmul_entry():
        """One rst960 packed frame's two launches (stem + final), and each
        launch of both plans."""
        pair = [launch_rows["rst960 stem"], launch_rows["rst960 final"]]
        pair1 = [launch_rows["rst1920 stem"], launch_rows["rst1920 final"]]
        return {"name": "conv_matmul", "route": "cuda", "source": f"{SOURCES}/conv_matmul.cu",
                "replaces": f"{CONV_MATMUL}:40", "launches": launches_ps,
                "max_abs_err": max(r["err"] for r in launch_rows.values()),
                "ms": sum(r["ms"] for r in pair), "plain_ms": sum(r["plain_ms"] for r in pair),
                "bound_ms": sum(r["bound"] for r in pair), "bound_by": "operations",
                "library_ms": sum(r["library_ms"] for r in pair),
                "per": "one rst960 packed frame: the stem and the final conv",
                "library_note": "F.conv2d bf16 VALID on the same padded input",
                "dual_launches": launches_pd, "rst1920_dual_launches": launches_p12,
                "rst1920_ms": sum(r["ms"] for r in pair1),
                "rst1920_plain_ms": sum(r["plain_ms"] for r in pair1),
                "rst1920_bound_ms": sum(r["bound"] for r in pair1),
                "rst1920_library_ms": sum(r["library_ms"] for r in pair1),
                "f32_max_abs_err": f32_row["err"], "f32_ms": f32_row["ms"],
                "launch_rows": launch_rows, "frame_ms": frame_times,
                "frame_profile": profiles}

    stats_rows = [r["stats"] for r in int8_rows.values()]
    stats_rows1 = [r["stats"] for r in int8_rows1]

    def probe_entry(arm, line):
        q, b = probe[(arm, "int8")], probe[(arm, "bf16")]
        return {"name": f"probe_int8_{arm}", "route": "cuda",
                "source": f"{SOURCES}/probe_int8.cu", "replaces": f"{PROBE}:{line}",
                "launches": q["launches"], "max_abs_err": q["err"], "ms": q["ms"],
                "plain_ms": q["plain_ms"], "bound_ms": q["bound"], "bound_by": q["by"],
                "library_ms": (lib_probe * probe_int8.NREP if isinstance(lib_probe, float)
                               else None) if arm == "mm" else None,
                "library_note": ("torch._int_mm of one product x nrep" if arm == "mm"
                                 else "no library call computes the band pattern"),
                "tops": q["tops"], "bf16_launches": b["launches"], "bf16_max_abs_err": b["err"],
                "bf16_ms": b["ms"], "bf16_plain_ms": b["plain_ms"], "bf16_bound_ms": b["bound"],
                "bf16_tops": b["tops"], "int8_bf16_ratio": probe[(arm, "ratio")]}
    table = {"kernels": [
        dict({"name": "conv_stage", "route": "cuda", "source": f"{SOURCES}/conv_stage.cu",
              "replaces": f"{TPU_KERNEL}:936", "launches": launches["conv_stage"],
              "max_abs_err": max([r["err"] for r in rows] + [extra["err"]]),
              "ms": sum(r["ms"] for r in rows),
              "plain_ms": sum(r["plain_ms"] for r in rows),
              "bound_ms": bound_sum(rows), "bound_by": bound_by(rows),
              "library_ms": sum(r["library_ms"] for r in rows),
              "dual_launches": launches2["conv_stage"],
              "dual_max_abs_err": max([r["err"] for r in dual_rows.values()]
                                      + [dual_extra["err"]]),
              "dual_ms": dual_sum("ms"), "dual_plain_ms": dual_sum("plain_ms"),
              "dual_bound_ms": bound_sum(dual_rows.get(i, r) for i, r in enumerate(rows)),
              "chunk_captured": chunk["single"]["captured"]["conv_stage"],
              "int8_launches": int8_runs["int8"]["launches"]["conv_stage"],
              "int8_max_abs_err": max(r["err"] for r in int8_rows.values()),
              "int8_ms": sum(r["ms"] for r in int8_rows.values()),
              "int8_plain_ms": sum(r["plain_ms"] for r in int8_rows.values()),
              "int8_bound_ms": bound_sum(int8_rows.values()),
              "int8_library_ms": lib_res if isinstance(lib_res, float) else None,
              "int8_library_note": ("torch._int_mm on one residual conv's im2col GEMM "
                                    "(28800 x 1152 x 128), im2col left out"
                                    if isinstance(lib_res, float) else lib_res),
              "int8_res_ms": int8_rows[4]["ms"],
              "dual_int8_launches": int8_runs["dual int8"]["launches"]["conv_stage"],
              "dual_int8_max_abs_err": max(r["err"] for r in int8_dual_rows.values()),
              "dual_int8_ms": sum(int8_dual_rows.get(i, r)["ms"] for i, r in int8_rows.items()),
              "int8_chunk_captured": chunk["int8"]["captured"]["conv_stage"],
              "rst1920_launches": launches1["conv_stage"],
              "rst1920_library_ms": sum(r["library_ms"] for r in rows1),
              "rst1920_frame_ms": frame1_ms,
              "rst1920_chunk_captured": chunk1["bf16"]["captured"]["conv_stage"],
              "rst1920_int8_launches": int8_run1["launches"]["conv_stage"],
              "rst1920_int8_library_ms": lib_res if isinstance(lib_res, float) else None,
              "rst1920_int8_frame_ms": int8_frame1_ms,
              "rst1920_int8_chunk_captured": chunk1["int8"]["captured"]["conv_stage"]},
             **rst1920(rows1), **rst1920(int8_rows1, "rst1920_int8_")),
        {"name": "finish", "route": "cuda", "source": f"{SOURCES}/finish.cu",
         "replaces": f"{TPU_KERNEL}:1601", "launches": launches["finish"],
         "max_abs_err": fin["err"], "ms": fin["ms"], "plain_ms": fin["plain_ms"],
         "bound_ms": max(fin["bytes_ms"], fin["ops_ms"]),
         "bound_by": "bytes" if fin["bytes_ms"] >= fin["ops_ms"] else "operations",
         "library_ms": None,
         "dual_launches": launches2["finish"], "dual_max_abs_err": fin_dual["err"],
         "dual_ms": fin_dual["ms"], "dual_plain_ms": fin_dual["plain_ms"],
         "dual_bound_ms": max(fin_dual["bytes_ms"], fin_dual["ops_ms"]),
         "chunk_captured": chunk["single"]["captured"]["finish"],
         "rst1920_launches": launches1["finish"], "rst1920_max_abs_err": fin1["err"],
         "rst1920_ms": fin1["ms"], "rst1920_plain_ms": fin1["plain_ms"],
         "rst1920_bound_ms": max(fin1["bytes_ms"], fin1["ops_ms"]),
         "rst1920_library_ms": None,
         "rst1920_int8_launches": int8_run1["launches"]["finish"]},
        dict({"name": "act_stats", "route": "cuda", "source": f"{SOURCES}/act_stats.cu",
              "replaces": f"{TPU_KERNEL}:929",
              "launches": int8_runs["int8"]["launches"]["act_stats"],
              "max_abs_err": max(r["err"] for r in stats_rows),
              "ms": sum(r["ms"] for r in stats_rows),
              "plain_ms": sum(r["plain_ms"] for r in stats_rows),
              "bound_ms": bound_sum(stats_rows), "bound_by": bound_by(stats_rows),
              "library_ms": None, "per": "one frame: 16 launches (18 at rst1920), check mode",
              "calibrate_frame_ms": calibrate_ms,
              "dual_launches": int8_runs["dual int8"]["launches"]["act_stats"],
              "rst1920_launches": int8_run1["launches"]["act_stats"],
              "rst1920_library_ms": None, "rst1920_calibrate_frame_ms": calibrate1_ms},
             **rst1920(stats_rows1)),
        probe_entry("mm", 57),
        probe_entry("band", 139),
        {"name": "probe_repack", "route": "cuda", "source": f"{SOURCES}/probe_repack.cu",
         "replaces": f"{REPACK_PROBE}:78",
         "launches": sum(r["launches"] for r in repack.values()), "max_abs_err": 0.0,
         "ms": sum(r["ms"] for r in repack.values()),
         "plain_ms": sum(r["plain_ms"] for r in repack.values()),
         "bound_ms": sum(r["bound"] for r in repack.values()), "bound_by": "bytes",
         "library_ms": sum(r["library_ms"] for r in repack.values()),
         "library_note": "one view().permute().contiguous() copy a case (torch.stack for "
                         "interleave, F.pad after the copy for unfold2's zero lanes)",
         "cases": repack},
        conv_matmul_entry(),
        {"name": "probe_smem", "route": "cuda", "source": f"{SOURCES}/probe_smem.cu",
         "replaces": f"{SMEM_PROBE}:73",
         "launches": probe_smem.try_alloc.launches + probe_smem.work.launches,
         "max_abs_err": max(r["err"] for r in work_rows), "ms": base["ms_hi"],
         "plain_ms": work_plain_ms, "bound_ms": bound_w, "bound_by": by_w, "library_ms": None,
         "per": f"one x{probe_smem.REPS[1]} work launch, no reservation",
         "library_note": "no one PyTorch call computes the repeated tap sum",
         "optin_bytes": optin, "alloc": smem_rows, "work": work_rows,
         "also_replaces": f"{SMEM_PROBE}:119"},
    ]}
    note(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
