#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (needs one CUDA device).

Run from the repository root: ``python3 chip_smoke.py``.

1. Builds the CUDA kernels (``nvcc``, one process per source) and prints the
   build time and the ptxas report.
2. Holds every stage kernel of the rst-960-120-128-17 frame against its plain
   PyTorch version on the card, on seeded inputs at the stage's real shapes:
   bf16 outputs within rtol 1.6e-2 (two bf16 ulps) + atol 1e-2 * max|ref|,
   moment sums within rtol 1e-3 + atol 1e-3 * max|ref| (the two sides share
   their rounding points and differ only in summation order).  Times each
   kernel, its plain version and one library ``F.conv2d`` in bf16 on the same
   input, with CUDA events.
3. Drives the main path: seeded full-width weights from the port's own
   initialisers, ``predict_style_params`` on a seeded 480x960 style image,
   ``prepare_style``, then 8 seeded frames through ``video.stylize_video``
   (prefetcher + ``stylize_prepacked``).  Every frame is compared with the
   eager f32 ``StyleTransferNet`` (TF32 off; rtol 0.08, atol 0.03) and with the
   plain bf16 stage composition (rtol 0.05, atol 0.02, median < 5e-3), and the
   launch counters must show every stage kernel launched for every frame.
4. Prints per-frame times of the kernel path and the plain paths, and the
   predictor's time, each beside the card's name and power limit.

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
N_FRAMES = 8
SEED = 0
TPU_KERNEL = "realtime_style_transfer_tpu/ops/pallas/fused_transfer.py"
SOURCES = "realtime_style_transfer_torch/csrc"


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
    from realtime_style_transfer_torch.ops import kernels
    from realtime_style_transfer_torch.ops.bounds import bound_ms, conv_stage_work
    from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
    from realtime_style_transfer_torch.ops.kernels import (
        Prologue, conv_stage, conv_stage_plain, finish, finish_plain, unpack_frame)
    from realtime_style_transfer_torch.video import stylize_video
    from realtime_style_transfer_torch.weights import to_flax

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(f"card: {gpu}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    failures = []

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

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    reports = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'cached'}",
          flush=True)
    for source, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
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
    rows = []

    def prologue_for(x, cin, relu):
        xf = x.float().reshape(-1, cin)
        stats = torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous()
        scale = torch.rand(cin, generator=gen, device=dev) * 0.4 + 0.8
        bias = torch.rand(cin, generator=gen, device=dev) * 0.4 - 0.2
        return Prologue(stats, float(xf.shape[0]), scale, bias, eps, relu)

    def check_stage(label, step, relu_override=None):
        st = step.stage
        if st.pack_c:
            x = fused.pack_frame(torch.rand((1,) + plan.input_shape, generator=gen, device=dev))
        else:
            x = torch.rand(st.in_shape, generator=gen, device=dev).to(bf16)
        relu = step.in_relu if relu_override is None else relu_override
        pro = prologue_for(x, st.cin, relu) if step.src >= 0 else None
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
              f"prologue={'affine' if pro else 'none'}{'+relu' if relu and pro else ''}"
              f"{'+skip_in' if skip_in is not None else ''}"
              f"{'+skip_out' if step.skip_out is not None else ''}"
              f"{'+moments' if step.slot >= 0 else ''}")
        (ko, ks, kst), (po, ps, pst) = outs["kernel"], outs["plain"]
        err = close(f"{label} out", ko, po, 1.6e-2, 1e-2)
        if ks is not None:
            err = max(err, close(f"{label} skip_out", ks, ps, 1.6e-2, 1e-2))
        if kst is not None:
            close(f"{label} sums", kst[0], pst[0], 1e-3, 1e-3)
            close(f"{label} sums of squares", kst[1], pst[1], 1e-3, 1e-3)

        scratch = torch.zeros((2, st.c_log), dtype=f32, device=dev) if step.slot >= 0 else None
        skip_scratch = torch.empty(st.in_shape, dtype=bf16, device=dev) \
            if step.skip_out is not None else None
        out = torch.empty(st.out_shape, dtype=bf16, device=dev)
        kernel_ms = cuda_ms(lambda: conv_stage(x, st, out, skip_out=skip_scratch,
                                               stats_out=scratch, **kw), 20)
        plain_ms = cuda_ms(lambda: conv_stage_plain(x, st, out, skip_out=skip_scratch,
                                                    stats_out=scratch, **kw), 3)
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
                                         skip_out=step.skip_out is not None)
        ops_ms, _ = bound_ms(flops, 0.0)
        bytes_ms, _ = bound_ms(0.0, n_bytes)
        note(f"{label}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"F.conv2d bf16 {library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
             f"({'operations' if ops_ms >= bytes_ms else 'bytes'}; {flops / 1e9:.2f} GFLOP, "
             f"{n_bytes / 1e6:.1f} MB)")
        return dict(err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    ops_ms=ops_ms, bytes_ms=bytes_ms)

    print("phase 2: stage kernels vs plain versions", flush=True)
    for step in fused.steps:
        rows.append(check_stage(step.stage.name, step))
    res2a = next(s for s in fused.steps if s.stage.name == "res2a")
    extra = check_stage("res2a with affine+relu+skip", res2a, relu_override=True)

    h, w = plan.input_shape[:2]
    xf = (torch.randn((h, w, 3), generator=gen, device=dev) * 2.0).to(bf16)
    pro = prologue_for(xf, 3, False)
    fin = {}
    for side, fn in (("kernel", finish), ("plain", finish_plain)):
        fin[side] = torch.empty((h // 4, w // 4, 128), dtype=bf16, device=dev)
        fn(xf, pro, fin[side])
    torch.cuda.synchronize()
    print(f"finish: in {tuple(xf.shape)} -> out {tuple(fin['kernel'].shape)}")
    fin_err = close("finish out", fin["kernel"], fin["plain"], 1.6e-2, 1e-2)
    scratch = torch.empty_like(fin["kernel"])
    fin_ms = cuda_ms(lambda: finish(xf, pro, scratch), 50)
    fin_plain_ms = cuda_ms(lambda: finish_plain(xf, pro, scratch), 10)
    fin_bytes_ms, _ = bound_ms(0.0, (xf.numel() + scratch.numel()) * 2)
    fin_ops_ms, _ = bound_ms(4 * xf.numel(), 0.0, "f32")  # mul, add, exp, divide
    note(f"finish: kernel {fin_ms:.4f} ms, plain {fin_plain_ms:.4f} ms, bound "
         f"{max(fin_bytes_ms, fin_ops_ms):.4f} ms (bytes)")
    if failures:
        print(f"FAILED phase 2: {failures}")
        return 1

    # ---- phase 3: the main path --------------------------------------------
    print(f"phase 3: {N_FRAMES} frames of {SPEC} through video.stylize_video", flush=True)
    rng = np.random.default_rng(SEED)
    style_image = rng.random((h, w, 3), dtype=np.float32)
    frames = [rng.random(plan.input_shape, dtype=np.float32) for _ in range(N_FRAMES)]
    results = {}
    kernels.reset_launch_counts()
    run = stylize_video(model, fused, style_image, frames,
                        lambda i, frame: results.__setitem__(i, frame))
    torch.cuda.synchronize()
    launches = {"conv_stage": kernels.conv_stage.launches, "finish": kernels.finish.launches}
    per_frame = {"conv_stage": len(fused.steps), "finish": 1}
    want_launches = {k: v * (N_FRAMES + 1) for k, v in per_frame.items()}  # + warm-up
    print(f"launches: {launches}, expected {want_launches} "
          f"({N_FRAMES} frames + 1 warm-up, {per_frame} per frame)")
    if launches != want_launches:
        failures.append("launch counts")
    style_params = run["style_params"]
    if tuple(style_params.shape) != (1, 1, 2662) or not torch.isfinite(style_params).all():
        failures.append("style params")
    if sorted(results) != list(range(N_FRAMES)):
        failures.append("frames delivered")
    prepared = fused.prepare_style(style_params)
    errs_f32, errs_plain = [], []
    with torch.no_grad():
        for i, frame in enumerate(frames):
            got = torch.from_numpy(results[i]).to(dev)
            if tuple(got.shape) != (h, w, 3) or not bool(torch.isfinite(got).all()):
                failures.append(f"frame {i} shape/finite")
                continue
            content = torch.from_numpy(frame)[None].to(dev)
            want32 = model.transfer(content, style_params)[0]
            raw = fused.stylize_prepacked_raw(fused.pack_frame_np(frame[None]), prepared,
                                              plain=True)
            want_bf = unpack_frame(raw, 3).float()
            e32 = (got - want32).abs()
            ebf = (got - want_bf).abs()
            ok32 = bool((e32 <= 0.03 + 0.08 * want32.abs()).all())
            okbf = bool((ebf <= 0.02 + 0.05 * want_bf.abs()).all()) and ebf.median().item() < 5e-3
            errs_f32.append(e32.max().item())
            errs_plain.append(ebf.max().item())
            print(f"  frame {i}: vs eager f32 max {e32.max().item():.3e} median "
                  f"{e32.median().item():.3e} {'ok' if ok32 else 'FAIL'}; vs plain bf16 "
                  f"max {ebf.max().item():.3e} median {ebf.median().item():.3e} "
                  f"{'ok' if okbf else 'FAIL'}", flush=True)
            if not (ok32 and okbf):
                failures.append(f"frame {i}")
    if failures:
        print(f"FAILED phase 3: {failures}")
        return 1

    # ---- phase 4: end-to-end times -------------------------------------------
    packed = fused.pack_frame_np(frames[0][None]).to(dev)
    content = torch.from_numpy(frames[0])[None].to(dev)
    style = torch.from_numpy(style_image)[None, None].to(dev)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: fused.stylize_prepacked_raw(packed, prepared), 20)
        plain_frame_ms = cuda_ms(
            lambda: fused.stylize_prepacked_raw(packed, prepared, plain=True), 3)
        eager_ms = cuda_ms(lambda: model.transfer(content, style_params), 3)
        predictor_ms = cuda_ms(lambda: model.predict_style_params(style), 10)
    lat = sorted(run["latency_s"])
    note(f"frame, kernel path (stylize_prepacked_raw): {frame_ms:.4f} ms")
    note(f"frame, plain bf16 stage composition: {plain_frame_ms:.4f} ms")
    note(f"frame, eager f32 StyleTransferNet: {eager_ms:.4f} ms")
    note(f"style predictor (MobileNetV3-Small, 480x960): {predictor_ms:.4f} ms")
    note(f"video loop host latency per frame (stylize + D2H, {len(lat)} frames): "
         f"median {lat[len(lat) // 2] * 1e3:.4f} ms, max {lat[-1] * 1e3:.4f} ms")
    note(f"stage kernels summed: {sum(r['ms'] for r in rows):.4f} ms; "
         f"max err vs eager f32 {max(errs_f32):.3e}, vs plain bf16 {max(errs_plain):.3e}")

    ops_sum = sum(r["ops_ms"] for r in rows)
    bytes_sum = sum(r["bytes_ms"] for r in rows)
    table = {"kernels": [
        {"name": "conv_stage", "route": "cuda", "source": f"{SOURCES}/conv_stage.cu",
         "replaces": f"{TPU_KERNEL}:936", "launches": launches["conv_stage"],
         "max_abs_err": max([r["err"] for r in rows] + [extra["err"]]),
         "ms": sum(r["ms"] for r in rows),
         "plain_ms": sum(r["plain_ms"] for r in rows),
         "bound_ms": sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows),
         "bound_by": "operations" if ops_sum >= bytes_sum else "bytes",
         "library_ms": sum(r["library_ms"] for r in rows)},
        {"name": "finish", "route": "cuda", "source": f"{SOURCES}/finish.cu",
         "replaces": f"{TPU_KERNEL}:1601", "launches": launches["finish"],
         "max_abs_err": fin_err, "ms": fin_ms, "plain_ms": fin_plain_ms,
         "bound_ms": max(fin_bytes_ms, fin_ops_ms),
         "bound_by": "bytes" if fin_bytes_ms >= fin_ops_ms else "operations",
         "library_ms": None},
    ]}
    print(json.dumps(table))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
