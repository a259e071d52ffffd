"""Stream frames from disk through the transfer net and write a video.

Port of ``predict_video_using_checkpoint.py``: the style params are computed
once and stay on the card; each frame is decoded (a G-buffer set of EXRs
through the native loader, or an image), stylized by the chosen engine and
written.  Encoding uses an ffmpeg pipe when ``ffmpeg`` is found and the
output has a suffix; otherwise the frames are written as a PNG sequence (into
the output path without its suffix).

    python -m realtime_style_transfer_torch.predict_video -C weights.npz \\
        -s style.jpg --frames_dir data/screenshots/hdr_images/validation \\
        -o out/video.mp4 [--device cpu]

``-C`` is a checkpoint file (``.npz`` keyed by ``/``-joined flax paths;
:func:`..cli.load_variables`).  ``--path fused`` runs the stage kernels
(:class:`..ops.fused_transfer.FusedTransfer`), ``packed`` the packed path
(:class:`..models.transfer_packed.PackedTransfer`), ``standard`` the eager
net, ``auto`` picks by :func:`..video.choose_path`.  ``--quant int8``
calibrates the int8 engine's scales on the first frames, or loads them from
``--scales`` (fingerprint-verified, then saturation-checked), as the JAX CLI
does.  Without ``--device`` it runs on CUDA and raises where there is none.

``--data_parallel N`` streams the frames over N ranks, one a card (gloo
ranks on the CPU with ``--device cpu``), through
:class:`..parallel.infer.FusedStreamStylizer`: each rank decodes and
stylizes one frame of every group of N, and rank 0 gathers the group and
writes it; a last group of fewer than N frames is padded with its last frame,
whose copies are not written.  Launched under ``torchrun --nproc_per_node N``
the command joins that group, otherwise it starts its N ranks itself on a
free localhost port.  ``--quant int8`` calibrates (or checks ``--scales``) on
rank 0's bf16 engine and broadcasts the scales.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import cli
from .tracing import logsetup

log = logging.getLogger("predict_video")


def _positive_int(s):
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    cli.add_config_args(p)
    p.add_argument("-C", "--checkpoint_path", type=Path, required=True,
                   help="checkpoint file: .npz keyed by /-joined flax paths")
    p.add_argument("-s", "--style", type=Path, action="append", required=True,
                   help="style image (repeat for dual-style blending)")
    p.add_argument("-w", "--style_weights", type=Path, default=None,
                   help="grayscale weight-map image for style 2 (static "
                        "across frames; zeros when omitted)")
    p.add_argument("--frames_dir", type=Path, required=True,
                   help="directory of frame PNGs (+ EXR siblings when HDR)")
    p.add_argument("-o", "--output", type=Path, default=Path("out/video.mp4"),
                   help="video file (ffmpeg), or a path without a suffix for a PNG "
                        "sequence in that directory")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--bitrate", type=str, default="7M")
    p.add_argument("--profile_dir", type=Path, default=None,
                   help="capture a torch.profiler trace of the frame loop")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument(
        "--path", choices=("auto", "fused", "packed", "standard"),
        default="auto",
        help="compute path: 'fused' = the stage kernels (flagship-family "
             "configs, 1-2 styles, CUDA), 'packed' = the packed-layout path, "
             "'standard' = the eager net; 'auto' picks fused when the config "
             "qualifies on CUDA",
    )
    p.add_argument(
        "--packed", action="store_true", help="alias for --path packed",
    )
    p.add_argument(
        "--quant", choices=("none", "int8"), default="none",
        help="deploy quantization of the fused path: 'int8' calibrates "
             "per-channel activation scales on the first frames (see "
             "--calibration_frames) with the CURRENT styles, then streams "
             "through the int8 engine (int8 tensor-core convs, f32 dequant "
             "epilogue).  Requires the fused path; scales are style-"
             "specific, so re-run per style selection",
    )
    p.add_argument(
        "--calibration_frames", type=_positive_int, default=4, metavar="N",
        help="frames used to calibrate --quant int8 activation scales "
             "(they are still stylized and written to the output)",
    )
    p.add_argument(
        "--scales", type=Path, default=None,
        help="load --quant int8 activation scales from this file instead of "
             "calibrating (must come from --scales_out with the SAME "
             "checkpoint and style selection — the file carries a "
             "provenance fingerprint and a mismatch is refused without "
             "--force_scales; loaded scales are saturation-checked on the "
             "first --calibration_frames frames either way)",
    )
    p.add_argument(
        "--scales_out", type=Path, default=None,
        help="save the calibrated --quant int8 scales (npz with a "
             "(checkpoint, style) provenance fingerprint) for reuse via "
             "--scales (skips startup calibration on restarts)",
    )
    p.add_argument(
        "--force_scales", action="store_true",
        help="deploy a --scales file whose provenance fingerprint does not "
             "match the current (checkpoint, style) selection anyway "
             "(mismatched scales can saturate the int8 clip and silently "
             "degrade output; the saturation check still runs and warns)",
    )
    p.add_argument(
        "--data_parallel", type=int, default=1, metavar="N",
        help="shard the frame stream over N ranks, one a card (one frame a rank a "
             "step; the fused engine is each rank's program where the plan "
             "qualifies: parallel.infer.FusedStreamStylizer)",
    )
    return p.parse_args(argv)


class VideoSink:
    """ffmpeg pipe when available and the output has a suffix; PNG sequence
    otherwise."""

    def __init__(self, output: Path, fps: int, bitrate: str, size_hw):
        self.output = output
        output.parent.mkdir(parents=True, exist_ok=True)
        self.ffmpeg = shutil.which("ffmpeg") if output.suffix else None
        self.proc = None
        self.frame_index = 0
        self.nonfinite = 0  # values written as 0 or clipped because not finite
        if self.ffmpeg:
            h, w = size_hw
            self.proc = subprocess.Popen(
                [
                    self.ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                    "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
                    "-b:v", bitrate, "-pix_fmt", "yuv420p", str(output),
                ],
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        else:
            if output.suffix:
                log.warning("ffmpeg not found: writing PNG sequence next to %s", output)
            self.frames_dir = output.with_suffix("")
            self.frames_dir.mkdir(parents=True, exist_ok=True)

    def write(self, frame01: np.ndarray) -> None:
        from .data.imaging import image_to_uint8

        self.nonfinite += int(np.size(frame01) - np.count_nonzero(np.isfinite(frame01)))
        rgb = image_to_uint8(frame01)
        if self.proc is not None:
            self.proc.stdin.write(rgb.tobytes())
        else:
            import PIL.Image

            PIL.Image.fromarray(rgb).save(
                self.frames_dir / f"frame_{self.frame_index:06d}.png"
            )
        self.frame_index += 1

    def close(self) -> None:
        if self.nonfinite:
            log.warning("%d non-finite output values written as 0 or clipped",
                        self.nonfinite)
        if self.proc is not None:
            self.proc.stdin.close()
            self.proc.wait()
            log.info("wrote %s (%d frames)", self.output, self.frame_index)
        else:
            log.info("wrote %d frames to %s", self.frame_index, self.frames_dir)


def _get_scales(args, variables, style_params, weights):
    """int8 scales from ``--scales``, fingerprint-verified, or None (the
    stream calibrates them); and the (checkpoint, style) fingerprint when a
    scales file is read or written (else None)."""
    from .ops.fused_transfer import load_act_scales, scales_fingerprint

    # fingerprinting hashes every checkpoint leaf: only pay for it when a
    # scales file is being verified or written
    fingerprint = None
    if args.scales is not None or args.scales_out is not None:
        fingerprint = scales_fingerprint(variables, style_params, weights)
    if args.scales is None:
        return None, fingerprint
    scales, file_fp = load_act_scales(args.scales)
    if file_fp is not None and file_fp != fingerprint:
        if not args.force_scales:
            raise SystemExit(
                f"--scales {args.scales} was calibrated against a "
                "DIFFERENT (checkpoint, style) selection than the one "
                "being deployed — mismatched scales can saturate the "
                "int8 clip and silently degrade output.  Recalibrate "
                "(drop --scales), or pass --force_scales to deploy "
                "them anyway.")
        log.warning(
            "--scales fingerprint mismatch overridden by --force_scales")
    elif file_fp is None:
        log.warning(
            "--scales %s has no provenance fingerprint (legacy .npy); "
            "cannot verify it matches this (checkpoint, style) — "
            "running the saturation check", args.scales)
    log.info("loaded int8 scales from %s", args.scales)
    return scales, fingerprint


def _check_loaded_scales(report, n_frames: int) -> None:
    """Warn when the int8 engine would clip meaningfully under loaded scales
    (``report``: ``check_act_saturation`` on the first ``n_frames``)."""
    worst = max(report, key=lambda r: r["max_ratio"])
    clips = sum(r["clip_events"] for r in report)
    total = sum(r["n_quantized"] for r in report)
    frac = clips / max(total, 1)
    if worst["max_ratio"] > 1.25 or frac > 1e-3:
        log.warning(
            "int8 scales SATURATE on these frames (worst stage %s: "
            "max|x|/scale = %.2f; %.4f%% of quantize events clip at "
            "+-127 across %d frames) — output quality will degrade; "
            "recalibrate with the deployed (checkpoint, style) selection",
            worst["stage"], worst["max_ratio"], 100.0 * frac, n_frames)
    else:
        log.info(
            "int8 scale saturation check ok on %d frames (worst stage %s: "
            "max|x|/scale = %.2f, clip fraction %.2e)",
            n_frames, worst["stage"], worst["max_ratio"], frac)


def _scales_ready(args, fingerprint: Optional[str]):
    """The stream's ``on_scales``: check loaded scales, or log (and save) the
    calibrated ones, before the first frame streams."""
    from .ops.fused_transfer import save_act_scales

    def on_scales(scales, report, n_frames):
        if report is not None:
            _check_loaded_scales(report, n_frames)
            return
        log.info("int8 engine calibrated on %d frames", n_frames)
        if args.scales_out is not None:
            args.scales_out.parent.mkdir(parents=True, exist_ok=True)
            save_act_scales(args.scales_out, np.asarray(scales), fingerprint)
            log.info("saved int8 scales to %s", args.scales_out)
    return on_scales


def _frames(args, config):
    """Decoded (H, W, C) f32 frames of ``--frames_dir``, in name order."""
    from .data.hdr_screenshots import find_screenshots, iter_hdr_screenshots
    from .data.imaging import list_image_paths, load_image

    if config.hdr and config.total_channels > 3:
        pngs = find_screenshots(args.frames_dir)
        return iter_hdr_screenshots(pngs, config.channels, config.content_shape)
    paths = list_image_paths(args.frames_dir)
    return (load_image(p, config.content_shape) for p in paths)


def main(argv=None):
    args = parse_args(argv)
    logsetup.setup()

    import torch

    from . import resolve_device
    from .data.imaging import load_image
    from .models.inference import plan_from_config
    from .models.transfer_packed import PackedTransfer
    from .ops.fused_transfer import FusedTransfer
    from .tracing.profiler import FrameTimer, trace
    from .video import EagerEngine, choose_path, stylize_video

    device = resolve_device(args.device)
    if args.data_parallel > 1:
        return _data_parallel(args)
    config = cli.config_from_args(args, num_styles=len(args.style))
    dtype = cli.compute_dtype(args)
    model = cli.build_inference(config, dtype=dtype, device=device)
    variables = cli.load_variables(args.checkpoint_path, model)

    # Style params once, resident on the device.
    styles = cli.load_styles(args.style, config)
    with torch.no_grad():
        style_params = model.predict_style_params(
            torch.as_tensor(styles, device=device)[None])

    # Static per-pixel weight map of the second style (zeros when omitted).
    wm = None
    if config.num_styles == 1 and args.style_weights is not None:
        raise SystemExit(
            "-w/--style_weights needs at least two -s styles to blend"
        )
    if config.num_styles > 1:
        if args.style_weights is not None:
            wm = load_image(args.style_weights,
                            config.output_dimensions + (config.num_styles - 1,))
        else:
            wm = np.zeros(config.style_weights_shape, np.float32)

    plan = plan_from_config(config)
    path = "packed" if args.packed else args.path
    if path == "auto":
        path = choose_path(config, plan, device)
        log.info("compute path: %s", path)
    if args.quant == "int8" and path != "fused":
        raise SystemExit(
            f"--quant int8 requires the fused path (got '{path}'); pass "
            "--path fused on a fused-family config")
    if path == "fused":
        engine = FusedTransfer(variables, plan, num_styles=config.num_styles,
                               device=device)
    elif path == "packed":
        engine = PackedTransfer(variables, plan, num_styles=config.num_styles,
                                dtype=dtype, device=device)
    else:
        engine = EagerEngine(model, config.num_styles)

    frames = _frames(args, config)
    quant = {}
    if args.quant == "int8":
        first = next(frames, None)
        if first is None:
            raise SystemExit("no frames found to calibrate --quant int8 on")
        frames = itertools.chain([first], frames)
        weights = None if wm is None else wm[None]
        scales, fingerprint = _get_scales(args, variables, style_params, weights)
        quant = dict(quant="int8", act_scales=scales, variables=variables,
                     calibration_frames=args.calibration_frames,
                     on_scales=_scales_ready(args, fingerprint))

    sink = VideoSink(args.output, args.fps, args.bitrate, config.output_dimensions)
    with trace(str(args.profile_dir) if args.profile_dir else None):
        run = stylize_video(model, engine, styles, frames,
                            lambda _i, frame: sink.write(frame), style_weights=wm,
                            max_frames=args.max_frames, style_params=style_params, **quant)
    sink.close()
    timer = FrameTimer()
    for seconds in run["latency_s"]:
        timer.add(seconds)
    stats = timer.percentiles()
    log.info("frame latency: %s", {k: round(v, 3) for k, v in stats.items()})
    log.info("%d frames in %.3f s of frame loop (%.2f frames/s, decode and sink "
             "included)", sink.frame_index, run["loop_s"],
             sink.frame_index / max(run["loop_s"], 1e-9))
    return dict(run, path=path, latency=stats, frames_written=sink.frame_index,
                nonfinite=sink.nonfinite)


def _frame_sources(args, config):
    """The frames of ``--frames_dir`` in name order, and a loader of one."""
    from .data.hdr_screenshots import find_screenshots, load_preprocessed_gbuffer
    from .data.imaging import list_image_paths, load_image

    if config.hdr and config.total_channels > 3:
        return find_screenshots(args.frames_dir), lambda p: load_preprocessed_gbuffer(
            p, config.channels, config.content_shape)
    return list_image_paths(args.frames_dir), lambda p: load_image(p, config.content_shape)


def _data_parallel(args):
    """``--data_parallel N``: join the torchrun group, or start N ranks."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from .parallel import distributed

    path = "packed" if args.packed else args.path
    if path == "standard":
        raise SystemExit("--data_parallel streams through the fused/packed per-chip "
                         "paths; use --path auto, fused or packed")
    backend = "gloo" if args.device == "cpu" else "nccl"
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        distributed.initialize(backend=backend)    # under torchrun
    if dist.is_initialized():
        return _stream_rank(args, path)
    results = mp.get_context("spawn").SimpleQueue()
    address = f"tcp://127.0.0.1:{distributed.free_port()}"
    ctx = mp.spawn(_spawned_stream_rank,
                   args=(args, path, address, backend, results),
                   nprocs=args.data_parallel, join=False)
    result = None
    while not ctx.join(timeout=0.5):
        if result is None and not results.empty():
            result = results.get()
    if result is None and not results.empty():
        result = results.get()
    return result


def _spawned_stream_rank(rank, args, path, address, backend, results) -> None:
    import torch.distributed as dist

    from .parallel import distributed

    logsetup.setup()
    distributed.initialize(address, args.data_parallel, rank, backend=backend)
    try:
        out = _stream_rank(args, path)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def _stream_rank(args, path):
    """One rank of the data-parallel stream; rank 0 writes the output and
    returns the run's summary (the other ranks return None)."""
    import torch

    from .data.imaging import load_image
    from .data.pipeline import DevicePrefetcher
    from .models.inference import plan_from_config
    from .parallel import make_mesh
    from .parallel.infer import FusedStreamStylizer
    from .tracing.profiler import FrameTimer, trace

    n = args.data_parallel
    mesh = make_mesh(n, device=args.device)
    config = cli.config_from_args(args, num_styles=len(args.style))
    dtype = cli.compute_dtype(args)
    model = cli.build_inference(config, dtype=dtype, device=mesh.device)
    variables = cli.load_variables(args.checkpoint_path, model)
    styles = cli.load_styles(args.style, config)
    with torch.no_grad():
        style_params = model.predict_style_params(
            torch.as_tensor(styles, device=mesh.device)[None])
    wm = None
    if config.num_styles == 1 and args.style_weights is not None:
        raise SystemExit("-w/--style_weights needs at least two -s styles to blend")
    if config.num_styles > 1:
        if args.style_weights is not None:
            wm = load_image(args.style_weights,
                            config.output_dimensions + (config.num_styles - 1,))
        else:
            wm = np.zeros(config.style_weights_shape, np.float32)
    weights = None if wm is None else wm[None]
    plan = plan_from_config(config)
    streamer = FusedStreamStylizer(variables, plan, mesh, num_styles=config.num_styles,
                                   path=path, dtype=dtype)
    log.info("data-parallel mesh: %d ranks, per-rank path: %s", n, streamer.path)
    sources, load = _frame_sources(args, config)
    result = {}
    if args.quant == "int8":
        if streamer.path != "fused":
            raise SystemExit(
                "--quant int8 requires the fused path; this config/mesh fell back to "
                "'packed' (pass --path fused on a fused-family config)")
        if not sources:
            raise SystemExit("no frames found to calibrate --quant int8 on")
        # calibrate (or check loaded scales) on rank 0's bf16 engine; every
        # rank deploys the same scales, as the kernels are the same on each
        scales, fingerprint = _get_scales(args, variables, style_params, weights)
        engine = streamer.fused_engine
        table = torch.zeros((engine.n_conv_stages, 128), dtype=torch.float32)
        if mesh.is_main:
            prepared = engine.prepare_style(style_params, weights)
            packs = [engine.pack_frame_np(load(p)[None])
                     for p in sources[:args.calibration_frames]]
            report = None
            if scales is None:
                scales = engine.calibrate_act_scales(packs, prepared)
            else:
                report = engine.check_act_saturation(packs, prepared, scales)
            table = torch.as_tensor(np.asarray(scales, np.float32))
            _scales_ready(args, fingerprint)(np.asarray(scales), report, len(packs))
            result.update(act_scales=table.numpy().copy(), saturation=report)
        table = mesh.broadcast_(table.to(mesh.device)).cpu().numpy()
        streamer = FusedStreamStylizer(variables, plan, mesh, num_styles=config.num_styles,
                                       path="fused", dtype=dtype, quant="int8",
                                       act_scales=table)
    prepared = streamer.prepare_style(style_params, weights)

    total = len(sources) if args.max_frames is None else min(len(sources), args.max_frames)
    steps = math.ceil(total / n)
    fused = streamer.path == "fused"
    if fused:
        prepare, stylize = streamer.fused_engine.pack_frame_np, streamer.stylize_local_prepacked
    else:
        def prepare(frame):
            host = torch.from_numpy(np.ascontiguousarray(frame))
            return host.pin_memory() if mesh.device.type == "cuda" else host

        stylize = streamer.stylize_local
    # this rank's frame of every group; the last group repeats its last frame
    mine = (load(sources[min(g * n + mesh.rank, total - 1)])[None] for g in range(steps))
    warm = prepare(np.zeros((1,) + config.content_shape, np.float32))
    stylize(warm.to(mesh.device), prepared).cpu()
    sink = (VideoSink(args.output, args.fps, args.bitrate, config.output_dimensions)
            if mesh.is_main else None)
    timer = FrameTimer()
    loop_start = time.perf_counter()
    with trace(str(args.profile_dir) if args.profile_dir and mesh.is_main else None):
        for g, item in enumerate(DevicePrefetcher(mine, 3, device=mesh.device,
                                                  prepare=prepare)):
            with timer.frame():
                group = stylize(item, prepared).cpu().numpy()
            if sink is not None:
                for frame in group[:min(n, total - g * n)]:
                    sink.write(frame)
    loop_s = time.perf_counter() - loop_start
    if sink is None:
        return None
    sink.close()
    stats = timer.percentiles()
    log.info("step latency (%d frames/step): %s", n, {k: round(v, 3) for k, v in stats.items()})
    return dict(result, path=streamer.path, data_parallel=n, latency=stats, loop_s=loop_s,
                frames_written=sink.frame_index, nonfinite=sink.nonfinite)


if __name__ == "__main__":
    main()
