"""Where a launch of the port's kernels spends its time, on one card.

    python -m realtime_style_transfer_torch.halo_profile [--parts P,...] [ROOT ...]

``--parts`` picks some of ``cin``, ``finish``, ``act_stats``, ``stages``,
``matmul`` and ``probe`` (all by default), run in that order.

First ``cin`` (``csrc/cin.cu``) at the training step's (4, 120, 240, 128),
bf16 and f32: the forward (each tree's ``cin``) and the backward (each tree's
own: a tree without ``cin_forward`` has the torch-ops ``cin_backward``) by
graph replay beside each ROOT's, the plain versions, ``F.instance_norm`` and
the bytes bounds and the phases of a block (``// PROFILE LAP i``, as below:
loads and sums, the grid barrier, the fold, the stores); this tree's forward
and backward on all the SMs, half and a quarter of them;
each output's largest difference from the plain version and each ROOT's, and
two calls of this tree bit-equal (the command exits 1 otherwise).

Then the two byte-bound passes beside each ROOT, a checkout of another
version of the port (a ``git archive`` of an earlier commit): ``finish`` at
the rst-960 and rst-1920 frames, one style and two, and ``act_stats`` in
check mode on every conv stage's input of one seeded frame (rst-960 one
style and two, rst-1920), each launch's graph time beside its bytes bound
and, for ``act_stats``, the phases of its blocks (``// PROFILE LAP i``, as
below); each output must be bit-equal to this tree's and to the plain
version, or the command exits 1.  Then ``calibrate_act_scales`` and
``check_act_saturation`` a frame of each ROOT's engine and this one in
turns ROOT, this, this, ROOT (CUDA events, the median of 5 windows of 10
frames), their results equal.

Then, for the stages of the flagship frame on each path of the kernel at their
real shapes (window: the stem from the f4 pack and the final conv; strided:
c1, c2, and c3 of rst-1920; halo: res0b, res0a, e0, e1, e2 of rst-1920 and a
5x11 grid that is one block), bf16 and int8, each with its frame's prologue
(an affine + ReLU prologue and moments on the final and halo stages), prints
the device time of one launch as the replay of a CUDA graph of 20 launches,
beside ``F.conv2d`` bf16 on the same input (bf16 stages) and the same stage
of each ROOT, a checkout of another version of the port (a ``git archive``
of an earlier commit): its own ``make_conv_stage`` lays the stage out and its
own ``conv_stage`` launches its own build, so its weight layout always
matches its source.  Then the phases of a block, read by ``clock64`` in a
copy of ``conv_stage.cu`` with counters added at the ``// PROFILE LAP i``
markers of ``conv_halo_kernel`` and ``conv_window_kernel`` (warp 0, lane 0
of each block, microseconds at the card's maximum SM clock, the median over
the blocks).

Then the packed path's ``conv_matmul``: each of its four launches (the
packed stem and final conv of rst-960-120-128-17 and rst-1920-120-128-17),
bf16 and then f32, by graph replay beside each ROOT's own
``conv_valid_matmul`` (its weights packed by its own ``pack_taps`` or
``pack_fma`` where it has one; this one's input with its channels padded to
the packed kernel's, as the packed path's ``F.pad`` pads them, each ROOT's
as it is; f32: each ROOT's largest difference from this kernel) and
``F.conv2d``, with the phases of a ``conv_wgmma_kernel`` or
``conv_fma_kernel`` block read the same way; then the packed frame (``PackedTransfer`` with
``conv_backend="pallas"``) of rst-960 with one style and rst-1920 with two,
each ROOT's engine and this one's on the same seeded variables, in turns
ROOT, this, this, ROOT (CUDA events, the median of 5 windows of 20 frames),
and each engine's device busy time a frame (``torch.profiler``).

Last, the matmul probes (``probe``): the int8 probe's mm and band arms, bf16
and int8, a launch at 64 repetitions and the slope between 16 and 64 (mm
1024), and the shared-memory probe's work arm, a launch at 32 and the slope
between 8 and 512, by graph replay beside each ROOT's own wrappers (its own
build of ``probe_int8.cu`` and ``probe_smem.cu``) on the same seeded inputs, every output held against the plain version
(the command exits 1 otherwise) and each ROOT's against this one's, and the
phases of a block of ``probe_rep.cuh``'s kernel (``// PROFILE LAP i``).
Needs one CUDA device, ``nvcc`` and ``nvidia-smi``.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import inspect
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import kernels
from .ops.conv import pack_transpose_kernel
from .ops.bounds import act_stats_work, bound_ms, cin_work, finish_work
from .ops.kernels import _ARGTYPES, Prologue, launch_act_stats, launch_conv_stage
from .ops.packed_conv import pack
from .timing import graph_ms

# the phases each instrumented kernel's PROFILE LAP markers close, in order
PHASES = {
    "conv_halo_kernel": ("fill + fold", "halo wait", "prologue pass", "K loop",
                         "sums to shared", "epilogue", "moments flush"),
    "conv_window_kernel": ("fill + fold", "input wait", "window pass", "K loop", "epilogue",
                           "moments flush"),
}
# the same for conv_matmul.cu's kernels
MATMUL_PHASES = {
    "conv_wgmma_kernel": ("set-up", "fill wait", "K loop", "sums to shared", "epilogue"),
    "conv_fma_kernel": ("set-up + fill wait", "K loop", "K-group sums", "epilogue"),
}
# the same for act_stats.cu's kernel
PASS_PHASES = {"act_stats_kernel": ("copies + fold", "stream", "flush")}
# the same for cin.cu's kernel (forward and backward)
CIN_PHASES = {"cin_kernel": ("loads + sums", "grid barrier", "fold", "stores")}
# the same for the probes' kernel (probe_rep.cuh), from a consumer thread
PROBE_PHASES = {"probe_rep_kernel": ("set-up", "repetitions", "grid barrier", "reduce")}
# the packed path's conv_matmul launches (bounds.conv_matmul_launches) and frames
MATMUL_SPECS = ("rst-960-120-128-17", "rst-1920-120-128-17")
FRAMES = (("rst-960-120-128-17", 1), ("rst-1920-120-128-17", 2))
# finish's frames (the final stage's output grid) and act_stats' engines
FINISH_FRAMES = (("rst-960", (480, 960)), ("rst-1920", (960, 1920)))
STATS_FRAMES = (("rst-960-120-128-17", 1), ("rst-960-120-128-17", 2), ("rst-1920-120-128-17", 1))
# the training step's residual CIN activation
CIN_SHAPE = (4, 120, 240, 128)
PARTS = ("cin", "finish", "act_stats", "stages", "matmul", "probe")
# label, path, kernel (kh, kw, cin, cout), input grid, pack input, prologue
CASES = (
    ("stem", "window", (9, 9, 17, 32), (480, 960), True, False),
    ("c1", "strided", (3, 3, 32, 16), (480, 960), False, False),
    ("c2", "strided", (3, 3, 16, 32), (240, 480), False, False),
    ("c3 (rst-1920)", "strided", (3, 3, 32, 32), (240, 480), False, False),
    ("final", "window", (9, 9, 16, 3), (480, 960), False, True),
    ("final (rst-1920)", "window", (9, 9, 8, 3), (960, 1920), False, True),
    ("res0b", "halo", (3, 3, 128, 128), (120, 240), False, True),
    ("res0a", "halo", (3, 3, 32, 128), (120, 240), False, True),
    ("e0", "expand", (3, 3, 128, 32), (120, 240), False, True),
    ("e1", "expand", (3, 3, 32, 16), (240, 480), False, True),
    ("e2 (rst-1920)", "expand", (3, 3, 16, 8), (480, 960), False, True),
    ("one block", "halo", (3, 3, 128, 128), (5, 11), False, True),
)


def _signature(text: str, name: str) -> Optional[int]:
    """Where kernel ``name``'s signature ``name(const <Params type> p`` starts
    in ``text``, or None."""
    found = re.search(rf"\b{name}\(const \w*Params p\b", text)
    return found.start() if found else None


def _kernel_span(text: str, name: str):
    """(start, end) of the body of kernel ``name`` in ``text``."""
    start = text.index(" {\n", _signature(text, name)) + 3
    return start, text.index("\n}\n", start)


def profiled_source(text: str) -> str:
    """A kernel source (conv_stage.cu, conv_matmul.cu, act_stats.cu, cin.cu,
    probe_rep.cuh) with clock64 counters in each of its kernels in PHASES,
    MATMUL_PHASES, PASS_PHASES, CIN_PHASES or PROBE_PHASES: its ``// PROFILE LAP
    i`` markers, in order i = 0, 1, ..., close counter i; each block's thread
    0 writes them to ``Params::counters``, 8 a block."""
    for name, phases in {**PHASES, **MATMUL_PHASES, **PASS_PHASES, **CIN_PHASES,
                         **PROBE_PHASES}.items():
        if _signature(text, name) is None:
            continue
        start, end = _kernel_span(text, name)
        kernel = text[start:end]
        laps = [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", kernel)]
        if laps != list(range(len(phases))):
            raise ValueError(f"{name}'s PROFILE LAP markers are {laps}, "
                             f"not 0..{len(phases) - 1}")
        kernel = ("  long long _c[8] = {0}, _t = clock64(), _u;\n"
                  "#define LAP(i) do { _u = clock64(); _c[i] += _u - _t; _t = _u; } while (0)\n"
                  + re.sub(r"// PROFILE LAP (\d+)", r"LAP(\1);", kernel) + "\n"
                  "  if (threadIdx.x == 0 && blockIdx.y == 0)\n"
                  "    for (int i = 0; i < 8; ++i) p.counters[blockIdx.x * 8 + i] = _c[i];\n"
                  "#undef LAP")
        text = text[:start] + kernel + text[end:]
    return text


def _build(text: str, name: str) -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = kernels.BUILD_DIR / f"{name}.cu", kernels.BUILD_DIR / f"{name}.so"
    cu.write_text(text)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def load_package(root, alias: str):
    """The ``kernels`` module of the port in checkout ``root``, its package
    imported under the name ``alias`` beside this one (the package's modules
    import each other relatively), building into ``root``'s own ``build/``."""
    pkg = Path(root).resolve() / "realtime_style_transfer_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.kernels")


def _stage(k, label, path, kshape, kernel, hw, pack_input, quant, dev):
    """The stage as ``k.make_conv_stage`` of a kernels module lays it out."""
    kh, kw, cin, cout = kshape
    bias, pads, stride, out_hw = np.zeros(cout, np.float32), (kh // 2, kw // 2), 1, hw
    kw_args = {}
    if path == "expand":  # the parity-packed 2x2 conv of an expand stage
        packed, (pad_y, pad_x) = pack_transpose_kernel(torch.from_numpy(kernel))
        kernel, pads, bias = packed.numpy(), (pad_y[0], pad_x[0]), np.tile(bias, 4)
        kw_args["transpose_cout"] = cout
    if path == "strided":  # the frame's contracts: even grids, TF SAME pads
        stride, out_hw, pads = 2, (hw[0] // 2, hw[1] // 2), (0, 0)
    epi = "contract" if path in ("strided", "window") and not label.startswith("final") \
        else "bias" if path in ("expand", "window") else "relu"
    if epi == "contract":
        kw_args.update(cscale=np.ones(cout, np.float32), cshift=np.zeros(cout, np.float32))
    return k.make_conv_stage(label, kernel, bias, in_hw=hw, out_hw=out_hw, stride=stride,
                             pads=pads, epi=epi, device=dev, pack_c=384 if pack_input else 0,
                             act_scale=np.full(cin, 2.0, np.float32) if quant else None,
                             **kw_args)


def _phases(counters: torch.Tensor, phases, mhz: float) -> str:
    """The median over the blocks of each phase and of a block, in us."""
    us = counters.view(-1, 8)[:, :len(phases)].double().cpu() / mhz
    med = us.median(dim=0).values
    return ("phases (us, median of " + f"{us.shape[0]} blocks): " + ", ".join(
        f"{name} {float(v):.2f}" for name, v in zip(phases, med))
        + f"; a block {float(us.sum(dim=1).median()):.2f}")


def stage_part(prof, others, mhz: float) -> None:
    """Each stage of CASES, bf16 and int8: its graph time beside each ROOT's
    and ``F.conv2d``'s, and its block phases."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng, gen = np.random.default_rng(0), torch.Generator(device=dev).manual_seed(0)
    for quant in (False, True):
        for label, path, kshape, hw, pack_input, prologue in CASES:
            kh, kw, cin, _ = kshape
            kernel = (rng.standard_normal(kshape) / np.sqrt(kh * kw * cin)).astype(np.float32)
            st = _stage(kernels, label, path, kshape, kernel, hw, pack_input, quant, dev)
            xl = torch.rand(hw + (cin,), generator=gen, device=dev).to(bf16)
            x = xl
            if pack_input:
                x = torch.zeros(st.in_shape, dtype=bf16, device=dev)
                x[:, :, :16 * cin] = pack(xl[None], 4)[0]
            pro = stats = None
            if prologue:
                xf = xl.float().reshape(-1, cin)
                pro = Prologue(torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous(),
                               float(xf.shape[0]),
                               torch.rand(cin, generator=gen, device=dev) + 0.5,
                               torch.rand(cin, generator=gen, device=dev) - 0.5, 1e-5, True)
                stats = torch.zeros((2, st.c_log), device=dev)
            out = torch.empty(st.out_shape, dtype=bf16, device=dev)
            row = [f"{label}{' int8' if quant else ''} ({st.path}) {hw[0]}x{hw[1]}x{cin} "
                   f"-> {st.n}:"]
            ms = graph_ms(lambda: kernels.conv_stage(x, st, out, prologue=pro, stats_out=stats))
            row.append(f"kernel {ms:.4f} ms")
            for name, k in others.items():
                ost = _stage(k, label, path, kshape, kernel, hw, pack_input, quant, dev)
                opro = k.Prologue(*pro) if pro else None
                other_ms = graph_ms(lambda: k.conv_stage(x, ost, out, prologue=opro,
                                                         stats_out=stats))
                row.append(f"{name} {other_ms:.4f} ms")
            if not quant:
                oh, ow = st.out_hw
                pb = (oh - 1) * st.stride + st.kh - hw[0] - st.pad_top
                pr = (ow - 1) * st.stride + st.kw - hw[1] - st.pad_left
                xp = F.pad(xl.permute(2, 0, 1)[None], (st.pad_left, pr, st.pad_top, pb))
                xp = xp.contiguous(memory_format=torch.channels_last)
                wt = st.weight_oihw().to(bf16).contiguous(memory_format=torch.channels_last)
                row.append(f"F.conv2d {graph_ms(lambda: F.conv2d(xp, wt, stride=st.stride)):.4f}"
                           " ms")
            counters = torch.zeros(st.grid[0] * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                counters.zero_()
                launch_conv_stage(prof, x, st, out, counters, prologue=pro, stats_out=stats)
            torch.cuda.synchronize()
            phases = PHASES["conv_window_kernel" if st.path == "window" else "conv_halo_kernel"]
            row.append(_phases(counters, phases, mhz))
            print("  ".join(row), flush=True)


def _window_ms(fn, reps: int = 10, windows: int = 3) -> float:
    """The median over ``windows`` of the CUDA-event ms of one call, each
    window ``reps`` calls, after 3 warm-up calls."""
    for _ in range(3):
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


def matmul_part(prof, others, mhz: float) -> None:
    """The packed path's four conv_matmul launches, bf16 and f32, beside
    each ROOT's and F.conv2d's, with their block phases; then the packed
    frames in turns."""
    from .config import ShapeConfig
    from .models.inference import make_inference_model, plan_from_config
    from .models.transfer_packed import PackedTransfer
    from .ops import conv_matmul as cm
    from .ops.bounds import conv_matmul_launches
    from .weights import to_flax

    mods = {name: importlib.import_module(k.__name__.rsplit(".", 2)[0] + ".ops.conv_matmul")
            for name, k in others.items()}
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (bf16, torch.float32):
        # each path's packing, its plan's summary, its launch and its kernel's phases
        pack, launch, kernel_name = ((cm.pack_taps, cm.launch_wgmma, "conv_wgmma_kernel")
                                     if dtype == bf16 else
                                     (cm.pack_fma, cm.launch_fma, "conv_fma_kernel"))
        for spec in MATMUL_SPECS:
            for seam, (hp, wp, k, _, cin, cout) in conv_matmul_launches(
                    plan_from_config(ShapeConfig.from_spec(spec))).items():
                x = torch.randn((hp, wp, cin), generator=gen, device=dev).to(dtype)
                w = (torch.randn((k, k, cin, cout), generator=gen, device=dev)
                     / (k * k * cin) ** 0.5).to(dtype)
                epi = dict(epilogue="none")
                if seam == "stem":
                    epi = dict(bias=torch.randn(cout, generator=gen, device=dev) * 0.1,
                               scale=torch.rand(cout, generator=gen, device=dev) + 0.5,
                               shift=torch.randn(cout, generator=gen, device=dev) * 0.1,
                               epilogue="contract")
                packed = pack(w)
                pl = packed.plan
                xk = F.pad(x, (0, packed.kernel.shape[2] - cin))  # as the packed path pads it
                shape = (f"bn {pl.bn}, rw {pl.rw}, {pl.nchunks} chunks, K {pl.k}"
                         if dtype == bf16 else
                         f"bn {pl.bn}, tm {pl.tm}, cc {pl.cc}, {pl.stages} stages, "
                         f"{pl.nbuf} buffers")
                row = [f"conv_matmul {str(dtype)[6:]} {spec} {seam} ({hp}, {wp}, {cin}) "
                       f"{k}x{k} -> {cout} ({shape}):"]
                mine = cm.conv_valid_matmul(xk, packed, **epi)
                row.append(f"kernel {graph_ms(lambda: cm.conv_valid_matmul(xk, packed, **epi)):.4f}"
                           " ms")
                for name, mod in mods.items():
                    has_pack = hasattr(mod, "pack_taps" if dtype == bf16 else "pack_fma")
                    kern = (mod.pack_taps if dtype == bf16 else mod.pack_fma)(w) if has_pack else w
                    row.append(f"{name} {graph_ms(lambda: mod.conv_valid_matmul(x, kern, **epi)):.4f}"
                               " ms")
                    if dtype != bf16:
                        diff = (mod.conv_valid_matmul(x, kern, **epi) - mine).abs().max().item()
                        row.append(f"(max |{name} - kernel| {diff:.3e})")
                xp = x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
                wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                row.append(f"F.conv2d {graph_ms(lambda: F.conv2d(xp, wl)):.4f} ms")
                h, w_ = hp - k + 1, wp - k + 1
                out = torch.empty((h, w_, cout), dtype=dtype, device=dev)
                rows = (None, None, None)
                if seam == "stem":
                    rows = cm._epilogue_rows(cout, dev, epi["bias"], epi["scale"], epi["shift"])
                counters = torch.zeros(pl.grid(h, w_)[0] * 8, dtype=torch.int64, device=dev)
                for _ in range(3):
                    counters.zero_()
                    err = launch(prof, xk, packed, rows, out, cm.EPILOGUES[epi["epilogue"]],
                                 counters)
                    if err:
                        raise RuntimeError(f"profiled conv_matmul: CUDA error {err}")
                torch.cuda.synchronize()
                row.append(_phases(counters, MATMUL_PHASES[kernel_name], mhz))
                print("  ".join(row), flush=True)

    engines = {name: importlib.import_module(
        k.__name__.rsplit(".", 2)[0] + ".models.transfer_packed").PackedTransfer
        for name, k in others.items()}
    rng = np.random.default_rng(0)
    for spec, styles in FRAMES:
        cfg = ShapeConfig.from_spec(spec, num_styles=styles)
        model = make_inference_model(cfg, seed=0)
        variables = to_flax(model.transfer.state_dict())
        plan = model.plan
        h, w_ = plan.input_shape[:2]
        content = torch.from_numpy(rng.random((1,) + tuple(plan.input_shape),
                                              dtype=np.float32)).to(dev)
        sp = torch.from_numpy(rng.random((1, styles, plan.num_style_parameters), dtype=np.float32)
                              + 0.5).to(dev)
        wmap = (torch.linspace(0, 1, h, device=dev)[None, :, None, None].expand(1, h, w_, 1)
                .contiguous() if styles == 2 else None)
        mine = PackedTransfer(variables, plan, num_styles=styles)
        frames = {"this": lambda: mine(content, sp, wmap, conv_backend="pallas")}
        for name, cls in engines.items():
            eng = cls(variables, plan, num_styles=styles)
            frames[name] = (lambda e: lambda: e(content, sp, wmap, conv_backend="pallas"))(eng)
        with torch.no_grad():
            for name in others:
                turns = [(r, _window_ms(frames[r], 20, 5)) for r in (name, "this", "this", name)]
                print(f"packed frame {spec}, {styles} style(s), turns {name}, this, this, "
                      f"{name}: " + ", ".join(f"{r} {ms:.4f} ms" for r, ms in turns), flush=True)
        del model, mine, frames


def _stats_call(k, x, st, pro, skip_in, act_inv):
    """One ``act_stats`` launch of kernels module ``k`` on these inputs as a
    closure, and its (maxima, clips) from zero: given rows where ``k`` takes
    them (``max_out``, ``clips_out``), else as it returns them."""
    dev = x.device
    pro = k.Prologue(*pro) if pro is not None else None
    if "max_out" in inspect.signature(k.act_stats).parameters:
        rows = (torch.zeros(st.cin, device=dev), torch.zeros(st.cin, dtype=torch.int64,
                                                             device=dev))

        def fn():
            k.act_stats(x, st, pro, skip_in, act_inv, max_out=rows[0], clips_out=rows[1])
        fn()
        return fn, (rows[0].clone(), rows[1].clone())

    def fn():
        return k.act_stats(x, st, pro, skip_in, act_inv)
    return fn, fn()


def _same(a, b) -> bool:
    return all(torch.equal(x.to(torch.int64) if x.dtype == torch.int32 else x,
                           y.to(torch.int64) if y.dtype == torch.int32 else y)
               for x, y in zip(a, b))


def finish_part(others) -> list:
    """``finish`` at the rst-960 and rst-1920 frames, one style and two: the
    graph time of this build and each ROOT's on the same seeded input, its
    bytes bound; each output bit-equal to this one's and to ``finish_plain``."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for label, (h, w) in FINISH_FRAMES:
        x = (torch.randn((h, w, 3), generator=gen, device=dev) * 2.0).to(bf16)
        xf = x.float().reshape(-1, 3)
        stats = torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous()
        for dual in (False, True):
            rows = [torch.rand(3, generator=gen, device=dev) * 0.4 + 0.8,
                    torch.rand(3, generator=gen, device=dev) * 0.4 - 0.2]
            second = ((torch.rand(3, generator=gen, device=dev) * 0.4 + 0.8,
                       torch.rand(3, generator=gen, device=dev) * 0.4 - 0.2,
                       torch.rand((h, w), generator=gen, device=dev).to(bf16)) if dual else ())
            pro = Prologue(stats, float(h * w), *rows, 1e-5, False, *second)
            outs = {name: torch.empty((h // 4, w // 4, 128), dtype=bf16, device=dev)
                    for name in ("this", "plain", *others)}
            kernels.finish_plain(x, pro, outs["plain"])
            kernels.finish(x, pro, outs["this"])
            ms = {"this": graph_ms(lambda: kernels.finish(x, pro, outs["this"]))}
            for name, k in others.items():
                kp = k.Prologue(*pro)
                k.finish(x, kp, outs[name])
                ms[name] = graph_ms(lambda: k.finish(x, kp, outs[name]))
            torch.cuda.synchronize()
            equal = {name: torch.equal(outs[name], outs["this"]) for name in outs if name != "this"}
            bad += [f"finish {label}{' dual' if dual else ''} vs {n}" for n, e in equal.items()
                    if not e]
            ops, n_bytes = finish_work(h, w, 3, 128, dual=dual)
            bound, by = max((bound_ms(ops, 0.0, "f32"), bound_ms(0.0, n_bytes)))
            print(f"finish {label}{' dual' if dual else ''} ({h}x{w}x3 -> {h // 4}x{w // 4}x128): "
                  + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
                  + f" (graph); bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB); "
                  + ", ".join(f"bit-equal to {n} {'yes' if e else 'NO'}" for n, e in equal.items()),
                  flush=True)
    return bad


def _stage_inputs(engine, packed, prep, inv_rows):
    """(stage, x, prologue, skip_in, act_inv) of each conv stage of one frame
    of ``engine``, copied as the stage loop hands them to ``act_stats``."""
    rec = []

    def hook(i, x, st, pro, skip_in):
        if pro is not None:
            pro = pro._replace(stats=pro.stats.clone())
        rec.append((st, x.clone(), pro, None if skip_in is None else skip_in.clone(),
                    inv_rows[i, :st.cin]))

    engine._run_frame(packed, prep, None, False, stage_hook=hook)
    return rec


def act_stats_part(others, prof=None, mhz: float = 1.0) -> list:
    """``act_stats`` in check mode (seeded scales) on every conv stage input
    of one seeded frame: rst-960 one style and two, rst-1920 one style; the
    graph time of this build and each ROOT's beside each launch's bound, the
    frame's sums, each result equal to this one's and to ``act_stats_plain``;
    then ``calibrate_act_scales`` and ``check_act_saturation`` a frame (CUDA
    events) of this engine and each ROOT's in turns, their results equal.
    Given ``prof``, a profiled build of ``act_stats.cu``, also the phases of
    each launch's blocks."""
    from .config import ShapeConfig
    from .models.inference import make_inference_model
    from .ops.fused_transfer import FusedTransfer
    from .weights import to_flax

    dev = torch.device("cuda")
    bad = []
    engines = {name: importlib.import_module(k.__name__.rsplit(".", 2)[0]
                                             + ".ops.fused_transfer").FusedTransfer
               for name, k in others.items()}
    for spec, styles in STATS_FRAMES:
        model = make_inference_model(ShapeConfig.from_spec(spec, num_styles=styles), seed=0,
                                     device=dev)
        plan = model.plan
        variables = to_flax(model.transfer.state_dict())
        rng = np.random.default_rng(0)
        h, w = plan.input_shape[:2]
        frame = rng.random((1,) + tuple(plan.input_shape), dtype=np.float32)
        sp = torch.from_numpy(rng.random((1, styles, plan.num_style_parameters),
                                         dtype=np.float32) + 0.5)
        wmap = (torch.linspace(0, 1, h)[None, :, None, None].expand(1, h, w, 1).contiguous()
                if styles == 2 else None)
        mine = FusedTransfer(variables, plan, num_styles=styles, device=dev)
        prep = mine.prepare_style(sp, wmap)
        packed = mine.pack_frame_np(frame).to(dev)
        scales = (np.random.default_rng(1).random((mine.n_conv_stages, 128)) * 2.5
                  + 0.5).astype(np.float32)
        inv = torch.from_numpy(mine._act_inv_rows(scales)).to(dev)
        tag = f"{spec}, {styles} style(s)"
        sums = dict.fromkeys(["this", *others, "bound"], 0.0)
        for st, x, pro, skip_in, act_inv in _stage_inputs(mine, packed, prep, inv):
            fn, got = _stats_call(kernels, x, st, pro, skip_in, act_inv)
            want = kernels.act_stats_plain(x, st, pro, skip_in, act_inv)
            ms = {"this": graph_ms(fn)}
            equal = {"plain": _same(got, want[:2])}
            for name, k in others.items():
                ofn, ogot = _stats_call(k, x, st, pro, skip_in, act_inv)
                ms[name] = graph_ms(ofn)
                equal[name] = _same(got, ogot)
            ih, iw = st.in_hw
            ops, n_bytes = act_stats_work(ih, iw, st.cin, affine=pro is not None,
                                          skip_in=skip_in is not None,
                                          dual=pro is not None and pro.dual, check=True)
            bound, by = max(bound_ms(ops, 0.0, "f32"), bound_ms(0.0, n_bytes))
            phases = ""
            if prof is not None:
                grid = kernels.stats_plan(st, torch.cuda.get_device_properties(dev)
                                          .multi_processor_count)
                counters = torch.zeros(grid.blocks * 8, dtype=torch.int64, device=dev)
                rows = (torch.zeros(st.cin, device=dev),
                        torch.zeros(st.cin, dtype=torch.int64, device=dev))
                for _ in range(3):
                    counters.zero_()
                    launch_act_stats(prof, x, st, pro, skip_in, act_inv, *rows, counters)
                torch.cuda.synchronize()
                phases = "; " + _phases(counters, PASS_PHASES["act_stats_kernel"], mhz)
            for name, v in ms.items():
                sums[name] += v
            sums["bound"] += bound
            bad += [f"act_stats {tag} {st.name} vs {n}" for n, e in equal.items() if not e]
            print(f"act_stats {tag} {st.name} ({ih}x{iw}x{st.cin}"
                  f"{', pack' if st.pack_c else ''}{', affine' if pro is not None else ''}"
                  f"{', dual' if pro is not None and pro.dual else ''}"
                  f"{', skip' if skip_in is not None else ''}): "
                  + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
                  + f" (graph); bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB); clips "
                  f"{int(got[1].sum())}; "
                  + ", ".join(f"equal to {n} {'yes' if e else 'NO'}" for n, e in equal.items())
                  + phases, flush=True)
        print(f"act_stats {tag}, the frame's {len(mine.steps)} launches summed: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in sums.items()), flush=True)
        for name in others:
            if "max_out" not in inspect.signature(others[name].act_stats).parameters:
                fills = graph_ms(lambda: (torch.zeros(128, device=dev),
                                          torch.zeros(128, dtype=torch.int32, device=dev)))
                print(f"act_stats {tag}: {name}'s wrapper fills two rows a launch, "
                      f"{fills:.4f} ms (graph) of its time", flush=True)
        runs = {"this": mine}
        for name, cls in engines.items():
            runs[name] = cls(variables, plan, num_styles=styles, device=dev)
        calls = {name: {"calibrate": (lambda e, pr: lambda: e.calibrate_act_scales(
                            [packed], pr))(eng, eng.prepare_style(sp, wmap)),
                        "check": (lambda e, pr: lambda: e.check_act_saturation(
                            [packed], pr, scales))(eng, eng.prepare_style(sp, wmap))}
                 for name, eng in runs.items()}
        with torch.no_grad():
            results = {name: (c["calibrate"](), c["check"]()) for name, c in calls.items()}
            for name in others or (None,):
                same = name is None or (
                    np.array_equal(results[name][0], results["this"][0])
                    and results[name][1] == results["this"][1])
                if not same:
                    bad.append(f"calibrate/check {tag} vs {name}")
                order = ("this",) if name is None else (name, "this", "this", name)
                for what in ("calibrate", "check"):
                    turns = [(r, _window_ms(calls[r][what], 10, 5)) for r in order]
                    print(f"{what} frame {tag}, turns {', '.join(order)} (events, a frame): "
                          + ", ".join(f"{r} {v:.4f} ms" for r, v in turns)
                          + ("" if name is None else f"; results equal {'yes' if same else 'NO'}"),
                          flush=True)
        del model, mine, runs
    return bad


def cin_part(others, prof=None, mhz: float = 1.0) -> list:
    """``cin`` forward and backward at :data:`CIN_SHAPE`, bf16 and f32: this
    tree's and each ROOT's by graph replay (each ROOT's own functions), the
    plain versions, ``F.instance_norm`` and the bounds; this tree on all, half
    and a quarter of the SMs; differences from the plain version and each
    ROOT's.  Given ``prof``, a profiled build of ``cin.cu``, also the phases
    of each launch's blocks."""
    from .ops import cin as cin_mod

    mods = {name: importlib.import_module(k.__name__.rsplit(".", 2)[0] + ".ops.cin")
            for name, k in others.items()}
    dev, eps = torch.device("cuda"), 1e-5
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, w, c = CIN_SHAPE
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"cin {CIN_SHAPE} {str(dtype)[6:]}"
        x = (torch.randn(CIN_SHAPE, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        g = torch.randn(CIN_SHAPE, generator=gen, device=dev).to(dtype)
        scale = torch.rand((b, 1, 1, c), generator=gen, device=dev) + 0.5
        bias = torch.randn((b, 1, 1, c), generator=gen, device=dev)
        rows = scale.reshape(b, c), bias.reshape(b, c)
        work = cin_work(b, h, w, c, x.element_size())
        bounds = {k: max(bound_ms(work[k][0], 0.0, "f32"), bound_ms(0.0, work[k][1]))
                  for k in ("forward", "backward")}
        with torch.no_grad():
            y, stats = cin_mod.cin_forward(x, *rows, eps)
            dx = cin_mod.cin_backward(x, g, stats, rows[0], eps)
            y2, stats2 = cin_mod.cin_forward(x, *rows, eps)
            dx2 = cin_mod.cin_backward(x, g, stats, rows[0], eps)
            py, pstats = cin_mod.cin_forward_plain(x, *rows, eps)
            pdx = cin_mod.cin_backward_plain(x, g, pstats, rows[0], eps)
            same = all(torch.equal(a, a2) for a, a2 in zip((y, stats, *dx), (y2, stats2, *dx2)))
            if not same:
                bad.append(f"{tag}: two calls differ")
            fwd = {"this": graph_ms(lambda: cin_mod.cin(x, scale, bias))}
            bwd = {"this": graph_ms(lambda: cin_mod.cin_backward(x, g, stats, rows[0], eps))}
            diffs = {"plain": ((y.float() - py.float()).abs().max().item(),
                               max((a.float() - p.float()).abs().max().item()
                                   for a, p in zip(dx, pdx)))}
            for name, mod in mods.items():
                oy = mod.cin(x, scale, bias)
                fwd[name] = graph_ms(lambda: mod.cin(x, scale, bias))
                if hasattr(mod, "cin_forward"):
                    odx = mod.cin_backward(x, g, stats, rows[0], eps)
                    bwd[name] = graph_ms(lambda: mod.cin_backward(x, g, stats, rows[0], eps))
                else:  # the torch-ops backward, which recomputes the moments
                    odx = mod.cin_backward(x, scale, g, eps)
                    bwd[name] = graph_ms(lambda: mod.cin_backward(x, scale, g, eps))
                diffs[name] = ((y.float() - oy.float()).abs().max().item(),
                               max((a.float() - o.float().reshape(a.shape)).abs().max().item()
                                   for a, o in zip(dx, odx)))
            fwd["plain"] = graph_ms(lambda: cin_mod.cin_forward_plain(x, *rows, eps), 5)
            bwd["plain"] = graph_ms(
                lambda: cin_mod.cin_backward_plain(x, g, stats, rows[0], eps), 5)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            fwd["F.instance_norm"] = graph_ms(lambda: F.instance_norm(
                x_nchw, weight=rows[0][0], bias=rows[1][0], eps=eps))
            sweep = {}
            lib = kernels._lib("cin.cu")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            for n in (sms, sms // 2, sms // 4):
                pf, pb = (cin_mod.cin_plan(b, h * w, c, x.element_size(), bw, n)
                          for bw in (False, True))
                ys = torch.empty_like(x), torch.empty_like(stats)
                ds = torch.empty_like(x), torch.empty_like(rows[0]), torch.empty_like(rows[0])
                scratch = torch.empty(b * pf.parts * 2 * c, device=dev)
                if (cin_mod.launch_forward(lib, x, *rows, eps, *ys, scratch, pf)
                        or cin_mod.launch_backward(lib, x, g, stats, rows[0], eps, *ds, scratch,
                                                   pb)):
                    raise RuntimeError(f"cin on {n} blocks: CUDA error at launch")
                sweep[n] = (
                    graph_ms(lambda: cin_mod.launch_forward(lib, x, *rows, eps, *ys, scratch, pf)),
                    graph_ms(lambda: cin_mod.launch_backward(lib, x, g, stats, rows[0], eps, *ds,
                                                             scratch, pb)),
                    [f"{p.pix_sm}/{p.rows * -(-b * p.parts // p.blocks)} rows held"
                     for p in (pf, pb)])
        plan_f = cin_mod._launch_plan(x, False)
        plan_b = cin_mod._launch_plan(x, True)
        phases = {}
        if prof is not None:
            scratch = torch.empty(b * plan_f.parts * 2 * c, device=dev)
            for what, plan, launch in (
                    ("forward", plan_f, lambda cnt: cin_mod.launch_forward(
                        prof, x, *rows, eps, torch.empty_like(x), torch.empty_like(stats),
                        scratch, plan_f, cnt)),
                    ("backward", plan_b, lambda cnt: cin_mod.launch_backward(
                        prof, x, g, stats, rows[0], eps, torch.empty_like(x),
                        torch.empty_like(rows[0]), torch.empty_like(rows[0]), scratch, plan_b,
                        cnt))):
                counters = torch.zeros(plan.blocks * 8, dtype=torch.int64, device=dev)
                for _ in range(3):
                    counters.zero_()
                    if launch(counters):
                        raise RuntimeError(f"profiled cin {what}: CUDA error")
                torch.cuda.synchronize()
                phases[what] = "; " + _phases(counters, CIN_PHASES["cin_kernel"], mhz)
        for what, ms, (bound, by), plan in (("forward", fwd, bounds["forward"], plan_f),
                                            ("backward", bwd, bounds["backward"], plan_b)):
            print(f"{tag} {what} (graph, a call): " + ", ".join(f"{n} {v:.4f} ms"
                                                               for n, v in ms.items())
                  + f"; bound {bound:.4f} ms ({by}); plan: {plan.blocks} blocks, {plan.parts} "
                  f"parts an image of {plan.rows} rows, {plan.pix_sm} rows a block held, "
                  f"{plan.smem_bytes} bytes" + phases.get(what, ""), flush=True)
        print(f"{tag}: largest difference (forward, backward) from " + ", ".join(
            f"{n} {a:.3e}, {d:.3e}" for n, (a, d) in diffs.items())
            + f"; two calls bit-equal {'yes' if same else 'NO'}", flush=True)
        print(f"{tag} by blocks (graph, forward / backward): " + "; ".join(
            f"{k}: {f:.4f} / {bw:.4f} ms ({', '.join(held)})"
            for k, (f, bw, held) in sweep.items()), flush=True)
    return bad


def _build_probe() -> ctypes.CDLL:
    """``probe_int8.cu`` on a copy of ``probe_rep.cuh`` with clock64 counters
    (the source includes the header from its own directory first)."""
    d = kernels.BUILD_DIR / "halo_profile_probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe_rep.cuh").write_text(profiled_source((kernels.CSRC / "probe_rep.cuh").read_text()))
    (d / "probe_int8.cu").write_text((kernels.CSRC / "probe_int8.cu").read_text())
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                    str(d / "probe_int8.so"), str(d / "probe_int8.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "probe_int8.so"))
    lib.rst_probe.argtypes = _ARGTYPES["rst_probe"]
    lib.rst_probe.restype = ctypes.c_int
    return lib


def probe_part(prof, others, mhz: float) -> list:
    """The two matmul probes' arms (the int8 probe's mm and band, bf16 and
    int8, a launch at NREP repetitions and the slope between NREP_LO and NREP,
    mm NREP_MM_HI; the shared-memory probe's work arm, no reservation, a
    launch at REPS[1] and the slope between REPS[0] and REPS_SLOPE_HI) by
    graph replay beside each ROOT's own wrappers on the same seeded inputs;
    each output at the launch's count against the plain version (int8
    exactly, bf16 within 2^-8 of the largest value, the work arm 1e-3) and
    each ROOT's output against this one's; then the phases of a block of
    this build's kernel."""
    from .ops import probe_int8 as pi
    from .ops import probe_smem as ps
    from .ops.probe_rep import rep_plan

    mods = {name: (importlib.import_module(k.__name__.rsplit(".", 2)[0] + ".ops.probe_int8"),
                   importlib.import_module(k.__name__.rsplit(".", 2)[0] + ".ops.probe_smem"))
            for name, k in others.items()}
    dev, bad = torch.device("cuda"), []
    lo, hi = pi.NREP_LO, pi.NREP
    for arm in ("mm", "band"):
        s_hi = pi.NREP_MM_HI if arm == "mm" else hi
        for quant in (False, True):
            x, w, inv = pi.make_inputs(arm, quant, dev, seed=0)
            kind = "int8" if quant else "bf16"
            fns = {"this": pi.probe_mm if arm == "mm" else pi.probe_band}
            fns.update({name: m[0].probe_mm if arm == "mm" else m[0].probe_band
                        for name, m in mods.items()})
            extra = (inv,) if arm == "band" else ()
            want = pi.probe_plain(x, w, hi, inv)
            limit = 0.0 if quant else 2.0 ** -8 * want.abs().max().item()
            mine = fns["this"](x, w, hi, *extra)
            row = [f"probe {arm} {kind}:"]
            for name, fn in fns.items():
                got = mine if name == "this" else fn(x, w, hi, *extra)
                err = (got.double() - want).abs().max().item()
                diff = (got.double() - mine.double()).abs().max().item()
                if err > limit:
                    bad.append(f"probe {arm} {kind} {name}")
                g = {n: graph_ms(lambda fn=fn, n=n: fn(x, w, n, *extra)) for n in {lo, hi, s_hi}}
                row.append(f"{name} x{hi} {g[hi]:.4f} ms; x{lo} {g[lo]:.4f}, x{s_hi} "
                           f"{g[s_hi]:.4f} ms, slope {(g[s_hi] - g[lo]) / (s_hi - lo) * 1e3:.4f} "
                           f"us (max_abs_err {err:.3e}, limit {limit:.3e}; from this build "
                           f"{diff:.3e})")
            print("  ".join(row), flush=True)
            plan = rep_plan(arm, hi, quant, sms=kernels._sm_count(dev))
            counters = torch.zeros(plan.blocks * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                counters.zero_()
                pi.launch_probe(prof, x, w, hi, inv, 1 if arm == "mm" else 3, counters)
            torch.cuda.synchronize()
            print(f"  probe {arm} {kind} x{hi}: " + _phases(counters, PROBE_PHASES["probe_rep_kernel"],
                                                           mhz), flush=True)
    x, w = ps.make_work_inputs(dev, seed=0)
    lo_w, hi_w = ps.REPS
    s_hi = ps.REPS_SLOPE_HI
    want = ps.work_plain(x, w, hi_w)
    mine = ps.work(x, w, hi_w)
    row = ["probe_smem work (no reservation):"]
    for name, fn in {"this": ps.work, **{n: m[1].work for n, m in mods.items()}}.items():
        got = mine if name == "this" else fn(x, w, hi_w)
        err = (got - want).abs().max().item()
        if err > 1e-3 * want.abs().max().item():
            bad.append(f"probe_smem work {name}")
        g = {n: graph_ms(lambda fn=fn, n=n: fn(x, w, n)) for n in (lo_w, hi_w, s_hi)}
        row.append(f"{name} x{hi_w} {g[hi_w]:.4f} ms; x{lo_w} {g[lo_w]:.4f}, x{s_hi} "
                   f"{g[s_hi]:.4f} ms, slope {(g[s_hi] - g[lo_w]) / (s_hi - lo_w) * 1e3:.4f} us "
                   f"(max_abs_err {err:.3e}; from this build "
                   f"{(got - mine).abs().max().item():.3e})")
    print("  ".join(row), flush=True)
    return bad


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("halo_profile: no CUDA device", file=sys.stderr)
        return 2
    # f32 yardsticks in full f32, as the f32 kernels compute
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = PARTS
    if argv[:1] == ["--parts"]:
        parts, argv = tuple(argv[1].split(",")), argv[2:]
        if set(parts) - set(PARTS):
            print(f"halo_profile: --parts takes {','.join(PARTS)}", file=sys.stderr)
            return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    mhz = float(card.split(",")[-1])
    others = {Path(root).name: load_package(root, f"_halo_profile_root{i}")
              for i, root in enumerate(argv)}
    # every build at once: these sources, their profiled copies, each root's
    sources = ("cin.cu",) if parts == ("cin",) else (
        "conv_stage.cu", "conv_matmul.cu", "finish.cu", "act_stats.cu", "cin.cu")
    if "probe" in parts:
        sources = (() if parts == ("probe",) else sources) + ("probe_int8.cu", "probe_smem.cu")
    profiled = {"stages": "conv_stage.cu", "matmul": "conv_matmul.cu",
                "act_stats": "act_stats.cu", "cin": "cin.cu"}
    with ThreadPoolExecutor() as pool:
        profs = {profiled[part]: pool.submit(
            _build, profiled_source((kernels.CSRC / profiled[part]).read_text()),
            f"halo_profile_{Path(profiled[part]).stem}") for part in parts if part in profiled}
        if "probe" in parts:
            profs["probe_rep.cuh"] = pool.submit(_build_probe)
        builds = [pool.submit(k.build, sources) for k in (kernels, *others.values())]
        profs = {src: f.result() for src, f in profs.items()}
        for b in builds:
            b.result()
    print(f"card: {card}", flush=True)
    bad = []
    if "cin" in parts:
        bad += cin_part(others, profs["cin.cu"], mhz)
    if "finish" in parts:
        bad += finish_part(others)
    if "act_stats" in parts:
        bad += act_stats_part(others, profs["act_stats.cu"], mhz)
    if "stages" in parts:
        stage_part(profs["conv_stage.cu"], others, mhz)
    if "matmul" in parts:
        matmul_part(profs["conv_matmul.cu"], others, mhz)
    if "probe" in parts:
        bad += probe_part(profs["probe_rep.cuh"], others, mhz)
    if bad:
        print(f"halo_profile: results differ: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
