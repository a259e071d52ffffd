"""Where a halo-path launch of ``csrc/conv_stage.cu`` spends its time, on one card.

    python -m realtime_style_transfer_torch.halo_profile [PARENT_ROOT]

For the halo stages of the flagship frame (res0b, res0a, e0, e1 at their real
shapes, e2 of rst-1920, and a 5x11 grid that is one block), bf16 and int8,
with an affine + ReLU prologue and moments, prints the device time of one
launch as the replay of a CUDA graph of 20 launches, beside ``F.conv2d``
bf16 on the same input (bf16 stages) and, given PARENT_ROOT (a checkout of a
version whose ``conv_stage.cu`` runs such stages on its gather path, with
``rst_conv_stage``'s argument list), that kernel on the same stage.  Then the
phases of a block, read by ``clock64`` in a copy of ``conv_stage.cu`` with
counters added at fixed points of ``conv_halo_kernel`` (warp 0, lane 0 of
each block, microseconds at the card's maximum SM clock, the median over the
blocks).  Needs one CUDA device, ``nvcc`` and ``nvidia-smi``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .ops import kernels
from .ops.conv import pack_transpose_kernel
from .ops.kernels import _ARGTYPES, Prologue, launch_conv_stage, make_conv_stage
from .timing import graph_ms

PHASES = ("fill + fold", "halo wait", "prologue pass", "K loop", "sums to shared", "epilogue",
          "moments flush")
CASES = (("res0b", (120, 240), 128, 128, False), ("res0a", (120, 240), 32, 128, False),
         ("e0", (120, 240), 128, 32, True), ("e1", (240, 480), 32, 16, True),
         ("e2 (rst-1920)", (480, 960), 16, 8, True), ("one block", (5, 11), 128, 128, False))


def profiled_source(text: str) -> str:
    """conv_stage.cu with clock64 counters in conv_halo_kernel: each of its
    ``// PROFILE LAP i`` markers, in order i = 0, 1, ..., closes counter i;
    each block's warp 0 writes them to the buffer passed as ``kmap`` (which
    the halo path does not read)."""
    head, sep, body = text.partition("conv_halo_kernel(const Params p) {\n")
    if not sep:
        raise ValueError("conv_halo_kernel not found")
    kernel, sep2, rest = body.partition("\n}\n")
    laps = [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", kernel)]
    if laps != list(range(len(PHASES))):
        raise ValueError(f"conv_halo_kernel's PROFILE LAP markers are {laps}, "
                         f"not 0..{len(PHASES) - 1}")
    kernel = ("  long long _c[8] = {0}, _t = clock64(), _u;\n"
              "#define LAP(i) do { _u = clock64(); _c[i] += _u - _t; _t = _u; } while (0)\n"
              + re.sub(r"// PROFILE LAP (\d+)", r"LAP(\1);", kernel) + "\n")
    kernel += ("  if (threadIdx.x == 0)\n    for (int i = 0; i < 8; ++i)\n"
               "      reinterpret_cast<long long*>(const_cast<int*>(p.kmap))[blockIdx.x * 8 + i]"
               " = _c[i];\n#undef LAP")
    return head + sep + kernel + sep2 + rest


def _build(text: str, name: str) -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = kernels.BUILD_DIR / f"{name}.cu", kernels.BUILD_DIR / f"{name}.so"
    cu.write_text(text)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.rst_conv_stage.argtypes = _ARGTYPES["rst_conv_stage"]
    lib.rst_conv_stage.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("halo_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    mhz = float(card.split(",")[-1])
    kernels.build(("conv_stage.cu",))
    prof = _build(profiled_source((kernels.CSRC / "conv_stage.cu").read_text()), "halo_profile")
    parent = None
    if argv:
        parent_cu = Path(argv[0]) / "realtime_style_transfer_torch" / "csrc" / "conv_stage.cu"
        parent = _build(parent_cu.read_text(), "halo_profile_parent")
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng, gen = np.random.default_rng(0), torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card}", flush=True)
    for quant in (False, True):
        for label, hw, cin, cout, transpose in CASES:
            kernel = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
                np.float32)
            bias, pads = np.zeros(cout, np.float32), (1, 1)
            if transpose:
                packed, (pad_y, pad_x) = pack_transpose_kernel(torch.from_numpy(kernel))
                kernel, pads, bias = packed.numpy(), (pad_y[0], pad_x[0]), np.tile(bias, 4)
            st = make_conv_stage(label, kernel, bias, in_hw=hw, out_hw=hw, stride=1, pads=pads,
                                 epi="bias" if transpose else "relu", device=dev,
                                 transpose_cout=cout if transpose else 0,
                                 act_scale=np.full(cin, 2.0, np.float32) if quant else None)
            x = torch.rand(st.in_shape, generator=gen, device=dev).to(bf16)
            xf = x.float().reshape(-1, cin)
            pro = Prologue(torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous(),
                           float(xf.shape[0]), torch.rand(cin, generator=gen, device=dev) + 0.5,
                           torch.rand(cin, generator=gen, device=dev) - 0.5, 1e-5, True)
            out = torch.empty(st.out_shape, dtype=bf16, device=dev)
            stats = torch.zeros((2, st.c_log), device=dev)
            row = [f"{label}{' int8' if quant else ''} {hw[0]}x{hw[1]}x{cin} -> {st.n}:"]
            halo_ms = graph_ms(lambda: kernels.conv_stage(x, st, out, prologue=pro,
                                                          stats_out=stats))
            row.append(f"halo {halo_ms:.4f} ms")
            if parent is not None:
                parent_ms = graph_ms(lambda: launch_conv_stage(
                    parent, x, st, out, "gather", st.kmap, prologue=pro, stats_out=stats))
                row.append(f"parent's gather path {parent_ms:.4f} ms")
            if not quant:
                xp = F.pad(x.permute(2, 0, 1)[None], (st.pad_left, st.kw - 1 - st.pad_left,
                                                      st.pad_top, st.kh - 1 - st.pad_top))
                xp = xp.contiguous(memory_format=torch.channels_last)
                wt = st.weight_oihw().to(bf16).contiguous(memory_format=torch.channels_last)
                row.append(f"F.conv2d {graph_ms(lambda: F.conv2d(xp, wt)):.4f} ms")
            counters = torch.zeros(st.grid[0] * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                counters.zero_()
                launch_conv_stage(prof, x, st, out, "halo", counters, prologue=pro,
                                  stats_out=stats)
            torch.cuda.synchronize()
            us = counters.view(-1, 8)[:, :len(PHASES)].double().cpu() / mhz
            med = us.median(dim=0).values
            row.append("phases (us, median of " + f"{us.shape[0]} blocks): " + ", ".join(
                f"{name} {float(v):.2f}" for name, v in zip(PHASES, med))
                + f"; a block {float(us.sum(dim=1).median()):.2f}")
            print("  ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
