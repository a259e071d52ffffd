"""Hand-written CUDA kernels of the fused transfer path, with plain twins.

``conv_stage`` (``csrc/conv_stage.cu``) and ``finish`` (``csrc/finish.cu``)
replace the TPU kernel ``FusedTransfer._kernel_impl``
(``realtime_style_transfer_tpu/ops/pallas/fused_transfer.py``): its conv
stages (``run_conv`` / ``run_conv_direct`` with ``fold_cin_affine``) and its
``run_pointwise`` finish, single or dual style (``fold_cin_affine``'s delta
rows and the per-pixel blend), bf16 or int8 (the ``quant='int8'`` engine:
per-input-channel activation scales folded into per-output-column int8
weights, the input quantized where it is made, int32 sums dequantized in the
f32 epilogue).  ``act_stats`` (``csrc/act_stats.cu``) replaces its calibrate
and check modes.  The TPU kernel runs all stages in one launch; here each
stage is one launch, because CIN moments are whole-frame sums and blocks on a
GPU cannot wait for each other inside a launch.

Bounds on the H100, from the flagship's shapes: the conv stages are bound by
operations (about 127 GFLOP against 0.35 GB a frame), so the kernel keeps
every conv on the tensor cores (``mma.sync``) and fuses the CIN prologue, the
epilogue and the moments into the conv, so no activation makes an extra trip
through device memory.  What the kernel meets first is L2 traffic, because
every block reads the whole weight matrix: the 9x9 stages read their MMA
operands from a shared-memory input window four output rows tall, the others
gather A tiles in blocks of 128 pixels (``PERF.md`` has the measurements).
``finish`` and ``act_stats`` are one elementwise pass each, bound by bytes.

Each wrapper dispatches on the device of its input: a CPU tensor goes to the
plain PyTorch version (same signature, same rounding points: bf16 storage,
f32 affine, f32 moments taken before rounding; int8 sums exact in float64), a
CUDA tensor launches the kernel or raises.  Each wrapper's ``launches`` counts
kernel launches only (a launch recorded into a CUDA graph counts once, when it
is recorded); :func:`replay_graph` counts the replays of such a graph.

The kernels build with ``nvcc`` on first use into ``build/rst_torch_kernels/``
at the repository root (one ``nvcc`` per source, all started together) and
load through ``ctypes``.  :data:`SOURCES` lists every CUDA source of the port;
the wrappers of the packed path's ``conv_matmul`` and of the probes live in
their own modules (:mod:`.conv_matmul`, :mod:`.probe_int8`,
:mod:`.probe_repack`, :mod:`.probe_smem`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .conv import depth_to_space_2x
from .packed_conv import pack, unpack

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rst_torch_kernels"
SOURCES = ("conv_stage.cu", "finish.cu", "act_stats.cu", "probe_int8.cu", "probe_repack.cu",
           "conv_matmul.cu", "probe_smem.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BK = 32          # reduction slice of conv_stage.cu: K is padded to it
Q_CIN_ALIGN = 32  # an int8 window stage pads cin_k to it: one tap a k32 slice
MAX_CIN = 128    # widest CIN prologue conv_stage.cu holds in shared memory
EPI = {"contract": 0, "relu": 1, "bias": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "rst_conv_stage": ([_P] * 12 + [_F, _F, _I, _I, _P, _P, _P, _P] + [_I] * 19
                       + [_P, _P, _I, _P]),
    "rst_finish": [_P] * 7 + [_F, _F, _P] + [_I] * 4 + [_P],
    "rst_act_stats": [_P] * 7 + [_F, _F, _I, _I] + [_P] * 4 + [_I] * 4 + [_P],
    "rst_probe": [_P] * 4 + [_I] * 5 + [_P],
    "rst_repack": [_P] * 3 + [_I] * 8 + [_P],
    "rst_conv_matmul": [_P] * 6 + [_I] * 8 + [_P],
    "rst_probe_smem": [_I] * 4 + [_P] * 5,
}
_LIBS: Dict[str, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(source: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    text = (CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(sources=SOURCES) -> Dict[str, str]:
    """Compile the sources not built yet, all in parallel; return each
    source's ptxas report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        lib = _lib_path(source)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports: Dict[str, str] = {}
    failed = []
    for source, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        reports[source] = log
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _lib(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build(SOURCES)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# stage description
# ---------------------------------------------------------------------------


class Prologue(NamedTuple):
    """The producer's CIN, applied by the consumer to each value it loads.

    Dual style shares the moments between the two styles and blends their
    affines per pixel by ``weight``, the second style's weight at the
    consumer's input resolution.
    """

    stats: torch.Tensor   # (2, C) f32: sums and sums of squares
    count: float          # values per channel behind those sums
    scale: torch.Tensor   # (C,) f32 style scale row
    bias: torch.Tensor    # (C,) f32 style bias row
    eps: float
    relu: bool
    scale1: Optional[torch.Tensor] = None  # (C,) f32 second style's scale row
    bias1: Optional[torch.Tensor] = None   # (C,) f32 second style's bias row
    weight: Optional[torch.Tensor] = None  # (H', W') bf16 weight of the second style

    @property
    def dual(self) -> bool:
        return self.weight is not None


@dataclasses.dataclass(frozen=True)
class ConvStage:
    """One conv stage: geometry plus its operands in the kernel's layout.

    The conv reads input pixel ``(oy*stride - pad_top + ty, ox*stride -
    pad_left + tx)`` for output grid pixel (oy, ox) and tap (ty, tx); taps
    outside the image read zero.  A ``transpose`` stage is the parity-packed
    dense conv of :func:`..conv.pack_transpose_kernel`: its ``n = 4 * c_log``
    columns are parity classes, stored through depth-to-space.  A ``window``
    stage (stride 1, more than 9 taps) reads its MMA fragments from a
    shared-memory input window, with channels padded to ``cin_k``, a multiple
    of 16 (of 32 for an int8 stage); the other stages gather A tiles through
    ``kmap``.

    An int8 (``quant``) stage holds int8 weights with the activation scales
    folded in, ``dequant = s_w / 127`` per output column and ``act_inv =
    127 / s_c`` per input channel (``fused_transfer.py:768-780``).
    """

    name: str
    w: torch.Tensor          # (n, k_pad) bf16 (int8 if quant), k = (ty * kw + tx) * cin_k + c
    kmap: Optional[torch.Tensor]  # gather path: (k_pad,) int32, (ty << 20) |
                             # (tx << 10) | c, -1 for padding
    bias: torch.Tensor       # (n,) f32
    cscale: Optional[torch.Tensor]  # (n,) f32, epi == 'contract'
    cshift: Optional[torch.Tensor]
    in_hw: Tuple[int, int]
    cin: int
    pack_c: int              # > 0: input is the f4 frame pack with pack_c channels
    out_hw: Tuple[int, int]  # output grid
    n: int
    c_log: int
    kh: int
    kw: int
    stride: int
    pad_top: int
    pad_left: int
    transpose: bool
    epi: str
    cin_k: int               # channel stride of the K index
    window: bool
    quant: bool = False
    dequant: Optional[torch.Tensor] = None  # (n,) f32, int8 only
    act_inv: Optional[torch.Tensor] = None  # (cin,) f32, int8 only

    @property
    def k_real(self) -> int:
        return self.kh * self.kw * self.cin_k

    def weight_oihw(self) -> torch.Tensor:
        """The stage's bf16 (or int8) weights as an f32 OIHW tensor."""
        w = self.w[:, :self.k_real].float().reshape(self.n, self.kh, self.kw, self.cin_k)
        return w[..., :self.cin].permute(0, 3, 1, 2)

    @property
    def in_shape(self) -> Tuple[int, ...]:
        h, w = self.in_hw
        if self.pack_c:
            return (h // 4, w // 4, self.pack_c)
        return (h, w, self.cin)

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        oh, ow = self.out_hw
        if self.transpose:
            return (2 * oh, 2 * ow, self.c_log)
        return (oh, ow, self.n)

    @property
    def block_n(self) -> int:
        return min(128, max(8, 1 << (self.n - 1).bit_length()))


def quantize_kernel(kernel: np.ndarray, act_scale) -> Tuple[np.ndarray, np.ndarray,
                                                               np.ndarray]:
    """HWIO f32 ``kernel`` and its input's (cin,) activation scales -> (int8
    kernel, (cout,) dequant row, (cin,) act_inv row), as the JAX package's
    int8 engine builds them (``fused_transfer.py:768-780``): the scales fold
    into the cin rows, then symmetric per-output-column int8 scales."""
    kernel = np.asarray(kernel, np.float32)
    s_c = np.maximum(np.asarray(act_scale, np.float32)[:kernel.shape[2]], 1e-6)
    k_scaled = kernel * s_c[None, None, :, None]
    s_w = np.abs(k_scaled).reshape(-1, kernel.shape[3]).max(axis=0)
    s_w = np.maximum(s_w / 127.0, 1e-12)
    q = np.clip(np.rint(k_scaled / s_w), -127, 127).astype(np.int8)
    return q, (s_w / 127.0).astype(np.float32), (127.0 / s_c).astype(np.float32)


def make_conv_stage(name: str, kernel: np.ndarray, bias: np.ndarray, *,
                    in_hw, out_hw, stride: int, pads: Tuple[int, int], epi: str,
                    device, pack_c: int = 0, transpose_cout: int = 0,
                    cscale=None, cshift=None, act_scale=None) -> ConvStage:
    """Lay out an HWIO ``kernel`` (f32 numpy) as a stage's operands.

    Stride-1 stages with more than 9 taps take the window path; the others
    gather, which needs ``cin % 8 == 0`` and an NHWC input.  Given the
    ``(cin,)`` activation scales of its input, ``act_scale``, the stage is
    int8 (:func:`quantize_kernel`).
    """
    kh, kw, cin, n = kernel.shape
    if epi not in EPI:
        raise ValueError(f"unknown epilogue {epi!r}")
    window = stride == 1 and kh * kw > 9
    if not window and (pack_c or cin % 8):
        raise ValueError(f"{name}: the gather path needs an NHWC input with "
                         f"cin % 8 == 0, got cin={cin}, pack_c={pack_c}")
    quant = act_scale is not None
    dequant = act_inv = None
    if quant:
        if np.shape(act_scale) != (cin,):
            raise ValueError(f"{name}: act_scale must be per-input-channel ({cin},), "
                             f"got {np.shape(act_scale)}")
        kernel, dequant, act_inv = quantize_kernel(kernel, act_scale)
    align = Q_CIN_ALIGN if quant else 16
    cin_k = -(-cin // align) * align if window else cin
    k_real = kh * kw * cin_k
    k_pad = -(-k_real // BK) * BK
    padded = np.zeros((kh, kw, cin_k, n), np.float32)
    padded[:, :, :cin] = kernel
    w = np.zeros((n, k_pad), np.float32)
    w[:, :k_real] = padded.reshape(k_real, n).T
    kmap = None
    if not window:
        kk = np.arange(k_real)
        kmap = np.full(k_pad, -1, np.int32)
        kmap[:k_real] = ((kk // (kw * cin)) << 20) | (((kk // cin) % kw) << 10) | (kk % cin)

    def f32(a):
        return None if a is None else torch.tensor(np.asarray(a, np.float32), device=device)

    if (epi == "contract") != (cscale is not None and cshift is not None):
        raise ValueError(f"{name}: contract scale/shift go with epi='contract'")
    return ConvStage(
        name=name,
        w=torch.tensor(w, device=device).to(torch.int8 if quant else torch.bfloat16),
        kmap=None if kmap is None else torch.tensor(kmap, device=device),
        bias=f32(bias), cscale=f32(cscale), cshift=f32(cshift),
        in_hw=tuple(in_hw), cin=cin, pack_c=pack_c, out_hw=tuple(out_hw),
        n=n, c_log=transpose_cout or n, kh=kh, kw=kw, stride=stride,
        pad_top=pads[0], pad_left=pads[1], transpose=transpose_cout > 0, epi=epi,
        cin_k=cin_k, window=window, quant=quant, dequant=f32(dequant), act_inv=f32(act_inv),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def fold_cin(pro: Prologue):
    """Moments + style rows -> the per-channel affine (a, b) and, dual, the
    second style's affine minus the first's (da, db), all f32; (da, db) are
    None for one style."""
    # divide by a tensor on the stats' device: CUDA divides by a host scalar
    # as a product with its reciprocal, the kernels (and the CPU) truly divide
    count = pro.stats.new_tensor(pro.count)
    mean = pro.stats[0] / count
    var = pro.stats[1] / count - mean * mean
    inv = torch.reciprocal(torch.sqrt(var + pro.eps))
    a = pro.scale * inv
    b = pro.bias - mean * a
    if not pro.dual:
        return a, b, None, None
    a1 = pro.scale1 * inv
    return a, b, a1 - a, (pro.bias1 - mean * a1) - b


def cin_affine(xf: torch.Tensor, pro: Prologue) -> torch.Tensor:
    """The CIN affine of (H', W', C) f32 ``xf``: ``x*a + b``, or, dual,
    ``(x*a + b) + w*(x*da + db)`` with every product and sum rounded to f32
    in that order, as the kernels do."""
    a, b, da, db = fold_cin(pro)
    f = xf * a + b
    if pro.dual:
        f = f + pro.weight.float()[..., None] * (xf * da + db)
    return f


def unpack_frame(packed: torch.Tensor, c: int) -> torch.Tensor:
    """(h/4, w/4, >=16c) f4 frame pack -> (h, w, c), same dtype."""
    return unpack(packed[None, :, :, :16 * c], 4, c)[0]


def stage_input(x: torch.Tensor, st: ConvStage, prologue: Optional[Prologue] = None,
                skip_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x' of a stage, the (H, W, cin) bf16 value its conv reads: the input
    (the stem's frame pack unpacked) after the CIN affine, ReLU and skip."""
    xb = unpack_frame(x, st.cin) if st.pack_c else x
    if prologue is None and skip_in is None:
        return xb
    xf = xb.float()
    if prologue is not None:
        xf = cin_affine(xf, prologue)
        if prologue.relu:
            xf = torch.relu(xf)
    if skip_in is not None:
        xf = xf + skip_in.float()
    return xf.to(torch.bfloat16)


def quantize_plain(xb: torch.Tensor, act_inv: torch.Tensor) -> torch.Tensor:
    """clamp(round(f32(x') * act_inv), -127, 127), ties to even, as f32."""
    return torch.round(xb.float() * act_inv).clamp_(-127.0, 127.0)


def conv_stage_plain(x: torch.Tensor, st: ConvStage, out: torch.Tensor, *,
                     prologue: Optional[Prologue] = None,
                     skip_in: Optional[torch.Tensor] = None,
                     skip_out: Optional[torch.Tensor] = None,
                     stats_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`conv_stage`.  An int8 stage quantizes x'
    (zero padding stays zero) and convolves the integer values in float64,
    where every sum is exact; the result rounds once to f32 before the
    dequant, as the kernel's int32 sum does."""
    h, w = st.in_hw
    xb = stage_input(x, st, prologue, skip_in)
    if skip_out is not None:
        skip_out.copy_(xb)
    oh, ow = st.out_hw
    pad_bottom = (oh - 1) * st.stride + st.kh - h - st.pad_top
    pad_right = (ow - 1) * st.stride + st.kw - w - st.pad_left
    pads = (st.pad_left, pad_right, st.pad_top, pad_bottom)
    if st.quant:
        xp = F.pad(quantize_plain(xb, st.act_inv).permute(2, 0, 1)[None].double(), pads)
        # no cuDNN: its FFT and Winograd algorithms would not keep the sums exact
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(xp, st.weight_oihw().double(), stride=st.stride)
        v = acc[0].permute(1, 2, 0).float() * st.dequant
    else:
        xp = F.pad(xb.float().permute(2, 0, 1)[None], pads)
        v = F.conv2d(xp, st.weight_oihw(), stride=st.stride)[0].permute(1, 2, 0)
    v = v + st.bias
    if st.epi == "contract":
        v = torch.relu(torch.relu(v) * st.cscale + st.cshift)
    elif st.epi == "relu":
        v = torch.relu(v)
    if stats_out is not None:
        stats_out[0] += v.sum(dim=(0, 1)).reshape(-1, st.c_log).sum(dim=0)
        stats_out[1] += (v * v).sum(dim=(0, 1)).reshape(-1, st.c_log).sum(dim=0)
    y = v.to(torch.bfloat16)
    out.copy_(depth_to_space_2x(y[None], st.c_log)[0] if st.transpose else y)
    return out


def act_stats_plain(x: torch.Tensor, st: ConvStage, prologue: Optional[Prologue] = None,
                    skip_in: Optional[torch.Tensor] = None,
                    act_inv: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`act_stats`: per input channel of ``st``,
    the max of |x'| (f32) and, given the ``act_inv`` row, the count of values
    with ``|x'| * act_inv > 127.5`` (int32), each element counted once."""
    a = stage_input(x, st, prologue, skip_in).float().abs().reshape(-1, st.cin)
    clips = (torch.zeros(st.cin, dtype=torch.int32, device=x.device) if act_inv is None
             else (a * act_inv > 127.5).sum(dim=0, dtype=torch.int32))
    return a.amax(dim=0), clips


def finish_plain(x: torch.Tensor, prologue: Prologue, out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`finish`."""
    c = x.shape[2]
    y = torch.sigmoid(cin_affine(x.float(), prologue)).to(torch.bfloat16)
    out.zero_()
    out[:, :, :16 * c] = pack(y[None], 4)[0]
    return out


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version, CUDA -> kernel
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: want a contiguous 16-byte-aligned tensor")


def _check_stage_inputs(x, st: ConvStage, prologue: Optional[Prologue],
                        skip_in: Optional[torch.Tensor]) -> None:
    """The checks :func:`conv_stage` and :func:`act_stats` share: the input,
    the prologue and the incoming skip of stage ``st``."""
    dev = x.device
    _check(x, f"{st.name} input", torch.bfloat16, st.in_shape, dev)
    if st.pack_c and (prologue is not None or skip_in is not None):
        raise ValueError(f"{st.name}: a pack-input stage takes no prologue or skips")
    if skip_in is not None:
        _check(skip_in, f"{st.name} skip_in", torch.bfloat16, st.in_shape, dev)
    if prologue is not None:
        if st.cin > MAX_CIN:
            raise ValueError(f"{st.name}: a CIN prologue takes <= {MAX_CIN} channels")
        _check_prologue(prologue, st.name, st.cin, st.in_hw, dev)


def _check_prologue(pro: Prologue, name: str, c: int, hw, device) -> None:
    f32 = torch.float32
    _check(pro.stats, f"{name} prologue stats", f32, (2, c), device)
    _check(pro.scale, f"{name} prologue scale", f32, (c,), device)
    _check(pro.bias, f"{name} prologue bias", f32, (c,), device)
    second = (pro.scale1, pro.bias1, pro.weight)
    if any(t is None for t in second) != all(t is None for t in second):
        raise ValueError(f"{name}: dual style needs scale1, bias1 and weight together")
    if pro.dual:
        _check(pro.scale1, f"{name} prologue scale1", f32, (c,), device)
        _check(pro.bias1, f"{name} prologue bias1", f32, (c,), device)
        _check(pro.weight, f"{name} prologue weight", torch.bfloat16, hw, device)


def _prologue_args(pro: Optional[Prologue]):
    """The six pointers of a prologue, in the kernels' argument order."""
    if pro is None:
        return (None,) * 6
    return tuple(_ptr(t) for t in (pro.stats, pro.scale, pro.bias, pro.scale1,
                                   pro.bias1, pro.weight))


def conv_stage(x: torch.Tensor, st: ConvStage, out: torch.Tensor, *,
               prologue: Optional[Prologue] = None,
               skip_in: Optional[torch.Tensor] = None,
               skip_out: Optional[torch.Tensor] = None,
               stats_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one conv stage into ``out``; add its moments into ``stats_out``."""
    if x.device.type == "cpu":
        return conv_stage_plain(x, st, out, prologue=prologue, skip_in=skip_in,
                                skip_out=skip_out, stats_out=stats_out)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stage runs on CUDA or the CPU, not {x.device}")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    _check_stage_inputs(x, st, prologue, skip_in)
    _check(out, f"{st.name} output", bf16, st.out_shape, dev)
    if skip_out is not None and st.window:
        raise ValueError(f"{st.name}: the window path writes no skip_out")
    if skip_out is not None:
        _check(skip_out, f"{st.name} skip_out", bf16, st.in_shape, dev)
    if skip_out is not None and (st.stride != 1 or st.transpose
                                 or (st.pad_top, st.pad_left) != (st.kh // 2, st.kw // 2)):
        raise ValueError(f"{st.name}: skip_out needs a stride-1 centred conv")
    if stats_out is not None:
        _check(stats_out, f"{st.name} stats_out", f32, (2, st.c_log), dev)
    oh, ow = st.out_hw
    err = _lib("conv_stage.cu").rst_conv_stage(
        _ptr(x), _ptr(st.w), _ptr(st.kmap), _ptr(st.bias), _ptr(st.cscale),
        _ptr(st.cshift), *_prologue_args(prologue),
        float(prologue.count) if prologue else 1.0,
        float(prologue.eps) if prologue else 0.0,
        int(prologue is not None), int(bool(prologue and prologue.relu)),
        _ptr(skip_in), _ptr(skip_out), _ptr(out), _ptr(stats_out),
        st.in_hw[0], st.in_hw[1], st.cin, st.pack_c, oh, ow, st.n,
        st.w.shape[1], st.kh, st.kw, st.stride, st.pad_top, st.pad_left, st.c_log,
        int(st.transpose), EPI[st.epi], st.cin_k, int(st.window), st.block_n,
        _ptr(st.dequant), _ptr(st.act_inv), int(st.quant), _stream(x))
    if err:
        raise RuntimeError(f"conv_stage {st.name}: CUDA error {err} at launch")
    conv_stage.launches += 1
    return out


conv_stage.launches = 0


def act_stats(x: torch.Tensor, st: ConvStage, prologue: Optional[Prologue] = None,
              skip_in: Optional[torch.Tensor] = None,
              act_inv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per input channel of stage ``st`` on its input ``x`` (with the
    stage's prologue and skip): (max |x'| f32, clip count int32 under the
    ``act_inv`` row, zeros without it)."""
    if x.device.type == "cpu":
        return act_stats_plain(x, st, prologue, skip_in, act_inv)
    if x.device.type != "cuda":
        raise ValueError(f"act_stats runs on CUDA or the CPU, not {x.device}")
    dev = x.device
    _check_stage_inputs(x, st, prologue, skip_in)
    if act_inv is not None:
        _check(act_inv, f"{st.name} act_inv", torch.float32, (st.cin,), dev)
    maxima = torch.zeros(st.cin, dtype=torch.float32, device=dev)
    clips = torch.zeros(st.cin, dtype=torch.int32, device=dev)
    err = _lib("act_stats.cu").rst_act_stats(
        _ptr(x), *_prologue_args(prologue),
        float(prologue.count) if prologue else 1.0,
        float(prologue.eps) if prologue else 0.0,
        int(prologue is not None), int(bool(prologue and prologue.relu)),
        _ptr(skip_in), _ptr(act_inv), _ptr(maxima),
        None if act_inv is None else _ptr(clips),
        st.in_hw[0], st.in_hw[1], st.cin, st.pack_c, _stream(x))
    if err:
        raise RuntimeError(f"act_stats {st.name}: CUDA error {err} at launch")
    act_stats.launches += 1
    return maxima, clips


act_stats.launches = 0


def finish(x: torch.Tensor, prologue: Prologue, out: torch.Tensor) -> torch.Tensor:
    """sigmoid(CIN(x)) of the final (H, W, C) stage into the packed
    (H/4, W/4, out_c) bf16 frame; channels >= 16*C are zero.  A dual
    prologue's weight plane is (H, W)."""
    if x.device.type == "cpu":
        return finish_plain(x, prologue, out)
    if x.device.type != "cuda":
        raise ValueError(f"finish runs on CUDA or the CPU, not {x.device}")
    h, w, c = x.shape
    dev = x.device
    _check(x, "finish input", torch.bfloat16, (h, w, c), dev)
    if h % 4 or w % 4 or c > MAX_CIN or out.shape[2] < 16 * c:
        raise ValueError(f"finish: unsupported shapes {tuple(x.shape)} -> {tuple(out.shape)}")
    _check(out, "finish output", torch.bfloat16, (h // 4, w // 4, out.shape[2]), dev)
    _check_prologue(prologue, "finish", c, (h, w), dev)
    err = _lib("finish.cu").rst_finish(
        _ptr(x), *_prologue_args(prologue), float(prologue.count),
        float(prologue.eps), _ptr(out), h, w, c, out.shape[2], _stream(x))
    if err:
        raise RuntimeError(f"finish: CUDA error {err} at launch")
    finish.launches += 1
    return out


finish.launches = 0


def replay_graph(graph: "torch.cuda.CUDAGraph") -> None:
    """Replay a CUDA graph of recorded kernel launches.  A replay does not
    pass through the wrappers, so ``replay_graph.replays`` counts it."""
    graph.replay()
    replay_graph.replays += 1


replay_graph.replays = 0


def reset_launch_counts() -> None:
    conv_stage.launches = 0
    finish.launches = 0
    act_stats.launches = 0
    replay_graph.replays = 0
