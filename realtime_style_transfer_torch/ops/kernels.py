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
every conv on the tensor cores (``wgmma``) and fuses the CIN prologue, the
epilogue and the moments into the conv, so no activation makes an extra trip
through device memory.  Every stage loads its block's input tile into shared
memory once and streams its weights through a ring of slices by TMA copies
(:func:`halo_slices`).  Each stage takes one of three A-operand paths,
chosen from its geometry alone (:func:`stage_path`): the 9x9 stages read
their MMA operands from a pixel-major input window four output rows tall,
their K running along a window row (``window``), the stride-1 stages of at
most 9 taps from the input halo of an 8x16 output tile (``halo``), the
stride-2 stages from the same tile over an input halo split by column parity
(``strided``); ``PERF.md`` has the measurements.
``finish`` and ``act_stats`` are one elementwise pass each, bound by bytes;
their grids come from :func:`finish_plan` and :func:`act_stats_plan`, whose
numpy twins :func:`finish_map` and :func:`stem_stats_map` replay the
kernels' index maps for the CPU tests.  ``act_stats`` maxes and adds into
rows its caller passes, so a calibrate or check run keeps one table a call.

Each wrapper dispatches on the device of its input: a CPU tensor goes to the
plain PyTorch version (same signature, same rounding points: bf16 storage,
f32 affine, f32 moments taken before rounding; int8 sums exact in float64), a
CUDA tensor launches the kernel or raises.  Each wrapper's ``launches`` counts
kernel launches only (a launch recorded into a CUDA graph counts once, when it
is recorded; ``conv_stage.path_launches`` splits its count by path,
``conv_stage.stage_launches`` by stage name);
:func:`replay_graph` counts the replays of such a graph.
``conv_stage.blends`` and ``finish.blends`` count the calls given a dual
prologue, which blend two styles per pixel by its weight plane: on the card
each is one launch, counted as ``launches`` is; on the CPU each is one call
of the plain version.
:func:`graph_input_node` and :func:`set_graph_input` re-point a recorded
graph's stem launch at another frame pack.  While spans are
recorded (:mod:`..tracing.spans`), a ``launch`` span goes around the ctypes
call of ``conv_stage`` and ``finish`` alone: the CUDA runtime call that
launches the kernel is inside it.

The kernels build with ``nvcc`` on first use into ``build/rst_torch_kernels/``
at the repository root (one ``nvcc`` per source, all started together) and
load through ``ctypes``.  :data:`SOURCES` lists every CUDA source of the port;
the wrappers of the packed path's ``conv_matmul``, of the training path's
``cin`` and of the probes live in their own modules (:mod:`.conv_matmul`,
:mod:`.cin`, :mod:`.probe_int8`, :mod:`.probe_repack`, :mod:`.probe_smem`).
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

from ..tracing import spans
from .conv import depth_to_space_2x
from .packed_conv import pack, unpack

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rst_torch_kernels"
SOURCES = ("conv_stage.cu", "finish.cu", "act_stats.cu", "probe_int8.cu", "probe_repack.cu",
           "conv_matmul.cu", "probe_smem.cu", "cin.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BK = 32          # K is padded to it: one wgmma K step of int8
WINDOW_BM = 64   # output columns a window-path block of conv_stage.cu (BM)
HALO_TH = 8      # output rows of a halo-path block of conv_stage.cu
HALO_TW = 16     # output columns of a halo-path block
RING = 3         # weight slices a block keeps in shared memory ...
SLICE_BYTES = 128  # ... each this many bytes of K for every column of the block
MAX_DYN_BYTES = 200 * 1024  # conv_stage.cu's cap on a block's dynamic shared memory
PATHS = {"strided": 0, "window": 1, "halo": 2}  # conv_stage.cu's PATH_* codes
MOMENT_GROUP = 32  # conv_stage.cu's GROUP: blocks one block adds the moments of
MAX_CIN = 128    # widest CIN prologue conv_stage.cu holds in shared memory
EPI = {"contract": 0, "relu": 1, "bias": 2}
SMS = 132        # the H100's SMs: what the grid twins size for without a card
PASS_THREADS = 256  # threads a block of finish.cu and act_stats.cu
FINISH_STAGE = 4096  # most input values a finish block stages a row (4 * tpx * C)
STATS_LOADS = 4  # act_stats.cu's LOADS: vectors a thread copies a stage of its ring
STATS_BLOCKS_PER_SM = 2  # act_stats' grid, where the input has the pixels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "rst_conv_stage": ([_P] * 12 + [_F, _F, _I, _I, _P, _P, _P, _P] + [_I] * 19
                       + [_P, _P, _I, _P, _P, _I, _I, _P]),
    "rst_finish": [_P] * 7 + [_F, _F, _P] + [_I] * 5 + [_P],
    "rst_act_stats": [_P] * 7 + [_F, _F, _I, _I] + [_P] * 5 + [_I] * 6 + [_P],
    "rst_probe": [_P] * 6 + [_I] * 6 + [_P],
    "rst_repack": [_P] * 3 + [_I] * 8 + [_P],
    "rst_conv_matmul": [_P] * 8 + [_I] * 13 + [_P],
    "rst_conv_matmul_f32": [_P] * 7 + [_I] * 11 + [_P],
    "rst_probe_smem": [_I] * 5 + [_P] * 6,
    "rst_cin_forward": [_P, _I, _P, _P, _F] + [_P] * 4 + [_I] * 6 + [_P],
    "rst_cin_backward": [_P, _P, _I, _P, _P, _F] + [_P] * 5 + [_I] * 6 + [_P],
    "rst_cin_forward_sums": [_P, _I, _P, _P] + [_I] * 5 + [_P],
    "rst_cin_forward_apply": [_P, _I, _P, _I, _P, _P, _F, _P, _P] + [_I] * 5 + [_P],
    "rst_cin_backward_sums": [_P, _P, _I, _P, _P, _P] + [_I] * 5 + [_P],
    "rst_cin_backward_apply": [_P, _P, _I, _P, _P, _I, _P, _F, _P] + [_I] * 5 + [_P],
    "rst_graph_input_node": [_P] * 4,
    "rst_graph_set_input": [_P] * 3,
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


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    columns are parity classes, stored through depth-to-space.  ``path`` is
    the kernel's A-operand path (:func:`stage_path`): a ``window`` stage reads
    its MMA fragments from a pixel-major input window, its K tap rows of
    ``k_row`` operands (``kw`` taps of ``cin_k``, :func:`window_pitch`: cin
    rounded up to 2, or 4 for an int8 stage; rounded up to a wgmma K step,
    zeros at the pad channels and the tail); a ``halo`` or ``strided`` stage
    from the input halo of its output
    tile, with ``cin_k = cin`` and ``k_row = kw * cin``.  Every stage's
    kernel streams its weights from ``wslices``.

    An int8 (``quant``) stage holds int8 weights with the activation scales
    folded in, ``dequant = s_w / 127`` per output column and ``act_inv =
    127 / s_c`` per input channel (``fused_transfer.py:768-780``).
    """

    name: str
    w: torch.Tensor          # (n, k_pad) bf16 (int8 if quant), k = ty * k_row + tx * cin_k + c
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
    cin_k: int               # channel pitch of the K index
    k_row: int               # K operands a tap row
    path: str                # "window", "halo" or "strided"
    quant: bool = False
    dequant: Optional[torch.Tensor] = None  # (n,) f32, int8 only
    act_inv: Optional[torch.Tensor] = None  # (cin,) f32, int8 only
    # ``w`` as the kernel streams it (:func:`halo_slices`)
    wslices: Optional[torch.Tensor] = None  # uint8
    # the kernel's moment scratch (:func:`moment_scratch`): static, so a CUDA
    # graph captures it; the kernel leaves the tickets zero after each launch
    partials: Optional[torch.Tensor] = None  # f32
    tickets: Optional[torch.Tensor] = None   # int32, zero

    @property
    def k_real(self) -> int:
        return self.kh * self.k_row

    def weight_oihw(self) -> torch.Tensor:
        """The stage's bf16 (or int8) weights as an f32 OIHW tensor."""
        w = self.w[:, :self.k_real].float().reshape(self.n, self.kh, self.k_row)
        w = w[:, :, :self.kw * self.cin_k].reshape(self.n, self.kh, self.kw, self.cin_k)
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

    @property
    def grid(self) -> Tuple[int, int]:
        """conv_stage.cu's launch grid: (blocks along the output pixels,
        blocks along the n columns)."""
        oh, ow = self.out_hw
        if self.path == "window":
            bx = -(-oh // window_rows(self.block_n)) * -(-ow // WINDOW_BM)
        else:
            bx = -(-oh // HALO_TH) * -(-ow // HALO_TW)
        return bx, -(-self.n // self.block_n)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block (:func:`window_smem_bytes`,
        :func:`halo_smem_bytes`)."""
        if self.path == "window":
            return window_smem_bytes(self.kh, self.kw, self.cin, self.block_n, self.quant,
                                     self.pack_c > 0)
        return halo_smem_bytes(self.kh, self.kw, self.cin_k, self.block_n, self.quant,
                               self.path == "strided")


def stage_path(stride: int, kh: int, kw: int) -> str:
    """conv_stage.cu's A-operand path for a stage's geometry: ``window`` at
    stride 1 with more than 9 taps, ``halo`` at stride 1 with at most 9,
    ``strided`` at stride 2."""
    if stride == 2:
        return "strided"
    if stride != 1:
        raise ValueError(f"no path of conv_stage.cu takes stride {stride}")
    return "window" if kh * kw > 9 else "halo"


def window_rows(block_n: int) -> int:
    """Output rows of a window-path block (conv_stage.cu's window_rows)."""
    return 4 if block_n <= 32 else 2


def window_pitch(cin: int, quant: bool) -> int:
    """Operands of a tap in a window stage's K (conv_stage.cu's
    window_pitch): cin rounded up to a 32-bit word, 2 bf16 or 4 int8."""
    align = 4 if quant else 2
    return -(-cin // align) * align


def window_pixel_bytes(cin: int, quant: bool) -> int:
    """Bytes of a window pixel in shared memory: a tap's, 16 more where a
    tap is whole 32-byte K steps (conv_stage.cu's window_pixel_bytes)."""
    tap = window_pitch(cin, quant) * (1 if quant else 2)
    return tap + (0 if tap % 32 else 16)


def window_k_row(kw: int, cin: int, quant: bool) -> int:
    """K operands of a window stage's tap row: kw pixels, rounded up to one
    wgmma K step (16 bf16, 32 int8)."""
    step = 32 if quant else 16
    return -(-kw * window_pitch(cin, quant) // step) * step


def window_cols(kw: int, cin: int, quant: bool) -> int:
    """Pixels of a window row: WINDOW_BM plus the pixels a tap row's K run
    reaches past its first, rounded up to 4."""
    reach = -(-window_k_row(kw, cin, quant) // window_pitch(cin, quant))
    return -(-(WINDOW_BM + reach) // 4) * 4


def epilogue_bytes(pixels: int, block_n: int) -> int:
    """conv_stage.cu's epi_bytes: the epilogue's f32 tile, [pixel][block_n +
    4], the partials of 256 threads x 4 columns, sums and squares, and the
    slots of 8 warps."""
    return 4 * (pixels * (block_n + 4) + 2 * 4 * 256 + 2 * 8 * block_n)


def window_smem_bytes(kh: int, kw: int, cin: int, block_n: int, quant: bool,
                      pack: bool = False) -> int:
    """conv_stage.cu's dynamic shared memory of a window-path block, each part
    padded to 128 bytes: the window (window_rows + kh - 1 rows of
    window_cols pixels), the raw bf16 input rows the fill stages (none for a
    bf16 stage on an NHWC input, which fills the window directly), and the
    weight ring; or the epilogue's bytes if those are larger."""
    rows, cols = window_rows(block_n) + kh - 1, window_cols(kw, cin, quant)
    raw = -(-rows * cols * cin * 2 // 128) * 128 if quant or pack else 0
    fill = (-(-rows * cols * window_pixel_bytes(cin, quant) // 128) * 128 + raw
            + RING * block_n * SLICE_BYTES)
    return max(fill, epilogue_bytes(window_rows(block_n) * WINDOW_BM, block_n))


def halo_pitch(cin_k: int, esize: int) -> int:
    """Bytes of a halo pixel in shared memory: ``cin_k`` operands of
    ``esize`` bytes rounded up to an odd number of 16-byte units."""
    return 16 * (-(-cin_k * esize // 16) | 1)


def halo_pixels(kh: int, kw: int, strided: bool = False) -> int:
    """Pixels of a halo tile: (HALO_TH + kh - 1) x (HALO_TW + kw - 1), or at
    stride 2 (2 HALO_TH + kh - 2) rows of two parity planes of HALO_TW + (kw
    - 1) // 2 pixels."""
    if strided:
        return (2 * HALO_TH + kh - 2) * 2 * (HALO_TW + (kw - 1) // 2)
    return (HALO_TH + kh - 1) * (HALO_TW + kw - 1)


def halo_smem_bytes(kh: int, kw: int, cin_k: int, block_n: int, quant: bool,
                    strided: bool = False) -> int:
    """conv_stage.cu's dynamic shared memory of a halo- or strided-path block:
    the halo tile (:func:`halo_pixels`), padded to 128 bytes, then the weight
    ring, RING slices of ``block_n`` rows of SLICE_BYTES, or, int8, the raw
    bf16 halo if that is larger; or the epilogue's f32 tile, partials and
    slots if those are larger."""
    pixels = halo_pixels(kh, kw, strided)
    esize = 1 if quant else 2
    tile = -(-pixels * halo_pitch(cin_k, esize) // 128) * 128
    ring = RING * block_n * SLICE_BYTES
    epilogue = epilogue_bytes(HALO_TH * HALO_TW, block_n)
    return max(tile + (max(ring, pixels * cin_k * 2) if quant else ring), epilogue)


def halo_slices(w: torch.Tensor, block_n: int) -> torch.Tensor:
    """(n, k_pad) stage weights -> the halo path's weight slices, each one TMA
    copy: for each block of ``block_n`` columns (zero rows past n) and each
    SLICE_BYTES of a weight row (zero past its end), block_n x SLICE_BYTES
    bytes in wgmma's core-matrix order [n // 8][K byte // 16][n % 8][16]."""
    n = w.shape[0]
    raw = w.contiguous().view(torch.uint8).reshape(n, -1)
    nb, nk = -(-n // block_n), -(-raw.shape[1] // SLICE_BYTES)
    full = raw.new_zeros(nb * block_n, nk * SLICE_BYTES)
    full[:n, :raw.shape[1]] = raw
    t = full.reshape(nb, block_n // 8, 8, nk, SLICE_BYTES // 16, 16)
    return t.permute(0, 3, 1, 4, 2, 5).contiguous()


def moment_scratch(st_grid: Tuple[int, int], block_n: int, device):
    """(partials, tickets) for conv_stage.cu's fixed-order moment reduction
    on a grid of ``st_grid`` blocks: a [2, block_n] partial a block and one a
    group of :data:`MOMENT_GROUP` blocks (f32), a ticket a group and one for
    the stage (int32, zero)."""
    bx, by = st_grid
    groups = -(-bx // MOMENT_GROUP) * by
    partials = torch.empty((bx * by + groups) * 2 * block_n, dtype=torch.float32,
                           device=device)
    return partials, torch.zeros(groups + 1, dtype=torch.int32, device=device)


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

    The stage's path follows from its geometry (:func:`stage_path`).  The
    halo and strided paths need an NHWC input with ``cin % 8 == 0``; a block
    must fit its path's shared memory.  Given the ``(cin,)`` activation scales
    of its input, ``act_scale``, the stage is int8 (:func:`quantize_kernel`);
    an int8 stage holds its ``act_inv`` row for at most MAX_CIN channels.  A
    geometry that no path takes raises ValueError.
    """
    kh, kw, cin, n = kernel.shape
    if epi not in EPI:
        raise ValueError(f"unknown epilogue {epi!r}")
    path = stage_path(stride, kh, kw)
    if path != "window" and (pack_c or cin % 8):
        raise ValueError(f"{name}: the {path} path needs an NHWC input with "
                         f"cin % 8 == 0, got cin={cin}, pack_c={pack_c}")
    quant = act_scale is not None
    dequant = act_inv = None
    if quant:
        if np.shape(act_scale) != (cin,):
            raise ValueError(f"{name}: act_scale must be per-input-channel ({cin},), "
                             f"got {np.shape(act_scale)}")
        if cin > MAX_CIN:
            raise ValueError(f"{name}: an int8 stage takes <= {MAX_CIN} input channels, "
                             f"got {cin}")
        kernel, dequant, act_inv = quantize_kernel(kernel, act_scale)
    if path == "window":
        cin_k, k_row = window_pitch(cin, quant), window_k_row(kw, cin, quant)
    else:
        cin_k, k_row = cin, kw * cin
    k_real = kh * k_row
    k_pad = -(-k_real // BK) * BK
    taps = np.zeros((kh, kw, cin_k, n), np.float32)
    taps[:, :, :cin] = kernel
    rows = np.zeros((kh, k_row, n), np.float32)  # K = ty * k_row + tx * cin_k + c
    rows[:, :kw * cin_k] = taps.reshape(kh, kw * cin_k, n)
    w = np.zeros((n, k_pad), np.float32)
    w[:, :k_real] = rows.reshape(k_real, n).T

    def f32(a):
        return None if a is None else torch.tensor(np.asarray(a, np.float32), device=device)

    if (epi == "contract") != (cscale is not None and cshift is not None):
        raise ValueError(f"{name}: contract scale/shift go with epi='contract'")
    stage = ConvStage(
        name=name,
        w=torch.tensor(w, device=device).to(torch.int8 if quant else torch.bfloat16),
        bias=f32(bias), cscale=f32(cscale), cshift=f32(cshift),
        in_hw=tuple(in_hw), cin=cin, pack_c=pack_c, out_hw=tuple(out_hw),
        n=n, c_log=transpose_cout or n, kh=kh, kw=kw, stride=stride,
        pad_top=pads[0], pad_left=pads[1], transpose=transpose_cout > 0, epi=epi,
        cin_k=cin_k, k_row=k_row, path=path, quant=quant, dequant=f32(dequant), act_inv=f32(act_inv),
    )
    if stage.smem_bytes > MAX_DYN_BYTES:
        raise ValueError(f"{name}: a {kh}x{kw} tile of {cin} channels needs "
                         f"{stage.smem_bytes} bytes of shared memory, over the {path} "
                         f"path's {MAX_DYN_BYTES}")
    partials, tickets = moment_scratch(stage.grid, stage.block_n, device)
    return dataclasses.replace(stage, partials=partials, tickets=tickets,
                               wslices=halo_slices(stage.w, stage.block_n))


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
                    act_inv: Optional[torch.Tensor] = None,
                    max_out: Optional[torch.Tensor] = None,
                    clips_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`act_stats`: per input channel of ``st``,
    the max of |x'| (f32) maxed into ``max_out`` and, given the ``act_inv``
    row, the count of values with ``|x'| * act_inv > 127.5`` (int64) added
    into ``clips_out``, each element counted once; rows not given start
    from zeros."""
    a = stage_input(x, st, prologue, skip_in).float().abs().reshape(-1, st.cin)
    if max_out is None:
        max_out = torch.zeros(st.cin, dtype=torch.float32, device=x.device)
    if clips_out is None:
        clips_out = torch.zeros(st.cin, dtype=torch.int64, device=x.device)
    torch.maximum(max_out, a.amax(dim=0), out=max_out)
    if act_inv is not None:
        clips_out += (a * act_inv > 127.5).sum(dim=0)
    return max_out, clips_out


def finish_plain(x: torch.Tensor, prologue: Prologue, out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`finish`."""
    c = x.shape[2]
    y = torch.sigmoid(cin_affine(x.float(), prologue)).to(torch.bfloat16)
    out.zero_()
    out[:, :, :16 * c] = pack(y[None], 4)[0]
    return out


# ---------------------------------------------------------------------------
# the byte-bound passes' grids, and numpy replays of their index maps
# ---------------------------------------------------------------------------


class FinishPlan(NamedTuple):
    tpx: int               # packed columns a block writes
    grid: Tuple[int, int]  # (column tiles, packed rows)
    smem: int              # dynamic shared bytes a block


def _pitch(n: int) -> int:
    """finish.cu's shared row for a staged span of ``n`` values: rounded up
    to 16 bytes, plus room for the span's offset from its 16-byte boundary."""
    return -(-n // 8) * 8 + 16


def finish_plan(h: int, w: int, c: int, dual: bool = False, sms: int = SMS) -> FinishPlan:
    """finish.cu's tile and grid: a block writes ``tpx`` packed columns of
    one packed row, ``tpx`` a multiple of the packed pixels its threads
    cover at once (``PASS_THREADS // (2 c)``, one real output vector a thread),
    the largest up to 128 whose 4 staged rows hold at most
    :data:`FINISH_STAGE` values each and that gives every SM at least 2
    blocks (down to one multiple)."""
    hp, wp = h // 4, w // 4
    per = PASS_THREADS // (2 * c)
    k = max(1, 128 // per)
    while k > 1 and (4 * per * k * c > FINISH_STAGE or hp * -(-wp // (per * k)) < 2 * sms):
        k -= 1
    tpx = per * k
    smem = 2 * 4 * _pitch(4 * tpx * c) + (2 * 4 * _pitch(4 * tpx) if dual else 0)
    return FinishPlan(tpx, (-(-wp // tpx), hp), smem)


def _stage_span(e0: int, n: int, pitch: int) -> np.ndarray:
    """finish.cu's ``stage_span``: the source index of each value of a
    shared row (-1 where nothing lands)."""
    a0 = e0 & ~7
    granules = (e0 + n - a0 + 7) >> 3
    if 8 * granules > pitch:
        raise ValueError("a staged span overflows its shared row")
    row = np.full(pitch, -1, np.int64)
    row[:8 * granules] = np.arange(a0, a0 + 8 * granules)
    return row


def finish_map(h: int, w: int, c: int, out_c: int, sms: int = SMS):
    """numpy replay of finish.cu's index map, through its staged shared
    rows: ``(out_idx, src_idx, w_idx)``, one entry per output value written,
    the flat index of the value in the (h/4, w/4, out_c) output, of the input
    value it takes in the flat (h, w, c) input (-1: a zero lane) and of the
    weight-plane value it takes in the flat (h, w) plane (-1: none)."""
    plan = finish_plan(h, w, c, sms=sms)
    tpx, (tiles, hp) = plan.tpx, plan.grid
    wp = w // 4
    pitch, wpitch = _pitch(4 * tpx * c), _pitch(4 * tpx)
    nvo, nreal = out_c // 8, 2 * c
    nzero = nvo - nreal
    tid = np.arange(PASS_THREADS)
    j = np.arange(8)
    outs, srcs, ws = [], [], []

    def write(py, px0, pxs, vs, src, wsrc):
        # vector vs of packed pixels pxs: (len(pxs), threads, 8) values
        base = (py * wp + px0 + pxs[:, None, None]) * out_c + 8 * vs[None, :, None] + j
        outs.append(base.ravel())
        srcs.append(np.broadcast_to(src, base.shape).ravel())
        ws.append(np.broadcast_to(wsrc, base.shape).ravel())

    for py in range(hp):
        for bx in range(tiles):
            px0 = bx * tpx
            ncols = min(tpx, wp - px0)
            e0 = [(4 * py + dy) * w + 4 * px0 for dy in range(4)]
            sx = np.concatenate([_stage_span(e * c, 4 * ncols * c, pitch) for e in e0])
            sw = np.concatenate([_stage_span(e, 4 * ncols, wpitch) for e in e0])
            if nzero > 0:
                pz = PASS_THREADS // nzero
                for qq in range(pz):
                    sel = tid[tid // nzero == qq]
                    write(py, px0, np.arange(qq, ncols, pz), nreal + sel % nzero, -1, -1)
            per = PASS_THREADS // nreal
            v = tid[:per * nreal] % nreal
            ch = 8 * v[:, None] + j                      # (threads, 8)
            sub = ch // c
            cc = ch - sub * c
            dy, dx = sub >> 2, sub & 3
            rows = np.take(e0, dy)
            off = dy * pitch + (rows * c) % 8 + dx * c + cc
            woff = dy * wpitch + rows % 8 + dx
            for qq in range(per):
                pxs = np.arange(qq, ncols, per)
                sel = tid[:per * nreal] // nreal == qq
                write(py, px0, pxs, v[sel], sx[off[sel][None] + 4 * c * pxs[:, None, None]],
                      sw[woff[sel][None] + 4 * pxs[:, None, None]])
    return np.concatenate(outs), np.concatenate(srcs), np.concatenate(ws)


class StatsPlan(NamedTuple):
    vectors: int  # 16-byte vectors a pixel a thread can own: cin / 8, or 2 * cin of the pack
    ppb: int      # pixels a block reads at once
    pixels: int   # pixels a block owns, a multiple of ppb * STATS_LOADS
    blocks: int


def act_stats_plan(npix: int, vectors: int, sms: int = SMS) -> StatsPlan:
    """act_stats.cu's grid over ``npix`` pixels of ``vectors`` 16-byte
    vectors each: contiguous pixel ranges, one a block, each a whole number of
    the block's steps (``ppb`` pixels by :data:`STATS_LOADS` vectors), as many
    blocks as the pixels need up to :data:`STATS_BLOCKS_PER_SM` an SM."""
    ppb = PASS_THREADS // vectors
    step = ppb * STATS_LOADS
    blocks = max(1, min(-(-npix // step), STATS_BLOCKS_PER_SM * sms))
    pixels = -(-(-(-npix // blocks)) // step) * step
    return StatsPlan(vectors, ppb, pixels, -(-npix // pixels))


def stats_plan(st: "ConvStage", sms: int = SMS) -> StatsPlan:
    """:func:`act_stats_plan` of stage ``st``'s input."""
    h, w = st.in_hw
    if st.pack_c:
        return act_stats_plan((h // 4) * (w // 4), 2 * st.cin, sms)
    return act_stats_plan(h * w, st.cin // 8, sms)


def stem_stats_map(hp: int, wp: int, cin: int, pack_c: int, sms: int = SMS):
    """numpy replay of act_stats.cu's reads of a frame pack: ``(pixel,
    channel, logical)``, one entry per value read, its packed pixel, its
    channel in the pack and the logical channel it is counted under."""
    plan = act_stats_plan(hp * wp, 2 * cin, sms)
    nv, ppb = plan.vectors, plan.ppb
    tid = np.arange(ppb * nv)
    v, q = tid % nv, tid // nv
    ch = 8 * v[:, None] + np.arange(8)         # (threads, 8)
    logical = ch % cin
    pix, chan, log = [], [], []
    for b in range(plan.blocks):
        start, end = b * plan.pixels, min((b + 1) * plan.pixels, hp * wp)
        for qq in range(ppb):
            pxs = np.arange(start + qq, end, ppb)
            sel = q == qq
            pix.append(np.broadcast_to(pxs[:, None, None], (len(pxs), sel.sum(), 8)).ravel())
            chan.append(np.broadcast_to(ch[sel][None], (len(pxs), sel.sum(), 8)).ravel())
            log.append(np.broadcast_to(logical[sel][None], (len(pxs), sel.sum(), 8)).ravel())
    return np.concatenate(pix), np.concatenate(chan), np.concatenate(log)


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version, CUDA -> kernel
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: want a contiguous 16-byte-aligned tensor")


def check_stage_input(x: torch.Tensor, st: ConvStage) -> None:
    """Stage ``st``'s input as its kernel reads it: bf16 of its input shape,
    contiguous and 16-byte aligned, or ValueError."""
    _check(x, f"{st.name} input", torch.bfloat16, st.in_shape, x.device)


def _check_stage_inputs(x, st: ConvStage, prologue: Optional[Prologue],
                        skip_in: Optional[torch.Tensor]) -> None:
    """The checks :func:`conv_stage` and :func:`act_stats` share: the input,
    the prologue and the incoming skip of stage ``st``."""
    dev = x.device
    check_stage_input(x, st)
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


def _blends(pro: Optional[Prologue]) -> int:
    """1 for a prologue that blends two styles, else 0."""
    return int(pro is not None and pro.dual)


def _prologue_args(pro: Optional[Prologue]):
    """The six pointers of a prologue, in the kernels' argument order."""
    if pro is None:
        return (None,) * 6
    return tuple(_ptr(t) for t in (pro.stats, pro.scale, pro.bias, pro.scale1,
                                   pro.bias1, pro.weight))


def launch_conv_stage(lib: ctypes.CDLL, x: torch.Tensor, st: ConvStage, out: torch.Tensor,
                      counters: Optional[torch.Tensor] = None, *,
                      prologue: Optional[Prologue] = None,
                      skip_in: Optional[torch.Tensor] = None,
                      skip_out: Optional[torch.Tensor] = None,
                      stats_out: Optional[torch.Tensor] = None) -> None:
    """``rst_conv_stage`` of ``lib`` on stage ``st``, unchecked and
    uncounted (``conv_stage`` checks its tensors first; ``halo_profile``
    gives it a profiled build of the source and ``counters``, the int64
    buffer of its clock counters)."""
    oh, ow = st.out_hw
    args = (
        _ptr(x), _ptr(st.wslices), _ptr(counters),
        _ptr(st.bias), _ptr(st.cscale), _ptr(st.cshift), *_prologue_args(prologue),
        float(prologue.count) if prologue else 1.0,
        float(prologue.eps) if prologue else 0.0,
        int(prologue is not None), int(bool(prologue and prologue.relu)),
        _ptr(skip_in), _ptr(skip_out), _ptr(out), _ptr(stats_out),
        st.in_hw[0], st.in_hw[1], st.cin, st.pack_c, oh, ow, st.n,
        st.w.shape[1], st.kh, st.kw, st.stride, st.pad_top, st.pad_left, st.c_log,
        int(st.transpose), EPI[st.epi], st.cin_k, PATHS[st.path], st.block_n,
        _ptr(st.dequant), _ptr(st.act_inv), int(st.quant), _ptr(st.partials),
        _ptr(st.tickets), st.partials.numel(), st.tickets.numel(), _stream(x))
    on = spans.on
    if on:
        spans.begin("launch")
    err = lib.rst_conv_stage(*args)
    if on:
        spans.end()
    if err:
        raise RuntimeError(f"conv_stage {st.name}: CUDA error {err} at launch")


def conv_stage(x: torch.Tensor, st: ConvStage, out: torch.Tensor, *,
               prologue: Optional[Prologue] = None,
               skip_in: Optional[torch.Tensor] = None,
               skip_out: Optional[torch.Tensor] = None,
               stats_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one conv stage into ``out``; add its moments into ``stats_out``
    (the kernel sums them in an order fixed by its grid, so two calls on the
    same input give the same bits; the stage's scratch serves one launch at a
    time, as one stream runs them)."""
    if x.device.type == "cpu":
        conv_stage.blends += _blends(prologue)
        return conv_stage_plain(x, st, out, prologue=prologue, skip_in=skip_in,
                                skip_out=skip_out, stats_out=stats_out)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stage runs on CUDA or the CPU, not {x.device}")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    _check_stage_inputs(x, st, prologue, skip_in)
    _check(out, f"{st.name} output", bf16, st.out_shape, dev)
    if st.path == "window" and (skip_in is not None or skip_out is not None):
        raise ValueError(f"{st.name}: the window path takes no skips")
    if skip_out is not None:
        _check(skip_out, f"{st.name} skip_out", bf16, st.in_shape, dev)
    if skip_out is not None and (st.stride != 1 or st.transpose
                                 or (st.pad_top, st.pad_left) != (st.kh // 2, st.kw // 2)):
        raise ValueError(f"{st.name}: skip_out needs a stride-1 centred conv")
    if stats_out is not None:
        _check(stats_out, f"{st.name} stats_out", f32, (2, st.c_log), dev)
    launch_conv_stage(_lib("conv_stage.cu"), x, st, out, prologue=prologue,
                      skip_in=skip_in, skip_out=skip_out, stats_out=stats_out)
    conv_stage.launches += 1
    conv_stage.path_launches[st.path] += 1
    conv_stage.stage_launches[st.name] = conv_stage.stage_launches.get(st.name, 0) + 1
    conv_stage.blends += _blends(prologue)
    return out


conv_stage.launches = 0
conv_stage.path_launches = dict.fromkeys(PATHS, 0)  # the launches by A-operand path
conv_stage.stage_launches = {}  # the launches by stage name
conv_stage.blends = 0  # the calls that blended two styles


def launch_act_stats(lib: ctypes.CDLL, x: torch.Tensor, st: ConvStage,
                     prologue: Optional[Prologue], skip_in: Optional[torch.Tensor],
                     act_inv: Optional[torch.Tensor], max_out: torch.Tensor,
                     clips_out: torch.Tensor, counters: Optional[torch.Tensor] = None) -> None:
    """``rst_act_stats`` of ``lib`` on stage ``st``'s input over the grid of
    :func:`stats_plan`, unchecked and uncounted (``act_stats`` checks its
    tensors first; ``halo_profile`` gives it a profiled build and
    ``counters``, the int64 buffer of its clock counters)."""
    plan = stats_plan(st, _sm_count(x.device))
    err = lib.rst_act_stats(
        _ptr(x), *_prologue_args(prologue),
        float(prologue.count) if prologue else 1.0,
        float(prologue.eps) if prologue else 0.0,
        int(prologue is not None), int(bool(prologue and prologue.relu)),
        _ptr(skip_in), _ptr(act_inv), _ptr(max_out),
        None if act_inv is None else _ptr(clips_out), _ptr(counters),
        st.in_hw[0], st.in_hw[1], st.cin, st.pack_c, plan.blocks, plan.pixels, _stream(x))
    if err:
        raise RuntimeError(f"act_stats {st.name}: CUDA error {err} at launch")


def act_stats(x: torch.Tensor, st: ConvStage, prologue: Optional[Prologue] = None,
              skip_in: Optional[torch.Tensor] = None,
              act_inv: Optional[torch.Tensor] = None,
              max_out: Optional[torch.Tensor] = None,
              clips_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per input channel of stage ``st`` on its input ``x`` (with the
    stage's prologue and skip): the max |x'| maxed into the (cin,) f32 row
    ``max_out`` and, under the ``act_inv`` row, the clip count added into
    the (cin,) int64 row ``clips_out``; returns the two rows.  Given both
    rows (one row each of a caller's per-stage tables) a launch allocates
    and fills nothing; a row not given starts from zeros.  Without
    ``act_inv`` the clip row is left as it is."""
    if x.device.type == "cpu":
        return act_stats_plain(x, st, prologue, skip_in, act_inv, max_out, clips_out)
    if x.device.type != "cuda":
        raise ValueError(f"act_stats runs on CUDA or the CPU, not {x.device}")
    dev = x.device
    _check_stage_inputs(x, st, prologue, skip_in)
    if act_inv is not None:
        _check(act_inv, f"{st.name} act_inv", torch.float32, (st.cin,), dev)
    if max_out is None:
        max_out = torch.zeros(st.cin, dtype=torch.float32, device=dev)
    if clips_out is None:
        clips_out = torch.zeros(st.cin, dtype=torch.int64, device=dev)
    _check(max_out, f"{st.name} max_out", torch.float32, (st.cin,), dev)
    _check(clips_out, f"{st.name} clips_out", torch.int64, (st.cin,), dev)
    launch_act_stats(_lib("act_stats.cu"), x, st, prologue, skip_in, act_inv, max_out,
                     clips_out)
    act_stats.launches += 1
    return max_out, clips_out


act_stats.launches = 0


def finish(x: torch.Tensor, prologue: Prologue, out: torch.Tensor) -> torch.Tensor:
    """sigmoid(CIN(x)) of the final (H, W, C) stage into the packed
    (H/4, W/4, out_c) bf16 frame; channels >= 16*C are zero.  A dual
    prologue's weight plane is (H, W)."""
    if x.device.type == "cpu":
        finish.blends += _blends(prologue)
        return finish_plain(x, prologue, out)
    if x.device.type != "cuda":
        raise ValueError(f"finish runs on CUDA or the CPU, not {x.device}")
    h, w, c = x.shape
    out_c = out.shape[2]
    dev = x.device
    _check(x, "finish input", torch.bfloat16, (h, w, c), dev)
    if (h % 4 or w % 4 or c > MAX_CIN or out_c < 16 * c or out_c % 8
            or out_c > 8 * PASS_THREADS):
        raise ValueError(f"finish: unsupported shapes {tuple(x.shape)} -> {tuple(out.shape)}")
    _check(out, "finish output", torch.bfloat16, (h // 4, w // 4, out_c), dev)
    _check_prologue(prologue, "finish", c, (h, w), dev)
    plan = finish_plan(h, w, c, prologue.dual, _sm_count(dev))
    lib = _lib("finish.cu")
    args = (_ptr(x), *_prologue_args(prologue), float(prologue.count),
            float(prologue.eps), _ptr(out), h, w, c, out_c, plan.tpx, _stream(x))
    on = spans.on
    if on:
        spans.begin("launch")
    err = lib.rst_finish(*args)
    if on:
        spans.end()
    if err:
        raise RuntimeError(f"finish: CUDA error {err} at launch")
    finish.launches += 1
    finish.blends += _blends(prologue)
    return out


finish.launches = 0
finish.blends = 0  # the calls that blended two styles


def replay_graph(graph: "torch.cuda.CUDAGraph") -> None:
    """Replay a CUDA graph of recorded kernel launches.  A replay does not
    pass through the wrappers, so ``replay_graph.replays`` counts it."""
    graph.replay()
    replay_graph.replays += 1


replay_graph.replays = 0


def graph_input_node(raw_graph: int, x: int) -> int:
    """The node of a recorded CUDA graph (``CUDAGraph.raw_cuda_graph()``,
    ``keep_graph=True``) that launches a ``conv_stage`` kernel on the input
    at address ``x``; RuntimeError unless exactly one does."""
    node, matches = ctypes.c_void_p(), ctypes.c_int()
    err = _lib("conv_stage.cu").rst_graph_input_node(raw_graph, x, ctypes.byref(node),
                                                     ctypes.byref(matches))
    if err:
        raise RuntimeError(f"graph_input_node: {matches.value} conv_stage launches read "
                           f"input {x:#x}, want 1 (CUDA error {err})")
    return node.value


def set_graph_input(graph_exec: int, node: int, x: int) -> None:
    """Point ``node`` (:func:`graph_input_node`) of the instantiated graph
    ``graph_exec`` (``CUDAGraph.raw_cuda_graph_exec()``) at the input at
    address ``x``, for the replays after this call."""
    err = _lib("conv_stage.cu").rst_graph_set_input(graph_exec, node, x)
    if err:
        raise RuntimeError(f"set_graph_input: CUDA error {err}")


def reset_launch_counts() -> None:
    conv_stage.launches = 0
    conv_stage.path_launches = dict.fromkeys(PATHS, 0)
    conv_stage.stage_launches = {}
    conv_stage.blends = 0
    finish.launches = 0
    finish.blends = 0
    act_stats.launches = 0
    replay_graph.replays = 0
