"""VALID stride-1 conv as tap matmuls with a fused f32 epilogue, on one image.

Port of ``realtime_style_transfer_tpu/ops/pallas/conv_matmul.py``: the TPU
kernel ``_kernel`` (``:40``) behind ``conv_valid_matmul`` (``:83``) and
``conv_same_batched`` (``:146``) becomes ``csrc/conv_matmul.cu``.  It computes
``(Hp, Wp, Cin) x (kh, kw, Cin, Cout) -> (Hp-kh+1, Wp-kw+1, Cout)`` as kh*kw
tap matmuls accumulated in f32, then the epilogue in f32 (``none``, ``bias``
or ``contract`` = ``relu(relu(acc + bias) * scale + shift)``), and stores
x.dtype (bf16 or f32).  The packed path runs it at its stride-1 seams
(:mod:`.packed_conv`).

Two paths, chosen by the input's type: ``wgmma`` (bf16: ``conv_wgmma_kernel``,
both MMA operands in shared memory, the input tile plane-major and both
operands streamed by TMA; :func:`tap_plan` lays them out) and ``f32``
(``conv_fma_kernel``: an implicit GEMM of f32 FMAs on the CUDA cores, which
holds JAX's f32 tolerance; :func:`fma_plan` tiles it).  The bf16 path's
weights are packed once by :func:`pack_taps` into a :class:`TapWeights`, Cin
zero-padded to a multiple of 8 (the input comes in TMA boxes of 8
channels); the f32 path's by :func:`pack_fma` into an :class:`FmaWeights`,
Cin zero-padded to whole chunks (a TMA box a chunk);
:class:`PackedTransfer <..models.transfer_packed.PackedTransfer>` keeps them on its
:class:`.packed_conv.PackedConv` and pads its input's channels in the same
``F.pad`` as its pixels.  A raw HWIO kernel handed to
:func:`conv_valid_matmul` is packed on every call, and an input with the
kernel's own Cin is zero-padded to the packed kernel's.

On a CPU tensor :func:`conv_valid_matmul` runs :func:`conv_valid_matmul_plain`
(the same tap matmuls in f32, the same epilogue, one rounding to x.dtype); on
a CUDA tensor it launches the kernel or raises.  ``conv_valid_matmul.launches``
counts kernel launches, ``conv_valid_matmul.path_launches`` splits them by path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import kernels

EPILOGUES = {"none": 0, "bias": 1, "contract": 2}
PATHS = ("wgmma", "f32")
MAX_TAPS_PER_AXIS = 15  # the widest bf16 kernel the wgmma path's plan serves

# csrc/conv_matmul.cu's constants
RING = 4            # weight slices in shared memory
SLICE_BYTES = 128   # bytes of K a slice: 4 wgmma k16 steps
KSTEPS = SLICE_BYTES // 32
BLOCK_W = 16        # output columns of a block (BW): two 8 x 8 m64 tiles
MAX_DYN_BYTES = 226 * 1024  # a block's dynamic shared memory cap
STEP_FIELD = 0x3FFF
STEP_NEW_CHUNK = 28
CHUNK_PLANES = 8     # planes (of 8 channels) a chunk of a wide input
SPLIT_PLANES = 5     # inputs of at most this many planes load in one chunk ...
ONE_CHUNK_PLANES = 12  # ... and of at most this many in two halves
# (bn, rw) instantiations: BN output columns a block, RW m64 tiles a warpgroup
BLOCK_N = (8, 16, 32, 48, 64, 96, 128, 192, 256)
ROWS = {8: 2, 16: 2, 32: 2, 48: 2, 64: 2, 96: 2, 128: 1, 192: 1, 256: 1}
# the f32 path's conv_fma_kernel: BN output columns a block -> (TM pixels a
# lane, TQ column quads a lane, NG column groups a warp: 32 // NG K-groups)
FMA_TILES = {48: (4, 3, 4), 96: (8, 3, 8), 128: (16, 1, 32)}
FMA_WINDOWS = {48: 3, 128: 5}  # the tile's kw that runs a sliding window (the finals, the stem)
FMA_WIDE_BN = 96    # the column block of a Cout above the widest tile
FMA_WARPS = 8       # consumer warps a block, TM pixels of one output row each
FMA_COLS = 16       # output columns of a block
FMA_MAX_BUF = 4     # stage buffers at most


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """How ``conv_wgmma_kernel`` runs a (kh, kw, cin, cout) kernel.

    A block owns ``8 * rw`` output rows x ``BLOCK_W`` columns and all ``bn``
    columns of one column block.  Its input tile, ``th x tw`` pixels, lies
    in shared memory plane-major: ``planes`` planes of 8 channels, each
    ``plane_px`` pixels of 16 bytes (the tile's, then zeros), loaded
    ``cp`` planes a chunk into ``nbuf`` buffers.  ``steps`` lists the wgmma
    k16 steps in K order: for each, its step word and the two (tap, plane)
    pairs whose 8 channels it multiplies (``None``: zero weights).
    """

    kh: int
    kw: int
    cin: int
    cout: int
    bn: int
    rw: int
    th: int
    tw: int
    planes: int
    plane_px: int
    cp: int
    nchunks: int
    steps: Tuple[Tuple[int, Optional[Tuple[int, int]], Optional[Tuple[int, int]]], ...]

    @property
    def nbuf(self) -> int:
        """Chunk buffers: two where Cin comes in more than one chunk."""
        return 1 if self.nchunks == 1 else 2

    @property
    def nk(self) -> int:
        """Weight slices a column block."""
        return len(self.steps) // KSTEPS

    @property
    def k(self) -> int:
        """K of the packed product: 16 a step."""
        return 16 * len(self.steps)

    @property
    def col_blocks(self) -> int:
        return -(-self.cout // self.bn)

    def grid(self, h: int, w: int) -> Tuple[int, int]:
        """conv_matmul.cu's launch grid for an (h, w) output."""
        return -(-h // (8 * self.rw)) * -(-w // BLOCK_W), self.col_blocks

    @property
    def chunk_bytes(self) -> int:
        """Bytes of a chunk buffer, padded to 128 (the ring after them is
        128-byte aligned)."""
        return -(-self.cp * self.plane_px * 16 // 128) * 128

    @property
    def smem_bytes(self) -> int:
        """A block's dynamic shared memory (conv_matmul.cu's wgmma_bytes)."""
        fill = self.nbuf * self.chunk_bytes + RING * self.bn * SLICE_BYTES
        return max(fill, 8 * self.rw * BLOCK_W * (self.bn + 4) * 4)


def _chunk_steps(kh: int, kw: int, tw: int, npix: int, plane_px: int, p0: int, pc: int):
    """The k16 steps of one chunk (planes p0 .. p0 + pc - 1): each tap's
    planes in pairs; an odd chunk pairs its last plane across consecutive
    taps (the second core matrix one tap's pixel offset further: LBO).

    A core matrix with zero weights still meets its pixels in the MMA (0 x
    Inf is NaN), so it reads pixels of the same outputs' receptive field: a
    lone last tap takes the tap before it as its zero first half, a padding
    step repeats the chunk's first step with zero weights, and a 1x1
    kernel's lone plane pairs with the zero pixels after its tile (``npix``
    on, inside a plane of ``plane_px`` >= 2 * npix)."""
    steps = []
    taps = [(ty, tx) for ty in range(kh) for tx in range(kw)]
    shift = [(ty * tw + tx) * 16 for ty, tx in taps]
    plane, last_tap = plane_px * 16, len(taps) - 1
    for t in range(len(taps)):
        for j in range(pc // 2):
            steps.append((2 * j * plane + shift[t], plane, (t, p0 + 2 * j), (t, p0 + 2 * j + 1)))
    if pc % 2:
        last, lp = (pc - 1) * plane, p0 + pc - 1
        for t in range(0, last_tap, 2):
            steps.append((last + shift[t], shift[t + 1] - shift[t], (t, lp), (t + 1, lp)))
        if len(taps) == 1:
            steps.append((last, npix * 16, (0, lp), None))
        elif len(taps) % 2:
            steps.append((last + shift[last_tap - 1], shift[last_tap] - shift[last_tap - 1],
                          None, (last_tap, lp)))
    while len(steps) % KSTEPS:
        steps.append((steps[0][0], steps[0][1], None, None))
    return steps


def tap_plan(kh: int, kw: int, cin: int, cout: int) -> TapPlan:
    """The wgmma path's plan for a (kh, kw, cin, cout) kernel: the column
    block width ``bn`` (Cout rounded up to an instantiated wgmma N, 256 a
    column block above that), the block's tile, the chunking of Cin into
    planes and the step table."""
    if max(kh, kw) > MAX_TAPS_PER_AXIS:
        raise ValueError(f"conv_valid_matmul: a {kh}x{kw} kernel's input tile exceeds "
                         f"shared memory (at most {MAX_TAPS_PER_AXIS} taps an axis)")
    bn = next(b for b in BLOCK_N if b >= min(cout, BLOCK_N[-1]))
    rw = ROWS[bn]
    th, tw = 8 * rw + kh - 1, BLOCK_W + kw - 1
    npix = th * tw
    # a multiple of 8 (TMA boxes into 128-byte aligned planes); a 1x1 kernel
    # keeps as many zero pixels after its tile as the tile has (_chunk_steps)
    plane_px = -(-npix // 8) * 8 * (2 if kh * kw == 1 else 1)
    planes = -(-cin // 8)
    ring = RING * bn * SLICE_BYTES
    # one chunk for a narrow input; two halves up to ONE_CHUNK_PLANES (the
    # stem), so the second loads under the first one's MMAs; else chunks of
    # CHUNK_PLANES (the finals); fewer planes a chunk where they do not fit
    cp = planes if planes <= SPLIT_PLANES else \
        -(-planes // 2) if planes <= ONE_CHUNK_PLANES else CHUNK_PLANES

    def buffers(c):
        return (1 if c == planes else 2) * -(-c * plane_px * 16 // 128) * 128

    if buffers(cp) + ring > MAX_DYN_BYTES:
        cp = next((c for c in (4, 2, 1) if c < cp and buffers(c) + ring <= MAX_DYN_BYTES), None)
        if cp is None:
            raise ValueError(f"conv_valid_matmul: no chunking of a {kh}x{kw} tile fits "
                             "shared memory")
    nchunks = -(-planes // cp)
    steps = []
    for c in range(nchunks):
        chunk = _chunk_steps(kh, kw, tw, npix, plane_px, c * cp, min(cp, planes - c * cp))
        for i, (a_off, lbo, first, second) in enumerate(chunk):
            word = (a_off // 16) | ((lbo // 16) << 14) | ((i == 0) << STEP_NEW_CHUNK)
            steps.append((word, first, second))
    return TapPlan(kh, kw, cin, cout, bn, rw, th, tw, planes, plane_px, cp, nchunks,
                   tuple(steps))


def step_weights(kernel: torch.Tensor, plan: TapPlan) -> torch.Tensor:
    """The (Cout, K) matrix the steps multiply: columns 16s .. 16s + 7 of step
    s hold the weights of its first (tap, plane) pair's 8 channels, 16s + 8
    .. 16s + 15 its second's; zeros past Cin and for a missing pair."""
    kh, kw, cin, cout = kernel.shape
    cin8 = 8 * plan.planes
    flat = kernel.new_zeros((kh * kw, cin8, cout))
    flat[:, :cin] = kernel.reshape(kh * kw, cin, cout)
    flat = torch.cat([flat.reshape(kh * kw * cin8, cout), kernel.new_zeros((1, cout))])
    zero = kh * kw * cin8
    idx = []
    for _, first, second in plan.steps:
        for pair in (first, second):
            idx.extend([zero] * 8 if pair is None else
                       range(pair[0] * cin8 + 8 * pair[1], pair[0] * cin8 + 8 * pair[1] + 8))
    return flat[torch.tensor(idx, device=kernel.device)].t().contiguous()


class TapWeights(NamedTuple):
    """A bf16 HWIO kernel packed for the wgmma path: its plan (``plan.cin``
    the kernel's own Cin), its (Cout, K) step matrix as weight slices
    (:func:`.kernels.halo_slices`: for each column block of ``bn`` and each
    128 bytes of K, bn x 128 bytes in wgmma's core-matrix order) and the
    step words, all on the kernel's device; ``kernel`` is the HWIO tensor
    (the plain version's), its Cin zero-padded to a multiple of 8."""

    kernel: torch.Tensor
    plan: TapPlan
    slices: torch.Tensor   # uint8
    steps: torch.Tensor    # int32 step words


def pack_taps(kernel: torch.Tensor) -> TapWeights:
    """Pack a bf16 HWIO kernel for :func:`conv_valid_matmul`: done once, at
    engine assembly, by :meth:`.packed_conv.PackedConv.with_taps`."""
    if kernel.ndim != 4:
        raise ValueError(f"want an HWIO kernel (kh, kw, Cin, Cout), got {tuple(kernel.shape)}")
    kh, kw, cin, cout = kernel.shape
    plan = tap_plan(kh, kw, cin, cout)
    slices = kernels.halo_slices(step_weights(kernel.to(torch.bfloat16), plan), plan.bn)
    steps = torch.tensor([w for w, _, _ in plan.steps], dtype=torch.int32,
                         device=kernel.device)
    if cin % 8:
        kernel = F.pad(kernel, (0, 0, 0, 8 * plan.planes - cin))
    return TapWeights(kernel, plan, slices, steps)


def _align128(n: int) -> int:
    return -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class FmaPlan:
    """How ``conv_fma_kernel`` runs a (kh, kw, cin, cout) f32 kernel.

    A block owns ``rows`` output rows x ``FMA_COLS`` columns and ``bn``
    output columns; warp w the ``tm`` pixels at row ``w // (FMA_COLS //
    tm)``, its lane (g, n) = (lane // ng, lane % ng) the columns
    ``4 * (n + ng * q) + 0..3`` (q < ``tq``) and the channel quads
    ``g + kgw * i`` of each chunk (i < ``ni``).  K runs in stages, one chunk
    of ``cc`` channels and one tap row each (chunk major), through ``nbuf``
    buffers: the input box (``rows`` x ``twc`` pixels x ``cc`` channels) and
    the stage's weight slice (``kw`` x ``cc`` x ``bn``); inside a stage,
    tap, channel quad, channel, or with a ``window`` (the kernel's kw, for
    the tiles of FMA_WINDOWS) channel quad, tap, channel.
    """

    kh: int
    kw: int
    cin: int
    cout: int
    bn: int
    tm: int
    tq: int
    ng: int
    cc: int
    nchunks: int
    nbuf: int

    @property
    def kgw(self) -> int:
        """K-groups a warp."""
        return 32 // self.ng

    @property
    def window(self) -> int:
        """The sliding window's taps (0: a tap at a time)."""
        return self.kw if FMA_WINDOWS.get(self.bn) == self.kw else 0

    @property
    def ni(self) -> int:
        """Channel quads a K-group reads a tap of a stage."""
        return self.cc // (4 * self.kgw)

    @property
    def rows(self) -> int:
        return self.tm // 2

    @property
    def twc(self) -> int:
        """Input columns of a box."""
        return FMA_COLS + self.kw - 1

    @property
    def cin_x(self) -> int:
        """The input's channels: Cin zero-padded to whole chunks."""
        return self.nchunks * self.cc

    @property
    def stages(self) -> int:
        return self.nchunks * self.kh

    @property
    def col_blocks(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def stage_bytes(self) -> int:
        """A stage's input box and weight slice, each padded to 128 bytes
        (conv_matmul.cu's fma_in_bytes, fma_w_bytes)."""
        return (_align128(self.rows * self.twc * self.cc * 4)
                + _align128(self.kw * self.cc * self.bn * 4))

    @property
    def smem_bytes(self) -> int:
        return self.nbuf * self.stage_bytes

    def grid(self, h: int, w: int) -> Tuple[int, int]:
        """conv_matmul.cu's launch grid for an (h, w) output."""
        return -(-h // self.rows) * -(-w // FMA_COLS), self.col_blocks


def fma_plan(kh: int, kw: int, cin: int, cout: int) -> FmaPlan:
    """The f32 path's plan for a (kh, kw, cin, cout) kernel: the column
    block ``bn`` (the narrowest tile that holds Cout, else column blocks of
    ``FMA_WIDE_BN``) and its lane tile; then the chunk ``cc`` (4 * kgw * ni
    channels, ni a power of 2, at most 256) with the fewest padded
    channels, then the widest (the fewest stages: each stage costs a wait
    and a pipeline refill, measured on the card), then the most stage
    buffers that fit shared memory."""
    bn = next((b for b in sorted(FMA_TILES) if b >= cout), FMA_WIDE_BN)
    tm, tq, ng = FMA_TILES[bn]
    best = None
    cc = 4 * (32 // ng)
    while cc <= 256:
        nchunks = -(-cin // cc)
        for nbuf in range(FMA_MAX_BUF, 1, -1):
            pl = FmaPlan(kh, kw, cin, cout, bn, tm, tq, ng, cc, nchunks, nbuf)
            if pl.smem_bytes <= MAX_DYN_BYTES and pl.twc <= 256:
                key = (nchunks * cc - cin, -cc, -nbuf)
                if best is None or key < best[0]:
                    best = (key, pl)
                break
        cc *= 2
    if best is None:
        raise ValueError(f"conv_valid_matmul: no f32 stage of a {kh}x{kw} kernel fits "
                         "shared memory")
    return best[1]


class FmaWeights(NamedTuple):
    """An f32 HWIO kernel packed for the f32 path: its plan (``plan.cin``
    the kernel's own Cin) and its stage slices, (col_blocks, stages, kw * cc
    * bn) f32 on the kernel's device (:func:`pack_fma`); ``kernel`` is the
    HWIO tensor (the plain version's), its Cin zero-padded to
    ``plan.cin_x``."""

    kernel: torch.Tensor
    plan: FmaPlan
    slices: torch.Tensor


def pack_fma(kernel: torch.Tensor) -> FmaWeights:
    """Pack an f32 HWIO kernel for :func:`conv_valid_matmul`: stage s = (chunk
    s // kh, tap row s % kh), inside it (tap, quad i, channel kk, column quad
    q, lane) with lane = g * ng + n, holding channel ``chunk * cc + 4 *
    (i * kgw + g) + kk`` and columns ``cb * bn + 4 * (n + ng * q) + 0..3``;
    zeros past Cin and Cout.  Done once, at engine assembly, by
    :meth:`.packed_conv.PackedConv.with_taps`."""
    if kernel.ndim != 4:
        raise ValueError(f"want an HWIO kernel (kh, kw, Cin, Cout), got {tuple(kernel.shape)}")
    kh, kw, cin, cout = kernel.shape
    pl = fma_plan(kh, kw, cin, cout)
    full = kernel.new_zeros((kh, kw, pl.cin_x, pl.col_blocks * pl.bn))
    full[:, :, :cin, :cout] = kernel
    t = full.reshape(kh, kw, pl.nchunks, pl.ni, pl.kgw, 4, pl.col_blocks, pl.tq, pl.ng, 4)
    slices = t.permute(6, 2, 0, 1, 3, 5, 7, 4, 8, 9).reshape(
        pl.col_blocks, pl.stages, kw * pl.cc * pl.bn).contiguous()
    return FmaWeights(full[..., :cout].contiguous(), pl, slices)


def _operands(x: torch.Tensor, kernel: Kernel):
    """x and the HWIO kernel it is multiplied by: a TapWeights' (Cin padded
    to a multiple of 8) or an FmaWeights' (to whole chunks), x's channels
    zero-padded to match where it has the kernel's own Cin."""
    if not isinstance(kernel, (TapWeights, FmaWeights)):
        return x, kernel
    cin8 = kernel.kernel.shape[2]
    if x.ndim == 3 and x.shape[2] == kernel.plan.cin < cin8:
        x = F.pad(x, (0, cin8 - x.shape[2]))
    return x, kernel.kernel


def _epilogue_rows(cout: int, device, bias, scale, shift):
    """bias, scale and shift as (cout,) f32 rows; missing ones are zeros, as
    the JAX function passes them.  A row that already is one is used as it
    is (PackedTransfer keeps its rows on the device)."""
    def row(v):
        if isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device == device \
                and v.shape == (cout,) and v.is_contiguous():
            return v
        if v is None:
            return torch.zeros(cout, dtype=torch.float32, device=device)
        return torch.as_tensor(v).detach().to(device, torch.float32).reshape(cout).contiguous()
    return row(bias), row(scale), row(shift)


def _apply_epilogue(acc: torch.Tensor, epilogue: str, bias, scale, shift) -> torch.Tensor:
    if epilogue == "contract":
        return torch.relu(torch.relu(acc + bias) * scale + shift)
    if epilogue == "bias":
        return acc + bias
    return acc


def _shapes(x: torch.Tensor, kernel: torch.Tensor, epilogue: str):
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {tuple(EPILOGUES)}, got {epilogue!r}")
    if x.ndim != 3 or kernel.ndim != 4 or kernel.shape[2] != x.shape[2]:
        raise ValueError(f"want x (Hp, Wp, Cin) and kernel (kh, kw, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    hp, wp, _ = x.shape
    kh, kw, _, cout = kernel.shape
    h, w = hp - kh + 1, wp - kw + 1
    if h < 1 or w < 1:
        raise ValueError(f"kernel {kh}x{kw} is larger than the input {hp}x{wp}")
    return h, w, cout


Kernel = Union[torch.Tensor, TapWeights, FmaWeights]


def path_of(dtype: torch.dtype) -> str:
    """The kernel path an input of ``dtype`` takes: ``wgmma`` (bf16) or
    ``f32``."""
    return "f32" if dtype == torch.float32 else "wgmma"


def conv_valid_matmul_plain(x: torch.Tensor, kernel: Kernel, *,
                            bias=None, scale=None, shift=None,
                            epilogue: str = "none") -> torch.Tensor:
    """The plain version of :func:`conv_valid_matmul`: the kh*kw tap matmuls
    on f32 copies of the operands accumulated in f32 (each product of two
    bf16 values is exact in f32), then the f32 epilogue, cast to x.dtype."""
    x, kernel = _operands(x, kernel)
    h, w, cout = _shapes(x, kernel, epilogue)
    kh, kw, cin, _ = kernel.shape
    xf, kf = x.float(), kernel.float()
    acc = torch.zeros((h * w, cout), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += xf[dy:dy + h, dx:dx + w].reshape(h * w, cin) @ kf[dy, dx]
    rows = _epilogue_rows(cout, x.device, bias, scale, shift)
    return _apply_epilogue(acc, epilogue, *rows).reshape(h, w, cout).to(x.dtype)


def conv_valid_matmul(x: torch.Tensor, kernel: Kernel, *,
                      bias: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      epilogue: str = "none") -> torch.Tensor:
    """VALID stride-1 conv of the pre-padded single image ``x`` (Hp, Wp, Cin)
    by the HWIO ``kernel`` (kh, kw, Cin, Cout) of the same dtype (bf16 or
    f32), or one packed by :func:`pack_taps` (bf16) or :func:`pack_fma`
    (f32) -> (Hp-kh+1, Wp-kw+1, Cout) in x.dtype, with the f32 ``epilogue``
    (``none``, ``bias`` or
    ``contract``; bias, scale and shift are (Cout,) rows, zeros where not
    given)."""
    if x.device.type == "cpu":
        return conv_valid_matmul_plain(x, kernel, bias=bias, scale=scale, shift=shift,
                                       epilogue=epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"conv_valid_matmul runs on CUDA or the CPU, not {x.device}")
    if isinstance(kernel, torch.Tensor) and kernel.dtype == x.dtype \
            and x.dtype in (torch.bfloat16, torch.float32):
        _shapes(x, kernel, epilogue)  # before packing pads Cin
        kernel = (pack_taps if x.dtype == torch.bfloat16 else pack_fma)(kernel)
    packed = kernel
    x, kernel = _operands(x, kernel)
    h, w, cout = _shapes(x, kernel, epilogue)
    if x.dtype not in (torch.bfloat16, torch.float32) or kernel.dtype != x.dtype \
            or kernel.device != x.device:
        raise ValueError(f"conv_valid_matmul: want bf16 or f32 x and a kernel of the same "
                         f"type on its device, got {x.dtype} on {x.device} and "
                         f"{kernel.dtype} on {kernel.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("conv_valid_matmul: want contiguous x and kernel")
    if x.data_ptr() % 16:
        raise ValueError("conv_valid_matmul: x comes by TMA and must start 16-byte aligned")
    rows = (None, None, None)
    if epilogue != "none":
        rows = _epilogue_rows(cout, x.device, bias, scale, shift)
        if epilogue == "bias":
            rows = (rows[0], None, None)
    out = torch.empty((h, w, cout), dtype=x.dtype, device=x.device)
    lib = kernels._lib("conv_matmul.cu")
    path = path_of(x.dtype)
    if path == "f32":
        err = launch_fma(lib, x, packed, rows, out, EPILOGUES[epilogue])
    else:
        err = launch_wgmma(lib, x, packed, rows, out, EPILOGUES[epilogue])
    if err:
        raise RuntimeError(f"conv_valid_matmul: CUDA error {err} at launch")
    conv_valid_matmul.launches += 1
    conv_valid_matmul.path_launches[path] += 1
    return out


conv_valid_matmul.launches = 0
conv_valid_matmul.path_launches = dict.fromkeys(PATHS, 0)  # the launches by path


def launch_wgmma(lib, x: torch.Tensor, taps: TapWeights, rows, out: torch.Tensor, epi: int,
                 counters: Optional[torch.Tensor] = None) -> int:
    """One launch of ``rst_conv_matmul`` from ``lib`` (the built source, or
    halo_profile.py's copy with clock64 counters); returns its CUDA error."""
    pl = taps.plan
    hp, wp, cin = x.shape
    return lib.rst_conv_matmul(
        kernels._ptr(x), kernels._ptr(taps.slices), kernels._ptr(taps.steps),
        *(kernels._ptr(r) for r in rows), kernels._ptr(out), kernels._ptr(counters),
        hp, wp, cin, pl.kh, pl.kw, pl.cout, epi, pl.bn, pl.rw, pl.nk, pl.cp, pl.nchunks,
        pl.plane_px, kernels._stream(x))


def launch_fma(lib, x: torch.Tensor, fw: FmaWeights, rows, out: torch.Tensor, epi: int,
               counters: Optional[torch.Tensor] = None) -> int:
    """One launch of ``rst_conv_matmul_f32`` from ``lib`` (the built source,
    or halo_profile.py's copy with clock64 counters); returns its CUDA error."""
    pl = fw.plan
    hp, wp, cin = x.shape
    return lib.rst_conv_matmul_f32(
        kernels._ptr(x), kernels._ptr(fw.slices), *(kernels._ptr(r) for r in rows),
        kernels._ptr(out), kernels._ptr(counters), hp, wp, cin, pl.kh, pl.kw, pl.cout, epi,
        pl.bn, pl.tm, pl.cc, pl.nbuf, kernels._stream(x))


def reset_launch_counts() -> None:
    conv_valid_matmul.launches = 0
    conv_valid_matmul.path_launches = dict.fromkeys(PATHS, 0)


def conv_same_batched(x: torch.Tensor, kernel: Kernel) -> torch.Tensor:
    """SAME stride-1 conv on (B, H, W, Cin) via :func:`conv_valid_matmul`:
    pads once (``(k-1)//2`` before, the rest after; a packed kernel's Cin
    padding too), one call a batch item (a raw kernel on the card is packed
    once for all of them)."""
    if x.is_cuda and isinstance(kernel, torch.Tensor) and kernel.dtype == torch.bfloat16:
        kernel = pack_taps(kernel)
    elif x.is_cuda and isinstance(kernel, torch.Tensor) and kernel.dtype == torch.float32:
        kernel = pack_fma(kernel)
    kh, kw, cin = (kernel if isinstance(kernel, torch.Tensor) else kernel.kernel).shape[:3]
    pb_y, pb_x = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, max(cin - x.shape[3], 0), pb_x, kw - 1 - pb_x, pb_y, kh - 1 - pb_y))
    return torch.stack([conv_valid_matmul(xp[i], kernel) for i in range(xp.shape[0])])
