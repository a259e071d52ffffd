"""The repack probe: what a grid-transition repack costs on Hopper as its own pass.

Port of ``tools/probe_repack_ops.py``.  The TPU's divider-1 fused kernel joins
its content grid and its bottleneck grid by repacks of c2's and e1's output
bands (``fold2`` / ``unfold2``), and the TPU probe asked which formulations
Mosaic could lower.  The port's stage loop runs every stage at true resolution
and needs no repack; a later one-launch kernel that keeps activations on chip
would, so the Hopper probe asks what one such pass costs here.  Four bf16
functions (``csrc/probe_repack.cu``), each on a batch of ``n`` inputs, each
with a plain PyTorch version that repeats the TPU probe's numpy ``want_*``
formula:

- :func:`deinterleave` ``(n, H, W, C) -> (n, H/2, W, 2C)``: even rows, then
  odd rows, stacked on channels;
- :func:`interleave` two ``(n, H, W, C) -> (n, 2H, W, C)``;
- :func:`fold2` ``(n, H, W, C) -> (n, H/2, W/2, 4C)``: channel block ``2p + q``
  holds input pixel ``(2i + p, 2j + q)``;
- :func:`unfold2` ``(n, H, W, 4Q) -> (n, 2H, 2W, out_c)``: output pixel
  ``(2i + p, 2j + q)`` takes channels ``[(2p + q)Q, (2p + q + 1)Q)`` of input
  pixel ``(i, j)``, channels ``Q..out_c-1`` zero; ``out_c = Q`` inverts
  :func:`fold2`.

:data:`CASES` holds the TPU probe's shapes and the port's own frame-sized
case, fold2 of the rst-1920 c2 output and unfold2 back.  Each wrapper sends a
CPU tensor to its plain version and a CUDA tensor to the kernel, and counts
its kernel launches in ``launches``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

_MODES = {"deinterleave": 0, "interleave": 1, "fold2": 2, "unfold2": 3}


class Case(NamedTuple):
    op: str
    in_shape: Tuple[int, int, int]  # one item (H, W, C)
    out_c: int = 0                  # unfold2 only: output channels
    n: int = 64                     # items in a timed batch


# the TPU probe's shapes (tools/probe_repack_ops.py:31,113,136) and the
# rst-1920 c2 output, (240, 480, 32), folded to the bottleneck grid and back
CASES: Dict[str, Case] = {
    "deinterleave": Case("deinterleave", (8, 240, 256)),
    "interleave": Case("interleave", (4, 240, 256)),
    "fold2": Case("fold2", (8, 480, 128)),
    "unfold2": Case("unfold2", (10, 240, 256), out_c=128),
    "fold2_rst1920_c2": Case("fold2", (240, 480, 32), n=8),
    "unfold2_rst1920_c2": Case("unfold2", (120, 240, 128), out_c=32, n=8),
}


def out_shape(op: str, in_shape, out_c: int = 0) -> Tuple[int, int, int]:
    """The output item shape of ``op`` on an input item of ``in_shape``."""
    h, w, c = in_shape
    return {"deinterleave": (h // 2, w, 2 * c), "interleave": (2 * h, w, c),
            "fold2": (h // 2, w // 2, 4 * c), "unfold2": (2 * h, 2 * w, out_c)}[op]


# ---- plain versions: the TPU probe's want_* formulas -------------------------------


def deinterleave_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[:, 0::2], v[:, 1::2]], dim=-1)


def interleave_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n, h, w, c = a.shape
    out = torch.empty((n, 2 * h, w, c), dtype=a.dtype, device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def fold2_plain(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    r = x.reshape(n, h // 2, 2, w // 2, 2 * c)
    return torch.cat([r[:, :, 0], r[:, :, 1]], dim=-1)


def unfold2_plain(u: torch.Tensor, out_c: int) -> torch.Tensor:
    n, h, w, c = u.shape
    half, q = c // 2, c // 4
    z = torch.stack([u[..., :half], u[..., half:]], dim=2).reshape(n, 2 * h, w, half)
    y = z.reshape(n, 2 * h, 2 * w, q)
    return F.pad(y, (0, out_c - q))


# ---- kernels ------------------------------------------------------------------------


def _repack(op: str, a: torch.Tensor, b: Optional[torch.Tensor], out_c: int) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"the repack probe runs on CUDA or the CPU, not {a.device}")
    if a.ndim != 4:
        raise ValueError(f"{op}: want an (n, H, W, C) batch, got {tuple(a.shape)}")
    n, h, w, c = a.shape
    oshape = out_shape(op, (h, w, c), out_c)
    run = c // 4 if op == "unfold2" else c
    if (h % 2 and op in ("deinterleave", "fold2")) or (w % 2 and op == "fold2") \
            or c % 8 or run % 8 or oshape[2] % 8 or oshape[2] < run:
        raise ValueError(f"{op}: unsupported shape {tuple(a.shape)} -> {oshape}")
    for t in (a,) if b is None else (a, b):
        kernels._check(t, f"{op} input", torch.bfloat16, (n, h, w, c), a.device)
    out = torch.empty((n,) + oshape, dtype=torch.bfloat16, device=a.device)
    err = kernels._lib("probe_repack.cu").rst_repack(
        kernels._ptr(a), kernels._ptr(b), kernels._ptr(out), _MODES[op], n, h, w, c,
        *oshape, kernels._stream(a))
    if err:
        raise RuntimeError(f"{op}: CUDA error {err} at launch")
    return out


def deinterleave(v: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cpu":
        return deinterleave_plain(v)
    out = _repack("deinterleave", v, None, 0)
    deinterleave.launches += 1
    return out


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return interleave_plain(a, b)
    out = _repack("interleave", a, b, 0)
    interleave.launches += 1
    return out


def fold2(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return fold2_plain(x)
    out = _repack("fold2", x, None, 0)
    fold2.launches += 1
    return out


def unfold2(u: torch.Tensor, out_c: int) -> torch.Tensor:
    if u.device.type == "cpu":
        return unfold2_plain(u, out_c)
    out = _repack("unfold2", u, None, out_c)
    unfold2.launches += 1
    return out


for _fn in (deinterleave, interleave, fold2, unfold2):
    _fn.launches = 0

KERNELS = {"deinterleave": deinterleave, "interleave": interleave, "fold2": fold2,
           "unfold2": unfold2}
PLAIN = {"deinterleave": deinterleave_plain, "interleave": interleave_plain,
         "fold2": fold2_plain, "unfold2": unfold2_plain}


def library(op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
            out_c: int = 0) -> torch.Tensor:
    """The same function as one strided PyTorch copy (``view(...).permute(...)
    .contiguous()``; ``torch.stack`` for interleave's two inputs, ``F.pad``
    after the copy for unfold2's zero lanes): the yardstick of the probe."""
    n, h, w, c = a.shape
    if op == "deinterleave":
        return a.view(n, h // 2, 2, w, c).permute(0, 1, 3, 2, 4).reshape(n, h // 2, w, 2 * c)
    if op == "interleave":
        return torch.stack([a, b], dim=2).view(n, 2 * h, w, c)
    if op == "fold2":
        return a.view(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, h // 2, w // 2, 4 * c)
    q = c // 4
    y = a.view(n, h, w, 2, 2, q).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, q)
    return y if out_c == q else F.pad(y, (0, out_c - q))


def make_inputs(case: Case, device, seed: int = 0):
    """Seeded standard-normal bf16 input(s) of a batch of ``case``: (a, b),
    b only for interleave."""
    gen = torch.Generator().manual_seed(seed)
    shape = (case.n,) + case.in_shape
    a = torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)
    b = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)
         if case.op == "interleave" else None)
    return a, b


def run(case: Case, a: torch.Tensor, b: Optional[torch.Tensor], *, plain: bool = False,
        lib: bool = False) -> torch.Tensor:
    """``case``'s function on its inputs: the kernel (or, on the CPU, the
    plain version), the plain version, or the library yardstick."""
    if lib:
        return library(case.op, a, b, case.out_c)
    table = PLAIN if plain else KERNELS
    args = {"interleave": (a, b), "unfold2": (a, case.out_c)}.get(case.op, (a,))
    return table[case.op](*args)
