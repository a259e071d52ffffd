"""The int8 matmul probe: int8 -> s32 against bf16 -> f32 ``mma.sync`` rates.

Port of ``tools/probe_int8_mxu.py``'s question to Hopper: does the int8
tensor-core path run at about twice the bf16 rate at the residual conv's
shapes?  Two products, each in a bf16 and an int8 arm (``csrc/probe_int8.cu``):

- the plain ``(2400, 128) x (128, 128)`` product (:func:`probe_mm`);
- the band pattern of the residual conv (:func:`probe_band`): a
  ``(12, 240, 128)`` bf16 band, quantized in the kernel for the int8 arm,
  then 9 tap products into a ``(2400, 128)`` accumulator (th = 10, wp = 240).

Each launch repeats its product ``nrep`` times and accumulates, so the result
is ``nrep`` times the product.  The plain versions compute it in float64,
which is exact for the int8 arm.  Weights are ``(taps, n, k)``: output column
n of tap t is ``x @ w[t, n]``.  ``chip_smoke.py`` checks and times both arms.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

C = 128              # K and N of every product
M, BAND_H, BAND_W = 2400, 10, 240  # the probe's shapes (tools/probe_int8_mxu.py)
NREP = 64


def probe_plain(x: torch.Tensor, w: torch.Tensor, nrep: int,
                act_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float64 ``nrep`` times the product: ``x (M, C) @ w[0].T`` for one tap,
    else the 3x3 band conv of ``x (R + 2, W, C)`` (zero columns outside the
    width) -> (R * W, C).  With ``act_inv`` the band is quantized first:
    clamp(round(f32(x) * act_inv), -127, 127)."""
    xf = x.float() if act_inv is None else kernels.quantize_plain(x, act_inv)
    xd, wd = xf.double(), w.double()
    if w.shape[0] == 1:
        return nrep * (xd @ wd[0].T)
    rows, width = x.shape[0] - 2, x.shape[1]
    xp = F.pad(xd, (0, 0, 1, 1))
    out = torch.zeros((rows, width, C), dtype=torch.float64, device=x.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        out += xp[dy:dy + rows, dx:dx + width] @ wd[t].T
    return nrep * out.reshape(rows * width, C)


def _probe(x, w, nrep, act_inv, ks):
    if x.device.type == "cpu":
        return probe_plain(x, w, nrep, act_inv)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on CUDA or the CPU, not {x.device}")
    quant = w.dtype == torch.int8
    if w.shape != (ks * ks, C, C) or not w.is_contiguous() or not x.is_contiguous():
        raise ValueError(f"probe: want contiguous ({ks * ks}, {C}, {C}) weights, got "
                         f"{tuple(w.shape)}")
    if ks == 1:
        rows, width = 1, x.shape[0]
        want = torch.int8 if quant else torch.bfloat16
    else:
        rows, width = x.shape[0] - 2, x.shape[1]
        want = torch.bfloat16
    if x.dtype != want or x.shape[-1] != C or (act_inv is not None) != (quant and ks == 3):
        raise ValueError(f"probe: a {w.dtype} arm with ks={ks} takes {want} input"
                         f"{' and an act_inv row' if quant and ks == 3 else ''}")
    out = torch.empty((rows * width, C), dtype=torch.int32 if quant else torch.float32,
                      device=x.device)
    err = kernels._lib("probe_int8.cu").rst_probe(
        kernels._ptr(x), kernels._ptr(w), kernels._ptr(act_inv), kernels._ptr(out),
        int(quant), ks, rows, width, nrep, kernels._stream(x))
    if err:
        raise RuntimeError(f"probe: CUDA error {err} at launch")
    return out


def probe_mm(x: torch.Tensor, w: torch.Tensor, nrep: int = NREP) -> torch.Tensor:
    """``nrep * x @ w[0].T``: (M, 128) bf16 or int8 by (1, 128, 128) of the
    same type -> (M, 128) f32 or s32."""
    out = _probe(x, w, nrep, None, 1)
    if x.device.type == "cuda":
        probe_mm.launches += 1
    return out


def probe_band(x: torch.Tensor, w: torch.Tensor, nrep: int = NREP,
               act_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nrep`` times the 3x3 band conv of the (R + 2, W, 128) bf16 band by
    (9, 128, 128) bf16 or int8 taps -> (R * W, 128) f32 or s32; the int8 arm
    quantizes the band with ``act_inv`` in the kernel."""
    out = _probe(x, w, nrep, act_inv, 3)
    if x.device.type == "cuda":
        probe_band.launches += 1
    return out


probe_mm.launches = 0
probe_band.launches = 0


def make_inputs(arm: str, quant: bool, device, seed: int = 0):
    """Seeded operands of one arm ('mm' or 'band'), as the TPU probe draws
    them: standard normal bf16, integers in [-127, 127) for int8, and the
    band's act_inv row 127 / 4."""
    gen = torch.Generator().manual_seed(seed)
    taps = 1 if arm == "mm" else 9
    x_shape = (M, C) if arm == "mm" else (BAND_H + 2, BAND_W, C)
    if quant and arm == "mm":
        x = torch.randint(-127, 127, x_shape, generator=gen, dtype=torch.int8)
    else:
        x = torch.randn(x_shape, generator=gen).to(torch.bfloat16)
    if quant:
        w = torch.randint(-127, 127, (taps, C, C), generator=gen, dtype=torch.int8)
    else:
        w = torch.randn((taps, C, C), generator=gen).to(torch.bfloat16)
    act_inv = torch.full((C,), 127.0 / 4.0) if quant and arm == "band" else None
    move = (lambda t: None if t is None else t.to(device))
    return move(x), move(w), move(act_inv)
