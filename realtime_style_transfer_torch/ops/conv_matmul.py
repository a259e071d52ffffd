"""VALID stride-1 conv as tap matmuls with a fused f32 epilogue, on one image.

Port of ``realtime_style_transfer_tpu/ops/pallas/conv_matmul.py``: the TPU
kernel ``_kernel`` (``:40``) behind ``conv_valid_matmul`` (``:83``) and
``conv_same_batched`` (``:146``) becomes ``csrc/conv_matmul.cu``.  It computes
``(Hp, Wp, Cin) x (kh, kw, Cin, Cout) -> (Hp-kh+1, Wp-kw+1, Cout)`` as kh*kw
tap matmuls accumulated in f32, then the epilogue in f32 (``none``, ``bias``
or ``contract`` = ``relu(relu(acc + bias) * scale + shift)``), and stores
x.dtype (bf16 or f32).  The packed path runs it at its stride-1 seams
(:mod:`.packed_conv`).

On a CPU tensor :func:`conv_valid_matmul` runs :func:`conv_valid_matmul_plain`
(the same tap matmuls in f32, the same epilogue, one rounding to x.dtype); on
a CUDA tensor it launches the kernel or raises.  ``conv_valid_matmul.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

EPILOGUES = {"none": 0, "bias": 1, "contract": 2}
MAX_TAPS_PER_AXIS = 15  # the widest bf16 kernel whose input tile fits Hopper's shared memory


def _epilogue_rows(cout: int, device, bias, scale, shift):
    """bias, scale and shift as (cout,) f32 rows; missing ones are zeros, as
    the JAX function passes them."""
    def row(v):
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


def conv_valid_matmul_plain(x: torch.Tensor, kernel: torch.Tensor, *,
                            bias=None, scale=None, shift=None,
                            epilogue: str = "none") -> torch.Tensor:
    """The plain version of :func:`conv_valid_matmul`: the kh*kw tap matmuls
    on f32 copies of the operands accumulated in f32 (each product of two
    bf16 values is exact in f32), then the f32 epilogue, cast to x.dtype."""
    h, w, cout = _shapes(x, kernel, epilogue)
    kh, kw, cin, _ = kernel.shape
    xf, kf = x.float(), kernel.float()
    acc = torch.zeros((h * w, cout), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += xf[dy:dy + h, dx:dx + w].reshape(h * w, cin) @ kf[dy, dx]
    rows = _epilogue_rows(cout, x.device, bias, scale, shift)
    return _apply_epilogue(acc, epilogue, *rows).reshape(h, w, cout).to(x.dtype)


def conv_valid_matmul(x: torch.Tensor, kernel: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      epilogue: str = "none") -> torch.Tensor:
    """VALID stride-1 conv of the pre-padded single image ``x`` (Hp, Wp, Cin)
    by the HWIO ``kernel`` (kh, kw, Cin, Cout) of the same dtype (bf16 or
    f32) -> (Hp-kh+1, Wp-kw+1, Cout) in x.dtype, with the f32 ``epilogue``
    (``none``, ``bias`` or ``contract``; bias, scale and shift are (Cout,)
    rows, zeros where not given)."""
    if x.device.type == "cpu":
        return conv_valid_matmul_plain(x, kernel, bias=bias, scale=scale, shift=shift,
                                       epilogue=epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"conv_valid_matmul runs on CUDA or the CPU, not {x.device}")
    h, w, cout = _shapes(x, kernel, epilogue)
    hp, wp, cin = x.shape
    kh, kw = kernel.shape[:2]
    if x.dtype not in (torch.bfloat16, torch.float32) or kernel.dtype != x.dtype \
            or kernel.device != x.device:
        raise ValueError(f"conv_valid_matmul: want bf16 or f32 x and a kernel of the same "
                         f"type on its device, got {x.dtype} on {x.device} and "
                         f"{kernel.dtype} on {kernel.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("conv_valid_matmul: want contiguous x and kernel")
    if x.dtype == torch.bfloat16 and max(kh, kw) > MAX_TAPS_PER_AXIS:
        raise ValueError(f"conv_valid_matmul: a {kh}x{kw} kernel's input tile exceeds "
                         f"shared memory (at most {MAX_TAPS_PER_AXIS} taps an axis)")
    rows = _epilogue_rows(cout, x.device, bias, scale, shift) if epilogue != "none" \
        else (None, None, None)
    out = torch.empty((h, w, cout), dtype=x.dtype, device=x.device)
    err = kernels._lib("conv_matmul.cu").rst_conv_matmul(
        kernels._ptr(x), kernels._ptr(kernel), *(kernels._ptr(r) for r in rows),
        kernels._ptr(out), hp, wp, cin, kh, kw, cout, EPILOGUES[epilogue],
        int(x.dtype == torch.float32), kernels._stream(x))
    if err:
        raise RuntimeError(f"conv_valid_matmul: CUDA error {err} at launch")
    conv_valid_matmul.launches += 1
    return out


conv_valid_matmul.launches = 0


def conv_same_batched(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 conv on (B, H, W, Cin) via :func:`conv_valid_matmul`:
    pads once (``(k-1)//2`` before, the rest after), one call a batch item."""
    kh, kw = kernel.shape[:2]
    pb_y, pb_x = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, pb_x, kw - 1 - pb_x, pb_y, kh - 1 - pb_y))
    return torch.stack([conv_valid_matmul(xp[i], kernel) for i in range(xp.shape[0])])
