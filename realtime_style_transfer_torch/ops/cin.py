"""Conditional instance norm on a hand-written CUDA kernel, with its gradient.

Port of ``realtime_style_transfer_tpu/ops/pallas/cin.py`` (TPU kernel row 2:
``_stats_kernel`` and ``_normalize_kernel`` behind ``cin_pallas``).
``csrc/cin.cu`` holds the two launches:

* ``cin_stats``: per (b, c) the f32 mean and mean of squares over H x W, a
  (B, 2, C) f32 tensor.  The kernel adds every value, then scales once by
  ``1/(H*W)`` (the TPU kernel adds ``sum * (1/HW)`` per H tile: a few f32
  ulps apart); its sums run in an order fixed by the grid, so two calls give
  the same bits.
* ``cin_normalize``: ``var = meansq - mean^2``, ``inv = rsqrt(var + eps)``,
  ``s = inv * scale``, ``t = bias - mean * s`` in f32, then ``x * s + t`` in
  f32, cast once to ``x.dtype``, into a fresh tensor (the JAX kernel writes
  in place; here autograd keeps ``x`` for the backward).

:func:`cin` routes as ``cin_pallas`` does: below :data:`MIN_CHANNELS`
channels it takes the plain ``conditional_instance_norm``.  Its backward is
``_cin_bwd`` in torch ops (moments recomputed from ``x`` in f32; ``dx``,
``dscale``, ``dbias`` cast back to their inputs' dtypes): the TPU package
wrote no backward kernel either.

Each launch wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version (:func:`cin_stats_plain`, :func:`cin_normalize_plain`, same
rounding points), a CUDA tensor launches the kernel or raises, and counts the
launch in ``launches``.

Bound on the H100: bytes.  (4, 120, 240, 128) bf16, the ten residual CINs of
a flagship training step, is 29.5 MB each way: 0.0176 ms for one read and
one write, 0.0264 ms for this design's read + read + write
(:func:`..ops.bounds.cin_work`).
"""

from __future__ import annotations

import torch

from .kernels import _check, _lib, _ptr, _stream
from .normalization import CIN_EPS, conditional_instance_norm

MIN_CHANNELS = 64   # below it the plain CIN runs, as in the TPU package
STATS_ROWS = 512    # cin.cu's ROWS: pixels a stats block adds
_DTYPES = (torch.float32, torch.bfloat16)


def cin_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C) f32: sums of x and x^2 over H x W in f32,
    each scaled once by 1/(H*W)."""
    b, h, w, c = x.shape
    xf = x.float()
    inv_n = 1.0 / float(h * w)
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1) * inv_n


def cin_normalize_plain(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The normalize step of :func:`cin_normalize` in torch ops."""
    mean, meansq = stats[:, 0], stats[:, 1]
    inv = torch.rsqrt((meansq - mean * mean) + eps)
    s = inv * scale
    t = bias - mean * s
    return (x.float() * s[:, None, None, :] + t[:, None, None, :]).to(x.dtype)


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPES or x.ndim != 4:
        raise ValueError(f"{name}: want a (B, H, W, C) f32 or bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    _check(x, name, x.dtype, x.shape, x.device)


def cin_stats(x: torch.Tensor) -> torch.Tensor:
    """The (B, 2, C) f32 [mean, mean of squares] of NHWC ``x``."""
    if x.device.type == "cpu":
        return cin_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"cin_stats runs on CUDA or the CPU, not {x.device}")
    _check_x(x, "cin_stats input")
    b, h, w, c = x.shape
    blocks = -(-(h * w) // STATS_ROWS)
    partials = torch.empty(b * blocks * 2 * c, dtype=torch.float32, device=x.device)
    tickets = torch.zeros(b, dtype=torch.int32, device=x.device)
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    err = _lib("cin.cu").rst_cin_stats(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(partials), _ptr(tickets), _ptr(stats),
        b, h * w, c, 1.0 / float(h * w), partials.numel(), _stream(x))
    if err:
        raise RuntimeError(f"cin_stats: CUDA error {err} at launch")
    cin_stats.launches += 1
    return stats


cin_stats.launches = 0


def cin_normalize(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * s + t`` with the f32 affine folded from ``stats`` (B, 2, C) and
    the (B, C) f32 ``scale`` and ``bias``; a fresh tensor of ``x``'s dtype."""
    if x.device.type == "cpu":
        return cin_normalize_plain(x, stats, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cin_normalize runs on CUDA or the CPU, not {x.device}")
    _check_x(x, "cin_normalize input")
    b, h, w, c = x.shape
    f32 = torch.float32
    _check(stats, "cin_normalize stats", f32, (b, 2, c), x.device)
    _check(scale, "cin_normalize scale", f32, (b, c), x.device)
    _check(bias, "cin_normalize bias", f32, (b, c), x.device)
    out = torch.empty_like(x)
    err = _lib("cin.cu").rst_cin_normalize(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(stats), _ptr(scale), _ptr(bias),
        float(eps), _ptr(out), b, h * w, c, _stream(x))
    if err:
        raise RuntimeError(f"cin_normalize: CUDA error {err} at launch")
    cin_normalize.launches += 1
    return out


cin_normalize.launches = 0


def _rows(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """A broadcastable (B, 1, 1, C)-like scale or bias as a (B, C) f32 row."""
    return t.reshape(b, c).float().contiguous()


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             plain: bool = False) -> torch.Tensor:
    b, _, _, c = x.shape
    if c < MIN_CHANNELS:
        return conditional_instance_norm(x, scale, bias, epsilon=eps)
    x = x.contiguous()
    rows = _rows(scale, b, c), _rows(bias, b, c)
    if plain:
        return cin_normalize_plain(x, cin_stats_plain(x), *rows, eps)
    return cin_normalize(x, cin_stats(x), *rows, eps)


def cin_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float):
    """``_cin_bwd`` of the TPU package in torch ops: (dx, dscale, dbias), dx
    of ``x``'s dtype, dscale and dbias f32 of ``scale``'s shape."""
    b, _, _, c = x.shape
    xf, gf = x.float(), g.float()
    mean = torch.mean(xf, dim=(1, 2), keepdim=True)
    var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dbias = torch.sum(gf, dim=(1, 2), keepdim=True).reshape(scale.shape)
    dscale = torch.sum(gf * xhat, dim=(1, 2), keepdim=True).reshape(scale.shape)
    dxhat = gf * scale.float().reshape(b, 1, 1, c)
    m_dxhat = torch.mean(dxhat, dim=(1, 2), keepdim=True)
    m_dxhat_xhat = torch.mean(dxhat * xhat, dim=(1, 2), keepdim=True)
    dx = inv * (dxhat - m_dxhat - xhat * m_dxhat_xhat)
    return dx.to(x.dtype), dscale, dbias


class _Cin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, plain):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_like = (bias.shape, bias.dtype)
        return _forward(x, scale, bias, eps, plain)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = cin_backward(x, scale, g, ctx.eps)
        shape, dtype = ctx.bias_like
        return dx, dscale.to(scale.dtype), dbias.reshape(shape).to(dtype), None, None


def cin(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        epsilon: float = CIN_EPS) -> torch.Tensor:
    """Fused CIN, ``bias + (x - mean) * rsqrt(var + eps) * scale`` over
    (H, W) of NHWC ``x``; ``scale`` and ``bias`` broadcastable (B, 1, 1, C)
    with one element a (b, c).  Differentiable in all three."""
    return _Cin.apply(x, scale, bias, float(epsilon), False)


def cin_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              epsilon: float = CIN_EPS) -> torch.Tensor:
    """:func:`cin` with the kernels' plain versions, on any device: same
    signature, same rounding points, same backward."""
    return _Cin.apply(x, scale, bias, float(epsilon), True)


def reset_launch_counts() -> None:
    cin_stats.launches = 0
    cin_normalize.launches = 0
