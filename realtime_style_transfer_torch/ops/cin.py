"""Conditional instance norm on hand-written CUDA kernels, with its gradient.

Port of ``realtime_style_transfer_tpu/ops/pallas/cin.py`` (TPU kernel row 2:
``_stats_kernel`` and ``_normalize_kernel`` behind ``cin_pallas``).
``csrc/cin.cu`` holds one kernel, launched once for the forward and once for
the backward:

* :func:`cin_forward`: per (b, c) the f32 mean and mean of squares over
  H x W (every value added, then scaled once by ``1/(H*W)``; the TPU kernel
  adds ``sum * (1/HW)`` per H tile: a few f32 ulps apart), then ``var =
  meansq - mean^2``, ``inv = rsqrt(var + eps)``, ``s = inv * scale``, ``t =
  bias - mean * s`` in f32 and ``x * s + t`` in f32, cast once to
  ``x.dtype``, into a fresh tensor (the JAX kernel writes in place; here
  autograd keeps ``x`` for the backward).  It returns the (B, 2, C) f32
  moments too.
* :func:`cin_backward`: ``_cin_bwd``'s function, ``dbias = sum g``,
  ``dscale = sum g * xhat``, ``dx = inv * scale * (g - mean(g) - xhat *
  mean(g * xhat))`` cast once to ``x.dtype``.  The TPU package wrote no
  backward kernel; this one has the forward's design.

A launch is one cooperative grid of one block an SM: each image's pixels are
cut into contiguous row ranges (:func:`cin_plan`), each block keeps its rows
in shared memory, adds its f32 sums in a fixed order and writes them to a
scratch; after a grid barrier every block adds its image's partials in part
order and writes its outputs from shared memory.  So each byte of x (and g)
is read once where a block's rows fit, and two calls give the same bits.
Each wrapper takes that scratch with ``torch.empty``, which launches nothing.

Divergence from the JAX package: ``_cin_bwd`` recomputes the moments from
``x``; here the forward's moments are saved and the backward reuses them.
The two differ only in the order of the f32 sums.

:func:`cin` routes as ``cin_pallas`` does: below :data:`MIN_CHANNELS`
channels it takes the plain ``conditional_instance_norm``, and its backward
recomputes the moments in torch ops.

The split mode, for a frame whose rows are sharded over the ranks of a
spatial group (:func:`cin_split`; ``parallel/spatial.py``): a grid barrier
cannot span ranks, so each pass is two launches of the same kernel with an
all-reduce of the (B, 2, C) f32 sums over the group between them, the shape
of the TPU kernel's ``_stats_kernel`` and ``_normalize_kernel``:
:func:`cin_forward_sums` (the unscaled ``[sum x, sum x^2]`` of this rank's
rows), :func:`cin_forward_apply` (the moments from the group's sums and the
group's pixel count, the one launch's fold and output),
:func:`cin_backward_sums` (``[sum g, sum g (x - mean)]`` from the forward's
moments) and :func:`cin_backward_apply` (``dx`` from the group's sums).
Each rank's ``dscale`` and ``dbias`` are its own rows' share, so that the
sum of the group's parameter gradients is the gradient.  Below
:data:`MIN_CHANNELS` the same split runs in torch ops
(``normalization.conditional_instance_norm(..., rows=...)``).  Neither launch
keeps rows in shared memory: the forward reads x twice and writes the output
once, the backward reads x and g twice and writes dx once.

Each wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version (:func:`cin_forward_plain`, :func:`cin_backward_plain`, same rounding
points of the folded coefficients), a CUDA tensor launches the kernel or
raises, and counts the launch in ``launches``.

Bound on the H100: bytes.  (4, 120, 240, 128) bf16, the ten residual CINs of
a flagship training step: the forward moves 29.5 MB each way, 0.0176 ms; the
backward reads x and g and writes dx, 0.0264 ms
(:func:`..ops.bounds.cin_work`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kernels import SMS, _check, _lib, _ptr, _sm_count, _stream
from .normalization import CIN_EPS, conditional_instance_norm

MIN_CHANNELS = 64   # below it the plain CIN runs, as in the TPU package
THREADS = 512       # cin.cu's NT: threads a block
SMEM_CAP = 232448   # cin.cu's SMEM_CAP: the H100's shared memory a block
AUX_FLOATS = 6      # cin.cu's AUX_FLOATS: f32 a channel ahead of the rows
_DTYPES = (torch.float32, torch.bfloat16)


class CinPlan(NamedTuple):
    """A launch of :func:`cin_forward` or :func:`cin_backward`: each image in
    ``parts`` items of ``rows`` rows (the last may be shorter), ``blocks``
    blocks taking items in turn, each keeping its first ``pix_sm`` rows in
    shared memory (``smem_bytes`` with the sums and coefficients); the rest
    are read a second time."""
    parts: int
    rows: int
    blocks: int
    pix_sm: int
    smem_bytes: int


def cin_plan(b: int, hw: int, c: int, itemsize: int, backward: bool = False,
             blocks: int = SMS) -> CinPlan:
    """One block an SM (``blocks``): each image cut into ``blocks // b``
    parts (at least one, at most one a row), so the training step's four
    images make one item a block; rows to shared memory while they fit."""
    parts = max(1, min(hw, blocks // b))
    rows = -(-hw // parts)
    grid = min(b * parts, blocks)
    aux = -(-AUX_FLOATS * 4 * c // 16) * 16
    row_bytes = c * itemsize * (2 if backward else 1)
    pix_sm = max(0, min(-(-b * parts // grid) * rows, (SMEM_CAP - aux) // row_bytes))
    return CinPlan(parts, rows, grid, pix_sm, aux + pix_sm * row_bytes)


def cin_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C) f32: sums of x and x^2 over H x W in f32,
    each scaled once by 1/(H*W)."""
    b, h, w, c = x.shape
    xf = x.float()
    inv_n = 1.0 / float(h * w)
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1) * inv_n


def cin_normalize_plain(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * s + t`` with the f32 affine folded from ``stats`` (B, 2, C) and
    the (B, C) f32 ``scale`` and ``bias``, in torch ops."""
    mean, meansq = stats[:, 0], stats[:, 1]
    inv = torch.rsqrt((meansq - mean * mean) + eps)
    s = inv * scale
    t = bias - mean * s
    return (x.float() * s[:, None, None, :] + t[:, None, None, :]).to(x.dtype)


def cin_forward_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cin_forward` in torch ops: (output, moments)."""
    stats = cin_stats_plain(x)
    return cin_normalize_plain(x, stats, scale, bias, eps), stats


def cin_forward_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C) f32: the unscaled sums of x and x^2 over
    H x W in f32."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def cin_forward_apply_plain(x: torch.Tensor, sums: torch.Tensor, n: int, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cin_forward_apply` in torch ops: (output, moments), the moments
    the (B, 2, C) ``sums`` of ``n`` pixels an image each scaled by 1/n."""
    stats = sums * (1.0 / float(n))
    return cin_normalize_plain(x, stats, scale, bias, eps), stats


def cin_backward_sums_plain(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) f32: the sums of g and of g (x - mean) over H x W, the
    mean from the forward's moments ``stats``."""
    b, _, _, c = x.shape
    gf = g.float()
    mean = stats[:, 0].reshape(b, 1, 1, c)
    return torch.stack([gf.sum(dim=(1, 2)), (gf * (x.float() - mean)).sum(dim=(1, 2))], dim=1)


def cin_backward_apply_plain(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                             sums: torch.Tensor, n: int, scale: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """:func:`cin_backward_apply` in torch ops, in the kernel's fold:
    ``dx = inv * scale * ((g - S / n) - (x - mean) * inv * (inv * Q) / n)``
    from the group's sums ``[S, Q]`` of ``n`` pixels an image."""
    b, _, _, c = x.shape
    mean, meansq = stats[:, 0], stats[:, 1]
    inv = torch.rsqrt((meansq - mean * mean) + eps)
    inv_n = 1.0 / float(n)
    k0 = inv * scale
    k1 = sums[:, 0] * inv_n
    k2 = inv * ((inv * sums[:, 1]) * inv_n)

    def per(t):
        return t.reshape(b, 1, 1, c)

    dx = per(k0) * ((g.float() - per(k1)) - (x.float() - per(mean)) * per(k2))
    return dx.to(x.dtype)


def cin_backward_plain(x: torch.Tensor, g: torch.Tensor, stats: Optional[torch.Tensor],
                       scale: torch.Tensor, eps: float):
    """``_cin_bwd`` of the TPU package in torch ops: (dx, dscale, dbias), dx
    of ``x``'s dtype, dscale and dbias (B, C) f32; ``scale`` (B, C).  With
    ``stats`` None the moments are recomputed from ``x``, as ``_cin_bwd``
    does; else the forward's (B, 2, C) moments are used."""
    b, _, _, c = x.shape
    xf, gf = x.float(), g.float()
    if stats is None:
        mean = torch.mean(xf, dim=(1, 2), keepdim=True)
        var = torch.mean(xf * xf, dim=(1, 2), keepdim=True) - mean * mean
    else:
        mean = stats[:, 0].reshape(b, 1, 1, c)
        var = stats[:, 1].reshape(b, 1, 1, c) - mean * mean
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dbias = torch.sum(gf, dim=(1, 2))
    dscale = torch.sum(gf * xhat, dim=(1, 2))
    dxhat = gf * scale.float().reshape(b, 1, 1, c)
    m_dxhat = torch.mean(dxhat, dim=(1, 2), keepdim=True)
    m_dxhat_xhat = torch.mean(dxhat * xhat, dim=(1, 2), keepdim=True)
    dx = inv * (dxhat - m_dxhat - xhat * m_dxhat_xhat)
    return dx.to(x.dtype), dscale, dbias


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPES or x.ndim != 4:
        raise ValueError(f"{name}: want a (B, H, W, C) f32 or bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    _check(x, name, x.dtype, x.shape, x.device)


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for CUDA."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or the CPU, not {x.device}")
    _check_x(x, f"{name} input")
    return True


def _vectors(c: int, itemsize: int) -> int:
    """The kernel's vectors a row: C over 16 bytes' worth of channels, or C."""
    return c // (16 // itemsize) if c % (16 // itemsize) == 0 else c


def _launch_plan(x: torch.Tensor, backward: bool) -> CinPlan:
    b, h, w, c = x.shape
    if _vectors(c, x.element_size()) > THREADS:
        raise ValueError(f"cin: at most {THREADS} vectors a row, not C = {c} "
                         f"{str(x.dtype)[6:]}")
    return cin_plan(b, h * w, c, x.element_size(), backward, _sm_count(x.device))


def launch_forward(lib, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   out: torch.Tensor, stats: torch.Tensor, partials: torch.Tensor,
                   plan: CinPlan, counters: Optional[torch.Tensor] = None) -> int:
    """``rst_cin_forward`` of ``lib``, unchecked and uncounted (the wrapper
    checks its tensors first; ``halo_profile`` gives it a profiled build and
    ``counters``, the int64 buffer of its clock counters): the CUDA error."""
    b, h, w, c = x.shape
    return lib.rst_cin_forward(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(scale), _ptr(bias), float(eps), _ptr(out),
        _ptr(stats), _ptr(partials), _ptr(counters), b, h * w, c, plan.parts, plan.blocks,
        plan.pix_sm, _stream(x))


def launch_backward(lib, x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                    scale: torch.Tensor, eps: float, dx: torch.Tensor, dscale: torch.Tensor,
                    dbias: torch.Tensor, partials: torch.Tensor, plan: CinPlan,
                    counters: Optional[torch.Tensor] = None) -> int:
    """``rst_cin_backward`` of ``lib``, as :func:`launch_forward`."""
    b, h, w, c = x.shape
    return lib.rst_cin_backward(
        _ptr(x), _ptr(g), int(x.dtype == torch.bfloat16), _ptr(stats), _ptr(scale), float(eps),
        _ptr(dx), _ptr(dscale), _ptr(dbias), _ptr(partials), _ptr(counters), b, h * w, c,
        plan.parts, plan.blocks, plan.pix_sm, _stream(x))


def cin_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """CIN of NHWC ``x`` with the (B, C) f32 ``scale`` and ``bias``: (the
    output, a fresh tensor of ``x``'s dtype; the (B, 2, C) f32 [mean, mean of
    squares])."""
    if not _on_cuda(x, "cin_forward"):
        return cin_forward_plain(x, scale, bias, eps)
    b, _, _, c = x.shape
    f32 = torch.float32
    _check(scale, "cin_forward scale", f32, (b, c), x.device)
    _check(bias, "cin_forward bias", f32, (b, c), x.device)
    plan = _launch_plan(x, False)
    out = torch.empty_like(x)
    stats = torch.empty((b, 2, c), dtype=f32, device=x.device)
    partials = torch.empty(b * plan.parts * 2 * c, dtype=f32, device=x.device)
    err = launch_forward(_lib("cin.cu"), x, scale, bias, eps, out, stats, partials, plan)
    if err:
        raise RuntimeError(f"cin_forward: CUDA error {err} at launch")
    cin_forward.launches += 1
    return out, stats


cin_forward.launches = 0


def cin_backward(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                 eps: float):
    """The gradient of :func:`cin_forward` for ``g``, the output's: (dx of
    ``x``'s dtype, dscale (B, C) f32, dbias (B, C) f32), from the forward's
    moments ``stats`` and the (B, C) f32 ``scale``."""
    if not _on_cuda(x, "cin_backward"):
        return cin_backward_plain(x, g, stats, scale, eps)
    b, _, _, c = x.shape
    f32 = torch.float32
    _check(g, "cin_backward g", x.dtype, x.shape, x.device)
    _check(stats, "cin_backward stats", f32, (b, 2, c), x.device)
    _check(scale, "cin_backward scale", f32, (b, c), x.device)
    plan = _launch_plan(x, True)
    dx = torch.empty_like(x)
    dscale = torch.empty((b, c), dtype=f32, device=x.device)
    dbias = torch.empty((b, c), dtype=f32, device=x.device)
    partials = torch.empty(b * plan.parts * 2 * c, dtype=f32, device=x.device)
    err = launch_backward(_lib("cin.cu"), x, g, stats, scale, eps, dx, dscale, dbias, partials,
                          plan)
    if err:
        raise RuntimeError(f"cin_backward: CUDA error {err} at launch")
    cin_backward.launches += 1
    return dx, dscale, dbias


cin_backward.launches = 0


def _split_plan(x: torch.Tensor) -> CinPlan:
    """The items and blocks of :func:`_launch_plan` with no rows kept in
    shared memory: a split launch streams its rows."""
    c = x.shape[-1]
    return _launch_plan(x, False)._replace(pix_sm=0, smem_bytes=-(-AUX_FLOATS * 4 * c // 16) * 16)


def _launched(fn, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")
    fn.launches += 1


def cin_forward_sums(x: torch.Tensor) -> torch.Tensor:
    """The split mode's forward sums: (B, 2, C) f32 ``[sum x, sum x^2]``
    over this tensor's H x W, unscaled, in the kernel's fixed order."""
    if not _on_cuda(x, "cin_forward_sums"):
        return cin_forward_sums_plain(x)
    b, h, w, c = x.shape
    plan = _split_plan(x)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    partials = torch.empty(b * plan.parts * 2 * c, dtype=torch.float32, device=x.device)
    _launched(cin_forward_sums, _lib("cin.cu").rst_cin_forward_sums(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(sums), _ptr(partials), b, h * w, c,
        plan.parts, plan.blocks, _stream(x)))
    return sums


def cin_forward_apply(x: torch.Tensor, sums: torch.Tensor, n: int, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split mode's forward apply: from the group's (B, 2, C) f32
    ``sums`` of ``n`` pixels an image and the (B, C) f32 ``scale`` and
    ``bias``, (the output, the (B, 2, C) f32 moments)."""
    if not _on_cuda(x, "cin_forward_apply"):
        return cin_forward_apply_plain(x, sums, n, scale, bias, eps)
    b, h, w, c = x.shape
    f32 = torch.float32
    for t, name in ((sums, "sums"), (scale, "scale"), (bias, "bias")):
        _check(t, f"cin_forward_apply {name}", f32, (b, 2, c) if name == "sums" else (b, c),
               x.device)
    plan = _split_plan(x)
    out = torch.empty_like(x)
    stats = torch.empty((b, 2, c), dtype=f32, device=x.device)
    _launched(cin_forward_apply, _lib("cin.cu").rst_cin_forward_apply(
        _ptr(x), int(x.dtype == torch.bfloat16), _ptr(sums), int(n), _ptr(scale), _ptr(bias),
        float(eps), _ptr(out), _ptr(stats), b, h * w, c, plan.parts, plan.blocks, _stream(x)))
    return out, stats


def cin_backward_sums(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """The split mode's backward sums: (B, 2, C) f32 ``[sum g, sum g (x -
    mean)]`` over this tensor's H x W, from the forward's moments."""
    if not _on_cuda(x, "cin_backward_sums"):
        return cin_backward_sums_plain(x, g, stats)
    b, h, w, c = x.shape
    f32 = torch.float32
    _check(g, "cin_backward_sums g", x.dtype, x.shape, x.device)
    _check(stats, "cin_backward_sums stats", f32, (b, 2, c), x.device)
    plan = _split_plan(x)
    sums = torch.empty((b, 2, c), dtype=f32, device=x.device)
    partials = torch.empty(b * plan.parts * 2 * c, dtype=f32, device=x.device)
    _launched(cin_backward_sums, _lib("cin.cu").rst_cin_backward_sums(
        _ptr(x), _ptr(g), int(x.dtype == torch.bfloat16), _ptr(stats), _ptr(sums),
        _ptr(partials), b, h * w, c, plan.parts, plan.blocks, _stream(x)))
    return sums


def cin_backward_apply(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor, sums: torch.Tensor,
                       n: int, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The split mode's backward apply: ``dx`` of ``x``'s dtype from the
    forward's moments and the group's (B, 2, C) f32 backward ``sums`` of
    ``n`` pixels an image."""
    if not _on_cuda(x, "cin_backward_apply"):
        return cin_backward_apply_plain(x, g, stats, sums, n, scale, eps)
    b, h, w, c = x.shape
    f32 = torch.float32
    _check(g, "cin_backward_apply g", x.dtype, x.shape, x.device)
    for t, name in ((stats, "stats"), (sums, "sums"), (scale, "scale")):
        _check(t, f"cin_backward_apply {name}", f32, (b, c) if name == "scale" else (b, 2, c),
               x.device)
    plan = _split_plan(x)
    dx = torch.empty_like(x)
    _launched(cin_backward_apply, _lib("cin.cu").rst_cin_backward_apply(
        _ptr(x), _ptr(g), int(x.dtype == torch.bfloat16), _ptr(stats), _ptr(sums), int(n),
        _ptr(scale), float(eps), _ptr(dx), b, h * w, c, plan.parts, plan.blocks, _stream(x)))
    return dx


for _fn in (cin_forward_sums, cin_forward_apply, cin_backward_sums, cin_backward_apply):
    _fn.launches = 0


def _rows(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """A broadcastable (B, 1, 1, C)-like scale or bias as a (B, C) f32 row."""
    return t.reshape(b, c).float().contiguous()


class _Cin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, plain):
        b, _, _, c = x.shape
        ctx.eps, ctx.plain = eps, plain
        ctx.bias_like = (bias.shape, bias.dtype)
        if c < MIN_CHANNELS:
            ctx.save_for_backward(x, scale, None)
            return conditional_instance_norm(x, scale, bias, epsilon=eps)
        x = x.contiguous()
        out, stats = (cin_forward_plain if plain else cin_forward)(
            x, _rows(scale, b, c), _rows(bias, b, c), eps)
        ctx.save_for_backward(x, scale, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        b, _, _, c = x.shape
        backward = cin_backward_plain if ctx.plain or stats is None else cin_backward
        dx, dscale, dbias = backward(x, g.contiguous(), stats, _rows(scale, b, c), ctx.eps)
        shape, dtype = ctx.bias_like
        return (dx, dscale.reshape(scale.shape).to(scale.dtype), dbias.reshape(shape).to(dtype),
                None, None)


def cin(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        epsilon: float = CIN_EPS) -> torch.Tensor:
    """Fused CIN, ``bias + (x - mean) * rsqrt(var + eps) * scale`` over
    (H, W) of NHWC ``x``; ``scale`` and ``bias`` broadcastable (B, 1, 1, C)
    with one element a (b, c).  Differentiable in all three."""
    return _Cin.apply(x, scale, bias, float(epsilon), False)


def cin_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              epsilon: float = CIN_EPS) -> torch.Tensor:
    """:func:`cin` with the kernels' plain versions, on any device: same
    signature, same rounding points, same saved moments."""
    return _Cin.apply(x, scale, bias, float(epsilon), True)


class _CinSplit(torch.autograd.Function):
    """CIN of this rank's rows of a frame sharded over ``rows``' group: the
    split launches with the group's all-reduce between them."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, plain, rows):
        b, h, w, c = x.shape
        x = x.contiguous()
        ctx.eps, ctx.plain, ctx.rows = eps, plain, rows
        ctx.n = rows.pixels(h, w)
        ctx.bias_like = (bias.shape, bias.dtype)
        sums = (cin_forward_sums_plain if plain else cin_forward_sums)(x)
        rows.all_reduce_(sums)
        out, stats = (cin_forward_apply_plain if plain else cin_forward_apply)(
            x, sums, ctx.n, _rows(scale, b, c), _rows(bias, b, c), eps)
        ctx.save_for_backward(x, scale, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        b, _, _, c = x.shape
        g = g.contiguous()
        sums = (cin_backward_sums_plain if ctx.plain else cin_backward_sums)(x, g, stats)
        # this rank's share of dscale and dbias, before the sums are the group's
        inv = torch.rsqrt((stats[:, 1] - stats[:, 0] * stats[:, 0]) + ctx.eps)
        dscale, dbias = inv * sums[:, 1], sums[:, 0].clone()
        ctx.rows.all_reduce_(sums)
        dx = (cin_backward_apply_plain if ctx.plain else cin_backward_apply)(
            x, g, stats, sums, ctx.n, _rows(scale, b, c), ctx.eps)
        shape, dtype = ctx.bias_like
        return (dx, dscale.reshape(scale.shape).to(scale.dtype), dbias.reshape(shape).to(dtype),
                None, None, None)


def cin_split(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, rows,
              epsilon: float = CIN_EPS, plain: bool = False) -> torch.Tensor:
    """:func:`cin` of this rank's rows of a frame whose rows are sharded over
    ``rows`` (a :class:`..parallel.spatial.RowShard`), the moments over the
    whole frame: the split launches (their plain versions with ``plain``)
    with an all-reduce of the sums over the group between them.  Below
    :data:`MIN_CHANNELS` the plain CIN's split in torch ops."""
    if x.shape[-1] < MIN_CHANNELS:
        return conditional_instance_norm(x, scale, bias, epsilon=epsilon, rows=rows)
    return _CinSplit.apply(x, scale, bias, float(epsilon), plain, rows)


def reset_launch_counts() -> None:
    for fn in (cin_forward, cin_backward, cin_forward_sums, cin_forward_apply,
               cin_backward_sums, cin_backward_apply):
        fn.launches = 0
