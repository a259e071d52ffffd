"""Packed-domain convolutions: conv / conv-transpose on space-to-depth tensors.

Port of ``realtime_style_transfer_tpu/ops/packed_conv.py``.  A tensor of
logical shape (B, H, W, C) is carried as (B, H/f, W/f, f*f*C) with channel
order (dy, dx, c), and each layer's kernel is assembled so that one VALID
conv maps packed -> packed directly.

Index math (per axis; logical SAME conv, stride s, odd k, dims divisible):
logical out row ``m = fout*a + dy`` reads logical in rows ``s*m + t - pb``
(``t`` in ``[0, k)``, ``pb = (k - s)//2``); packed in row ``r`` holds logical
row ``fin*r + ey``, so tap t contributes iff ``(s*dy + t - pb - ey) % fin ==
0``, at packed offset ``(s*dy + t - pb - ey) / fin`` relative to the packed
stride ``S = s*fout/fin``.  All (dy, ey) classes share one window, so the
assembled kernel has that window's extent and channel blocks (ey, ex, cin) ->
(dy, dx, cout).  Stride-2 transpose convs decompose into per-output-parity
stride-1 convs (:func:`..ops.conv._axis_classes`) that go through the same
assembly with the output parity folded into fout.

Kernels are HWIO (numpy or torch) and are assembled on the host;
:func:`assemble_conv` and :func:`assemble_conv_transpose` do it once, and
:func:`run_packed_conv` applies an assembled kernel.  ``backend="pallas"``
sends a packed-stride-1 conv whose packed output height is even to the
hand-written tap-matmul kernel (:func:`.conv_matmul.conv_valid_matmul`), as
the JAX package routes it; every other conv is one library ``F.conv2d``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .conv import _axis_classes

if TYPE_CHECKING:
    from .conv_matmul import FmaWeights, TapWeights

BACKENDS = ("xla", "pallas")


def pack(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, f*f*C), channel order (dy, dx, c)."""
    if f == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def unpack(p: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    if f == 1:
        return p
    b, hh, ww, _ = p.shape
    x = p.reshape(b, hh, ww, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * f, ww * f, c)


def _axis_plan(k: int, s: int, fin: int, fout: int):
    """Tap placement for one axis: (offsets dict, LO, extent, S), where
    ``offsets[(dy, ey)]`` lists the (packed_offset, tap_index) pairs."""
    if (s * fout) % fin:
        raise ValueError(f"packed stride s*fout/fin not integral: {s}*{fout}/{fin}")
    pb = (k - s) // 2
    if pb < 0:
        raise ValueError("kernel smaller than stride")
    offsets = {}
    lo, hi = 10**9, -(10**9)
    for dy in range(fout):
        for ey in range(fin):
            pairs = []
            for t in range(k):
                num = s * dy + t - pb - ey
                if num % fin:
                    continue
                off = num // fin
                pairs.append((off, t))
                lo, hi = min(lo, off), max(hi, off)
            offsets[(dy, ey)] = pairs
    return offsets, lo, hi - lo + 1, (s * fout) // fin


def _host(kernel) -> Tuple[torch.Tensor, torch.device]:
    """A HWIO kernel (numpy or torch) as a CPU tensor, and where it came from."""
    if isinstance(kernel, torch.Tensor):
        return kernel.detach().cpu(), kernel.device
    return torch.from_numpy(np.asarray(kernel)), torch.device("cpu")


def packed_conv_kernel(kernel, *, stride: int, fin: int, fout: int):
    """Assemble the packed-domain kernel for a logical SAME conv.

    Returns ``(packed_kernel (Ph, Pw, fin^2*Cin, fout^2*Cout), (lo_y, Ph),
    (lo_x, Pw), S)``: ``S`` is the packed-space stride, the pads apply to the
    packed input.  The kernel is a tensor on the input kernel's device (the
    CPU for a numpy kernel), in its dtype.
    """
    k, device = _host(kernel)
    kh, kw, cin, cout = k.shape
    offs_y, lo_y, ph, s_y = _axis_plan(kh, stride, fin, fout)
    offs_x, lo_x, pw, _ = _axis_plan(kw, stride, fin, fout)
    packed = k.new_zeros((ph, pw, fin * fin * cin, fout * fout * cout))
    for dy in range(fout):
        for dx in range(fout):
            out_block = (dy * fout + dx) * cout
            for ey in range(fin):
                for ex in range(fin):
                    in_block = (ey * fin + ex) * cin
                    for off_y, ty in offs_y[(dy, ey)]:
                        for off_x, tx in offs_x[(dx, ex)]:
                            packed[off_y - lo_y, off_x - lo_x, in_block:in_block + cin,
                                   out_block:out_block + cout] = k[ty, tx]
    return packed.to(device), (lo_y, ph), (lo_x, pw), s_y


def _pads(lo: int, extent: int, s_packed: int, hp_in: int, hp_out: int):
    before = max(0, -lo)
    last_read = s_packed * (hp_out - 1) + lo + extent - 1
    after = max(0, last_read - (hp_in - 1))
    return before, after


def packed_conv_transpose_kernel(kernel, *, fin: int, fout: int):
    """Assemble the packed-domain kernel for a logical stride-2 'SAME'
    transpose conv, with the output-parity reorder folded into the kernel's
    output channels; returns what :func:`packed_conv_kernel` returns.
    Requires ``fout % 2 == 0`` (the transpose's own 2x is the inner output
    parity)."""
    if fout % 2:
        raise ValueError("fout must be a multiple of 2 for a 2x transpose conv")
    k, device = _host(kernel)
    kh, kw, cin, cout = k.shape
    fo = fout // 2  # extra packing applied on top of the transpose parity
    cls_y = _axis_classes(kh)
    cls_x = _axis_classes(kw)
    # each parity class (d_y, d_x) is a stride-1 conv whose logical input
    # window starts at (o_y, o_x): merge them into one logical kernel over the
    # union window, one output channel block a class, made odd and centred so
    # that SAME padding (k' - 1) // 2 equals -lo
    len_y = [len(t) for t, _ in cls_y]
    len_x = [len(t) for t, _ in cls_x]
    o_y = [s for _, s in cls_y]
    o_x = [s for _, s in cls_x]
    lo_y, hi_y = min(o_y), max(o_y[d] + len_y[d] - 1 for d in range(2))
    lo_x, hi_x = min(o_x), max(o_x[d] + len_x[d] - 1 for d in range(2))
    kk_y = max(hi_y - lo_y + 1, 2 * (-lo_y) + 1)
    kk_x = max(hi_x - lo_x + 1, 2 * (-lo_x) + 1)
    kk_y += 1 - kk_y % 2
    kk_x += 1 - kk_x % 2
    pb_y, pb_x = (kk_y - 1) // 2, (kk_x - 1) // 2

    merged = k.new_zeros((kk_y, kk_x, cin, 4 * cout))
    for dy in range(2):
        taps_y, start_y = cls_y[dy]
        for dx in range(2):
            taps_x, start_x = cls_x[dx]
            if not taps_y or not taps_x:
                continue
            cls = dy * 2 + dx
            py, px = start_y + pb_y, start_x + pb_x
            merged[py:py + len(taps_y), px:px + len(taps_x), :,
                   cls * cout:(cls + 1) * cout] = k[taps_y[0]::2, taps_x[0]::2]

    pk, pads_y, pads_x, s_packed = packed_conv_kernel(merged, stride=1, fin=fin, fout=fo)
    # the assembled output channels are (gy, gx, (dy, dx), c); the packed
    # layout for factor fout = 2*fo is (gy, dy, gx, dx, c)
    perm = np.empty(fout * fout * cout, np.int64)
    for gy in range(fo):
        for gx in range(fo):
            for dy in range(2):
                for dx in range(2):
                    src = ((gy * fo + gx) * 4 + dy * 2 + dx) * cout
                    dst = ((((gy * 2 + dy) * fo + gx) * 2) + dx) * cout
                    perm[dst:dst + cout] = np.arange(src, src + cout)
    return pk[..., torch.from_numpy(perm)].to(device), pads_y, pads_x, s_packed


class PackedConv(NamedTuple):
    """An assembled packed-domain conv: what one VALID conv needs to map a
    fin-packed tensor to the fout-packed result of the logical layer."""

    weight: torch.Tensor            # (Ph, Pw, fin^2*Cin, fout^2*Cout) HWIO, the tap-matmul kernel's
    oihw: torch.Tensor              # the same as channels-last OIHW, the library conv's
    pads_y: Tuple[int, int]         # (lo, extent) of the packed window, rows
    pads_x: Tuple[int, int]         # the same for columns
    s_packed: int                   # packed-space stride
    scale: Tuple[int, int]          # packed out dim = packed in dim * scale[0] // scale[1]
    # ``weight`` packed for the tap-matmul kernel (with_taps)
    taps: Optional["TapWeights | FmaWeights"] = None

    @staticmethod
    def make(weight: torch.Tensor, pads_y, pads_x, s_packed: int, scale) -> "PackedConv":
        oihw = weight.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return PackedConv(weight.contiguous(), oihw, pads_y, pads_x, s_packed, scale)

    def to(self, device, dtype) -> "PackedConv":
        return PackedConv.make(self.weight.to(device, dtype), self.pads_y, self.pads_x,
                               self.s_packed, self.scale)

    def with_taps(self) -> "PackedConv":
        """This conv with its weight packed once for the tap-matmul kernel
        (bf16: :func:`.conv_matmul.pack_taps`, f32:
        :func:`.conv_matmul.pack_fma`), which the ``pallas`` backend then
        launches without repacking it each frame."""
        # conv_matmul imports kernels, which imports this
        from .conv_matmul import pack_fma, pack_taps
        pack = {torch.bfloat16: pack_taps, torch.float32: pack_fma}.get(self.weight.dtype)
        if pack is None or self.s_packed != 1:
            return self
        return self._replace(taps=pack(self.weight))

    def out_hw(self, hp: int, wp: int) -> Tuple[int, int]:
        num, den = self.scale
        return hp * num // den, wp * num // den


def assemble_conv(kernel, *, stride: int, fin: int, fout: int) -> PackedConv:
    """:func:`packed_conv_kernel` as a :class:`PackedConv`."""
    pk, pads_y, pads_x, s_packed = packed_conv_kernel(kernel, stride=stride, fin=fin,
                                                      fout=fout)
    return PackedConv.make(pk, pads_y, pads_x, s_packed, (fin, stride * fout))


def assemble_conv_transpose(kernel, *, fin: int, fout: int) -> PackedConv:
    """:func:`packed_conv_transpose_kernel` as a :class:`PackedConv`."""
    pk, pads_y, pads_x, s_packed = packed_conv_transpose_kernel(kernel, fin=fin, fout=fout)
    return PackedConv.make(pk, pads_y, pads_x, s_packed, (2 * fin, fout))


def _padded(p: torch.Tensor, pc: PackedConv, cin: Optional[int] = None):
    """``p`` padded for the VALID conv of ``pc`` (its channels zero-padded
    to ``cin`` where given), and the packed output size."""
    _, hp, wp, c = p.shape
    hp_out, wp_out = pc.out_hw(hp, wp)
    pb_y, pa_y = _pads(*pc.pads_y, pc.s_packed, hp, hp_out)
    pb_x, pa_x = _pads(*pc.pads_x, pc.s_packed, wp, wp_out)
    return F.pad(p, (0, (cin or c) - c, pb_x, pa_x, pb_y, pa_y)), hp_out, wp_out


def _tap_matmuls(p, pc, matmul, **epilogue) -> torch.Tensor:
    """One ``matmul`` a batch item on ``p`` padded for ``pc``: on its packed
    taps where it has them, the input's channels padded in the same
    ``F.pad`` to the taps' Cin (bf16: a multiple of 8; f32: whole chunks)."""
    if matmul is None:
        # imported here: conv_matmul needs kernels, which imports pack / unpack from here
        from .conv_matmul import conv_valid_matmul as matmul
    kernel = pc.weight if pc.taps is None else pc.taps
    pp, hp_out, wp_out = _padded(p, pc, None if pc.taps is None else pc.taps.kernel.shape[2])
    out = torch.stack([matmul(pp[i], kernel, **epilogue) for i in range(pp.shape[0])])
    return out[:, :hp_out, :wp_out, :]


def run_packed_conv(p: torch.Tensor, pc: PackedConv, *, backend: str = "xla",
                    matmul: Optional[Callable] = None) -> torch.Tensor:
    """Apply the assembled ``pc`` to the packed (B, Hp, Wp, C) ``p``.

    ``backend="pallas"`` runs a packed-stride-1 conv with an even packed
    output height as one ``matmul`` (:func:`.conv_matmul.conv_valid_matmul`,
    or its plain version) a batch item; every other conv is ``F.conv2d``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "pallas" and pc.s_packed == 1 and pc.out_hw(*p.shape[1:3])[0] % 2 == 0:
        return _tap_matmuls(p, pc, matmul)
    pp, hp_out, wp_out = _padded(p, pc)
    out = F.conv2d(pp.permute(0, 3, 1, 2), pc.oihw, stride=pc.s_packed)
    return out.permute(0, 2, 3, 1)[:, :hp_out, :wp_out, :]


def run_fused_contract(p: torch.Tensor, pc: PackedConv, contract: dict, *,
                       matmul: Optional[Callable] = None) -> torch.Tensor:
    """The assembled stride-1 ``pc`` with the contract-block tail in the
    tap-matmul kernel's epilogue; ``contract`` is :func:`tiled_contract`'s."""
    if pc.s_packed != 1:
        raise ValueError("fused contract path requires packed stride 1")
    return _tap_matmuls(p, pc, matmul, **contract)


def packed_conv(p: torch.Tensor, kernel, *, stride: int, fin: int, fout: int,
                backend: str = "xla") -> torch.Tensor:
    """Logical SAME conv applied to a packed tensor, producing a packed tensor.

    ``p``: (B, Hl/fin, Wl/fin, fin^2*Cin); result: (B, Ho/fout, Wo/fout,
    fout^2*Cout) where Ho = Hl/stride.  ``backend='pallas'`` routes
    packed-stride-1 cases with an even packed output height through the
    tap-matmul kernel; other cases use the library conv.
    """
    pc = assemble_conv(kernel, stride=stride, fin=fin, fout=fout).to(p.device, p.dtype)
    return run_packed_conv(p, pc, backend=backend)


def tiled_contract(bias, scale, shift, fout: int, device) -> dict:
    """Per-logical-channel bias and BN affine, tiled over the fout^2 parity
    groups, f32: the ``contract`` epilogue's keywords."""
    ff = fout * fout

    def tile(v):
        return torch.as_tensor(v).detach().float().repeat(ff).to(device)

    return dict(bias=tile(bias), scale=tile(scale), shift=tile(shift), epilogue="contract")


def packed_conv_fused_contract(p: torch.Tensor, kernel, bias, scale, shift, *,
                               fin: int, fout: int) -> torch.Tensor:
    """Stride-1 packed conv with the contract-block tail fused in the
    tap-matmul kernel: ``relu(relu(conv + bias) * scale + shift)``.

    ``bias``/``scale``/``shift`` are per LOGICAL output channel; they are
    tiled across the fout^2 parity groups here.
    """
    pc = assemble_conv(kernel, stride=1, fin=fin, fout=fout).to(p.device, p.dtype)
    return run_fused_contract(p, pc, tiled_contract(bias, scale, shift, fout, p.device))


def packed_conv_transpose_2x(p: torch.Tensor, kernel, *, fin: int, fout: int) -> torch.Tensor:
    """Stride-2 'SAME' transpose conv on packed tensors: the 4 output-parity
    stride-1 convs as one assembled VALID conv."""
    pc = assemble_conv_transpose(kernel, fin=fin, fout=fout).to(p.device, p.dtype)
    return run_packed_conv(p, pc)
