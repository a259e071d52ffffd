"""The transfer net as a chain of hand-written CUDA stage kernels.

Port of the host side of ``realtime_style_transfer_tpu/ops/pallas/
fused_transfer.py`` (``FusedTransfer``).  The TPU version runs the whole net
in one Pallas launch on an s2d-f4 packed grid; here each stage is one launch
of :func:`.kernels.conv_stage` (stem, c1, c2, res0a..res4b, e0, e1, final)
plus :func:`.kernels.finish`, on NHWC bf16 activations at true resolution.
The TPU layouts survive only where data enters and leaves:
:meth:`FusedTransfer.pack_frame_np` returns the JAX pack bit for bit
(``(H/4, W/4, 384)`` bf16, subpixel-major) and
:meth:`FusedTransfer.stylize_prepacked_raw` returns ``(H/4, W/4, 128)`` bf16
with the first ``16 * 3`` channels in pack order.

The consumer of each CIN folds its affine from the producer's moments (one
f32 ``[2, C]`` buffer per CIN, zeroed once per frame) and the style row; the
residual skips ping-pong between two buffers, written by the centre tap of
the stage that owns each pixel.  On CUDA the stage loop calls only the kernel
wrappers; on the CPU the same loop runs their plain versions.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.transfer import NUM_RESIDUAL_BLOCKS, BN_EPS, TransferPlan
from .conv import pack_transpose_kernel, same_pads
from .kernels import (
    ConvStage,
    Prologue,
    conv_stage,
    conv_stage_plain,
    finish,
    finish_plain,
    make_conv_stage,
    unpack_frame,
)
from .normalization import CIN_EPS
from .packed_conv import pack

LANE = 128  # channel padding of the frame pack and of the packed output


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.array(v, np.float32)


class _Step(NamedTuple):
    stage: ConvStage
    src: int                 # CIN slot applied on load, -1 for none
    in_relu: bool
    skip_in: Optional[int]   # skip buffer added on load
    skip_out: Optional[int]  # skip buffer the centre tap writes
    slot: int                # CIN slot whose moments this stage adds up, -1 for none


class FusedTransfer:
    """Stage-kernel inference for a fixed plan + variables (batch 1).

    ``variables`` is the flax tree of the transfer net (``{"params",
    "batch_stats"}``, optionally nested under ``"transfer"``) of numpy arrays
    or tensors; :func:`..weights.to_flax` makes one from a ``state_dict``.
    The TPU-only layout knobs are accepted and ignored.
    """

    def __init__(self, variables, plan: TransferPlan, *, num_styles: int = 1,
                 cin_epsilon: float = CIN_EPS, device=None,
                 quant: Optional[str] = None, act_scales=None,
                 direct_ring: Optional[bool] = None,
                 wmip_resident: Optional[bool] = None,
                 q_edges: Optional[bool] = None,
                 wb_expanded: Optional[bool] = None,
                 k_resident: Optional[bool] = None):
        self.device = resolve_device(device)
        if (plan.num_contract_blocks, plan.num_expand_blocks) not in ((2, 2), (3, 3)):
            raise ValueError("fused kernel supports the 2-contract/2-expand "
                             "(flagship) and 3-contract/3-expand (divider-1) "
                             "families; use stylize_packed otherwise")
        if plan.num_contract_blocks == 3:
            raise NotImplementedError(
                "the 3-contract (divider-1, three_seg) plan is not ported yet: "
                "ROADMAP.md Queue 2 row 1e")
        if plan.bottleneck_num_filters > LANE:
            raise ValueError(f"fused kernel supports <= {LANE} bottleneck filters "
                             f"(got {plan.bottleneck_num_filters})")
        if num_styles not in (1, 2):
            raise ValueError("fused kernel supports 1 or 2 styles "
                             "(reference blends exactly two)")
        if num_styles == 2:
            raise NotImplementedError(
                "dual style is not ported yet: ROADMAP.md Queue 2 row 1c")
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        if quant == "int8":
            raise NotImplementedError(
                "int8 (with calibrate/check) is not ported yet: ROADMAP.md "
                "Queue 2 row 1d")
        self.plan = plan
        self.eps = float(cin_epsilon)
        h, w, _ = plan.input_shape
        self.hp, self.wp = h // 4, w // 4
        if self.wp % 8:
            raise ValueError(f"packed width {self.wp} must be a multiple of 8")
        th = max(t for t in (8, 4, 2, 1) if self.hp % t == 0)
        if self.hp // th < 2 or self.hp < 4:
            raise ValueError("need at least 2 row bands")
        self._build(variables)

    # ---- host-side weight prep ------------------------------------------

    def _build(self, variables) -> None:
        params = variables["params"]
        stats = variables["batch_stats"]
        params = params.get("transfer", params)
        stats = stats.get("transfer", stats)
        plan = self.plan
        dev = self.device
        h, w, c_in = plan.input_shape
        filters = plan.bottleneck_num_filters

        def conv_np(name):
            return _np(params[name]["kernel"]), _np(params[name]["bias"])

        def bn_affine(name):
            inv = 1.0 / np.sqrt(_np(stats[name]["var"]) + BN_EPS)
            scale = _np(params[name]["scale"]) * inv
            return scale, _np(params[name]["bias"]) - _np(stats[name]["mean"]) * scale

        def same(hw, k, s):
            return same_pads(hw[0], k, s)[0], same_pads(hw[1], k, s)[0]

        steps: List[_Step] = []
        cur = (h, w)
        for bi, (_f, k, s) in enumerate(plan.contract_schedule):
            kernel, bias = conv_np(f"contract_{bi}_conv")
            scale, shift = bn_affine(f"contract_{bi}_bn")
            out_hw = (-(-cur[0] // s), -(-cur[1] // s))
            stage = make_conv_stage(
                ("stem", "c1", "c2")[bi], kernel, bias, in_hw=cur, out_hw=out_hw,
                stride=s, pads=same(cur, k, s), epi="contract", device=dev,
                pack_c=_round_up(16 * c_in, LANE) if bi == 0 else 0,
                cscale=scale, cshift=shift)
            steps.append(_Step(stage, -1, False, None, None, -1))
            cur = out_hw

        slot_channels: List[int] = []
        slot_counts: List[float] = []
        for ri in range(NUM_RESIDUAL_BLOCKS):
            for ci in range(2):
                kernel, bias = conv_np(f"residual_{ri}_conv{ci}")
                slot = 2 * ri + ci
                is_a = ci == 0
                stage = make_conv_stage(
                    f"res{ri}{'ab'[ci]}", kernel, bias, in_hw=cur, out_hw=cur,
                    stride=1, pads=(1, 1), epi="relu", device=dev)
                steps.append(_Step(
                    stage, slot - 1 if slot > 0 else -1, not is_a,
                    ri % 2 if is_a and ri >= 2 else None,
                    (ri - 1) % 2 if is_a and ri >= 1 else None, slot))
                slot_channels.append(filters)
                slot_counts.append(float(cur[0] * cur[1]))
        self._skip_shape = cur + (filters,)

        skip_in: Optional[int] = NUM_RESIDUAL_BLOCKS % 2
        for ei in range(plan.num_expand_blocks):
            kernel, bias = conv_np(f"expand_{ei}_conv")
            cout = kernel.shape[3]
            packed, (pad_y, pad_x) = pack_transpose_kernel(torch.from_numpy(kernel))
            slot = len(slot_channels)
            stage = make_conv_stage(
                f"e{ei}", packed.numpy(), np.tile(bias, 4), in_hw=cur, out_hw=cur,
                stride=1, pads=(pad_y[0], pad_x[0]), epi="bias", device=dev,
                transpose_cout=cout)
            steps.append(_Step(stage, slot - 1, ei > 0, skip_in, None, slot))
            skip_in = None
            cur = (2 * cur[0], 2 * cur[1])
            slot_channels.append(cout)
            slot_counts.append(float(cur[0] * cur[1]))

        kernel, bias = conv_np(f"expand_{plan.num_expand_blocks}_conv")
        k = kernel.shape[0]
        slot = len(slot_channels)
        stage = make_conv_stage("final", kernel, bias, in_hw=cur, out_hw=cur,
                                stride=1, pads=same(cur, k, 1), epi="bias", device=dev)
        steps.append(_Step(stage, slot - 1, True, None, None, slot))
        slot_channels.append(kernel.shape[3])
        slot_counts.append(float(cur[0] * cur[1]))

        self.steps: Tuple[_Step, ...] = tuple(steps)
        self._slot_channels = tuple(slot_channels)
        self._slot_counts = tuple(slot_counts)
        # one f32 [2, C] moment buffer per CIN inside one allocation (16-byte
        # aligned views), zeroed once per frame
        offsets, total = [], 0
        for c in slot_channels:
            offsets.append(total)
            total += _round_up(2 * c, 4)
        self._moments = torch.zeros(total, dtype=torch.float32, device=dev)
        self._moment_views = tuple(
            self._moments[o:o + 2 * c].view(2, c) for o, c in zip(offsets, slot_channels))

    # ---- per-style constants ----------------------------------------------

    def prepare_style(self, style_params, style_weights=None) -> torch.Tensor:
        """(1, 1, P), (1, P) or (P,) style vector -> the (n_cin, 2, 128) f32
        table of per-CIN scale and bias rows, in slice (ABI) order."""
        if style_weights is not None:
            raise ValueError("style_weights are for dual style, which is not ported")
        sp = torch.as_tensor(style_params).detach().cpu().float().reshape(-1)
        n_params = self.plan.num_style_parameters
        if sp.numel() != n_params:
            raise ValueError(f"style vector has {sp.numel()} values, plan wants {n_params}")
        table = torch.zeros((len(self._slot_channels), 2, LANE), dtype=torch.float32)
        offset = 0
        for slot, c in enumerate(self._slot_channels):
            table[slot, 0, :c] = sp[offset:offset + c]
            table[slot, 1, :c] = sp[offset + c:offset + 2 * c]
            offset += 2 * c
        return table.to(self.device)

    # ---- frame packing ----------------------------------------------------

    def _pack(self, x: torch.Tensor, pin: bool) -> torch.Tensor:
        y = pack(x, 4)[0]
        hp, wp, c16 = y.shape
        out = torch.zeros((hp, wp, _round_up(c16, LANE)), dtype=torch.bfloat16,
                          device=x.device, pin_memory=pin)
        out[:, :, :c16] = y
        return out

    def pack_frame_np(self, content: np.ndarray) -> torch.Tensor:
        """(1, H, W, C) f32 numpy -> the (H/4, W/4, 384) bf16 frame pack, on
        the host (pinned when the engine runs on CUDA); equal bit for bit to
        the JAX package's ``pack_frame_np``."""
        x = np.asarray(content, np.float32)
        if x.shape[0] != 1:
            raise ValueError("pack one frame at a time")
        return self._pack(torch.from_numpy(np.ascontiguousarray(x)),
                          pin=self.device.type == "cuda")

    def pack_frame(self, content: torch.Tensor) -> torch.Tensor:
        """(1, H, W, C) tensor -> the frame pack on the engine's device."""
        if content.shape[0] != 1:
            raise ValueError("fused kernel runs batch 1 per call")
        return self._pack(content.to(self.device, torch.float32), pin=False)

    def unpack_frame_np(self, packed_out) -> np.ndarray:
        """(H/4, W/4, >=48) packed output -> (1, H, W, 3) f32 numpy."""
        x = torch.as_tensor(packed_out).detach().cpu().float()
        return unpack_frame(x, self.plan.expand_blocks[-1][0])[None].numpy()

    # ---- per-frame stage loop -------------------------------------------------

    def _prologue(self, prepared: torch.Tensor, slot: int, relu: bool) -> Prologue:
        c = self._slot_channels[slot]
        return Prologue(self._moment_views[slot], self._slot_counts[slot],
                        prepared[slot, 0, :c], prepared[slot, 1, :c], self.eps, relu)

    def stylize_prepacked_raw(self, packed: torch.Tensor, prepared: torch.Tensor, *,
                              plain: bool = False) -> torch.Tensor:
        """Frame pack in, packed (H/4, W/4, 128) bf16 frame out: sigmoid
        outputs in the first ``16 * 3`` channels (pack order), zeros after.

        ``plain=True`` runs every stage's plain PyTorch version on the same
        device: the oracle that the kernels are held against on the card.
        """
        dev = self.device
        packed = packed.to(dev, non_blocking=True)
        bf16 = torch.bfloat16
        run_conv, run_finish = ((conv_stage_plain, finish_plain) if plain
                                else (conv_stage, finish))
        self._moments.zero_()
        skips = [torch.empty(self._skip_shape, dtype=bf16, device=dev) for _ in range(2)]
        x = packed
        for step in self.steps:
            out = torch.empty(step.stage.out_shape, dtype=bf16, device=dev)
            run_conv(
                x, step.stage, out,
                prologue=None if step.src < 0 else self._prologue(prepared, step.src, step.in_relu),
                skip_in=None if step.skip_in is None else skips[step.skip_in],
                skip_out=None if step.skip_out is None else skips[step.skip_out],
                stats_out=None if step.slot < 0 else self._moment_views[step.slot])
            x = out
        result = torch.empty((self.hp, self.wp, LANE), dtype=bf16, device=dev)
        run_finish(x, self._prologue(prepared, len(self._slot_channels) - 1, False), result)
        return result

    def stylize_prepacked(self, packed: torch.Tensor, prepared: torch.Tensor) -> torch.Tensor:
        """Frame pack in, (1, H, W, 3) f32 out, on the engine's device."""
        raw = self.stylize_prepacked_raw(packed, prepared)
        return unpack_frame(raw, self.plan.expand_blocks[-1][0]).float()[None]

    def stylize_prepared(self, content: torch.Tensor, prepared: torch.Tensor) -> torch.Tensor:
        """(1, H, W, C) content with :meth:`prepare_style` output -> (1, H, W, 3)."""
        return self.stylize_prepacked(self.pack_frame(content), prepared)

    def __call__(self, content: torch.Tensor, style_params,
                 style_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """content (1, H, W, C); style_params (1, 1, P) or (P,)."""
        return self.stylize_prepared(content, self.prepare_style(style_params, style_weights))
