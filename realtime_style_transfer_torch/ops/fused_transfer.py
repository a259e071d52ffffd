"""The transfer net as a chain of hand-written CUDA stage kernels.

Port of the host side of ``realtime_style_transfer_tpu/ops/pallas/
fused_transfer.py`` (``FusedTransfer``).  The TPU version runs the whole net
in one Pallas launch on an s2d-f4 packed grid; here each stage is one launch
of :func:`.kernels.conv_stage` (stem, c1, c2, res0a..res4b, e0, e1, final on
the flagship's 2-contract plan; the divider-1 plan adds c3 and e2) plus
:func:`.kernels.finish`, on NHWC bf16 activations at true resolution.  The
TPU kernel runs the divider-1 plan (``three_seg``) on two grids joined by
fold2 / unfold2 repacks of c2's and e1's output bands; at true resolution the
grid transitions are the stride-2 c3 and the transpose e2 themselves, so the
stage loop has no repack.
The TPU layouts survive only where data enters and leaves:
:meth:`FusedTransfer.pack_frame_np` returns the JAX pack bit for bit
(``(H/4, W/4, 384)`` bf16, subpixel-major) and
:meth:`FusedTransfer.stylize_prepacked_raw` returns ``(H/4, W/4, 128)`` bf16
with the first ``16 * 3`` channels in pack order.

The consumer of each CIN folds its affine from the producer's moments (one
f32 ``[2, C]`` buffer per CIN, zeroed once per frame) and the style row; the
residual skips ping-pong between two buffers, written by the centre tap of
the stage that owns each pixel.  Dual style adds the second style's rows and
blends the two affines per pixel by the weight map's mip at the CIN's
resolution.  On CUDA the stage loop calls only the kernel wrappers; on the CPU
the same loop runs their plain versions.

Chunk mode (:meth:`FusedTransfer.stylize_prepacked_chunk`) runs N frames with
one host dispatch, the counterpart of the TPU kernel's ``grid=(N,)``: on CUDA
the N-frame stage sequence is recorded once into a CUDA graph and replayed.
:meth:`FusedTransfer.stylize_prepacked` runs a frame on CUDA as one replay of
a one-frame graph, whose stem node is re-pointed at each call's pack
(:class:`FrameGraph`): one launch a frame from the host, not one a stage.

int8 (``quant="int8"``) is the JAX package's deploy-mode post-training
quantization: :meth:`FusedTransfer.calibrate_act_scales` records, on the bf16
engine, the per-channel max |x'| of every conv stage's input; an engine built
with those ``act_scales`` folds them into per-output-column int8 weights,
quantizes each stage's input where it is made and dequantizes the int32 sums
in the f32 epilogue; :meth:`FusedTransfer.check_act_saturation` measures how
hard given scales clip.  The finish stays bf16/f32.

**The scales table is the port's own layout**: ``(n_conv_stages, 128)`` f32,
one row per entry of ``steps`` (16 on the flagship, 18 on the divider-1
plan) with the first ``cin`` entries used; the stem's 17 entries are the
logical G-buffer channels.  The JAX table is ``(n_kernels, 512)`` over the
TPU's packed (subpixel, channel) lanes, which mean nothing on the port's
true-resolution NHWC stages, so a JAX scales file fails here at engine build
with the shape error, and the reverse holds too.  ``check_act_saturation``
counts every input element once, so its ``n_quantized`` is ``H * W * cin *
frames``; the JAX kernel counts its band-halo rows twice.  The guard
thresholds read ``max_ratio`` and the clip fraction, which do not depend on
the tiling.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.transfer import NUM_RESIDUAL_BLOCKS, BN_EPS, TransferPlan
from ..tracing import spans
from . import kernels
from .conv import pack_transpose_kernel, same_pads
from .image_ops import style_weight_mips
from .kernels import (
    ConvStage,
    Prologue,
    act_stats,
    act_stats_plain,
    conv_stage,
    conv_stage_plain,
    finish,
    finish_plain,
    make_conv_stage,
    unpack_frame,
)
from .normalization import CIN_EPS
from .packed_conv import pack, unpack
from .style_params import concat_implicit_weight

LANE = 128  # channel padding of the frame pack and of the packed output


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.array(v, np.float32)


# ---------------------------------------------------------------------------
# int8 deploy-scale provenance
# ---------------------------------------------------------------------------


def _leaves(tree, path=""):
    """(path, numpy array) of every leaf of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}/{key}")
    else:
        a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        yield path, a


def _f32_bytes(v) -> bytes:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


def scales_fingerprint(variables, style_params, style_weights=None) -> str:
    """Provenance hash of what int8 activation scales were calibrated against.

    The scales are maxima of post-CIN-affine activations, so they are a
    function of (transfer weights, style params[, dual weight map]); a file
    deployed against another pair can saturate the ±127 clip.  sha256 over
    each leaf of the flax tree by its path in sorted order (path, shape,
    dtype, bytes), then the f32 style params and the f32 weight map.  The
    digest differs from the JAX package's, which hashes ``str(treedef)``.
    """
    h = hashlib.sha256()
    for path, a in _leaves(variables):
        h.update(path.encode())
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(_f32_bytes(style_params))
    if style_weights is not None:
        h.update(_f32_bytes(style_weights))
    return h.hexdigest()


def save_act_scales(path, scales, fingerprint: Optional[str] = None) -> None:
    """Write an int8 scales file (``.npz`` with keys ``scales`` and
    ``fingerprint``) through an open handle, so the exact path is kept (a
    bare ``np.savez`` would append ``.npz`` to ``foo.npy``)."""
    with open(path, "wb") as f:
        np.savez(f, scales=np.asarray(scales, np.float32),
                 fingerprint=np.asarray(fingerprint or ""))


def load_act_scales(path):
    """Read a scales file -> (scales, fingerprint or None).  A bare ``.npy``
    has no fingerprint: treat it as unverified and run
    :meth:`FusedTransfer.check_act_saturation`."""
    data = np.load(path, allow_pickle=False)
    if hasattr(data, "files"):
        scales = np.asarray(data["scales"], np.float32)
        fp = str(data["fingerprint"]) if "fingerprint" in data.files else ""
        return scales, (fp or None)
    return np.asarray(data, np.float32), None


class PreparedStyle(NamedTuple):
    """Per-style constants of a frame stream (:meth:`FusedTransfer.prepare_style`)."""

    table: torch.Tensor  # (n_cin, 2 * num_styles, 128) f32: [scale0, bias0(, scale1, bias1)]
    planes: Tuple[torch.Tensor, ...]  # dual: the second style's bf16 weight
                                      # plane at each CIN resolution; () for one style


class ChunkGraph(NamedTuple):
    """The N-frame stage sequence recorded into one CUDA graph, with the
    static buffers it reads and writes."""

    graph: "torch.cuda.CUDAGraph"
    packed: torch.Tensor      # (N, H/4, W/4, 384) bf16 frame packs in
    prepared: PreparedStyle   # the style constants the graph reads
    out: torch.Tensor         # (N, H/4, W/4, 128) bf16 packed frames out
    captured: Dict[str, int]  # launches recorded into the graph, per kernel, and
                              # "blends": those given a weight plane (dual)
    stages: Tuple[str, ...]   # the stage of each recorded conv_stage and finish
                              # launch, in launch order ("finish" for finish)


@dataclasses.dataclass
class FrameGraph:
    """One frame's stage sequence recorded into a CUDA graph that reads the
    caller's frame pack where it lies: only the stem's node reads the pack,
    and :meth:`set_input` points that node at another before a replay.  The
    style is read through static buffers, the frame written to one."""

    graph: "torch.cuda.CUDAGraph"
    prepared: PreparedStyle   # the style constants the graph reads
    out: torch.Tensor         # (H/4, W/4, 128) bf16 packed frame out
    captured: Dict[str, int]  # as ChunkGraph.captured
    stages: Tuple[str, ...]   # as ChunkGraph.stages, for one frame
    node: int                 # the stem's kernel node in the recorded graph
    graph_exec: int           # the instantiated graph that replays
    x: int                    # the address of the pack the stem's node reads

    def set_input(self, packed: torch.Tensor) -> None:
        """Point the stem's node at ``packed``, unless it reads it already.
        Replays already queued keep the pack they were launched with."""
        x = packed.data_ptr()
        if x != self.x:
            kernels.set_graph_input(self.graph_exec, self.node, x)
            self.x = x


def _recorded() -> Dict[str, int]:
    """The wrappers' counters that a graph's ``captured`` takes the
    difference of across its recording."""
    return {"conv_stage": kernels.conv_stage.launches, "finish": kernels.finish.launches,
            "blends": kernels.conv_stage.blends + kernels.finish.blends}


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
    ``quant="int8"`` builds the int8 engine from ``act_scales``, the
    ``(n_conv_stages, 128)`` table of :meth:`calibrate_act_scales`.  The
    TPU-only layout knobs are accepted and ignored.
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
        if num_styles not in (1, 2):
            raise ValueError("fused kernel supports 1 or 2 styles "
                             "(reference blends exactly two)")
        # the divider-1 family (rst-1920): c3 and e2 are two more stages
        self.three_seg = plan.num_contract_blocks == 3
        if plan.bottleneck_num_filters > LANE:
            raise ValueError(f"fused kernel supports <= {LANE} bottleneck filters "
                             f"(got {plan.bottleneck_num_filters})")
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        self.quant = quant == "int8"
        if self.quant and act_scales is None:
            raise ValueError("quant='int8' requires act_scales from "
                             "calibrate_act_scales() on the bf16 engine")
        self.plan = plan
        self.num_styles = num_styles
        self.eps = float(cin_epsilon)
        self.n_conv_stages = (len(plan.contract_schedule) + 2 * NUM_RESIDUAL_BLOCKS
                              + plan.num_expand_blocks + 1)
        self.act_scales = None
        if self.quant:
            self.act_scales = self._check_scales(act_scales, "per-channel maxima from "
                                                 "calibrate_act_scales()")
        self.chunk_graphs: Dict[int, ChunkGraph] = {}
        self.frame_graph: Optional[FrameGraph] = None
        h, w, _ = plan.input_shape
        self.hp, self.wp = h // 4, w // 4
        # the JAX kernel's bottleneck grid; the port keeps its checks so that
        # both packages accept and refuse the same plans
        self.hp_s, self.wp_s = (h // 8, w // 8) if self.three_seg else (self.hp, self.wp)
        if self.wp % 8 or self.wp_s % 8:
            raise ValueError(f"packed widths {self.wp}/{self.wp_s} must be multiples of 8")
        th = max(t for t in (8, 4, 2, 1) if self.hp % t == 0)
        if self.hp // th < 2 or self.hp_s < 4:
            raise ValueError("need at least 2 row bands")
        if self.three_seg and num_styles != 1:
            raise ValueError(
                "dual-style is not yet supported on the 3-contract "
                "(divider-1) fused kernel; use stylize_packed")
        self._build(variables)

    # ---- host-side weight prep ------------------------------------------

    def _check_scales(self, scales, what: str) -> np.ndarray:
        scales = np.asarray(scales, np.float32)
        want = (self.n_conv_stages, LANE)
        if scales.shape != want:
            raise ValueError(f"act_scales must be {want} {what} (the port's layout: one "
                             f"row per conv stage, not the JAX package's (n, 512) lanes); "
                             f"got {scales.shape}")
        return scales

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

        def scale_row(kernel):
            """The int8 scales of the next conv stage's input, or None."""
            if self.act_scales is None:
                return None
            return self.act_scales[len(steps), :kernel.shape[2]]

        steps: List[_Step] = []
        cur = (h, w)
        for bi, (_f, k, s) in enumerate(plan.contract_schedule):
            kernel, bias = conv_np(f"contract_{bi}_conv")
            scale, shift = bn_affine(f"contract_{bi}_bn")
            out_hw = (-(-cur[0] // s), -(-cur[1] // s))
            stage = make_conv_stage(
                ("stem", "c1", "c2", "c3")[bi], kernel, bias, in_hw=cur, out_hw=out_hw,
                stride=s, pads=same(cur, k, s), epi="contract", device=dev,
                pack_c=_round_up(16 * c_in, LANE) if bi == 0 else 0,
                cscale=scale, cshift=shift, act_scale=scale_row(kernel))
            steps.append(_Step(stage, -1, False, None, None, -1))
            cur = out_hw

        # per CIN slot: channels, values per channel, resolution (which picks
        # the dual-style weight plane: the mips are keyed by width)
        slot_channels: List[int] = []
        slot_counts: List[float] = []
        slot_hw: List[Tuple[int, int]] = []
        for ri in range(NUM_RESIDUAL_BLOCKS):
            for ci in range(2):
                kernel, bias = conv_np(f"residual_{ri}_conv{ci}")
                slot = 2 * ri + ci
                is_a = ci == 0
                stage = make_conv_stage(
                    f"res{ri}{'ab'[ci]}", kernel, bias, in_hw=cur, out_hw=cur,
                    stride=1, pads=(1, 1), epi="relu", device=dev,
                    act_scale=scale_row(kernel))
                steps.append(_Step(
                    stage, slot - 1 if slot > 0 else -1, not is_a,
                    ri % 2 if is_a and ri >= 2 else None,
                    (ri - 1) % 2 if is_a and ri >= 1 else None, slot))
                slot_channels.append(filters)
                slot_counts.append(float(cur[0] * cur[1]))
                slot_hw.append(cur)
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
                transpose_cout=cout, act_scale=scale_row(kernel))
            steps.append(_Step(stage, slot - 1, ei > 0, skip_in, None, slot))
            skip_in = None
            cur = (2 * cur[0], 2 * cur[1])
            slot_channels.append(cout)
            slot_counts.append(float(cur[0] * cur[1]))
            slot_hw.append(cur)

        kernel, bias = conv_np(f"expand_{plan.num_expand_blocks}_conv")
        k = kernel.shape[0]
        slot = len(slot_channels)
        stage = make_conv_stage("final", kernel, bias, in_hw=cur, out_hw=cur,
                                stride=1, pads=same(cur, k, 1), epi="bias", device=dev,
                                act_scale=scale_row(kernel))
        steps.append(_Step(stage, slot - 1, True, None, None, slot))
        slot_channels.append(kernel.shape[3])
        slot_counts.append(float(cur[0] * cur[1]))
        slot_hw.append(cur)

        self.steps: Tuple[_Step, ...] = tuple(steps)
        assert len(steps) == self.n_conv_stages
        self._stage_spans = tuple("stage." + step.stage.name for step in steps)
        self._slot_channels = tuple(slot_channels)
        self._slot_counts = tuple(slot_counts)
        self._plane_hw = tuple(dict.fromkeys(slot_hw))  # distinct, in slot order
        self._slot_plane = tuple(self._plane_hw.index(hw) for hw in slot_hw)
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

    def prepare_style(self, style_params, style_weights=None) -> PreparedStyle:
        """Style vectors ((1, S, P), (S, P), or (P,) for one style) and, dual,
        the (1, H, W, 1) weight map of the second style -> the per-CIN table
        of scale and bias rows in slice (ABI) order, and the weight planes
        (built on the host; a ``style.planes`` span while spans are
        recorded)."""
        n_styles = self.num_styles
        if n_styles == 2 and style_weights is None:
            raise ValueError("style_weights required for dual-style")
        if n_styles == 1 and style_weights is not None:
            raise ValueError("style_weights blend two styles: build the engine "
                             "with num_styles=2")
        sp = torch.as_tensor(style_params).detach().cpu().float()
        n_params = self.plan.num_style_parameters
        if sp.numel() != n_styles * n_params:
            raise ValueError(f"style params have {sp.numel()} values, a {n_styles}-style "
                             f"engine wants {n_styles} x {n_params}")
        sp = sp.reshape(n_styles, n_params)
        table = torch.zeros((len(self._slot_channels), 2 * n_styles, LANE),
                            dtype=torch.float32)
        offset = 0
        for slot, c in enumerate(self._slot_channels):
            for s in range(n_styles):
                table[slot, 2 * s, :c] = sp[s, offset:offset + c]
                table[slot, 2 * s + 1, :c] = sp[s, offset + c:offset + 2 * c]
            offset += 2 * c
        planes = ()
        if n_styles == 2:
            on = spans.on
            if on:
                spans.begin("style.planes")
            planes = self._weight_planes(style_weights)
            if on:
                spans.end()
        return PreparedStyle(table.to(self.device), planes)

    def _weight_planes(self, style_weights) -> Tuple[torch.Tensor, ...]:
        """The second style's weight at each CIN resolution, bf16: channel 1
        of the mips of the weight map with its implicit first weight, as the
        JAX package's ``_weight_maps`` takes them."""
        h, w, _ = self.plan.output_shape
        wt = torch.as_tensor(style_weights).detach().cpu().float()
        if tuple(wt.shape) != (1, h, w, 1):
            raise ValueError(f"style_weights: want (1, {h}, {w}, 1), got {tuple(wt.shape)}")
        mips = style_weight_mips(concat_implicit_weight(wt), self.plan.num_mips)
        return tuple(mips[pw][0, :, :, 1].to(torch.bfloat16).contiguous().to(self.device)
                     for _ph, pw in self._plane_hw)

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

    def _check_prepared(self, prepared: PreparedStyle) -> None:
        want = (len(self._slot_channels), 2 * self.num_styles, LANE)
        if not isinstance(prepared, PreparedStyle) or tuple(prepared.table.shape) != want \
                or len(prepared.planes) != (len(self._plane_hw) if self.num_styles == 2 else 0):
            raise ValueError(f"prepared style does not fit this {self.num_styles}-style "
                             "engine: make it with its prepare_style")

    def _prologue(self, prepared: PreparedStyle, slot: int, relu: bool) -> Prologue:
        c = self._slot_channels[slot]
        rows = prepared.table[slot, :, :c]
        dual = () if self.num_styles == 1 else (
            rows[2], rows[3], prepared.planes[self._slot_plane[slot]])
        return Prologue(self._moment_views[slot], self._slot_counts[slot],
                        rows[0], rows[1], self.eps, relu, *dual)

    def _frame_buffers(self) -> List[torch.Tensor]:
        """Zero the CIN moments and allocate the two skip buffers of a frame."""
        self._moments.zero_()
        return [torch.empty(self._skip_shape, dtype=torch.bfloat16, device=self.device)
                for _ in range(2)]

    def _run_frame(self, packed: torch.Tensor, prepared: PreparedStyle,
                   result: Optional[torch.Tensor], plain: bool,
                   stage_hook: Optional[Callable] = None) -> None:
        """The stage loop of one frame pack on the engine's device into the
        packed (H/4, W/4, 128) bf16 ``result``; device work only, so a CUDA
        graph can record it.  Given a ``stage_hook`` (calibrate and check),
        each conv stage i first calls ``stage_hook(i, x, stage, prologue,
        skip_in)`` on its input, and the finish is skipped."""
        self._run_stages(packed, prepared, result, self._frame_buffers(), plain, stage_hook)

    def _run_stages(self, packed: torch.Tensor, prepared: PreparedStyle,
                    result: Optional[torch.Tensor], skips: List[torch.Tensor], plain: bool,
                    stage_hook: Optional[Callable] = None) -> None:
        """:meth:`_run_frame` after its buffers: one ``stage.<name>`` span a
        step and ``stage.finish`` while spans are recorded, none under a
        ``stage_hook``."""
        dev = self.device
        bf16 = torch.bfloat16
        run_conv, run_finish = ((conv_stage_plain, finish_plain) if plain
                                else (conv_stage, finish))
        on = spans.on and stage_hook is None
        x = packed
        for i, step in enumerate(self.steps):
            st = step.stage
            if on:
                spans.begin(self._stage_spans[i])
            prologue = None if step.src < 0 else self._prologue(prepared, step.src, step.in_relu)
            skip_in = None if step.skip_in is None else skips[step.skip_in]
            if stage_hook is not None:
                stage_hook(i, x, st, prologue, skip_in)
            out = torch.empty(st.out_shape, dtype=bf16, device=dev)
            run_conv(
                x, st, out, prologue=prologue, skip_in=skip_in,
                skip_out=None if step.skip_out is None else skips[step.skip_out],
                stats_out=None if step.slot < 0 else self._moment_views[step.slot])
            if on:
                spans.end()
            x = out
        if stage_hook is None:
            if on:
                spans.begin("stage.finish")
            run_finish(x, self._prologue(prepared, len(self._slot_channels) - 1, False), result)
            if on:
                spans.end()

    # ---- int8 calibrate and check ---------------------------------------------

    def _act_stats(self, packed_frames, prepared: PreparedStyle,
                   inv_rows: Optional[np.ndarray], plain: bool):
        """The stage loop over ``packed_frames`` with ``act_stats`` before
        each conv stage, each launch maxing and adding into its stage's row
        of a (n_conv_stages, 128) f32 table of maxima and an int64 table of
        clip counts on the engine's device (zeroed once, copied to the host
        once) -> (maxima, clip counts, frame count)."""
        self._check_prepared(prepared)
        n, dev = self.n_conv_stages, self.device
        maxima = torch.zeros((n, LANE), dtype=torch.float32, device=dev)
        clips = torch.zeros((n, LANE), dtype=torch.int64, device=dev)
        inv = None if inv_rows is None else torch.tensor(inv_rows, device=dev)
        run_stats = act_stats_plain if plain else act_stats

        def hook(i, x, st, prologue, skip_in):
            run_stats(x, st, prologue, skip_in, None if inv is None else inv[i, :st.cin],
                      maxima[i, :st.cin], clips[i, :st.cin])

        frames = 0
        for packed in packed_frames:
            self._run_frame(packed.to(dev, non_blocking=True), prepared, None, plain, hook)
            frames += 1
        return maxima.cpu().numpy(), clips.cpu().numpy(), frames

    def calibrate_act_scales(self, packed_frames, prepared: PreparedStyle, *,
                             plain: bool = False) -> np.ndarray:
        """Per conv stage and input channel, the max |x'| of the exact value
        its conv quantizes (after the CIN affine, ReLU and skip, bf16), over
        the frame packs ``packed_frames`` -> ``(n_conv_stages, 128)`` f32 to
        pass as ``act_scales`` to an int8 engine.  Runs on the bf16 engine.

        The scales are per (checkpoint, style): the maxima come after the
        CIN affine, whose rows are ``prepared``'s.  For several styles,
        calibrate once per style and ``np.maximum`` the tables.  ``plain``
        runs the plain versions of the kernels.
        """
        if self.quant:
            raise ValueError("calibrate on the bf16 engine, not a quant one")
        maxima, _, frames = self._act_stats(packed_frames, prepared, None, plain)
        if frames == 0:
            raise ValueError("need at least one calibration frame")
        return maxima

    def _act_inv_rows(self, scales: np.ndarray) -> np.ndarray:
        """Per-stage ``127 / s_c`` rows, as the int8 engine quantizes with."""
        rows = np.zeros((self.n_conv_stages, LANE), np.float32)
        for i, step in enumerate(self.steps):
            cin = step.stage.cin
            rows[i, :cin] = 127.0 / np.maximum(scales[i, :cin], 1e-6)
        return rows

    def check_act_saturation(self, packed_frames, prepared: PreparedStyle,
                             act_scales) -> List[dict]:
        """How hard the given int8 ``act_scales`` would clip on these frames,
        with the deploy style table ``prepared``; runs on the bf16 engine.

        Returns one dict a conv stage: ``{"stage", "max_ratio",
        "clip_events", "n_quantized"}``; ``max_ratio`` is ``max_c(max|x'|_c
        / scale_c)`` (above 1 clips) and ``clip_events / n_quantized`` the
        clip fraction.  Every input element counts once: ``n_quantized`` is
        ``H * W * cin * frames`` (the JAX kernel counts band halos twice).
        """
        if self.quant:
            raise ValueError("check saturation on the bf16 engine, not a quant one")
        scales = self._check_scales(act_scales, "per-channel scales")
        maxima, clips, frames = self._act_stats(packed_frames, prepared,
                                                self._act_inv_rows(scales), False)
        if frames == 0:
            raise ValueError("need at least one frame to check")
        report = []
        for i, step in enumerate(self.steps):
            st = step.stage
            h, w = st.in_hw
            report.append({
                "stage": st.name,
                "max_ratio": float(np.max(maxima[i, :st.cin]
                                          / np.maximum(scales[i, :st.cin], 1e-6))),
                "clip_events": int(clips[i].sum()),
                "n_quantized": h * w * st.cin * frames,
            })
        return report

    def stylize_prepacked_raw(self, packed: torch.Tensor, prepared: PreparedStyle, *,
                              plain: bool = False) -> torch.Tensor:
        """Frame pack in, packed (H/4, W/4, 128) bf16 frame out: sigmoid
        outputs in the first ``16 * 3`` channels (pack order), zeros after.

        ``plain=True`` runs every stage's plain PyTorch version on the same
        device: the oracle that the kernels are held against on the card.
        """
        on = spans.on
        if on:
            spans.begin("frame.prep")
        self._check_prepared(prepared)
        packed = packed.to(self.device, non_blocking=True)
        result = torch.empty((self.hp, self.wp, LANE), dtype=torch.bfloat16,
                             device=self.device)
        skips = self._frame_buffers()
        if on:
            spans.end()
        self._run_stages(packed, prepared, result, skips, plain)
        return result

    def stylize_prepacked(self, packed: torch.Tensor, prepared: PreparedStyle) -> torch.Tensor:
        """Frame pack in, (1, H, W, 3) f32 out, on the engine's device.

        On CUDA one replay of the engine's frame graph runs the frame: the
        first call warms the kernels up on one frame, then records one
        frame's stage sequence (moment zeroing, the skips, the conv stages
        and ``finish``) into a graph (:class:`FrameGraph`); each call copies
        the style constants into its static buffers, points its stem at the
        pack and replays it.  On the CPU, and while the current stream is
        being captured into another graph, the stage loop runs.  While spans
        are recorded: a ``frame`` span with ``frame.prep``, ``frame.replay``
        and ``frame.unpack`` in it; the stage loop has a ``stage.*`` span a
        stage in place of ``frame.replay``."""
        on = spans.on
        if on:
            spans.begin_frame("frame")
        if self._frame_graph_engages():
            raw = self._replay_frame(packed, prepared, on)
        else:
            raw = self.stylize_prepacked_raw(packed, prepared)
        if on:
            spans.begin("frame.unpack")
        out = unpack_frame(raw, self.plan.expand_blocks[-1][0]).float()[None]
        if on:
            spans.end()
            spans.end()
        return out

    def _frame_graph_engages(self) -> bool:
        """Whether :meth:`stylize_prepacked` replays the frame graph: on
        CUDA, unless the current stream is being captured (captures do not
        nest)."""
        return self.device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    def _replay_frame(self, packed: torch.Tensor, prepared: PreparedStyle,
                      on: bool) -> torch.Tensor:
        """The frame graph's half of :meth:`stylize_prepacked`: the packed
        (H/4, W/4, 128) frame, in the graph's static output."""
        if on:
            spans.begin("frame.prep")
        self._check_prepared(prepared)
        packed = packed.to(self.device, non_blocking=True)
        # the graph's stem reads whatever lies at the pointer: refuse here what
        # the eager stem would refuse
        kernels.check_stage_input(packed, self.steps[0].stage)
        fg = self.frame_graph
        if fg is None:
            fg = self.frame_graph = self._capture_frame(packed, prepared)
        fg.prepared.table.copy_(prepared.table)
        for static, plane in zip(fg.prepared.planes, prepared.planes):
            static.copy_(plane)
        fg.set_input(packed)
        if on:
            spans.end()
            spans.begin("frame.replay")
        kernels.replay_graph(fg.graph)
        if on:
            spans.end()
        return fg.out

    def _capture_frame(self, packed: torch.Tensor, prepared: PreparedStyle) -> FrameGraph:
        """Record one frame's stage sequence on the pack ``packed`` into a
        CUDA graph over a static copy of ``prepared``, and find the stem's
        node, the one node that reads ``packed``."""
        dev = self.device
        static_prep = PreparedStyle(prepared.table.clone(),
                                    tuple(p.clone() for p in prepared.planes))
        out = torch.empty((self.hp, self.wp, LANE), dtype=torch.bfloat16, device=dev)
        # one frame outside the graph loads the kernels and sets their launch
        # attributes, which may not happen while a graph records; its buffers
        # are freed on return, so the recording holds no more than one frame's
        self._run_frame(packed, static_prep, out, plain=False)
        torch.cuda.synchronize(dev)
        before = _recorded()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._run_frame(packed, static_prep, out, plain=False)
        captured = {k: v - before[k] for k, v in _recorded().items()}
        x = packed.data_ptr()
        node = kernels.graph_input_node(graph.raw_cuda_graph(), x)
        graph.instantiate()
        order = tuple(step.stage.name for step in self.steps) + ("finish",)
        return FrameGraph(graph, static_prep, out, captured, order, node,
                          graph.raw_cuda_graph_exec(), x)

    def stylize_prepacked_chunk(self, packed: torch.Tensor,
                                prepared: PreparedStyle) -> torch.Tensor:
        """(N, H/4, W/4, 384) frame packs -> (N, H, W, 3) f32, the frames in
        order, each as :meth:`stylize_prepacked` gives it.

        On CUDA one replay of a CUDA graph runs all N frames: the first call
        for an N warms the kernels up on one frame, then records the N-frame
        stage sequence (moment zeroing, one ``conv_stage`` launch a conv stage
        and 1 ``finish`` launch a frame) into a graph that reads and writes
        static buffers; each call copies the packs and the style constants into them on the
        device and copies the frames out.  On the CPU the stage loop runs N
        times.  While spans are recorded: a ``chunk`` span with
        ``chunk.copy_in``, ``chunk.replay`` and ``chunk.unpack`` in it (on the
        CPU each frame's stage spans in place of the first two).
        """
        on = spans.on
        if on:
            spans.begin_frame("chunk")
        self._check_prepared(prepared)
        if packed.ndim != 4 or tuple(packed.shape[1:3]) != (self.hp, self.wp):
            raise ValueError(f"want (N, {self.hp}, {self.wp}, C) frame packs, "
                             f"got {tuple(packed.shape)}")
        n = packed.shape[0]
        c_out = self.plan.expand_blocks[-1][0]
        if self.device.type != "cuda":
            raw = torch.stack([self.stylize_prepacked_raw(packed[i], prepared)
                               for i in range(n)])
        else:
            chunk = self.chunk_graphs.get(n)
            if chunk is None:
                chunk = self.chunk_graphs[n] = self._capture_chunk(packed, prepared)
            if on:
                spans.begin("chunk.copy_in")
            chunk.packed.copy_(packed, non_blocking=True)
            chunk.prepared.table.copy_(prepared.table)
            for static, plane in zip(chunk.prepared.planes, prepared.planes):
                static.copy_(plane)
            if on:
                spans.end()
                spans.begin("chunk.replay")
            kernels.replay_graph(chunk.graph)
            if on:
                spans.end()
            raw = chunk.out
        if on:
            spans.begin("chunk.unpack")
        out = unpack(raw[..., :16 * c_out], 4, c_out).float()
        if on:
            spans.end()
            spans.end()
        return out

    def _capture_chunk(self, packed: torch.Tensor, prepared: PreparedStyle) -> ChunkGraph:
        """Record the stage sequence of ``len(packed)`` frames into a CUDA
        graph over static copies of ``packed`` and ``prepared``."""
        n, dev = packed.shape[0], self.device
        static_in = packed.to(dev, torch.bfloat16).clone(memory_format=torch.contiguous_format)
        static_prep = PreparedStyle(prepared.table.clone(),
                                    tuple(p.clone() for p in prepared.planes))
        out = torch.empty((n, self.hp, self.wp, LANE), dtype=torch.bfloat16, device=dev)
        # one frame outside the graph loads the kernels and sets their launch
        # attributes, which may not happen while a graph records
        self._run_frame(static_in[0], static_prep, out[0], plain=False)
        torch.cuda.synchronize(dev)
        before = _recorded()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for i in range(n):
                self._run_frame(static_in[i], static_prep, out[i], plain=False)
        captured = {k: v - before[k] for k, v in _recorded().items()}
        order = tuple(step.stage.name for step in self.steps) + ("finish",)
        return ChunkGraph(graph, static_in, static_prep, out, captured, order * n)

    def stylize_prepared(self, content: torch.Tensor, prepared: PreparedStyle) -> torch.Tensor:
        """(1, H, W, C) content with :meth:`prepare_style` output -> (1, H, W, 3)."""
        return self.stylize_prepacked(self.pack_frame(content), prepared)

    def __call__(self, content: torch.Tensor, style_params,
                 style_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """content (1, H, W, C); style_params (1, S, P), or (P,) for one
        style; style_weights (1, H, W, 1), required when dual."""
        return self.stylize_prepared(content, self.prepare_style(style_params, style_weights))
