"""ONNX emission for the two deployable inference graphs (no onnx dependency).

The port's copy of ``realtime_style_transfer_tpu/export/onnx.py``: the same
first-party emitter, on the port's ``utils/proto.py``.  The engine runtime
reads ``predictor.onnx`` and ``transfer.onnx`` (IR version 8, opset 13).  A
``GraphBuilder`` assembles nodes, initializers and IO, and two exporters walk
a flax tree of arrays (what :func:`..cli.load_variables` returns) emitting
the model family's op set:

* transfer net: Transpose, Conv, Relu, BatchNormalization, ReduceMean, Sub, Mul,
  Add, Sqrt, Div, Slice, Reshape, ConvTranspose, Sigmoid
* predictor: the above plus Clip (hard-sigmoid/swish decomposition),
  GlobalAveragePool, grouped Conv (depthwise)

Graphs are NCHW inside (ONNX Conv requirement) with NHWC boundary transposes.
For the same tree the bytes equal the JAX emitter's except the producer
string, which is :data:`PRODUCER`.  Initializers
are written as f32 whatever the tree's dtype.  ``export/onnx_numpy.py``
parses and executes the emitted bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import proto as pb

# TensorProto.DataType
FLOAT = 1
INT64 = 7

IR_VERSION = 8
OPSET_VERSION = 13
PRODUCER = "realtime-style-transfer-torch"

# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS = 6, 7


def _tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    if array.dtype == np.int64:
        dtype = INT64
    else:
        array = array.astype(np.float32)
        dtype = FLOAT
    return (
        pb.enc_packed_int64s(1, array.shape)
        + pb.enc_int64(2, dtype)
        + pb.enc_string(8, name)
        + pb.enc_bytes(9, array.tobytes())
    )


def _attribute(name: str, value) -> bytes:
    out = pb.enc_string(1, name)
    if isinstance(value, float):
        out += pb.enc_float(2, value) + pb.enc_int64(20, _ATTR_FLOAT)
    elif isinstance(value, int):
        out += pb.enc_int64(3, value) + pb.enc_int64(20, _ATTR_INT)
    elif isinstance(value, str):
        out += pb.enc_bytes(4, value.encode()) + pb.enc_int64(20, _ATTR_STRING)
    elif isinstance(value, (list, tuple)) and all(
        isinstance(v, int) for v in value
    ):
        out += pb.enc_packed_int64s(8, value) + pb.enc_int64(20, _ATTR_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(pb.enc_float(7, float(v)) for v in value)
        out += pb.enc_int64(20, _ATTR_FLOATS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(pb.enc_bytes(1, pb.enc_int64(1, d)) for d in shape)
    tensor_type = pb.enc_int64(1, FLOAT) + pb.enc_bytes(2, dims)
    return pb.enc_string(1, name) + pb.enc_bytes(2, pb.enc_bytes(1, tensor_type))


class GraphBuilder:
    """Tiny append-only ONNX GraphProto builder."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, shape: Sequence[int]) -> str:
        self.inputs.append(_value_info(name, shape))
        return name

    def add_output(self, name: str, shape: Sequence[int]) -> None:
        self.outputs.append(_value_info(name, shape))

    def add_initializer(self, name: str, array: np.ndarray) -> str:
        self.initializers.append(_tensor_proto(name, array))
        return name

    def const(self, hint: str, array: np.ndarray) -> str:
        return self.add_initializer(self.fresh(hint), array)

    def node(self, op_type: str, inputs: Sequence[str],
             output: Optional[str] = None, **attrs) -> str:
        output = output or self.fresh(op_type.lower())
        encoded = (
            b"".join(pb.enc_string(1, i) for i in inputs)
            + pb.enc_string(2, output)
            + pb.enc_string(3, self.fresh(f"node_{op_type}"))
            + pb.enc_string(4, op_type)
            + b"".join(pb.enc_bytes(5, _attribute(k, v))
                       for k, v in sorted(attrs.items()))
        )
        self.nodes.append(encoded)
        return output

    def build_model(self, *, doc: str = "") -> bytes:
        graph = (
            b"".join(pb.enc_bytes(1, n) for n in self.nodes)
            + pb.enc_string(2, self.name)
            + b"".join(pb.enc_bytes(5, t) for t in self.initializers)
            + (pb.enc_string(10, doc) if doc else b"")
            + b"".join(pb.enc_bytes(11, v) for v in self.inputs)
            + b"".join(pb.enc_bytes(12, v) for v in self.outputs)
        )
        opset = pb.enc_string(1, "") + pb.enc_int64(2, OPSET_VERSION)
        return (
            pb.enc_int64(1, IR_VERSION)
            + pb.enc_string(2, PRODUCER)
            + pb.enc_bytes(7, graph)
            + pb.enc_bytes(8, opset)
        )


# ---------------------------------------------------------------------------
# Shared emission helpers (NCHW inside)
# ---------------------------------------------------------------------------


def _same_pads(in_hw: Tuple[int, int], k: Tuple[int, int],
               stride: int) -> List[int]:
    """TF-SAME pads for a forward conv -> ONNX [beg_h, beg_w, end_h, end_w]."""
    pads = []
    for size, kk in zip(in_hw, k):
        out = -(-size // stride)
        total = max((out - 1) * stride + kk - size, 0)
        pads.append((total // 2, total - total // 2))
    return [pads[0][0], pads[1][0], pads[0][1], pads[1][1]]


def _transpose_pads(k: Tuple[int, int], stride: int) -> List[int]:
    """TF-SAME transpose-conv pads (= pads of the conv it is the gradient of)."""
    pads = []
    for kk in k:
        total = max(kk - stride, 0)
        pads.append((total // 2, total - total // 2))
    return [pads[0][0], pads[1][0], pads[0][1], pads[1][1]]


def _conv(g: GraphBuilder, x: str, kernel: np.ndarray, bias: Optional[np.ndarray],
          *, stride: int, in_hw: Tuple[int, int], group: int = 1,
          name_hint: str = "conv") -> Tuple[str, Tuple[int, int]]:
    """Emit Conv from an HWIO kernel; returns (output name, output hw)."""
    kh, kw, _, _ = kernel.shape
    w = g.const(f"{name_hint}_w", np.transpose(kernel, (3, 2, 0, 1)))  # OIHW
    inputs = [x, w]
    if bias is not None:
        inputs.append(g.const(f"{name_hint}_b", bias))
    out = g.node(
        "Conv", inputs,
        kernel_shape=[kh, kw], strides=[stride, stride],
        pads=_same_pads(in_hw, (kh, kw), stride), group=group,
    )
    return out, (-(-in_hw[0] // stride), -(-in_hw[1] // stride))


def _conv_transpose(g: GraphBuilder, x: str, kernel: np.ndarray,
                    bias: Optional[np.ndarray], *, stride: int,
                    in_hw: Tuple[int, int],
                    name_hint: str = "convt") -> Tuple[str, Tuple[int, int]]:
    """Emit ConvTranspose from our (kh, kw, I, O) lax-layout kernel.

    The transfer net's expands are ``lax.conv_transpose(transpose_kernel=
    False)`` (:func:`..ops.conv.conv_transpose_2x`); ONNX ConvTranspose has
    TF-gradient semantics, so the kernel converts by a spatial flip + I/O
    swap, then (out, in, kh, kw) -> ONNX (Cin, Cout, kH, kW) layout =
    transpose to (in, out, kh, kw).
    """
    kh, kw, _, _ = kernel.shape
    k_tf = np.transpose(kernel[::-1, ::-1], (0, 1, 3, 2))  # (kh, kw, out, in)
    w = g.const(f"{name_hint}_w", np.transpose(k_tf, (3, 2, 0, 1)))  # (in,out,h,w)
    inputs = [x, w]
    if bias is not None:
        inputs.append(g.const(f"{name_hint}_b", bias))
    out = g.node(
        "ConvTranspose", inputs,
        kernel_shape=[kh, kw], strides=[stride, stride],
        pads=_transpose_pads((kh, kw), stride),
    )
    return out, (in_hw[0] * stride, in_hw[1] * stride)


def _batch_norm(g: GraphBuilder, x: str, params: Dict, stats: Dict,
                *, epsilon: float = 1e-3, name_hint: str = "bn") -> str:
    return g.node(
        "BatchNormalization",
        [
            x,
            g.const(f"{name_hint}_scale", params["scale"]),
            g.const(f"{name_hint}_bias", params["bias"]),
            g.const(f"{name_hint}_mean", stats["mean"]),
            g.const(f"{name_hint}_var", stats["var"]),
        ],
        epsilon=float(epsilon),
    )


class _StyleCursor:
    """Static cursor emitting Slice+Reshape nodes over the flat style vector."""

    def __init__(self, g: GraphBuilder, style_params: str):
        self.g = g
        self.name = style_params
        self.offset = 0

    def take(self, n: int) -> str:
        g = self.g
        sliced = g.node(
            "Slice",
            [
                self.name,
                g.const("slice_starts", np.asarray([self.offset], np.int64)),
                g.const("slice_ends", np.asarray([self.offset + n], np.int64)),
                g.const("slice_axes", np.asarray([1], np.int64)),
            ],
        )
        self.offset += n
        return g.node(
            "Reshape",
            [sliced, g.const("reshape_shape", np.asarray([1, n, 1, 1], np.int64))],
        )


def _cin(g: GraphBuilder, x: str, cursor: _StyleCursor, channels: int,
         *, epsilon: float = 1e-5) -> str:
    """Conditional instance norm as primitive ops (scale-then-bias slice
    order is the ABI)."""
    scale = cursor.take(channels)
    bias = cursor.take(channels)
    axes = [2, 3]
    mean = g.node("ReduceMean", [x], axes=axes, keepdims=1)
    xc = g.node("Sub", [x, mean])
    var = g.node("ReduceMean", [g.node("Mul", [xc, xc])], axes=axes, keepdims=1)
    eps = g.const("cin_eps", np.asarray(epsilon, np.float32))
    denom = g.node("Sqrt", [g.node("Add", [var, eps])])
    normalized = g.node("Div", [xc, denom])
    return g.node("Add", [bias, g.node("Mul", [normalized, scale])])


# ---------------------------------------------------------------------------
# Transfer network
# ---------------------------------------------------------------------------


def export_transfer_onnx(variables, plan, *, cin_epsilon: float = 1e-5) -> bytes:
    """StyleTransferNet (single style) -> ONNX ModelProto bytes.

    Inputs: ``content`` (1, H, W, C) NHWC and ``style_params`` (1, P) — the
    engine's flat style buffer (:mod:`..predict_style_params` writes it).
    Output: ``stylized`` (1, H, W, 3).  Mirrors
    :class:`..models.transfer.StyleTransferNet`.
    """
    from ..models.transfer import (
        CONTRACT_FILTER_SIZES,
        NUM_RESIDUAL_BLOCKS,
        STEM_FILTERS,
    )

    params = variables["params"]
    stats = variables["batch_stats"]
    params = params.get("transfer", params)
    stats = stats.get("transfer", stats)

    h, w, cin = plan.input_shape
    g = GraphBuilder("StyleTransferNet")
    content = g.add_input("content", (1, h, w, cin))
    style_params = g.add_input("style_params", (1, plan.num_style_parameters))
    cursor = _StyleCursor(g, style_params)

    x = g.node("Transpose", [content], perm=[0, 3, 1, 2])
    hw = (h, w)

    schedule = [(STEM_FILTERS, 9, 1)] + [
        CONTRACT_FILTER_SIZES[i] for i in range(plan.num_contract_blocks)
    ]
    for bi, (_f, kernel, stride) in enumerate(schedule):
        p = params[f"contract_{bi}_conv"]
        x, hw = _conv(
            g, x, np.asarray(p["kernel"]), np.asarray(p["bias"]),
            stride=stride, in_hw=hw, name_hint=f"contract_{bi}",
        )
        x = g.node("Relu", [x])
        x = _batch_norm(
            g, x,
            {k: np.asarray(v) for k, v in params[f"contract_{bi}_bn"].items()},
            {k: np.asarray(v) for k, v in stats[f"contract_{bi}_bn"].items()},
            name_hint=f"contract_{bi}_bn",
        )
        x = g.node("Relu", [x])

    filters = plan.bottleneck_num_filters
    for ri in range(NUM_RESIDUAL_BLOCKS):
        fx = x
        for ci in range(2):
            p = params[f"residual_{ri}_conv{ci}"]
            fx, _ = _conv(
                g, fx, np.asarray(p["kernel"]), np.asarray(p["bias"]),
                stride=1, in_hw=hw, name_hint=f"residual_{ri}_{ci}",
            )
            fx = g.node("Relu", [fx])
            fx = _cin(g, fx, cursor, filters, epsilon=cin_epsilon)
            if ci == 0:
                fx = g.node("Relu", [fx])
        x = fx if ri == 0 else g.node("Add", [x, fx])

    num_blocks = len(plan.expand_blocks)
    for ei, (filters_e, kernel, stride) in enumerate(plan.expand_blocks):
        p = params[f"expand_{ei}_conv"]
        if stride == 1:
            x, hw = _conv(
                g, x, np.asarray(p["kernel"]), np.asarray(p["bias"]),
                stride=1, in_hw=hw, name_hint=f"expand_{ei}",
            )
        else:
            x, hw = _conv_transpose(
                g, x, np.asarray(p["kernel"]), np.asarray(p["bias"]),
                stride=stride, in_hw=hw, name_hint=f"expand_{ei}",
            )
        x = _cin(g, x, cursor, filters_e, epsilon=cin_epsilon)
        x = g.node("Sigmoid" if ei == num_blocks - 1 else "Relu", [x])

    assert cursor.offset == plan.num_style_parameters
    out = g.node("Transpose", [x], output="stylized", perm=[0, 2, 3, 1])
    g.add_output(out, (1,) + tuple(plan.output_shape))
    return g.build_model(
        doc=f"transfer net {plan.input_shape}->{plan.output_shape}, "
        f"{plan.num_style_parameters} style params",
    )


# ---------------------------------------------------------------------------
# Style predictor
# ---------------------------------------------------------------------------


def _hard_sigmoid(g: GraphBuilder, x: str) -> str:
    shifted = g.node("Add", [x, g.const("three", np.asarray(3.0, np.float32))])
    clipped = g.node(
        "Clip",
        [shifted, g.const("zero", np.asarray(0.0, np.float32)),
         g.const("six", np.asarray(6.0, np.float32))],
    )
    return g.node(
        "Mul", [clipped, g.const("sixth", np.asarray(1.0 / 6.0, np.float32))]
    )


def _hard_swish(g: GraphBuilder, x: str) -> str:
    return g.node("Mul", [x, _hard_sigmoid(g, x)])


def _mobilenet_v3(g: GraphBuilder, x: str, params, stats,
                  in_hw: Tuple[int, int]) -> str:
    """MobileNetV3-Small feature extractor (:mod:`..models.backbones.mobilenetv3`)."""
    from ..models.backbones.mobilenetv3 import MOBILENETV3_SMALL_BLOCKS

    def act(name, y):
        return g.node("Relu", [y]) if name == "relu" else _hard_swish(g, y)

    def bn(y, name):
        return _batch_norm(
            g, y, {k: np.asarray(v) for k, v in params[name].items()},
            {k: np.asarray(v) for k, v in stats[name].items()},
            name_hint=name,
        )

    hw = in_hw
    x, hw = _conv(g, x, np.asarray(params["stem_conv"]["kernel"]), None,
                  stride=2, in_hw=hw, name_hint="stem")
    x = _hard_swish(g, bn(x, "stem_bn"))

    channels = 16
    for i, (k, exp, out, use_se, act_name, stride) in enumerate(
        MOBILENETV3_SMALL_BLOCKS
    ):
        name = "expanded_conv" if i == 0 else f"expanded_conv_{i}"
        block_p, block_s = params[name], stats[name]
        shortcut, in_channels = x, channels
        if i > 0:
            x, _ = _conv(g, x, np.asarray(block_p["expand"]["kernel"]), None,
                         stride=1, in_hw=hw, name_hint=f"{name}_expand")
            x = act(act_name, _batch_norm(
                g, x,
                {kk: np.asarray(v) for kk, v in block_p["expand_bn"].items()},
                {kk: np.asarray(v) for kk, v in block_s["expand_bn"].items()},
                name_hint=f"{name}_expand_bn"))
            channels = exp
        # depthwise: our kernel (kh, kw, 1, C); ONNX group conv wants
        # (C, 1, kh, kw) = transpose (3, 2, 0, 1) of HWIO -> matches _conv
        x, hw = _conv(
            g, x, np.asarray(block_p["depthwise"]["kernel"]), None,
            stride=stride, in_hw=hw, group=channels,
            name_hint=f"{name}_depthwise",
        )
        x = act(act_name, _batch_norm(
            g, x,
            {kk: np.asarray(v) for kk, v in block_p["depthwise_bn"].items()},
            {kk: np.asarray(v) for kk, v in block_s["depthwise_bn"].items()},
            name_hint=f"{name}_depthwise_bn"))
        if use_se:
            se = g.node("GlobalAveragePool", [x])
            se, _ = _conv(g, se, np.asarray(block_p["se"]["se_reduce"]["kernel"]),
                          np.asarray(block_p["se"]["se_reduce"]["bias"]),
                          stride=1, in_hw=(1, 1), name_hint=f"{name}_se_reduce")
            se = g.node("Relu", [se])
            se, _ = _conv(g, se, np.asarray(block_p["se"]["se_expand"]["kernel"]),
                          np.asarray(block_p["se"]["se_expand"]["bias"]),
                          stride=1, in_hw=(1, 1), name_hint=f"{name}_se_expand")
            x = g.node("Mul", [x, _hard_sigmoid(g, se)])
        x, _ = _conv(g, x, np.asarray(block_p["project"]["kernel"]), None,
                     stride=1, in_hw=hw, name_hint=f"{name}_project")
        x = _batch_norm(
            g, x,
            {kk: np.asarray(v) for kk, v in block_p["project_bn"].items()},
            {kk: np.asarray(v) for kk, v in block_s["project_bn"].items()},
            name_hint=f"{name}_project_bn")
        channels = out
        if stride == 1 and in_channels == out:
            x = g.node("Add", [x, shortcut])

    x, _ = _conv(g, x, np.asarray(params["last_conv"]["kernel"]), None,
                 stride=1, in_hw=hw, name_hint="last")
    return _hard_swish(g, bn(x, "last_bn"))


def export_predictor_onnx(variables, *, style_shape: Tuple[int, int, int],
                          num_top_parameters: int,
                          feature_extractor: str = "mobilenet") -> bytes:
    """StylePredictor -> ONNX ModelProto bytes.

    Input ``style`` (1, H, W, 3) NHWC in [0, 1]; output ``style_params``
    (1, num_top_parameters) — the buffer :mod:`..predict_style_params` writes
    raw for the engine.  Mirrors :class:`..models.predictor.StylePredictor`;
    only the dummy and MobileNet extractors are emitted.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    params = params.get("style_predictor", params)
    stats = stats.get("style_predictor", stats) if stats else {}

    h, w, _ = style_shape
    g = GraphBuilder("StylePredictor")
    style = g.add_input("style", (1, h, w, 3))
    x = g.node("Transpose", [style], perm=[0, 3, 1, 2])

    if feature_extractor == "dummy":
        p = params["dummy_conv"]
        x, _ = _conv(g, x, np.asarray(p["kernel"]), np.asarray(p["bias"]),
                     stride=5, in_hw=(h, w), name_hint="dummy")
    elif feature_extractor == "mobilenet":
        # Rescaling(2, -1), stylePrediction.py:37
        x = g.node("Mul", [x, g.const("two", np.asarray(2.0, np.float32))])
        x = g.node("Sub", [x, g.const("one", np.asarray(1.0, np.float32))])
        x = _mobilenet_v3(g, x, params["backbone"], stats["backbone"], (h, w))
    else:
        raise ValueError(
            f"ONNX export supports dummy/mobilenet extractors, "
            f"not {feature_extractor!r}"
        )

    x = g.node("GlobalAveragePool", [x])
    for name in ("StylePredictor", "StyleNormPredictor"):
        p = params[name]
        x, _ = _conv(g, x, np.asarray(p["kernel"]), np.asarray(p["bias"]),
                     stride=1, in_hw=(1, 1), name_hint=name)
    out = g.node(
        "Reshape",
        [x, g.const("out_shape", np.asarray([1, num_top_parameters], np.int64))],
        output="style_params",
    )
    g.add_output(out, (1, num_top_parameters))
    return g.build_model(doc=f"style predictor ({feature_extractor})")
