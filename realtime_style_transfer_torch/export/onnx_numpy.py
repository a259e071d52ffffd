"""Numpy interpreter for the exported ONNX graphs (a checking tool).

The port's copy of ``realtime_style_transfer_tpu/export/onnx_numpy.py``:
parses ONNX ModelProto bytes (via ``utils.proto``) and executes the model
family's op set with numpy, straight from the ONNX operator spec, so the
emitted graph is checked by running it.  The tests and ``chip_smoke.py`` use
it; it is not a serving path.

The parse and the operator semantics are the JAX copy's.  One difference:
each conv tap is contracted with a BLAS product (``np.matmul``) where the JAX
copy calls ``np.einsum`` without ``optimize``, which takes minutes on a
480x960 graph; the sums therefore run in another order.

Implemented ops (opset 13): Conv (grouped), ConvTranspose, BatchNormalization,
Relu, Sigmoid, Clip, Add, Sub, Mul, Div, Sqrt, ReduceMean, Reshape, Transpose,
Slice, GlobalAveragePool.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils import proto as pb

_FLOAT, _INT64 = 1, 7


def _parse_tensor(buf: bytes):
    dims: List[int] = []
    dtype = _FLOAT
    name = ""
    raw = b""
    for field, wire, value in pb.parse_fields(buf):
        if field == 1:
            if wire == 2:
                dims.extend(pb.parse_packed_int64s(value))
            else:
                dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = value.decode()
        elif field == 9:
            raw = value
    np_dtype = np.float32 if dtype == _FLOAT else np.int64
    return name, np.frombuffer(raw, np_dtype).reshape(dims)


def _parse_attribute(buf: bytes):
    name, value = "", None
    ints: List[int] = []
    floats: List[float] = []
    for field, wire, v in pb.parse_fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:
            value = v
        elif field == 3:
            value = v if v < 1 << 63 else v - (1 << 64)
        elif field == 4:
            value = v.decode()
        elif field == 7:
            floats.append(v)
        elif field == 8:
            if wire == 2:
                ints.extend(pb.parse_packed_int64s(v))
            else:
                ints.append(v if v < 1 << 63 else v - (1 << 64))
    if ints:
        value = ints
    elif floats:
        value = floats
    return name, value


def _parse_node(buf: bytes):
    inputs, outputs, attrs = [], [], {}
    op_type = ""
    for field, _wire, value in pb.parse_fields(buf):
        if field == 1:
            inputs.append(value.decode())
        elif field == 2:
            outputs.append(value.decode())
        elif field == 4:
            op_type = value.decode()
        elif field == 5:
            k, v = _parse_attribute(value)
            attrs[k] = v
    return op_type, inputs, outputs, attrs


def _parse_value_info_name(buf: bytes) -> str:
    for field, _wire, value in pb.parse_fields(buf):
        if field == 1:
            return value.decode()
    return ""


def parse_model(model_bytes: bytes):
    """ModelProto bytes -> (nodes, initializers, input names, output names)."""
    graph = None
    for field, _wire, value in pb.parse_fields(model_bytes):
        if field == 7:
            graph = value
    if graph is None:
        raise ValueError("no GraphProto in model")
    nodes, initializers = [], {}
    inputs, outputs = [], []
    for field, _wire, value in pb.parse_fields(graph):
        if field == 1:
            nodes.append(_parse_node(value))
        elif field == 5:
            name, arr = _parse_tensor(value)
            initializers[name] = arr
        elif field == 11:
            inputs.append(_parse_value_info_name(value))
        elif field == 12:
            outputs.append(_parse_value_info_name(value))
    return nodes, initializers, inputs, outputs


# ---------------------------------------------------------------------------
# op implementations (NCHW)
# ---------------------------------------------------------------------------


def _conv(x, w, b, *, strides, pads, group):
    n, cin, h, wid = x.shape
    cout, cin_g, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    oh = (h + ph0 + ph1 - kh) // strides[0] + 1
    ow = (wid + pw0 + pw1 - kw) // strides[1] + 1
    cout_g = cout // group
    xg = xp.reshape((n, group, cin_g) + xp.shape[2:])
    # (kh, kw, group, cout_g, cin_g): each tap's matrices contiguous, so that
    # matmul takes BLAS (a strided operand sends it to a slow loop)
    taps = np.ascontiguousarray(w.reshape(group, cout_g, cin_g, kh, kw).transpose(3, 4, 0, 1, 2))
    out = np.zeros((n, group, cout_g, oh * ow), np.float32)
    for dy in range(kh):
        for dx in range(kw):
            patch = xg[..., dy:dy + oh * strides[0]:strides[0],
                       dx:dx + ow * strides[1]:strides[1]]
            # (group, cout_g, cin_g) @ (n, group, cin_g, oh*ow) -> (n, group, cout_g, oh*ow)
            out += np.matmul(taps[dy, dx], patch.reshape(n, group, cin_g, oh * ow))
    out = out.reshape(n, cout, oh, ow)
    if b is not None:
        out += b.reshape(1, cout, 1, 1)
    return out


def _conv_transpose(x, w, b, *, strides, pads):
    """ONNX ConvTranspose: W (Cin, Cout, kH, kW), gradient-of-conv semantics."""
    n, cin, h, wid = x.shape
    _, cout, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    oh = (h - 1) * strides[0] + kh - (ph0 + ph1)
    ow = (wid - 1) * strides[1] + kw - (pw0 + pw1)
    full = np.zeros((n, cout, oh + ph0 + ph1, ow + pw0 + pw1), np.float32)
    flat = x.reshape(n, cin, h * wid)
    taps = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # (kh, kw, cout, cin)
    for dy in range(kh):
        for dx in range(kw):
            # out[p*s + d] += x[p] @ w[:, :, dy, dx]
            contrib = np.matmul(taps[dy, dx], flat).reshape(n, cout, h, wid)
            full[:, :, dy:dy + h * strides[0]:strides[0],
                 dx:dx + wid * strides[1]:strides[1]] += contrib
    out = full[:, :, ph0:ph0 + oh, pw0:pw0 + ow]
    if b is not None:
        out = out + b.reshape(1, cout, 1, 1)
    return out


def run_model(model_bytes: bytes, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute an exported model; returns {output_name: array}."""
    nodes, initializers, input_names, output_names = parse_model(model_bytes)
    env: Dict[str, np.ndarray] = dict(initializers)
    for name in input_names:
        if name not in feeds:
            raise ValueError(f"missing feed for graph input {name!r}")
        env[name] = np.asarray(feeds[name], np.float32)

    def get(name: str) -> Optional[np.ndarray]:
        return env[name] if name else None

    for op_type, inputs, outputs, attrs in nodes:
        a = [get(i) for i in inputs]
        if op_type == "Conv":
            out = _conv(
                a[0], a[1], a[2] if len(a) > 2 else None,
                strides=attrs.get("strides", [1, 1]),
                pads=attrs.get("pads", [0, 0, 0, 0]),
                group=attrs.get("group", 1),
            )
        elif op_type == "ConvTranspose":
            out = _conv_transpose(
                a[0], a[1], a[2] if len(a) > 2 else None,
                strides=attrs.get("strides", [1, 1]),
                pads=attrs.get("pads", [0, 0, 0, 0]),
            )
        elif op_type == "BatchNormalization":
            x, scale, bias, mean, var = a
            eps = attrs.get("epsilon", 1e-5)
            shape = (1, -1, 1, 1)
            out = (x - mean.reshape(shape)) / np.sqrt(
                var.reshape(shape) + eps
            ) * scale.reshape(shape) + bias.reshape(shape)
        elif op_type == "Relu":
            out = np.maximum(a[0], 0.0)
        elif op_type == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-a[0]))
        elif op_type == "Clip":
            out = np.clip(a[0], a[1], a[2])
        elif op_type == "Add":
            out = a[0] + a[1]
        elif op_type == "Sub":
            out = a[0] - a[1]
        elif op_type == "Mul":
            out = a[0] * a[1]
        elif op_type == "Div":
            out = a[0] / a[1]
        elif op_type == "Sqrt":
            out = np.sqrt(a[0])
        elif op_type == "ReduceMean":
            out = np.mean(a[0], axis=tuple(attrs["axes"]),
                          keepdims=bool(attrs.get("keepdims", 1)))
        elif op_type == "Reshape":
            out = a[0].reshape([int(d) for d in a[1]])
        elif op_type == "Transpose":
            out = np.transpose(a[0], attrs["perm"])
        elif op_type == "Slice":
            data, starts, ends, axes = a[0], a[1], a[2], a[3]
            slices = [slice(None)] * data.ndim
            for s, e, ax in zip(starts, ends, axes):
                slices[int(ax)] = slice(int(s), int(e))
            out = data[tuple(slices)]
        elif op_type == "GlobalAveragePool":
            out = np.mean(a[0], axis=(2, 3), keepdims=True)
        else:
            raise NotImplementedError(f"op {op_type}")
        env[outputs[0]] = np.asarray(out, np.float32)

    return {name: env[name] for name in output_names}
