"""The port's ONNX emitter and interpreter (``realtime_style_transfer_torch.export``)
held against the JAX package's (``realtime_style_transfer_tpu.export``) on the CPU.

* For one flax tree both emitters give the same bytes but the producer
  name (the model's field 2): every other top-level field, in order, is
  equal byte for byte.  The transfer net at
  ``rst-120-15-4-3`` and ``rst-240-15-4-6`` (the JAX test's specs, its
  jitted ``init``), the predictor with the dummy extractor at (60, 120), and
  with MobileNet at (64, 96) under ``-m slow`` as the JAX test marks it.
* The golden ``tests/golden/transfer_tiny_reference.onnx``, byte for byte
  but the producer name, from the weights ``tests/test_onnx_export.py``
  builds.
* The port's interpreter parses the bytes as JAX's does and runs them to
  JAX's ``run_model`` and the JAX eager net within ``rtol=1e-3, atol=1e-4``
  (``tests/test_onnx_export.py``'s limits; its taps are BLAS products, JAX's
  ``np.einsum``, so the sums run in another order).
* The ONNX of the port's own seeded nets runs to the port's eager nets
  within the same limits.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.export import export_predictor_onnx, export_transfer_onnx
from realtime_style_transfer_torch.export.onnx import IR_VERSION, OPSET_VERSION, PRODUCER
from realtime_style_transfer_torch.export.onnx_numpy import parse_model, run_model
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.models.predictor import StylePredictor as TPredictor
from realtime_style_transfer_torch.utils.proto import parse_fields
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.export import export_predictor_onnx as jax_predictor_onnx
from realtime_style_transfer_tpu.export import export_transfer_onnx as jax_transfer_onnx
from realtime_style_transfer_tpu.export.onnx_numpy import parse_model as jax_parse_model
from realtime_style_transfer_tpu.export.onnx_numpy import run_model as jax_run_model
from realtime_style_transfer_tpu.models.predictor import StylePredictor
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet, make_transfer_plan

torch.set_num_threads(2)

JAX_PRODUCER = "realtime-style-transfer-tpu"
RTOL, ATOL = 1e-3, 1e-4
GOLDEN = Path(__file__).parent / "golden"


def _fields(model_bytes):
    return [(f, v) for f, _w, v in parse_fields(model_bytes)]


def _but_producer(model_bytes):
    """An ONNX model's top-level fields but its producer name (field 2)."""
    return [(f, v) for f, v in _fields(model_bytes) if f != 2]


def _assert_same_graph(a, b):
    """Same parse: nodes, initializers bit for bit, graph inputs and outputs."""
    nodes_a, init_a, in_a, out_a = a
    nodes_b, init_b, in_b, out_b = b
    assert nodes_a == nodes_b and in_a == in_b and out_a == out_b
    assert init_a.keys() == init_b.keys()
    for name in init_a:
        assert init_a[name].dtype == init_b[name].dtype
        np.testing.assert_array_equal(init_a[name], init_b[name])


@pytest.fixture(scope="module", params=["rst-120-15-4-3", "rst-240-15-4-6"])
def transfer(request):
    """The JAX transfer net of a spec with its jitted init (the JAX test's
    setup), a seeded content and style vector, its output, and both
    packages' ONNX bytes of its variables."""
    spec = request.param
    cfg = ShapeConfig.from_spec(spec)
    plan = make_transfer_plan(cfg.content_shape, cfg.output_shape, cfg.bottleneck_res_y,
                              cfg.bottleneck_num_filters)
    net = StyleTransferNet(plan=plan)
    rng = np.random.default_rng(7)
    content = rng.random((1,) + cfg.content_shape).astype(np.float32)
    style_params = rng.standard_normal((1, 1, plan.num_style_parameters)).astype(np.float32) * 0.1
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(content), jnp.asarray(style_params), train=False))
    expected = np.asarray(jax.jit(lambda v, c, sp: net.apply(v, c, sp, train=False))(
        variables, jnp.asarray(content), jnp.asarray(style_params)))
    port_plan = tplan(TConfig.from_spec(spec))
    return dict(spec=spec, cfg=cfg, plan=plan, variables=variables, content=content,
                style_params=style_params, expected=expected,
                jax_bytes=jax_transfer_onnx(variables, plan),
                port_bytes=export_transfer_onnx(variables, port_plan))


def test_transfer_bytes_equal_the_jax_emitters(transfer):
    # only field 2 (producer_name) differs
    own, jax_fields = _fields(transfer["port_bytes"]), _fields(transfer["jax_bytes"])
    assert [f for f, _ in own] == [f for f, _ in jax_fields] == [1, 2, 7, 8]
    assert dict(own)[2] == PRODUCER.encode() and dict(jax_fields)[2] == JAX_PRODUCER.encode()
    assert _but_producer(transfer["port_bytes"]) == _but_producer(transfer["jax_bytes"])
    assert dict(own)[1] == IR_VERSION == 8
    assert {f: v for f, _w, v in parse_fields(dict(own)[8])}[2] == OPSET_VERSION == 13


def test_transfer_interpreter_matches_jax_run_model_and_eager_net(transfer):
    data = transfer["jax_bytes"]
    _assert_same_graph(parse_model(data), jax_parse_model(data))
    feeds = {"content": transfer["content"], "style_params": transfer["style_params"][:, 0, :]}
    got = run_model(data, feeds)["stylized"]
    assert got.shape == transfer["expected"].shape == (1,) + transfer["cfg"].output_shape
    np.testing.assert_allclose(got, jax_run_model(data, feeds)["stylized"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, transfer["expected"], rtol=RTOL, atol=ATOL)


def test_transfer_onnx_structure(transfer):
    """tests/test_onnx_export.py::test_transfer_onnx_structure on the port's
    parse: ConvTranspose per stride-2 expand, 2 Slices per CIN."""
    nodes, initializers, inputs, outputs = parse_model(transfer["port_bytes"])
    assert inputs == ["content", "style_params"] and outputs == ["stylized"]
    op_types = [n[0] for n in nodes]
    plan = transfer["plan"]
    assert op_types.count("ConvTranspose") == plan.num_expand_blocks
    assert op_types.count("Slice") == 2 * (2 * 5 + len(plan.expand_blocks))
    assert all(name and np.isfinite(a).all() for name, a in initializers.items())


@pytest.mark.parametrize(
    "extractor,hw",
    [("dummy", (60, 120)),
     # the MobileNet tower through JAX's numpy interpreter takes 33 s, as in
     # tests/test_onnx_export.py
     pytest.param("mobilenet", (64, 96), marks=pytest.mark.slow)])
def test_predictor_bytes_and_values_match_jax(extractor, hw):
    num_top = 50
    module = StylePredictor(num_top_parameters=num_top, feature_extractor=extractor)
    style = np.random.default_rng(3).random((1,) + hw + (3,)).astype(np.float32)
    variables = jax.device_get(jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.asarray(style), train=False))
    expected = np.asarray(module.apply(variables, jnp.asarray(style), train=False))
    kw = dict(style_shape=hw + (3,), num_top_parameters=num_top, feature_extractor=extractor)
    data = jax_predictor_onnx(variables, **kw)
    assert _but_producer(export_predictor_onnx(variables, **kw)) == _but_producer(data)
    _assert_same_graph(parse_model(data), jax_parse_model(data))
    got = run_model(data, {"style": style})["style_params"]
    assert got.shape == expected.shape == (1, num_top)
    np.testing.assert_allclose(got, jax_run_model(data, {"style": style})["style_params"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


def test_transfer_golden_bytes():
    """The port's emitter on tests/test_onnx_export.py's golden weights gives
    tests/golden/transfer_tiny_reference.onnx byte for byte but the
    producer name."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from convert_keras_weights import convert_transfer

    weights = np.load(GOLDEN / "reference" / "transfer_tiny" / "weights.npz")
    variables = jax.device_get(convert_transfer(weights))
    cfg = TConfig(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
                  num_channels=17, hdr=True)
    data = export_transfer_onnx(variables, tplan(cfg))
    golden = (GOLDEN / "transfer_tiny_reference.onnx").read_bytes()
    assert dict(_fields(golden))[2] == JAX_PRODUCER.encode()
    assert _but_producer(data) == _but_producer(golden), (
        f"{len(data)} bytes against the golden's {len(golden)}")


@pytest.mark.parametrize("spec", ["rst-120-15-4-3", "rst-128-16-8-17"])
def test_onnx_of_the_ports_seeded_nets_runs_to_its_eager_nets(spec):
    """The port's own weights (seeded, through ``to_flax``): the transfer
    net's and the MobileNet predictor's ONNX against the eager nets."""
    cfg = TConfig.from_spec(spec)
    model = tcli.build_inference(cfg, device="cpu")
    variables = to_flax(model.state_dict())
    plan = tplan(cfg)
    rng = np.random.default_rng(11)
    content = rng.random((1,) + cfg.content_shape, dtype=np.float32)
    style = rng.random((1,) + cfg.output_shape, dtype=np.float32)
    with torch.no_grad():
        want_params = model.predict_style_params(torch.from_numpy(style)).numpy()
        want = model.stylize(torch.from_numpy(content), torch.from_numpy(want_params)[:, None])
    params = run_model(export_predictor_onnx(variables, style_shape=cfg.output_shape,
                                             num_top_parameters=plan.num_style_parameters),
                       {"style": style})["style_params"]
    np.testing.assert_allclose(params, want_params, rtol=RTOL, atol=ATOL)
    got = run_model(export_transfer_onnx(variables, plan),
                    {"content": content, "style_params": want_params})["stylized"]
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


def test_predictor_onnx_refuses_other_extractors():
    with pytest.raises(ValueError, match="dummy/mobilenet"):
        export_predictor_onnx({"params": {}}, style_shape=(32, 32, 3), num_top_parameters=8,
                              feature_extractor="efficientnet")


def test_initializers_are_f32_whatever_the_trees_dtype():
    """A bf16-rounded tree held in f64 and in f32 emits the same bytes: every
    float initializer is written as f32, as JAX's ``_tensor_proto`` does."""
    module = TPredictor(8, "dummy")
    tree = to_flax({k: v.to(torch.bfloat16).float() for k, v in module.state_dict().items()})
    wide = jax.tree.map(lambda a: a.astype(np.float64), tree)
    kw = dict(style_shape=(60, 120, 3), num_top_parameters=8, feature_extractor="dummy")
    assert export_predictor_onnx(wide, **kw) == export_predictor_onnx(tree, **kw)
    _, initializers, _, _ = parse_model(export_predictor_onnx(wide, **kw))
    assert {a.dtype for a in initializers.values()} <= {np.dtype(np.float32), np.dtype(np.int64)}
