"""Models and the weight bridge of the PyTorch port against the JAX package.

Both sides run in f32 on the CPU with the same weights: JAX-initialised
variables pass through ``realtime_style_transfer_torch.weights``; the TF
reference fixtures in ``tests/golden/reference`` pass through
``tools/convert_keras_weights.py`` first, as ``tests/test_reference_parity.py``
does.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models.backbones.mobilenetv3 import (
    MobileNetV3Small as TMobileNet,
)
from realtime_style_transfer_torch.models.inference import make_inference_model as tmake
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.models.predictor import StylePredictor as TPredictor
from realtime_style_transfer_torch.models.transfer import StyleTransferNet as TNet
from realtime_style_transfer_torch.models.transfer import style_param_count
from realtime_style_transfer_torch.weights import from_flax, load_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.backbones.mobilenetv3 import (
    CONTENT_TAPS,
    STYLE_TAPS,
    MobileNetV3Small,
)
from realtime_style_transfer_tpu.models.inference import make_inference_model, plan_from_config
from realtime_style_transfer_tpu.models.predictor import StylePredictor
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "golden" / "reference"
sys.path.insert(0, str(REPO / "tools"))

from convert_keras_weights import convert_predictor, convert_transfer  # noqa: E402

torch.set_num_threads(2)

TINY_KW = dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
               num_channels=17, hdr=True)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", params=[1, 2], ids=["single", "dual"])
def tiny_net(request):
    ns = request.param
    cfg = ShapeConfig(num_styles=ns, **TINY_KW)
    plan = plan_from_config(cfg)
    rng = np.random.default_rng(21 + ns)
    content = rng.random((1,) + cfg.content_shape).astype(np.float32)
    style_params = (rng.random((1, ns, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    weights = (rng.random((1,) + cfg.output_dimensions + (ns - 1,)).astype(np.float32)
               if ns > 1 else None)
    net = StyleTransferNet(plan=plan, num_styles=ns)
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(3), content, style_params, weights, train=False))
    want = np.asarray(jax.jit(lambda v, c, p, w: net.apply(v, c, p, w, train=False))(
        variables, content, style_params, weights))
    return ns, variables, content, style_params, weights, want


def test_transfer_net_matches_jax(tiny_net):
    ns, variables, content, style_params, weights, want = tiny_net
    net = load_flax(TNet(tplan(TConfig(num_styles=ns, **TINY_KW)), ns), variables)
    with torch.no_grad():
        got = net(t(content), t(style_params), None if weights is None else t(weights))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_weight_bridge_consumes_every_leaf_and_round_trips(tiny_net):
    ns, variables, *_ = tiny_net
    net = TNet(tplan(TConfig(num_styles=ns, **TINY_KW)), ns)
    state = from_flax(variables, expected=net)
    assert set(state) == set(net.state_dict())
    back = to_flax(state)
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    # the port's own initialisation survives the other direction too
    state2 = from_flax(to_flax(net.state_dict()), expected=net)
    for key, value in net.state_dict().items():
        assert torch.equal(state2[key], value), key


def test_weight_bridge_raises_on_unconsumed_or_unfilled(tiny_net):
    ns, variables, *_ = tiny_net
    net = TNet(tplan(TConfig(num_styles=ns, **TINY_KW)), ns)
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((1, 1, 1, 1))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="stray"):
        from_flax(extra, expected=net)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "expand_0_conv"},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="expand_0_conv"):
        from_flax(missing, expected=net)
    odd = {"params": {"contract_0_conv": {"embedding": np.zeros(3)}}}
    with pytest.raises(ValueError, match="embedding"):
        from_flax(odd)
    flat = {f"params/{k}/kernel": v["kernel"] for k, v in variables["params"].items()
            if "kernel" in v}
    assert all(key.endswith(".weight") for key in from_flax(flat))


@pytest.mark.parametrize("name,num_styles", [("transfer_tiny", 1), ("transfer_dual", 2)])
def test_transfer_net_matches_tf_reference_fixture(name, num_styles):
    w = np.load(FIXTURES / name / "weights.npz")
    io = np.load(FIXTURES / name / "io.npz")
    plan = tplan(TConfig(num_styles=num_styles, **TINY_KW))
    assert plan.num_style_parameters == int(io["num_style_params"])
    net = load_flax(TNet(plan, num_styles), convert_transfer(w))
    weights = t(io["style_weights"]) if num_styles > 1 else None
    with torch.no_grad():
        out = net(t(io["content"]), t(io["style_params"]), weights).numpy()
    err = np.abs(out - io["output"])
    assert err.max() < 1e-4
    assert np.median(err) < 1e-5


def test_style_param_count_is_2662_for_flagship():
    cfg = TConfig.from_spec("rst-960-120-128-17")
    assert style_param_count(cfg.content_shape, cfg.output_shape,
                             cfg.bottleneck_res_y, cfg.bottleneck_num_filters) == 2662
    assert tplan(cfg).num_style_parameters == 2662


@pytest.mark.parametrize("extractor", ["mobilenet", "dummy"])
def test_predictor_matches_jax(extractor):
    img = np.random.default_rng(4).random((2, 64, 128, 3)).astype(np.float32)
    jp = StylePredictor(num_top_parameters=40, feature_extractor=extractor)
    variables = jax.device_get(jax.jit(jp.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), img, train=False))
    want = np.asarray(jax.jit(lambda v, x: jp.apply(v, x, train=False))(variables, img))
    tp = load_flax(TPredictor(40, extractor), variables)
    with torch.no_grad():
        got = tp(t(img)).numpy()
    assert got.shape == want.shape == (2, 40)
    assert np.abs(got - want).max() < 1e-5


def test_mobilenet_backbone_taps_match_jax():
    x = np.random.default_rng(6).random((1, 64, 128, 3)).astype(np.float32) * 2 - 1
    taps = STYLE_TAPS + CONTENT_TAPS
    jm = MobileNetV3Small(capture=taps)
    variables = jax.device_get(jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(2), x, train=False))
    rng = np.random.default_rng(8)
    # non-trivial batch statistics, so the BN arithmetic is exercised
    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree.map(
            lambda a: (rng.random(a.shape) * 0.5 + 0.5).astype(np.float32),
            variables["batch_stats"]),
    }
    feats, jtaps = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    tm = load_flax(TMobileNet(capture=taps), variables)
    with torch.no_grad():
        got, ttaps = tm(t(x))
    assert sorted(ttaps) == sorted(jtaps) == sorted(taps)
    for name, ref, ours in [("features", feats, got)] + [
            (n, jtaps[n], ttaps[n]) for n in taps]:
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() / np.abs(ref).max() < 1e-4, name


def test_predictor_dummy_matches_tf_reference_fixture():
    w = np.load(FIXTURES / "predictor_dummy" / "weights.npz")
    io = np.load(FIXTURES / "predictor_dummy" / "io.npz")
    tp = load_flax(TPredictor(int(io["num_top"]), "dummy"), convert_predictor(w))
    with torch.no_grad():
        out = tp(t(io["image"])).numpy()
    assert np.abs(out - io["output"]).max() < 1e-5


def test_inference_matches_committed_golden():
    """JAX-initialised weights through the bridge reproduce
    ``tests/golden/tiny_inference_v1.npy`` (see ``tests/test_golden.py``)."""
    kw = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
              num_channels=3, hdr=False, feature_extractor="dummy")
    model = make_inference_model(ShapeConfig(**kw))
    cfg = TConfig(**kw)
    h, w = cfg.input_dimensions
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    content = np.stack([yy, xx, yy * xx], axis=-1).astype(np.float32)[None]
    style = np.stack([xx, yy, (yy + xx) / 2], axis=-1).astype(np.float32)[None, None]
    variables = jax.device_get(jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(1234), jnp.asarray(content), jnp.asarray(style), train=False))
    tmodel = load_flax(tmake(cfg, device="cpu"), variables)
    with torch.no_grad():
        got = tmodel(t(content), t(style)).numpy()
    want = np.load(REPO / "tests" / "golden" / "tiny_inference_v1.npy")
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
