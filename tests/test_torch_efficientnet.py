"""The port's EfficientNet backbones (B3, V2-S), the weight bridge on their
trees and the V2-S style predictor, against the JAX package on the CPU.

JAX's variables come from ``jax.eval_shape`` of ``init`` filled by a numpy
seed (B3's jitted ``init`` alone takes tens of seconds on the CPU), pass to
the port through ``weights.from_flax``, and each JAX forward runs once, jitted,
in a module fixture.  Inputs are in [-1, 1], at an even and an odd size: the
stride-2 convs pad asymmetrically (TF ``SAME``) and the odd size checks it.

Limits.  f32: within rtol 1e-4 + atol 1e-5 x max|JAX| (rounding; measured
about 1e-6 of the largest value); in train mode, where 110 batch norms
divide by batch variances, atol 1e-4 x max|JAX| (measured 1.2e-5).  bf16: rtol 0.05 + atol 0.02 with the
median error under 5e-3, the repo's bf16 limit.  The bridge round trip and
the checkpoint file: leaf for leaf, bit-equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models.backbones import efficientnet as teff
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.models.layers import BatchNorm
from realtime_style_transfer_torch.models.predictor import StylePredictor as TPredictor
from realtime_style_transfer_torch.models.training import make_style_transfer_training_model
from realtime_style_transfer_torch.weights import (from_flax, load_flax, state_from_flax,
                                                   state_to_flax, to_flax)
from realtime_style_transfer_tpu.models.backbones import efficientnet as jeff
from realtime_style_transfer_tpu.models.predictor import StylePredictor as JPredictor

torch.set_num_threads(2)

SIZES = {"even": (2, 32, 48, 3), "odd": (2, 33, 47, 3)}
# train mode: batch statistics over 4 x 4 x 4 elements at the last stage (at
# the even size's 2 x 1 x 2 the variance of four values turns rounding into
# percent-level differences)
TRAIN_SIZE = (4, 64, 64, 3)
MODELS = {
    "b3": (jeff.EfficientNetB3, teff.EfficientNetB3,
           jeff.STYLE_TAPS_B3 + jeff.CONTENT_TAPS_B3),
    "v2s": (jeff.EfficientNetV2S, teff.EfficientNetV2S,
            jeff.STYLE_TAPS_V2S + jeff.CONTENT_TAPS_V2S),
}


def seeded_variables(shapes, seed, gain=1.0):
    """A flax tree of ``shapes`` (``jax.eval_shape`` output) filled from a
    numpy seed: kernels at variance gain^2 / fan_in, scales and variances in
    [1, 1.2], everything else (biases, means) around 0 at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (gain * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var", "variance"):
            return (1 + 0.2 * rng.random(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


def inputs(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) * 2 - 1


def close(got, want, rtol=1e-4, atol_frac=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


def close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (err <= 0.02 + 0.05 * np.abs(want)).all(), err.max()
    assert np.median(err) < 5e-3, np.median(err)


@pytest.fixture(scope="module")
def backbones():
    """Per model: seeded variables, JAX's eval features and taps at both
    sizes, V2-S's train-mode forward, and the port loaded with them."""
    out = {}
    for name, (jcls, tcls, capture) in MODELS.items():
        jmod = jcls(capture=capture)
        variables = seeded_variables(jax.eval_shape(
            lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(SIZES["even"]))), 7)
        apply = jax.jit(jmod.apply)
        want = {size: jax.tree.map(np.asarray, apply(variables, inputs(shape, 1)))
                for size, shape in SIZES.items()}
        train = None
        if name == "v2s":
            train = jax.tree.map(np.asarray, jax.jit(
                lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
                    variables, inputs(TRAIN_SIZE, 2)))
        out[name] = types.SimpleNamespace(variables=variables, want=want, train=train,
                                          port=load_flax(tcls(capture), variables),
                                          capture=capture)
    return out


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_features_and_every_tap_match_jax(backbones, name, size):
    ref = backbones[name]
    feats, taps = ref.want[size]
    with torch.no_grad():
        got, got_taps = ref.port(torch.from_numpy(inputs(SIZES[size], 1)))
    close(got.numpy(), feats)
    assert set(got_taps) == set(taps) == set(ref.capture)
    for tap in taps:
        close(got_taps[tap].numpy(), taps[tap])


def test_v2s_train_mode_and_its_batch_stats_match_jax(backbones):
    ref = backbones["v2s"]
    (feats, taps), mutated = ref.train
    got, got_taps = ref.port(torch.from_numpy(inputs(TRAIN_SIZE, 2)), train=True)
    close(got.detach().numpy(), feats, atol_frac=1e-4)
    for name in taps:
        close(got_taps[name].detach().numpy(), taps[name], atol_frac=1e-4)
    update = {}
    for name, m in ref.port.named_modules():
        if isinstance(m, BatchNorm):
            update[f"{name}.running_mean"], update[f"{name}.running_var"] = m.batch_update
    want = from_flax({"batch_stats": mutated["batch_stats"]})
    # stem, 2 + 2 x 8 fused, 3 x 30 MBConv and top batch norms, two leaves each
    assert set(update) == set(want) and len(want) == 2 * 110
    for key in want:
        close(update[key].numpy(), want[key].numpy())


def test_round_filters_and_the_b3_schedule():
    for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for width in (1.0, 1.1, 1.2, 2.0):
            assert teff.round_filters(f, width) == jeff.round_filters(f, width)
    for r in range(1, 6):
        assert teff.round_repeats(r, teff.B3_DEPTH) == jeff.round_repeats(r, jeff.B3_DEPTH)
    b3 = teff.EfficientNetB3()
    assert len(b3.block_names) == 26 and b3.block_names[-1] == "block7b"
    assert b3.stem_conv.weight.shape[0] == 40 and b3.top_conv.weight.shape[0] == 1536
    adds = [n for n in b3.block_names if getattr(b3, n).has_add]
    assert {t[:-len("_add")] for t in teff.STYLE_TAPS_B3 + teff.CONTENT_TAPS_B3} <= set(adds)
    # the depthwise 5x5 of stages 3 and 6 at stride 2
    assert b3.block3a.depthwise.stride == 2 and b3.block3a.depthwise.weight.shape[2:] == (5, 5)
    assert b3.block6a.depthwise.stride == 2 and b3.block6a.depthwise.groups == 136 * 6
    # SE width from the block's input channels, not the expanded ones
    assert b3.block2a.se_reduce.weight.shape[0] == max(1, int(24 * 0.25))
    v2s = teff.EfficientNetV2S()
    assert len(v2s.block_names) == 40 and v2s.block_names[-1] == "block6o"
    assert not v2s.block1a.has_expand and v2s.block2a.has_expand


def test_bridge_round_trips_b3_with_its_normalization_and_the_npz_file(backbones, tmp_path):
    ref = backbones["b3"]
    variables = ref.variables
    norm = variables["batch_stats"]["normalization"]
    assert sorted(norm) == ["mean", "variance"]
    sd = from_flax(variables, expected=ref.port)
    assert torch.equal(sd["normalization.running_variance"],
                       torch.from_numpy(norm["variance"]))
    back = to_flax(sd)
    flat = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    again = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(again)
    for key, value in flat.items():
        np.testing.assert_array_equal(again[key], value)
    # the .npz of /-joined flax paths, as the converter's tree is saved
    path = tcli.save_variables(tmp_path / "b3.npz", variables)
    with np.load(path) as data:
        assert "batch_stats/normalization/variance" in data.files
        port = load_flax(teff.EfficientNetB3(ref.capture), data)
    for key, value in port.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_v2s_training_state_round_trips_leaf_for_leaf():
    cfg = TConfig(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
                  num_channels=3, hdr=False, feature_extractor="efficientnet",
                  with_depth_loss=False)
    tm = make_style_transfer_training_model(cfg, loss_extractor="dummy", device="cpu")
    assert isinstance(tm.model.style_predictor.backbone, teff.EfficientNetV2S)
    state = tm.init_state()
    gen = torch.Generator().manual_seed(3)
    state.opt_state.nu.update({k: torch.rand(v.shape, generator=gen)
                               for k, v in state.opt_state.nu.items()})
    tree = state_to_flax(state)
    assert "backbone" in tree["batch_stats"]["style_predictor"]
    view = types.SimpleNamespace(step=tree["step"], params=tree["params"],
                                 batch_stats=tree["batch_stats"],
                                 opt_state=(types.SimpleNamespace(nu=tree["nu"]),))
    back = state_from_flax(view, tm)
    for got, want in ((back.params, state.params), (back.batch_stats, state.batch_stats),
                      (back.opt_state.nu, state.opt_state.nu)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2s_predictor_matches_jax(backbones, dtype):
    n_params = 24
    jdtype, tdtype = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jmod = JPredictor(n_params, feature_extractor="efficientnet", dtype=jdtype)
    # the backbone fixture's V2-S weights under the predictor's head
    rng = np.random.default_rng(9)
    v2s = backbones["v2s"].variables
    head = {name: {"kernel": (rng.standard_normal((1, 1, cin, cout)) / np.sqrt(cin)).astype(
        np.float32), "bias": (0.5 + 0.1 * rng.standard_normal(cout)).astype(np.float32)}
        for name, cin, cout in (("StylePredictor", 1280, 100),
                                ("StyleNormPredictor", 100, n_params))}
    variables = {"params": {"backbone": v2s["params"], **head},
                 "batch_stats": {"backbone": v2s["batch_stats"]}}
    style = np.random.default_rng(5).random((2, 40, 40, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jmod.apply)(variables, style))
    port = load_flax(TPredictor(n_params, "efficientnet", dtype=tdtype), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(style)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, n_params)
    if dtype == "float32":
        close(got, want)
    else:
        close_bf16(got, want)


def test_inference_model_serves_a_v2s_style_vector():
    cfg = TConfig(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
                  num_channels=3, hdr=False, with_depth_loss=False)
    model = make_inference_model(cfg, feature_extractor="efficientnet", device="cpu")
    rng = np.random.default_rng(6)
    style = torch.from_numpy(rng.random((1, 1) + cfg.output_shape, dtype=np.float32))
    content = torch.from_numpy(rng.random((1,) + cfg.content_shape, dtype=np.float32))
    with torch.no_grad():
        params = model.predict_style_params(style)
        frame = model.stylize(content, params)
    assert params.shape == (1, 1, model.plan.num_style_parameters)
    assert frame.shape == (1,) + cfg.output_shape and torch.isfinite(frame).all()
