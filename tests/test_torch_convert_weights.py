"""The port's Keras weight converter against the JAX tool's, on seeded dumps.

``python -m realtime_style_transfer_torch.convert_keras_weights`` must build,
from the same Keras-layout ``.npz``, the tree ``tools/convert_keras_weights.py``
builds, bit for bit, for each of the six converters, and write it as an
``.npz`` that ``cli.load_variables`` loads into the port's module.  The dumps
are the inverse of the layout math: each leaf of the port module's flax tree
gets seeded values under its Keras name and layout (a depthwise kernel
transposed back, a transpose-conv kernel flipped and swapped back, a batch
norm's leaves under Keras' names), so the converted tree must also equal the
seeded tree.  ``tests/test_weight_conversion.py`` proves the layout math
against numpy oracles of the TF ops; its in-memory ``.npz`` helper and its
transpose-conv oracle are reused here.  The transfer net loaded from the
port's file must give the JAX net's output on the JAX tool's tree within
1e-5 (f32).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch import cli
from realtime_style_transfer_torch import convert_keras_weights as tconv
from realtime_style_transfer_torch.models.backbones.efficientnet import (EfficientNetB3,
                                                                         EfficientNetV2S)
from realtime_style_transfer_torch.models.backbones.mobilenetv3 import MobileNetV3Small
from realtime_style_transfer_torch.models.backbones.vgg import VGG16Features
from realtime_style_transfer_torch.models.predictor import StylePredictor
from realtime_style_transfer_torch.models.transfer import StyleTransferNet, make_transfer_plan
from realtime_style_transfer_torch.weights import to_flax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import convert_keras_weights as jconv  # noqa: E402
from test_weight_conversion import _npz, tf_conv2d_transpose_same_oracle  # noqa: E402

torch.set_num_threads(2)
BN_LEAVES = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def _walk(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _put(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def seeded(module, seed):
    """The flax tree of ``module`` with seeded values in every leaf (a
    variance in [0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    out = {}
    for (col, *path), v in _walk(to_flax(module.state_dict())):
        value = (rng.random(v.shape) + 0.5 if path[-1] in ("var", "variance")
                 else rng.standard_normal(v.shape)).astype(np.float32)
        _put(out, (col, *path), value)
    return out


def _keras_name(kind, path, backbone):
    """The Keras weight name of a flax ``(collection, *path)`` leaf, and
    whether its layout differs (depthwise, transpose); a predictor's
    backbone is ``backbone``'s."""
    col, *mods, leaf = path
    if kind == "vgg16":
        return f"vgg16/{mods[0]}/{leaf}:0", None
    if kind == "transfer":
        name = BN_LEAVES[leaf] if mods[-1].endswith("_bn") else leaf
        swap = "transpose" if leaf == "kernel" and mods[0].startswith("expand_") else None
        return f"{mods[0]}/{name}", swap
    if kind == "predictor":
        if mods[0] != "backbone":
            return f"{mods[0]}/{leaf}:0", None
        return _keras_name(backbone, (col, *mods[1:], leaf), None)
    bn_leaf = BN_LEAVES[leaf] if mods[-1].endswith("_bn") else leaf
    if kind == "mobilenetv3":
        top = {"stem_conv": "Conv", "stem_bn": "Conv/BatchNorm", "last_conv": "Conv_1",
               "last_bn": "Conv_1/BatchNorm"}
        if mods[0] in top:
            return f"{top[mods[0]]}/{bn_leaf}:0", None
        blk, part = mods[0], mods[1]
        if part == "se":
            conv = {"se_reduce": "Conv", "se_expand": "Conv_1"}[mods[2]]
            return f"{blk}/squeeze_excite/{conv}/{leaf}:0", None
        if part.endswith("_bn"):
            return f"{blk}/{part[:-3]}/BatchNorm/{bn_leaf}:0", None
        if part == "depthwise":
            return f"{blk}/depthwise/depthwise_kernel:0", "depthwise"
        return f"{blk}/{part}/{leaf}:0", None
    # EfficientNet B3 and V2-S
    if mods[0] == "normalization":
        return f"normalization/{leaf}:0", None
    if len(mods) == 1:
        return f"{mods[0]}/{bn_leaf}:0", None
    blk, part = mods
    dw = "dwconv" if kind == "efficientnet_b3" else "dwconv2"
    names = {"expand": "expand_conv", "expand_bn": "expand_bn", "depthwise_bn": "bn",
             "project": "project_conv", "project_bn": "project_bn", "se_reduce": "se_reduce",
             "se_expand": "se_expand"}
    if part == "depthwise":
        return f"{blk}_{dw}/depthwise_kernel:0", "depthwise"
    return f"{blk}_{names[part]}/{bn_leaf}:0", None


def keras_dump(kind, truth, backbone="mobilenetv3"):
    """The Keras-layout arrays of the flax tree ``truth``."""
    dump = {}
    for path, value in _walk(truth):
        name, layout = _keras_name(kind, path, backbone)
        if layout == "depthwise":       # (H, W, 1, C) -> Keras (H, W, C, 1)
            value = np.transpose(value, (0, 1, 3, 2))
        elif layout == "transpose":     # (kh, kw, in, out) -> Keras (kh, kw, out, in), flipped
            value = np.ascontiguousarray(np.transpose(value, (0, 1, 3, 2))[::-1, ::-1])
        dump[name] = value
    return dump


def assert_trees_equal(got, want):
    a, b = dict(_walk(got)), dict(_walk(want))
    assert sorted(a) == sorted(b)
    for path in a:
        assert a[path].dtype == b[path].dtype and a[path].shape == b[path].shape, path
        np.testing.assert_array_equal(a[path], b[path], err_msg=str(path))


def _modules():
    gen = torch.Generator().manual_seed(0)
    plan = make_transfer_plan((120, 240, 3), (120, 240, 3), 15, 4)
    return {"vgg16": VGG16Features(generator=gen),
            "mobilenetv3": MobileNetV3Small(generator=gen),
            "efficientnet_b3": EfficientNetB3(generator=gen),
            "efficientnet_v2s": EfficientNetV2S(generator=gen),
            "transfer": StyleTransferNet(plan, generator=gen),
            "predictor": StylePredictor(plan.num_style_parameters, "mobilenet", generator=gen)}


@pytest.fixture(scope="module")
def modules():
    return _modules()


@pytest.mark.parametrize("kind", sorted(tconv.CONVERTERS))
def test_each_converter_matches_the_jax_tool_and_loads(kind, modules, tmp_path, capsys):
    module = modules[kind]
    truth = seeded(module, seed=len(kind))
    dump = keras_dump(kind, truth)
    path = tmp_path / "dump.npz"
    np.savez(path, **dump)
    out = tconv.main([kind, str(path), str(tmp_path / f"{kind}.npz")])
    assert f"converted {kind}: {sum(v.size for v in dump.values()):,} source values" in \
        capsys.readouterr().out
    got = cli.load_variables(out, module)
    want = jconv.CONVERTERS[kind](_npz(dump))
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    assert_trees_equal(got, truth)


@pytest.mark.parametrize("rescale", [False, True])
def test_efficientnet_b3_normalization_and_pruned_top(rescale, modules):
    """The loss tower's dump without top_conv/top_bn (zeros and ones fill
    them) and the ImageNet rescale folded into the normalization variance,
    as the JAX tool does."""
    truth = seeded(modules["efficientnet_b3"], seed=7)
    dump = {k: v for k, v in keras_dump("efficientnet_b3", truth).items()
            if not k.startswith("top_")}
    got = tconv.convert("efficientnet_b3", _npz(dump), imagenet_rescale=rescale)
    want = jconv.convert_efficientnet_b3(_npz(dump), imagenet_rescale=rescale)
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    norm = truth["batch_stats"]["normalization"]
    np.testing.assert_array_equal(got["batch_stats"]["normalization"]["variance"],
                                  norm["variance"] * (tconv.IMAGENET_STDDEV_RGB if rescale
                                                      else 1))
    assert not got["params"]["top_conv"]["kernel"].any()


def test_predictor_with_the_v2s_backbone_and_the_dummy_head(modules):
    gen = torch.Generator().manual_seed(1)
    for fe in ("efficientnet", "dummy"):
        module = StylePredictor(40, fe, generator=gen)
        truth = seeded(module, seed=11)
        dump = keras_dump("predictor", truth, backbone="efficientnet_v2s")
        got = tconv.convert_predictor(_npz(dump))
        assert_trees_equal(got, jax.tree.map(np.asarray, jconv.convert_predictor(_npz(dump))))
        assert_trees_equal(got, truth)


def test_refusals_match_the_jax_tool():
    for fn, arrays, match in (
            ("convert_vgg16", {"vgg16/block1_conv1/kernel:0": np.zeros((3, 3, 3, 4))}, "missing"),
            ("convert_transfer", {"contract_0_bn/epsilon": np.zeros(1)}, "unknown BN leaf"),
            ("convert_predictor", {"StylePredictor/kernel:0": np.zeros(1)},
             "missing head conv StyleNormPredictor"),
            ("convert_predictor", {"StylePredictor/kernel:0": np.zeros(1),
                                   "StyleNormPredictor/kernel:0": np.zeros(1),
                                   "mystery/kernel:0": np.zeros(1)}, "unrecognized backbone")):
        with pytest.raises(SystemExit, match=match) as mine:
            getattr(tconv, fn)(_npz(arrays))
        with pytest.raises(SystemExit) as theirs:
            getattr(jconv, fn)(_npz(arrays))
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="rank-4"):
        tconv.convert_conv_transpose_kernel(np.zeros((3, 3, 4)))
    with pytest.raises(SystemExit):
        tconv.main(["resnet50", "x.npz", "y.npz"])


def test_transfer_net_from_the_ports_file_matches_the_jax_net(tmp_path):
    """A seeded transfer dump -> the port's .npz -> cli.load_variables into
    the eager net, against JAX's StyleTransferNet on the JAX tool's tree;
    and one expand kernel against tests/test_weight_conversion.py's numpy
    oracle of Keras' Conv2DTranspose."""
    from realtime_style_transfer_tpu.models.transfer import StyleTransferNet as JNet
    from realtime_style_transfer_tpu.models.transfer import make_transfer_plan as jplan

    plan = make_transfer_plan((64, 128, 3), (64, 128, 3), 16, 8)
    net = StyleTransferNet(plan, generator=torch.Generator().manual_seed(2))
    truth = seeded(net, seed=5)
    dump = keras_dump("transfer", truth)
    np.savez(tmp_path / "transfer_keras.npz", **dump)
    out = tconv.main(["transfer", str(tmp_path / "transfer_keras.npz"),
                      str(tmp_path / "transfer.npz")])
    cli.load_variables(out, net)
    rng = np.random.default_rng(6)
    content = rng.random((1, 64, 128, 3)).astype(np.float32)
    params = (rng.random((1, 1, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(content), torch.from_numpy(params)).numpy()
    jnet = JNet(plan=jplan((64, 128, 3), (64, 128, 3), 16, 8))
    want = np.asarray(jnet.apply(jconv.convert_transfer(_npz(dump)), jnp.asarray(content),
                                 jnp.asarray(params), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the port's expand_0 kernel reproduces Keras' Conv2DTranspose
    x = rng.standard_normal((4, 5, 8)).astype(np.float32)
    keras_kernel = dump["expand_0_conv/kernel"]
    want_y = tf_conv2d_transpose_same_oracle(x, keras_kernel.astype(np.float64), 2)
    from realtime_style_transfer_torch.ops.conv import conv_transpose_2x

    w = torch.from_numpy(tconv.convert_conv_transpose_kernel(keras_kernel))
    got_y = conv_transpose_2x(torch.from_numpy(x)[None], w)[0].numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
