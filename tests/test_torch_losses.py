"""The port's loss towers, depth term, train-mode batch norm and RMSprop
against the JAX package, on the CPU with the same numpy weights.

Limits: f32 towers and losses rtol 1e-4 with an absolute floor of 1e-5 of
the largest value (convolutions summed in another order); the loss values of
the TF fixture rtol 1e-4 (the JAX package's own limit there); resizes and
batch norm atol 1e-5; RMSprop rtol 1e-6 (the same f32 operations).
"""

import functools
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtime_style_transfer_torch.models import depth as tdepth
from realtime_style_transfer_torch.models import losses as tlosses
from realtime_style_transfer_torch.models.backbones.vgg import VGG16Features
from realtime_style_transfer_torch.models.layers import BatchNorm
from realtime_style_transfer_torch.ops import image_ops as timg
from realtime_style_transfer_torch.optim import RMSProp, apply_updates
from realtime_style_transfer_torch.weights import load_flax
from realtime_style_transfer_tpu.depth_pretrain import (BUNDLED_DEPTH_CHECKPOINT,
                                                        load_depth_checkpoint)
from realtime_style_transfer_tpu.models import depth as jdepth
from realtime_style_transfer_tpu.models import losses as jlosses
from realtime_style_transfer_tpu.models.backbones import vgg as jvgg
from realtime_style_transfer_tpu.ops import image_ops as jimg

torch.set_num_threads(2)
FIXTURE = Path(__file__).parent / "golden" / "reference" / "loss_dummy"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def close(got, want, rtol=1e-4, floor=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=floor * max(float(np.abs(want).max()), 1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def images(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_vgg_preprocess_gram_and_l2():
    x = images((2, 6, 8, 3), 0)
    close(tlosses.vgg_preprocess(t(x)), jlosses.vgg_preprocess(jnp.asarray(x)))
    f = np.random.default_rng(1).standard_normal((2, 5, 7, 16)).astype(np.float32)
    close(timg.gram_matrix(t(f)), jimg.gram_matrix(jnp.asarray(f)))
    close(timg.mean_l2_loss_on_batch(t(f)), jimg.mean_l2_loss_on_batch(jnp.asarray(f)))
    fb = torch.from_numpy(f).to(torch.bfloat16)
    want = jimg.gram_matrix(jnp.asarray(f).astype(jnp.bfloat16))
    assert timg.gram_matrix(fb).dtype == torch.float32
    close(timg.gram_matrix(fb), want)


@pytest.fixture(scope="module")
def towers():
    """Each extractor's JAX variables (seeded) and the port's module filled
    from them."""
    out = {}
    for name, shape in (("dummy", (2, 16, 16, 3)), ("mobilenet", (2, 64, 64, 3)),
                        ("vgg", (1, 32, 32, 3))):
        jmod = jlosses.LOSS_EXTRACTORS[name]()
        variables = jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.zeros(shape, jnp.float32))
        tmod = load_flax(tlosses.loss_extractor(name), np_tree(variables)).eval()
        out[name] = (jmod, variables, tmod, shape)
    return out


@pytest.mark.parametrize("name", ["dummy", "mobilenet", "vgg"])
def test_extractor_taps_match_jax(towers, name):
    jmod, variables, tmod, shape = towers[name]
    x = images(shape, 4)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(t(x))
    assert tmod.factors == tlosses.LossFactors(*jmod.factors.__dict__.values())
    for kind in ("content", "style"):
        assert set(got[kind]) == set(want[kind])
        for layer in want[kind]:
            close(got[kind][layer], want[kind][layer])


def test_vgg16_features_taps_match_jax():
    """The bare VGG16 on a small image, every tap and the pooled output."""
    jmod = jvgg.VGG16Features()
    x = np.random.default_rng(5).standard_normal((1, 32, 48, 3)).astype(np.float32) * 50
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(6), jnp.asarray(x))
    want_out, want_taps = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    tmod = load_flax(VGG16Features(), np_tree(variables))
    with torch.no_grad():
        got_out, got_taps = tmod(t(x))
    close(got_out, want_out)
    assert set(got_taps) == set(want_taps) == set(jvgg.STYLE_TAPS + jvgg.CONTENT_TAPS)
    for layer in want_taps:
        close(got_taps[layer], want_taps[layer])


@pytest.mark.parametrize("tower_mode", ["split", "batched", "scan"])
def test_style_loss_function_matches_jax(towers, tower_mode):
    jmod, variables, tmod, _ = towers["dummy"]
    pred, gt_c = images((2, 16, 16, 3), 7), images((2, 16, 16, 3), 8)
    gt_s = images((2, 1, 16, 16, 3), 9)
    jfn = jlosses.make_style_loss_function(
        functools.partial(jmod.apply, variables), jmod.factors, tower_mode=tower_mode)
    want = jfn(jnp.asarray(pred), {"content": jnp.asarray(gt_c), "style": jnp.asarray(gt_s)})
    tfn = tlosses.make_style_loss_function(tmod, tmod.factors, tower_mode=tower_mode)
    with torch.no_grad():
        got = tfn(t(pred), {"content": t(gt_c), "style": t(gt_s)})
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key])


def test_style_loss_function_matches_the_tf_fixture():
    """``tests/golden/reference/loss_dummy``: the TF reference's dummy loss
    model, its weights and its loss values."""
    w, io = np.load(FIXTURE / "weights.npz"), np.load(FIXTURE / "io.npz")
    params = {}
    for key in w.files:
        layer, leaf = key.rsplit("/", 1)
        params.setdefault(layer, {})[leaf.replace(":0", "")] = w[key]
    tmod = load_flax(tlosses.DummyLossExtractor(), {"params": params})
    tfn = tlosses.make_style_loss_function(tmod, tlosses.LossFactors(*io["factors"]))
    with torch.no_grad():
        got = tfn(t(io["prediction"]), {"content": t(io["gt_content"]),
                                        "style": t(io["gt_style"])})
    for key in ("loss", "feature_loss", "style_loss", "total_variation_loss"):
        np.testing.assert_allclose(got[key].numpy(), io[f"loss/{key}"], rtol=1e-4, atol=1e-8)


def test_multi_style_and_unported_towers_are_refused(towers):
    tmod = towers["dummy"][2]
    tfn = tlosses.make_style_loss_function(tmod, tmod.factors)
    with pytest.raises(ValueError, match="multiple styles"):
        tfn(t(images((1, 8, 8, 3), 0)), {"content": t(images((1, 8, 8, 3), 1)),
                                          "style": t(images((1, 2, 8, 8, 3), 2))})
    with pytest.raises(ValueError, match="tower_mode"):
        tlosses.make_style_loss_function(tmod, tmod.factors, tower_mode="loop")
    with pytest.raises(ValueError, match="unknown loss extractor"):
        tlosses.loss_extractor("efficientnet_b7")
    # the EfficientNet towers are ported: both build, named as the JAX modules
    assert set(tlosses.LOSS_EXTRACTORS) == set(jlosses.LOSS_EXTRACTORS)
    assert hasattr(tlosses.loss_extractor("efficientnet"), "efficientnetb3")
    assert hasattr(tlosses.loss_extractor("efficientnet_v2s"), "efficientnetv2s")


@pytest.fixture(scope="module")
def midas():
    variables = load_depth_checkpoint(BUNDLED_DEPTH_CHECKPOINT)
    jmod = jdepth.MidasLite(base_filters=int(
        np.asarray(variables["params"]["enc0_down"]["kernel"]).shape[-1]))
    return jmod, variables, tdepth.load_bundled_depth().eval()


def test_midas_lite_with_the_bundled_weights(midas):
    jmod, variables, tmod = midas
    x = images((1, 64, 96, 3), 10)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(t(x))
    assert got.shape == (1, 64, 96)
    close(got, want)


@pytest.mark.parametrize("shape", [(1, 480, 960, 3), (2, 48, 96, 3), (1, 7, 5, 4)])
def test_resize_for_depth_matches_jax(shape):
    """Shrinking (480x960 -> 384x384 antialiases) and growing."""
    x = images(shape, 11)
    want = jdepth.resize_for_depth(jnp.asarray(x))
    np.testing.assert_allclose(tdepth.resize_for_depth(t(x)).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_decoder_upsampling_matches_jax_at_the_edges():
    x = images((1, 5, 6, 3), 12)
    want = jax.image.resize(jnp.asarray(x), (1, 10, 12, 3), "bilinear")
    got = tdepth.resize_bilinear(t(x), (10, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_ssitrim_loss_and_depth_term_match_jax(midas):
    jmod, variables, tmod = midas
    d1, d2 = images((2, 20, 30), 13), images((2, 20, 30), 14)
    close(tdepth.ssitrim_loss(t(d1), t(d2)), jdepth.ssitrim_loss(jnp.asarray(d1),
                                                                jnp.asarray(d2)))
    close(tdepth.normalize_depth(t(d1)), jdepth.normalize_depth(jnp.asarray(d1)))
    gt, pred = images((2, 40, 80, 3), 15), images((2, 40, 80, 3), 16)
    jfn = jdepth.make_depth_loss_fn(lambda im: jmod.apply(variables, im))
    want = jax.jit(jfn)(jnp.asarray(gt), jnp.asarray(pred))
    with torch.no_grad():
        got = tdepth.make_depth_loss_fn(tmod)(t(gt), t(pred))
    assert got.shape == (2,)
    close(got, want, rtol=1e-3)


@pytest.mark.parametrize("momentum", [0.99, 0.999])
def test_batch_norm_train_mode_matches_flax(momentum):
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((3, 5, 6, 8)) * 2 + 1).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": rng.random(8).astype(np.float32) + 0.5,
              "bias": rng.standard_normal(8).astype(np.float32)}
    stats = {"mean": rng.standard_normal(8).astype(np.float32),
             "var": rng.random(8).astype(np.float32) + 0.5}
    want, mutated = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              mutable=["batch_stats"])
    tbn = load_flax(BatchNorm(8, 1e-3, momentum), {"params": params, "batch_stats": stats})
    got = tbn(t(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    new_mean, new_var = tbn.batch_update
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(mutated["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    # the forward leaves the buffers alone; eval mode reads them
    np.testing.assert_array_equal(tbn.running_mean.numpy(), stats["mean"])
    want_eval = fnn.BatchNorm(use_running_average=True, momentum=momentum, epsilon=1e-3).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(tbn(t(x)).detach().numpy(), np.asarray(want_eval),
                               atol=1e-5, rtol=1e-5)


def test_rmsprop_matches_optax():
    rng = np.random.default_rng(18)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    opt = optax.rmsprop(1e-3, decay=0.9, eps=1e-7)
    jstate, jparams = opt.init(params), params
    topt = RMSProp(1e-3, decay=0.9, eps=1e-7)
    tparams = {k: t(v) for k, v in params.items()}
    tstate = topt.init(tparams)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10 ** (step - 2)).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = topt.update({k: t(v) for k, v in grads.items()}, tstate)
        tparams = apply_updates(tparams, tupdates)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate[0].nu[k]),
                                       rtol=1e-6)
