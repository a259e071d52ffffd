"""The port's depth pretraining (``realtime_style_transfer_torch.depth_pretrain``)
against the JAX package's, on the CPU: the target map, the procedural scene
(equal arrays), the correlation metrics, the ``.npz`` checkpoint round trip
read by either package, and three ``pretrain_on_pairs`` steps from the same
weights (losses within rtol 1e-4; the port's Adam is optax's arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch import depth_pretrain as tdp
from realtime_style_transfer_tpu import depth_pretrain as jdp
from realtime_style_transfer_tpu.models.depth import MidasLite as JMidasLite

torch.set_num_threads(2)
RES = 32


def test_depth_to_target_matches_jax(rng):
    depth = (rng.random((17, 23)) * 50).astype(np.float32)
    depth[3, 4] = -2.0  # clamped at 0
    np.testing.assert_array_equal(tdp.depth_to_target(depth), jdp.depth_to_target(depth))


@pytest.mark.parametrize("seed", [0, 7])
def test_procedural_scene_equals_jax(seed):
    for got, want in zip(tdp.generate_procedural_scene(seed, 64),
                         jdp.generate_procedural_scene(seed, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for (g_rgb, g_t), (w_rgb, w_t) in zip(tdp.synthetic_depth_pairs(2, 48, seed=3),
                                          jdp.synthetic_depth_pairs(2, 48, seed=3)):
        np.testing.assert_array_equal(g_rgb, w_rgb)
        np.testing.assert_array_equal(g_t, w_t)


def test_correlation_metrics_match_jax(rng):
    a = rng.random((20, 30)).astype(np.float32)
    b = (a * 0.7 + rng.random((20, 30)) * 0.3).astype(np.float32)
    for name in ("correlation", "spearman_correlation", "aligned_rmse"):
        assert getattr(tdp, name)(a, b) == getattr(jdp, name)(a, b), name
    flat = np.full((4, 4), 2.0, np.float32)
    assert tdp.spearman_correlation(flat, b[:4, :4]) == 0.0
    assert tdp.aligned_rmse(flat, b[:4, :4]) == jdp.aligned_rmse(flat, b[:4, :4])


def test_npz_checkpoint_round_trip_across_packages(tmp_path, rng):
    variables = {"params": {"enc0_down": {"kernel": rng.random((3, 3, 3, 4), np.float32),
                                          "bias": rng.random(4, np.float32)}}}
    tdp.save_depth_checkpoint(variables, tmp_path / "port.npz")
    jdp.save_depth_checkpoint(variables, tmp_path / "jax.npz")
    for path in ("port.npz", "jax.npz"):
        for load in (tdp.load_depth_checkpoint, jdp.load_depth_checkpoint):
            restored = load(tmp_path / path)
            assert tdp.depth_base_filters(restored) == 4
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(restored["params"]["enc0_down"][leaf],
                                              variables["params"]["enc0_down"][leaf])
    with pytest.raises(ValueError, match="one .npz file"):
        tdp.save_depth_checkpoint(variables, tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="Converting a JAX checkpoint"):
        tdp.load_depth_checkpoint(tmp_path)
    bundled = tdp.load_depth_checkpoint(tdp.BUNDLED_DEPTH_CHECKPOINT)
    assert tdp.depth_base_filters(bundled) == 16


def test_pretrain_on_pairs_three_steps_match_jax():
    pairs = tdp.synthetic_depth_pairs(4, RES, seed=5)
    train, val = pairs[:3], pairs[3:]
    kw = dict(resolution=RES, base_filters=4, epochs=3, batch_size=3, learning_rate=3e-3,
              seed=2, log_every=0)
    jax_vars, jax_hist = jdp.pretrain_on_pairs(train, val, **kw)
    # the JAX function draws its weights from PRNGKey(seed); start the port there
    init = jax.jit(JMidasLite(base_filters=4).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, RES, RES, 3), jnp.float32))
    port_vars, port_hist = tdp.pretrain_on_pairs(
        train, val, variables=jax.tree.map(np.asarray, init), device="cpu", **kw)
    assert len(port_hist["train_loss"]) == 3
    np.testing.assert_allclose(port_hist["train_loss"], jax_hist["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(port_hist["initial_val_correlation"],
                               jax_hist["initial_val_correlation"], rtol=1e-4)
    np.testing.assert_allclose(port_hist["val_correlation"], jax_hist["val_correlation"],
                               rtol=1e-3)
    # three Adam steps move a parameter by at most 3 x lr; the packages agree
    # far inside that
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_vars["params"])[0]:
        got = port_vars["params"]
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, np.asarray(leaf), atol=3e-4)
    scores = tdp.evaluate_depth_checkpoint(port_vars, val, device="cpu")
    assert scores["n"] == 1 and np.isfinite(scores["spearman"])
