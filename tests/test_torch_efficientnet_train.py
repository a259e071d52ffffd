"""The port's training step with the EfficientNet B3 loss tower against the
JAX package's on the CPU, and the trainer CLI with ``--loss efficientnet``.

The JAX training model is built with the dummy tower and then given the B3
tower with seeded weights (its own ``init`` of B3 under jit takes tens of
seconds on the CPU), as its constructor builds it: the loss function over
the tower's ``apply``, factors 1.  Limits, ``tests/test_torch_training.py``'s
(TINY: a dummy predictor, f32): metrics rtol 1e-4, batch statistics 1e-5,
updated parameters 1e-5 where the gradient is above the f32 noise floor (1e-6
of the largest) and within two RMSprop first-step updates (6.4e-3) where it
is not.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch import train_network
from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.training import make_style_transfer_training_model
from realtime_style_transfer_torch.weights import load_flax, state_to_flax
from realtime_style_transfer_tpu.config import ShapeConfig as JShapeConfig
from realtime_style_transfer_tpu.models import losses as jlosses
from realtime_style_transfer_tpu.models.training import TrainState as JTrainState
from realtime_style_transfer_tpu.models.training import \
    make_style_transfer_training_model as jax_training_model
from test_torch_efficientnet_towers import tower_variables

torch.set_num_threads(2)
TINY = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
            num_channels=3, hdr=False, feature_extractor="dummy", with_depth_loss=False)
LR_STEP = 2 * 1e-3 / np.sqrt(1 - 0.9)   # the most two RMSprop updates can differ


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def train_step():
    """One JAX train step with the B3 tower from the port's initial state."""
    cfg = JShapeConfig(**TINY)
    jtm = jax_training_model(cfg, loss_extractor="dummy")
    jtm.loss_module = jlosses.EfficientNetLossExtractor()
    jtm.loss_variables = tower_variables("efficientnet", jtm.loss_module)
    jtm.compute_loss = jlosses.make_style_loss_function(
        lambda imgs: jtm.loss_module.apply(jtm.loss_variables, imgs), jtm.loss_module.factors,
        tower_mode="split")
    port = make_style_transfer_training_model(ShapeConfig(**TINY), loss_extractor="efficientnet",
                                              device="cpu")
    load_flax(port.loss_module, jtm.loss_variables)
    state0 = port.init_state()
    tree = state_to_flax(state0)
    params = jax.tree.map(jnp.asarray, tree["params"])
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                     opt_state=jtm.optimizer.init(params))
    rng = np.random.default_rng(0)
    inputs = {k: rng.random((2,) + s, dtype=np.float32) for k, s in cfg.input_shape.items()}
    batch = (inputs, {"content": inputs["content"][..., :3], "style": inputs["style"]})
    js, metrics = jax.jit(jtm.train_step)(js, jax.tree.map(jnp.asarray, batch))
    return dict(port=port, state0=state0, batch=batch, state=jax.tree.map(np.asarray, js),
                metrics={k: float(v) for k, v in metrics.items()})


def test_train_step_with_the_b3_tower_matches_jax(train_step):
    port, want = train_step["port"], train_step["state"]
    _, _, _, grads = port.value_and_grad(train_step["state0"], train_step["batch"])
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    state, metrics = port.train_step(train_step["state0"], train_step["batch"])
    assert set(metrics) == set(train_step["metrics"])
    for key, value in train_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=1e-4, err_msg=key)
    got = state_to_flax(state)
    assert got["step"] == 1
    for path, value in _leaves(want.batch_stats):
        np.testing.assert_allclose(_get(got["batch_stats"], path), value, rtol=1e-5, atol=1e-5)
    nu = want.opt_state[0].nu
    leaves = list(_leaves(want.params))
    assert len(leaves) == len(state.params)
    for path, value in leaves:
        err = np.abs(_get(got["params"], path) - value)
        noisy = _get(nu, path) <= 0.1 * (2 * floor) ** 2
        assert err[~noisy].max(initial=0.0) <= 1e-5, path
        assert err.max(initial=0.0) <= LR_STEP, path


def test_trainer_cli_with_the_b3_tower_writes_its_run(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    for sub in ("training", "validation"):
        for kind in ("content", "style"):
            (root / kind / sub).mkdir(parents=True)
            for i in range(3):
                PIL.Image.fromarray((rng.random((70, 130, 3)) * 255).astype(np.uint8)).save(
                    root / kind / sub / f"{i}.png")
    run = train_network.main([
        "--device", "cpu", "--network_spec", "rst-120-15-4-3", "--sdr", "--loss",
        "efficientnet", "--no_depth_loss", "--epochs", "1", "--batch_size", "2",
        "--log_dir", str(tmp_path / "run"), "--content_dir", str(root / "content"),
        "--style_dir", str(root / "style"), "--dtype", "float32"])
    tags = {json.loads(line).get("tag") for line in (run / "metrics.jsonl").open()}
    assert {"training/loss", "validation/loss"} <= tags
    assert (run / "weights" / "latest_epoch_weights.npz").is_file()
    assert [p.name for p in (run / "latest_ckpt").iterdir()] == ["0.npz"]
    assert any((run / "images").glob("*.png"))
