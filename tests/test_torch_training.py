"""The port's training step against the JAX package's, on the CPU.

Holds ``realtime_style_transfer_torch.models.training`` against
``tests/test_training.py``'s model: TINY (dummy predictor, dummy loss, f32)
and TINY with 64 bottleneck filters, where ``use_pallas=True`` sends the ten
residual CINs to the CIN kernel (its plain version here; JAX's ``cin_pallas``
in interpret mode).  Both packages start from the port's seeded weights,
carried to JAX through ``weights.state_to_flax``, and see the same numpy
batch.

Limits.  Loss and metrics: rtol 1e-4.  Gradients: rtol 1e-3 plus an
absolute floor of 1e-6 of the largest gradient (the f32 noise floor: the
gradient of a bias in front of an instance norm is zero up to rounding).
Updated parameters: 1e-5, except where the gradient lies under that floor:
RMSprop's first steps turn any gradient into an update of about lr /
sqrt(1 - decay), so there two packages' rounding noise may move a parameter
by up to twice that, 6.4e-3 a step.  ``nu`` is compared as its square root
(a running RMS of the gradients): rtol 2e-3 plus sqrt(0.1 n) x 2 x floor
after n steps.  Batch statistics: 1e-5.  These hold for one step from a
common state, the first and the third (from JAX's second state).  Along the
port's own three steps the noise-driven updates of the first step feed the
next forwards, so the port's third state is held to looser limits, set from
the measured spread: batch statistics rtol 1e-2 (measured 6.4e-3), every
parameter within the noise bound of one step, 6.4e-3 (measured 2.9e-3); the
metrics keep rtol 1e-4 (measured 3.6e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.depth import (BUNDLED_DEPTH_CHECKPOINT,
                                                        load_depth_checkpoint)
from realtime_style_transfer_torch.models.training import (
    TrainState, make_style_transfer_training_model)
from realtime_style_transfer_torch.ops import cin as tcin
from realtime_style_transfer_torch.weights import load_flax, state_from_flax, state_to_flax
from realtime_style_transfer_tpu.config import ShapeConfig as JShapeConfig
from realtime_style_transfer_tpu.models.training import TrainState as JTrainState
from realtime_style_transfer_tpu.models.training import \
    make_style_transfer_training_model as jax_training_model

torch.set_num_threads(2)
TINY = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
            num_channels=3, hdr=False, feature_extractor="dummy", with_depth_loss=False)
TINY64 = dict(TINY, bottleneck_num_filters=64)
LR_STEP = 2 * 1e-3 / np.sqrt(1 - 0.9)   # the most two RMSprop updates can differ
METRICS = {"loss", "feature_loss", "style_loss", "total_variation_loss"}


def _batch(cfg, batch_size=2, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {name: rng.random((batch_size,) + shape, dtype=np.float32)
              for name, shape in cfg.input_shape.items()}
    return inputs, {"content": inputs["content"][..., :3], "style": inputs["style"]}


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


def _port(kw, like=None, **options):
    """The port's training model on the CPU; ``like`` lends it its loss tower."""
    port = make_style_transfer_training_model(ShapeConfig(**kw), loss_extractor="dummy",
                                              device="cpu", **options)
    if like is not None:
        port.loss_module.load_state_dict(like.loss_module.state_dict())
    return port


def _jax_state(port_state, jtm):
    tree = state_to_flax(port_state)
    params = jax.tree.map(jnp.asarray, tree["params"])
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                       opt_state=jtm.optimizer.init(params))


def _reference(kw, *, use_pallas=False, dtype=jnp.float32, steps=3, grads=True,
               evaluate=False):
    """The port's model and initial state, and JAX's steps from the same
    weights: states and metrics after each step, the gradients at the
    start, the eval metrics."""
    cfg = JShapeConfig(**kw)
    port = _port(kw, use_pallas=use_pallas,
                 dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    jtm = jax_training_model(cfg, loss_extractor="dummy", use_pallas=use_pallas, dtype=dtype)
    load_flax(port.loss_module, jax.tree.map(np.asarray, jtm.loss_variables))
    state0 = port.init_state()
    js = _jax_state(state0, jtm)
    batch = _batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    out = {"port": port, "state0": state0, "batch": batch, "states": [], "metrics": []}
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jtm.train_step)
        if grads:
            out["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: jtm.loss_and_metrics(p, js.batch_stats, jbatch, train=True)[0]))(
                    js.params))
        if evaluate:
            out["eval"] = {k: float(v) for k, v in jax.jit(jtm.eval_step)(js, jbatch).items()}
        for _ in range(steps):
            js, metrics = step(js, jbatch)
            out["states"].append(jax.tree.map(np.asarray, js))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
    return out


@pytest.fixture(scope="module")
def tiny():
    return _reference(TINY, evaluate=True)


@pytest.fixture(scope="module")
def tiny64():
    return _reference(TINY64, use_pallas=True)


def _gmax(grads):
    return max(float(np.abs(v).max()) for _, v in _leaves(grads))


def _check_state(port_state, jax_state, floor, n_steps):
    got = state_to_flax(port_state)
    assert got["step"] == int(jax_state.step)
    for path, want in _leaves(jax_state.batch_stats):
        np.testing.assert_allclose(_get(got["batch_stats"], path), want, rtol=1e-5, atol=1e-5)
    nu = jax.tree.map(np.asarray, jax_state.opt_state[0].nu)
    for path, want in _leaves(nu):
        np.testing.assert_allclose(np.sqrt(_get(got["nu"], path)), np.sqrt(want), rtol=2e-3,
                                   atol=np.sqrt(0.1 * n_steps) * 2 * floor, err_msg=str(path))
    for path, want in _leaves(jax_state.params):
        err = np.abs(_get(got["params"], path) - want)
        # a gradient under the noise floor leaves nu under 0.1 x floor^2 per step
        noisy = _get(nu, path) <= 0.1 * (2 * floor) ** 2 * n_steps
        assert err[~noisy].max(initial=0.0) <= 1e-5, path
        assert err.max(initial=0.0) <= LR_STEP * n_steps, path


@pytest.mark.parametrize("name", ["tiny", "tiny64"])
def test_gradients_match_jax(name, request):
    ref = request.getfixturevalue(name)
    port = ref["port"]
    _, _, _, grads = port.value_and_grad(ref["state0"], ref["batch"])
    got = state_to_flax(TrainState(ref["state0"].step, grads, {}, port.optimizer.init(grads)))
    floor = 1e-6 * _gmax(ref["grads"])
    for path, want in _leaves(ref["grads"]):
        np.testing.assert_allclose(_get(got["params"], path), want, rtol=1e-3, atol=floor,
                                   err_msg=str(path))


def _check_metrics(metrics, want):
    assert set(metrics) == METRICS
    for key, value in want.items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", ["tiny", "tiny64"])
def test_train_steps_match_jax(name, n_steps, request):
    """The n-th step from JAX's state n - 1, and for n = 3 the port's own
    three steps."""
    ref = request.getfixturevalue(name)
    port, floor = ref["port"], 1e-6 * _gmax(ref["grads"])
    start = ref["state0"] if n_steps == 1 else state_from_flax(ref["states"][n_steps - 2], port)
    state, metrics = port.train_step(start, ref["batch"])
    _check_metrics(metrics, ref["metrics"][n_steps - 1])
    _check_state(state, ref["states"][n_steps - 1], floor, n_steps)
    if n_steps == 1:
        return
    state = ref["state0"]
    for i in range(n_steps):
        state, metrics = port.train_step(state, ref["batch"])
        _check_metrics(metrics, ref["metrics"][i])
    got, want = state_to_flax(state), ref["states"][-1]
    assert got["step"] == n_steps
    for path, value in _leaves(want.batch_stats):
        np.testing.assert_allclose(_get(got["batch_stats"], path), value, rtol=1e-2, atol=1e-4)
    for path, value in _leaves(want.params):
        assert np.abs(_get(got["params"], path) - value).max() <= LR_STEP, path


def test_state_round_trips_through_jax_layouts(tiny):
    """``state_from_flax`` of ``state_to_flax`` gives the state back."""
    port = tiny["port"]
    state, _ = port.train_step(tiny["state0"], tiny["batch"])
    tree = state_to_flax(state)
    jax_like = dataclasses.make_dataclass("S", ["step", "params", "batch_stats", "opt_state"])(
        tree["step"], tree["params"], tree["batch_stats"],
        (type("Rms", (), {"nu": tree["nu"]})(),))
    back = state_from_flax(jax_like, port)
    for a, b in ((state.params, back.params), (state.batch_stats, back.batch_stats),
                 (state.opt_state.nu, back.opt_state.nu)):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_eval_step_metrics_match_jax(tiny):
    got = tiny["port"].eval_step(tiny["state0"], tiny["batch"])
    assert set(got) == METRICS
    for key, want in tiny["eval"].items():
        np.testing.assert_allclose(float(got[key]), want, rtol=1e-4, err_msg=key)


def test_loss_falls_over_steps(tiny):
    port = tiny["port"]
    state, first = port.train_step(tiny["state0"], tiny["batch"])
    for _ in range(5):
        state, metrics = port.train_step(state, tiny["batch"])
    assert int(state.step) == 6
    assert float(metrics["loss"]) < float(first["loss"])


def test_depth_component_present():
    port = _port(TINY, with_depth_loss=True,
                 depth_variables=load_depth_checkpoint(BUNDLED_DEPTH_CHECKPOINT))
    metrics = port.eval_step(port.init_state(), _batch(ShapeConfig(**TINY)))
    assert set(metrics) == METRICS | {"depth_loss"}
    assert np.isfinite(float(metrics["depth_loss"])) and float(metrics["depth_loss"]) > 0


def test_remat_equals_the_plain_step_and_updates_statistics_once(tiny64):
    plain, batch = tiny64["port"], tiny64["batch"]
    remat = _port(TINY64, plain, use_pallas=True, remat=True)
    state0 = tiny64["state0"]
    s_plain, m_plain = plain.train_step(state0, batch)
    s_remat, m_remat = remat.train_step(state0, batch)
    for key in m_plain:
        np.testing.assert_allclose(float(m_remat[key]), float(m_plain[key]), rtol=1e-5,
                                   atol=1e-6)
    for key, value in s_plain.params.items():
        torch.testing.assert_close(s_remat.params[key], value, rtol=1e-5, atol=1e-6)
    # one update: m * running + (1 - m) * batch, not applied twice
    for key, value in s_plain.batch_stats.items():
        torch.testing.assert_close(s_remat.batch_stats[key], value, rtol=0, atol=0)
    moved = [k for k in state0.batch_stats
             if not torch.equal(state0.batch_stats[k], s_plain.batch_stats[k])]
    assert len(moved) == len(state0.batch_stats)


def test_use_pallas_equals_the_plain_cin_on_the_cpu(tiny64):
    """On the CPU the kernel's plain version runs (f32, one rounding): the
    step equals ``use_pallas=False`` within the kernel's f32 limit, and no
    kernel launch is counted."""
    without = _port(TINY64, tiny64["port"])
    tcin.reset_launch_counts()
    s_on, m_on = tiny64["port"].train_step(tiny64["state0"], tiny64["batch"])
    s_off, m_off = without.train_step(tiny64["state0"], tiny64["batch"])
    assert (tcin.cin_forward.launches, tcin.cin_backward.launches) == (0, 0)
    for key in m_on:
        np.testing.assert_allclose(float(m_on[key]), float(m_off[key]), rtol=2e-4)


def test_bf16_step_is_finite_and_near_jax():
    """bf16 compute over f32 parameters: metrics within rtol 0.05 / atol
    0.02 of JAX's bf16 step (the port's bf16 limit)."""
    ref = _reference(TINY, dtype=jnp.bfloat16, steps=1, grads=False)
    state, metrics = ref["port"].train_step(ref["state0"], ref["batch"])
    for key, want in ref["metrics"][0].items():
        assert np.isfinite(float(metrics[key])), key
        np.testing.assert_allclose(float(metrics[key]), want, rtol=0.05, atol=0.02,
                                   err_msg=key)
    assert all(v.dtype == torch.float32 for v in state.params.values())
