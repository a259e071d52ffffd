"""The port's trainer (``realtime_style_transfer_torch.trainer`` with its
callbacks and ``.npz`` checkpoints) against the JAX package's
``Trainer.fit``, on the CPU.

Both fit ``tests/test_trainer.py``'s TINY model (dummy predictor, dummy loss
tower, f32) for 2 epochs of 2 seeded batches with every callback on (metrics,
checkpoints, summary images every epoch; weight histograms and gradients
every 5 epochs, as ``train_network`` sets them: at epoch 0),
from the same weights: the port's seeded state carried to JAX through
``weights.state_to_flax``, and JAX's loss tower loaded into the port's.

Limits.  The metrics streams have the same tags.  The loss components:
rtol 1e-4 in epoch 0 and 1e-3 in epoch 1, or twice the reference's own
spread where that is wider.  RMSprop's first steps turn gradients that are
rounding noise into full-size updates, and those feed the next forwards: the
JAX fit itself, started from its weights moved by one ulp at random, moved
the total variation loss (which dominates the loss at these random weights)
by up to 1.8e-4 in epoch 0's validation and 2.7e-3 in epoch 1's over four
such starts, more than the port differs from it there (9.7e-5, 1.7e-3).  So
the fixture repeats JAX's steps from four such starts and takes each loss's
spread over them.  Parameters: within n_steps x the most two RMSprop updates
can differ (``LR_STEP`` of ``tests/test_torch_training.py``).
Batch statistics: rtol 1e-2 + atol 1e-4.  Also: the checkpoint schedule
against Orbax's (the JAX CheckpointManager's), resume bit for bit against an
uninterrupted run, the weights artifact through ``cli.load_variables`` and
the refusal of a device mesh.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.models.training import make_style_transfer_training_model
from realtime_style_transfer_torch.tracing import callbacks as tcb
from realtime_style_transfer_torch.tracing.checkpoint import CheckpointManager
from realtime_style_transfer_torch.tracing.metrics import MetricsWriter
from realtime_style_transfer_torch.trainer import Trainer
from realtime_style_transfer_torch.weights import load_flax, state_to_flax
from realtime_style_transfer_tpu import trainer as jtrainer
from realtime_style_transfer_tpu.config import ShapeConfig as JConfig
from realtime_style_transfer_tpu.models.training import TrainState as JTrainState
from realtime_style_transfer_tpu.models.training import \
    make_style_transfer_training_model as jax_training_model
from realtime_style_transfer_tpu.tracing import callbacks as jcb
from realtime_style_transfer_tpu.tracing import checkpoint as jckpt
from realtime_style_transfer_tpu.tracing import metrics as jmetrics

torch.set_num_threads(2)
TINY = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
            num_channels=3, hdr=False, feature_extractor="dummy", with_depth_loss=False)
LR_STEP = 2 * 1e-3 / np.sqrt(1 - 0.9)   # the most two RMSprop updates can differ
EPOCHS, N_BATCHES = 2, 2
EVERY = 5   # the histogram and gradient callbacks' period, as train_network sets it
LOSSES = ("loss", "feature_loss", "style_loss", "total_variation_loss")


def _batches(cfg, n_batches=N_BATCHES, batch_size=2, seed=0):
    """tests/test_trainer.py's seeded batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        inputs = {name: rng.random((batch_size,) + shape, dtype=np.float32)
                  for name, shape in cfg.input_shape.items()}
        out.append((inputs, {"content": inputs["content"][..., :3], "style": inputs["style"]}))
    return out


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


def _port_fit(tm, state, batches, log_dir, epochs=EPOCHS, initial_epoch=0, cadence=1):
    writer = MetricsWriter(log_dir)
    ckpts = CheckpointManager(log_dir, cadence=cadence, keep=2)
    trainer = Trainer(tm, log_dir=log_dir, metrics_writer=writer, callbacks=[
        tcb.MetricsCallback(writer), tcb.CheckpointCallback(ckpts),
        tcb.SummaryImageCallback(log_dir, tm, batches[0], batches[1]),
        tcb.HistogramCallback(writer, every=EVERY),
        tcb.GradientsCallback(writer, tm, batches[0], every=EVERY)])
    state = trainer.fit(state, lambda: iter(batches), lambda: iter(batches), epochs=epochs,
                        initial_epoch=initial_epoch)
    writer.close()
    return trainer, state


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The port's and JAX's 2-epoch fits from the same weights."""
    cfg = JConfig(**TINY)
    tm = make_style_transfer_training_model(TConfig(**TINY), loss_extractor="dummy",
                                            device="cpu", seed=0)
    jtm = jax_training_model(cfg, loss_extractor="dummy")
    load_flax(tm.loss_module, jax.tree.map(np.asarray, jtm.loss_variables))
    state0 = tm.init_state()
    tree = state_to_flax(state0)
    params = jax.tree.map(jnp.asarray, tree["params"])
    jstate0 = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                          opt_state=jtm.optimizer.init(params))
    batches = _batches(cfg)

    jdir = tmp_path_factory.mktemp("jax_run")
    jwriter = jmetrics.MetricsWriter(jdir)
    jckpts = jckpt.CheckpointManager(jdir, cadence=1, keep=2)
    jt = jtrainer.Trainer(jtm, log_dir=jdir, metrics_writer=jwriter, callbacks=[
        jcb.MetricsCallback(jwriter), jcb.CheckpointCallback(jckpts),
        jcb.SummaryImageCallback(jdir, jtm, batches[0], batches[1]),
        jcb.HistogramCallback(jwriter, every=EVERY),
        jcb.GradientsCallback(jwriter, jtm, batches[0], every=EVERY)])
    spread = _jax_spread(jstate0, batches, jt._train_step, jt._eval_step)
    # the JAX trainer's jitted step donates its state: hand it a copy
    jstate = jt.fit(jax.tree.map(jnp.array, jstate0), lambda: iter(batches),
                    lambda: iter(batches), epochs=EPOCHS)
    jckpts.close()
    jwriter.close()

    pdir = tmp_path_factory.mktemp("port_run")
    trainer, state = _port_fit(tm, state0, batches, pdir)
    return dict(tm=tm, state0=state0, state=state, trainer=trainer, batches=batches,
                jstate=jax.tree.map(np.asarray, jstate), pdir=pdir, jdir=jdir,
                jstate0=jstate0, spread=spread)


def _jax_losses(state, batches, train_step, eval_step):
    """{(tag, epoch): value} of the loss components of a fit of JAX's steps
    from a copy of ``state`` (the trainer's jitted step donates it)."""
    state = jax.tree.map(jnp.array, state)
    out = {}
    for epoch in range(EPOCHS):
        sums = {}
        for batch in batches:
            state, metrics = train_step(state, batch)
            for k, v in metrics.items():
                sums[f"training/{k}"] = sums.get(f"training/{k}", 0.0) + float(v)
        for batch in batches:
            for k, v in eval_step(state, batch).items():
                sums[f"validation/{k}"] = sums.get(f"validation/{k}", 0.0) + float(v)
        out.update({(k, epoch): v / len(batches) for k, v in sums.items()})
    return out


def _jax_spread(jstate0, batches, train_step, eval_step, trials=4):
    """The largest relative change of each loss of JAX's own fit when its
    starting weights move by one ulp (a random sign an element)."""
    base = _jax_losses(jstate0, batches, train_step, eval_step)
    rng = np.random.default_rng(0)
    spread = dict.fromkeys(base, 0.0)
    for _ in range(trials):
        params = jax.tree.map(lambda x: x * jnp.asarray(
            1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -23, jnp.float32), jstate0.params)
        moved = _jax_losses(jstate0.replace(params=params), batches, train_step, eval_step)
        for key, value in base.items():
            spread[key] = max(spread[key], abs(moved[key] - value) / abs(value))
    return spread


def _events(log_dir):
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").open()]


def test_fit_writes_the_jax_tag_set_and_artifacts(fits):
    got, want = _events(fits["pdir"]), _events(fits["jdir"])
    assert {e["tag"] for e in got} == {e["tag"] for e in want}
    assert sorted((e["tag"], e["step"]) for e in got) == sorted(
        (e["tag"], e["step"]) for e in want)
    hist = [e for e in got if "histogram" in e]
    assert any(e["tag"].startswith("gradients/") for e in hist)
    for e in hist:
        h = e["histogram"]
        assert len(h["bucket"]) == len(h["bucket_limit"]) == tcb.NUM_HISTOGRAM_BINS
        assert sum(h["bucket"]) == h["num"] > 0
    pdir = fits["pdir"]
    assert sorted(p.name for p in (pdir / "images").glob("*.png")) == sorted(
        p.name for p in (fits["jdir"] / "images").glob("*.png"))
    assert [p.name for p in sorted((pdir / "ckpt").iterdir())] == ["0.npz", "1.npz"]
    assert [p.name for p in (pdir / "latest_ckpt").iterdir()] == ["1.npz"]
    assert (pdir / "weights" / "latest_epoch_weights.npz").is_file()
    assert int(fits["state"].step) == EPOCHS * N_BATCHES
    assert [t[0] for t in fits["trainer"].timings] == [0, 0, 1, 1]


def test_fit_losses_match_jax(fits):
    def scalars(log_dir):
        return {(e["tag"], e["step"]): e["value"] for e in _events(log_dir) if "value" in e}

    got, want = scalars(fits["pdir"]), scalars(fits["jdir"])
    checked = 0
    for (tag, step), value in want.items():
        split, _, name = tag.partition("/")
        if split in ("training", "validation") and name in LOSSES:
            rtol = max(1e-4 if step == 0 else 1e-3, 2 * fits["spread"][(tag, step)])
            np.testing.assert_allclose(got[(tag, step)], value, rtol=rtol,
                                       err_msg=f"{tag} epoch {step}")
            checked += 1
        elif tag == "training/steps":
            assert got[(tag, step)] == value == N_BATCHES
    assert checked == 2 * len(LOSSES) * EPOCHS


def test_fit_state_matches_jax(fits):
    got, want = state_to_flax(fits["state"]), fits["jstate"]
    assert got["step"] == int(want.step) == EPOCHS * N_BATCHES
    for path, value in _leaves(want.params):
        assert np.abs(_get(got["params"], path) - value).max() <= LR_STEP * EPOCHS * N_BATCHES, \
            path
    for path, value in _leaves(want.batch_stats):
        np.testing.assert_allclose(_get(got["batch_stats"], path), value, rtol=1e-2, atol=1e-4,
                                   err_msg=str(path))


SCHEDULES = [(2, 2, range(5)), (2, 2, range(3, 8)), (3, 5, range(12)), (1, 5, range(7))]


@pytest.mark.parametrize("cadence,keep,epochs", SCHEDULES)
def test_checkpoint_schedule_matches_orbax(fits, tmp_path, cadence, keep, epochs):
    port = CheckpointManager(tmp_path / "port", cadence=cadence, keep=keep)
    orbax = jckpt.CheckpointManager(tmp_path / "jax", cadence=cadence, keep=keep)
    for epoch in epochs:
        port.save_epoch(epoch, fits["state0"])
        orbax.save_epoch(epoch, fits["jstate0"])
    orbax.wait()
    orbax.close()

    def kept(directory):
        return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit())

    assert port.epochs() == kept(tmp_path / "jax" / "ckpt")
    assert [port.latest_epoch()] == kept(tmp_path / "jax" / "latest_ckpt")


def test_resume_is_bit_exact(fits, tmp_path):
    tm, state0, batches = fits["tm"], fits["state0"], fits["batches"]
    trainer = Trainer(tm)
    restored, epoch = trainer.resume(tm.init_state(), CheckpointManager(fits["pdir"]))
    assert epoch == EPOCHS
    saved = fits["state"]
    assert restored.step.dtype == saved.step.dtype and int(restored.step) == int(saved.step)
    for got, want in ((restored.params, saved.params), (restored.batch_stats, saved.batch_stats),
                      (restored.opt_state.nu, saved.opt_state.nu)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    _, resumed = _port_fit(tm, restored, batches, tmp_path / "resumed", epochs=EPOCHS + 1,
                           initial_epoch=epoch)
    _, straight = _port_fit(tm, state0, batches, tmp_path / "straight", epochs=EPOCHS + 1)
    assert int(resumed.step) == int(straight.step) == (EPOCHS + 1) * N_BATCHES
    for got, want in ((resumed.params, straight.params),
                      (resumed.batch_stats, straight.batch_stats),
                      (resumed.opt_state.nu, straight.opt_state.nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # nothing to resume from: the state comes back as it was, from epoch 0
    fresh = tm.init_state()
    same, start = trainer.resume(fresh, CheckpointManager(tmp_path / "empty"))
    assert same is fresh and start == 0


def test_weights_artifact_loads_through_the_cli(fits):
    model = make_inference_model(TConfig(**TINY), device="cpu", seed=9)
    variables = tcli.load_variables(fits["pdir"], model)
    assert set(variables) == {"params", "batch_stats"}
    state = fits["state"]
    named = dict(model.named_parameters())
    for k, v in state.params.items():
        assert torch.equal(named[k], v), k
    inputs = fits["batches"][0][0]
    with torch.no_grad():
        got = model(torch.from_numpy(inputs["content"]), torch.from_numpy(inputs["style"]))
    assert torch.equal(got, fits["tm"].predict(state, inputs))
    with pytest.raises(ValueError, match="Converting a JAX checkpoint"):
        tcli.load_variables(fits["jdir"], model)   # an Orbax run directory


def test_mesh_is_refused(fits):
    """No longer refused: over a mesh of one process (no group) the trainer
    takes the single device's steps bit for bit (the gloo ranks against JAX's
    data mesh: tests/test_torch_parallel.py)."""
    from realtime_style_transfer_torch.parallel import make_mesh

    tm = fits["tm"]
    trainer = Trainer(tm, mesh=make_mesh(1, device="cpu"))
    assert trainer._dist.data_parallelism == 1
    state = trainer.init_state()
    batch = fits["batches"][0]
    got, metrics = trainer._train_step(state, batch)
    want, want_metrics = tm.train_step(tm.init_state(), batch)
    for k in want_metrics:
        assert torch.equal(metrics[k], want_metrics[k]), k
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k


def test_predict_datapoint_figure(fits, tmp_path):
    from realtime_style_transfer_torch import renderers

    batches = fits["batches"]
    fig = renderers.predict_datapoint(fits["tm"], fits["state"], batches[0], batches[1],
                                      save_path=tmp_path / "figure.png")
    assert (tmp_path / "figure.png").stat().st_size > 0
    assert [ax.get_title() for ax in fig.axes] == [
        "content", "style", "validation prediction", "training prediction"]
