"""The port's ``parallel/`` against the JAX package on the CPU: the data axis
and the spatial axis.

Two gloo ranks, each a subprocess on a free localhost port (killed with its
process group if it outlives its timeout, as
``tests/test_distributed_multiprocess.py`` does), run the port's
``DistributedTrainer``, ``DistributedStylizer`` and ``FusedStreamStylizer``
on a data mesh, then ``DistributedTrainer`` and ``DistributedStylizer`` (one
style and two with a weight map) on a ``data=1, spatial=2`` mesh, TINY's 60
rows split 32 + 28; rank 0 writes what they give.  Meanwhile this process
computes JAX's: its ``DistributedTrainer`` on a 2-device data mesh and on
``make_mesh(2, spatial=2)`` (conftest gives JAX 8 CPU devices) from the
port's initial state, and its ``DistributedStylizer`` (on both meshes) and
packed-path ``FusedStreamStylizer`` in f32 on the same weights.  Then
``predict_video --data_parallel 2 --device cpu``, which starts its own two
ranks, must write the frames of ``--data_parallel 1``, bf16 and int8.

Limits.  The training step: ``tests/test_torch_training.py``'s (metrics rtol
1e-4, batch statistics 1e-5, parameters 1e-5 where the gradient is above the
f32 noise floor and within two RMSprop first-step updates, 6.4e-3, where it
is not); the transfer net's contract batch norms run in train mode, so a
rank normalizing by its own slice's moments would miss the batch statistics
by far more (on the spatial axis, a rank's rows' moments: the batch norms'
and the CINs').  The eager stylizer and the f32 packed stream: rtol 1e-4 +
atol 1e-5 x max.  The fused stream (the kernels' plain versions on the CPU, bf16)
against JAX's f32 packed stream: rtol 0.08 / atol 0.03, the port's
fused-against-f32 limit; and bit-equal to the port's single-process
``FusedTransfer`` on the same frames.  The CLI: the same PNGs, bit for bit.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch import predict_video, train_network
from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.data.exr import write_gbuffer_fixture
from realtime_style_transfer_torch.models.inference import make_inference_model, plan_from_config
from realtime_style_transfer_torch.models.training import make_style_transfer_training_model
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.parallel import (batch_sharding, distributed, make_mesh,
                                                    replicate, replicated, shard_batch)
from realtime_style_transfer_torch.weights import state_to_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig as JShapeConfig
from realtime_style_transfer_tpu.models.inference import make_inference_model as jmake
from realtime_style_transfer_tpu.models.training import TrainState as JTrainState
from realtime_style_transfer_tpu.models.training import \
    make_style_transfer_training_model as jax_training_model
from realtime_style_transfer_tpu.parallel import DistributedTrainer as JDistributedTrainer
from realtime_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from realtime_style_transfer_tpu.parallel.infer import DistributedStylizer as JDistributedStylizer
from realtime_style_transfer_tpu.parallel.infer import FusedStreamStylizer as JStream

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
LR_STEP = 2 * 1e-3 / np.sqrt(1 - 0.9)   # the most two RMSprop updates can differ
TIMEOUT = 240
TINY = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
            num_channels=3, hdr=False, feature_extractor="dummy", with_depth_loss=False)
STREAM_SPEC = "rst-128-16-8-17"
STREAM_REFUSAL = ("FusedStreamStylizer shards whole frames over the data axis; build the mesh "
                  "with spatial=1")


def train_batch(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {k: rng.random((n,) + s, dtype=np.float32) for k, s in cfg.input_shape.items()}
    return inputs, {"content": inputs["content"][..., :3], "style": inputs["style"]}


def stream_inputs(plan, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.random((4,) + plan.input_shape, dtype=np.float32)
    params = (rng.random((1, 1, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    return frames, params


def tiny_frames(seed=2):
    """Two TINY frames, style vectors for one and two styles, a weight map."""
    rng = np.random.default_rng(seed)
    n_params = plan_from_config(ShapeConfig(**TINY)).num_style_parameters
    out = {"tiny_content": rng.random((2, 60, 120, 3), dtype=np.float32),
           "tiny_weights": rng.random((2, 60, 120, 1), dtype=np.float32)}
    for s in (1, 2):
        out[f"tiny_params{s}"] = (rng.random((2, s, n_params)) * 0.4 + 0.8).astype(np.float32)
    return out


# a rank: imports no JAX; its inputs come from the fixture's inputs.npz
WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.models.training import make_style_transfer_training_model
from realtime_style_transfer_torch.parallel import (DistributedStylizer, DistributedTrainer,
                                                    FusedStreamStylizer, distributed, make_mesh)
from realtime_style_transfer_torch.tracing.checkpoint import write_tree
from realtime_style_transfer_torch.weights import state_to_flax, to_flax

address, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
TINY, STREAM_SPEC = @TINY@, @STREAM_SPEC@
data = np.load(out + "/inputs.npz")
batches = [({"content": data[f"content{i}"], "style": data[f"style{i}"]},
            {"content": data[f"content{i}"][..., :3], "style": data[f"style{i}"]})
           for i in (0, 1)]
distributed.initialize(address, 2, rank, backend="gloo")
mesh = make_mesh(2, device="cpu")
assert mesh.shape == {"data": 2, "spatial": 1} and mesh.rank == rank
assert distributed.host_batch_slice(4) == slice(2 * rank, 2 * rank + 2)
results = {}

cfg = ShapeConfig(**TINY)
# each rank draws other weights: the trainer takes rank 0's state and towers
tm = make_style_transfer_training_model(cfg, loss_extractor="dummy", device="cpu", seed=rank)
trainer = DistributedTrainer(tm, mesh)
state = trainer.init_state()
state, metrics = trainer.train_step(state, trainer.shard_batch(batches[0]))
results.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
results["eval/loss"] = trainer.eval_step(state, trainer.shard_batch(batches[1]))["loss"].numpy()
tree = state_to_flax(state)

scfg = ShapeConfig.from_spec(STREAM_SPEC)
model = make_inference_model(scfg, device="cpu", seed=0)
frames, params = data["frames"], data["params"]
ds = DistributedStylizer(model, None, mesh)
results["stylizer"] = ds.stylize(frames, np.repeat(params, 4, 0)).numpy()
variables = to_flax(model.transfer.state_dict())
for path, dtype in (("fused", torch.bfloat16), ("packed", torch.float32)):
    stream = FusedStreamStylizer(variables, model.plan, mesh, path=path, dtype=dtype)
    assert stream.path == path and stream.batch_per_step == 2
    prepared = stream.prepare_style(params)
    results[path] = np.concatenate([stream.stylize_batch(frames[i:i + 2], prepared).numpy()
                                    for i in (0, 2)])
    if path == "fused":
        packed = stream.pack_frames_np(frames[:2])
        results["prepacked"] = stream.stylize_batch_prepacked(packed, prepared).numpy()

# the spatial axis: one data index, TINY's rows over both ranks
smesh = make_mesh(2, spatial=2, device="cpu")
assert smesh.shape == {"data": 1, "spatial": 2} and (smesh.rank, smesh.spatial_rank) == (0, rank)
results["bounds"] = np.array(smesh.rows(60, 4).bounds)
try:
    FusedStreamStylizer(variables, model.plan, smesh, path="fused")
    results["stream_refused"] = np.array("")
except ValueError as e:
    results["stream_refused"] = np.array(str(e))
tm = make_style_transfer_training_model(cfg, loss_extractor="dummy", device="cpu", seed=rank)
trainer = DistributedTrainer(tm, smesh)
state = trainer.init_state()
state, metrics = trainer.train_step(state, trainer.shard_batch(batches[0]))
results.update({f"spatial_metric/{k}": v.numpy() for k, v in metrics.items()})
results["spatial_eval/loss"] = trainer.eval_step(
    state, trainer.shard_batch(batches[1]))["loss"].numpy()
spatial_tree = state_to_flax(state)
for n_styles in (1, 2):
    model = make_inference_model(ShapeConfig(**TINY, num_styles=n_styles), device="cpu", seed=0)
    ds = DistributedStylizer(model, None, smesh)
    results[f"spatial_stylizer{n_styles}"] = ds.stylize(
        data["tiny_content"], data[f"tiny_params{n_styles}"],
        data["tiny_weights"] if n_styles == 2 else None).numpy()
if rank == 0:
    write_tree(out + "/state.npz", tree)
    write_tree(out + "/spatial_state.npz", spatial_tree)
    np.savez(out + "/results.npz", **results)
# both ranks tear down together: a rank that destroys its group and exits while
# the other still writes its results dies in c10d's teardown now and then
# ("terminate called without an active exception", rc -6)
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} ok", flush=True)
"""


def run_ranks(tmp_path, n=2):
    """Start the worker's ``n`` ranks; returns a function that waits for
    them (killing their process groups on a timeout) and asserts they ended
    well."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.replace("@TINY@", repr(TINY)).replace("@STREAM_SPEC@",
                                                                    repr(STREAM_SPEC)))
    batches = [train_batch(ShapeConfig(**TINY), seed=i)[0] for i in (0, 1)]
    frames, params = stream_inputs(plan_from_config(ShapeConfig.from_spec(STREAM_SPEC)))
    np.savez(tmp_path / "inputs.npz", frames=frames, params=params, **tiny_frames(),
             **{f"{k}{i}": b[k] for i, b in enumerate(batches) for k in ("content", "style")})
    # gloo on the loopback interface, whatever this machine's hostname resolves to
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    address = f"tcp://127.0.0.1:{distributed.free_port()}"
    logs = [tmp_path / f"rank{r}.log" for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as log:   # a file, not a pipe nobody drains meanwhile
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), address, str(r), str(tmp_path)], env=env,
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True))

    def wait():
        try:
            for p in procs:
                p.wait(timeout=TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        for r, p in enumerate(procs):
            out = logs[r].read_text()
            assert p.returncode == 0 and f"rank {r} ok" in out, f"rank {r} failed:\n{out}"

    return wait


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's two gloo ranks, and JAX's references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("ranks")
    wait = run_ranks(tmp)
    ref = {}
    # the training step: JAX's DistributedTrainer from the port's state
    cfg = ShapeConfig(**TINY)
    port = make_style_transfer_training_model(cfg, loss_extractor="dummy", device="cpu")
    jtm = jax_training_model(JShapeConfig(**TINY), loss_extractor="dummy")
    tree = state_to_flax(port.init_state())
    params = jax.tree.map(jnp.asarray, tree["params"])
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                     opt_state=jtm.optimizer.init(params))
    jtrainer = JDistributedTrainer(jtm, jmake_mesh(2))
    # rank 0's loss tower, which the port's trainer broadcasts
    jtm.loss_variables = jax.tree.map(jnp.asarray, to_flax(port.loss_module.state_dict()))
    js, metrics = jtrainer.train_step(js, jtrainer.shard_batch(train_batch(cfg)))
    ref["state"] = jax.tree.map(np.asarray, js)
    ref["metrics"] = {k: float(v) for k, v in metrics.items()}
    ref["eval_loss"] = float(jtrainer.eval_step(js, jtrainer.shard_batch(
        train_batch(cfg, seed=1)))["loss"])
    ref["port"] = port
    # the spatial axis: JAX's DistributedTrainer on make_mesh(2, spatial=2)
    smesh = jmake_mesh(2, spatial=2)
    strainer = JDistributedTrainer(jtm, smesh)
    params = jax.tree.map(jnp.asarray, tree["params"])   # the first step donated its state
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=jax.tree.map(jnp.asarray, tree["batch_stats"]),
                     opt_state=jtm.optimizer.init(params))
    js, metrics = strainer.train_step(js, strainer.shard_batch(train_batch(cfg)))
    ref["spatial_state"] = jax.tree.map(np.asarray, js)
    ref["spatial_metrics"] = {k: float(v) for k, v in metrics.items()}
    ref["spatial_eval_loss"] = float(strainer.eval_step(js, strainer.shard_batch(
        train_batch(cfg, seed=1)))["loss"])
    tiny = tiny_frames()
    for n_styles in (1, 2):
        tmodel = make_inference_model(ShapeConfig(**TINY, num_styles=n_styles), device="cpu",
                                      seed=0)
        jm = jmake(JShapeConfig(**TINY, num_styles=n_styles))
        ref[f"spatial_stylizer{n_styles}"] = np.asarray(JDistributedStylizer(
            jm, to_flax(tmodel.state_dict()), smesh).stylize(
            jnp.asarray(tiny["tiny_content"]), jnp.asarray(tiny[f"tiny_params{n_styles}"]),
            jnp.asarray(tiny["tiny_weights"]) if n_styles == 2 else None))
    # the stream: JAX's stylizers on the port's seeded weights
    scfg = ShapeConfig.from_spec(STREAM_SPEC)
    model = make_inference_model(scfg, device="cpu", seed=0)
    frames, sp = stream_inputs(model.plan)
    jmodel = jmake(JShapeConfig.from_spec(STREAM_SPEC))
    variables = to_flax(model.state_dict())
    mesh = jmake_mesh(2)
    ref["stylizer"] = np.asarray(JDistributedStylizer(jmodel, variables, mesh).stylize(
        jnp.asarray(frames), jnp.asarray(np.repeat(sp, 4, 0))))
    stream = JStream(variables, jmodel.plan, mesh, path="packed", dtype=jnp.float32)
    prepared = stream.prepare_style(jnp.asarray(sp))
    ref["stream"] = np.concatenate([np.asarray(stream.stylize_batch(jnp.asarray(frames[i:i + 2]),
                                                                    prepared))
                                    for i in (0, 2)])
    engine = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu")
    prep = engine.prepare_style(torch.from_numpy(sp))
    ref["single_fused"] = np.concatenate([engine.stylize_prepacked(
        engine.pack_frame_np(frames[i:i + 1]), prep).numpy() for i in range(4)])
    wait()
    from realtime_style_transfer_torch.tracing.checkpoint import read_tree

    got = dict(np.load(tmp / "results.npz"))
    got["state"] = read_tree(tmp / "state.npz")
    got["spatial_state"] = read_tree(tmp / "spatial_state.npz")
    return ref, got


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


def close(got, want, rtol=1e-4, atol_frac=1e-5):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.rank == 0 and mesh.group is None
    assert make_mesh(1, device="cpu").shape == {"data": 1, "spatial": 1}
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 rank"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        make_mesh(1, spatial=2, device="cpu")
    # --mesh N,S is N * S ranks, as the JAX CLI's make_mesh(N * S, spatial=S)
    assert train_network.mesh_ranks("4,2") == (8, 2) and train_network.mesh_ranks("1,2") == (2, 2)
    assert train_network.mesh_ranks("4") == train_network.mesh_ranks("4,1") == (4, 1)
    assert mesh.rows(60, 4) is None and mesh.spatial_group is None and mesh.is_main
    # one process without a group: the mesh's collectives are the identity
    distributed.initialize(num_processes=1)
    assert distributed.host_batch_slice(4) == slice(0, 4)
    t = {"a": torch.arange(4.0), "b": (np.ones((4, 2)),)}
    assert torch.equal(replicate(t, mesh)["a"], t["a"])
    assert torch.equal(replicated(mesh)(t)["a"], t["a"])
    assert shard_batch(t, mesh)["b"][0].shape == (4, 2)
    assert torch.equal(batch_sharding(mesh)(t)["b"][0], torch.ones((4, 2), dtype=torch.float64))
    assert torch.equal(distributed.global_array_from_host_batch(mesh, t)["a"], t["a"])


def test_spatial_axis_is_refused_by_name(two_ranks):
    """The spatial mesh is built (TINY's rows split 32 + 28 at multiples of
    4); the frame stream alone refuses it, with JAX's message."""
    _, got = two_ranks
    assert got["bounds"].tolist() == [[0, 32], [32, 60]]
    assert str(got["stream_refused"]) == STREAM_REFUSAL


def test_distributed_train_step_matches_jax(two_ranks):
    check_train_step(*two_ranks, "")


def test_spatial_train_step_matches_jax(two_ranks):
    """The data=1, spatial=2 step (TINY's rows 32 + 28: halo exchanges, the
    CIN and batch norm moments over the group, the gathered frame's loss)
    against JAX's DistributedTrainer on make_mesh(2, spatial=2)."""
    check_train_step(*two_ranks, "spatial_")


def check_train_step(ref, got, pre):
    port, want = ref["port"], ref[f"{pre}state"]
    for key, value in ref[f"{pre}metrics"].items():
        np.testing.assert_allclose(float(got[f"{pre}metric/{key}"]), value, rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(float(got[f"{pre}eval/loss"]), ref[f"{pre}eval_loss"], rtol=1e-4)
    state = got[f"{pre}state"]
    assert int(state["step"]) == 1
    # the contract batch norms' statistics come from the global batch
    assert any("contract" in "/".join(p) for p, _ in _leaves(want.batch_stats))
    for path, value in _leaves(want.batch_stats):
        np.testing.assert_allclose(_get(state["batch_stats"], path), value, rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
    _, _, _, grads = port.value_and_grad(port.init_state(), train_batch(port.config))
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    nu = want.opt_state[0].nu
    for path, value in _leaves(want.params):
        err = np.abs(_get(state["params"], path) - value)
        noisy = _get(nu, path) <= 0.1 * (2 * floor) ** 2
        assert err[~noisy].max(initial=0.0) <= 1e-5, path
        assert err.max(initial=0.0) <= LR_STEP, path


def test_distributed_stylizer_matches_jax(two_ranks):
    ref, got = two_ranks
    close(got["stylizer"], ref["stylizer"])


@pytest.mark.parametrize("n_styles", [1, 2])
def test_spatial_stylizer_matches_jax(two_ranks, n_styles):
    """DistributedStylizer on the data=1, spatial=2 mesh (uneven rows, two
    styles blended by a weight map cut to each rank's rows) against JAX's
    on make_mesh(2, spatial=2)."""
    ref, got = two_ranks
    close(got[f"spatial_stylizer{n_styles}"], ref[f"spatial_stylizer{n_styles}"])


def test_fused_stream_matches_jax_and_the_single_engine(two_ranks):
    ref, got = two_ranks
    close(got["packed"], ref["stream"])
    fused = got["fused"]
    assert fused.shape == ref["stream"].shape and np.isfinite(fused).all()
    err = np.abs(fused - ref["stream"])
    assert (err <= 0.03 + 0.08 * np.abs(ref["stream"])).all(), err.max()
    np.testing.assert_array_equal(fused, ref["single_fused"])
    np.testing.assert_array_equal(got["prepacked"], ref["single_fused"][:2])


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    cfg = ShapeConfig.from_spec(STREAM_SPEC)
    for i in range(3):   # 3 frames: the last group of 2 is padded
        write_gbuffer_fixture(root / "frames", f"f{i}", cfg.channels, 70, 130, seed=i,
                              compression="none")
    PIL.Image.fromarray((np.random.default_rng(0).random((70, 130, 3)) * 255).astype(
        np.uint8)).save(root / "style.png")
    model = make_inference_model(cfg, device="cpu", seed=0)
    ckpt = tcli.save_variables(root / "weights.npz", to_flax(model.state_dict()))
    return root, ckpt


def _pngs(directory):
    return [np.asarray(PIL.Image.open(p)) for p in sorted(directory.glob("frame_*.png"))]


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_predict_video_data_parallel_writes_the_single_rank_frames(video, quant, monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")   # the ranks' gloo on the loopback
    root, ckpt = video
    extra = ["--quant", "int8", "--calibration_frames", "2"] if quant == "int8" else []

    def argv(out, dp):
        return ["--network_spec", STREAM_SPEC, "-C", str(ckpt), "-s", str(root / "style.png"),
                "--frames_dir", str(root / "frames"), "-o", str(root / out), "--device", "cpu",
                "--path", "fused", "--data_parallel", str(dp), *extra]

    one = predict_video.main(argv(f"{quant}_one", 1))
    two = predict_video.main(argv(f"{quant}_two", 2))
    assert two["path"] == "fused" and two["data_parallel"] == 2
    assert two["frames_written"] == one["frames_written"] == 3 and two["nonfinite"] == 0
    a, b = _pngs(root / f"{quant}_one"), _pngs(root / f"{quant}_two")
    assert len(a) == len(b) == 3
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    if quant == "int8":
        np.testing.assert_array_equal(one["act_scales"], two["act_scales"])
    with pytest.raises(SystemExit, match="use --path auto, fused or packed"):
        predict_video.main(argv("standard", 2) + ["--path", "standard"])
