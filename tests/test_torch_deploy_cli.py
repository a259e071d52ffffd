"""The port's deploy and analysis CLIs (``python -m realtime_style_transfer_torch.<name>``)
at ``--device cpu``, each ``main`` called in this process, held against the JAX
package on the same weights and inputs.

One module fixture trains the port for one epoch (``train_network --device cpu
--network_spec rst-120-15-4-3 --sdr --loss dummy --dtype float32``,
``tests/test_torch_train_cli.py``'s dataset); its
``weights/latest_epoch_weights.npz`` is read by both packages.  The JAX
references are jitted once in module fixtures: ``model.apply`` of the JAX
inference model on that tree, and ``loss_and_metrics`` and ``jax.grad`` of the
JAX training model whose dummy tower takes the port's tower weights (each
package draws its own).  Limits:

* ``predict_using_checkpoint``'s PNG within one 8-bit level of JAX's output,
  ``predict_style_params``' buffer within ``rtol=1e-4, atol=1e-5`` of JAX's
  vector (f32 on both sides; the eager nets agree to a few f32 ulps);
* ``compare_unreal_style_params``' ``|unreal - python|`` row below 1e-4
  (``tests/test_interop_and_aux.py``);
* the permutation losses and the gradient attributions within 1e-4 relative
  of JAX's;
* ``predict_using_saved_models`` (a ``torch.export`` program) equal to
  ``predict_using_checkpoint``'s PNG within one level (expected equal);
* ``depth_analysis``' printed table within 1e-5 of one computed with
  ``jax.image.resize``;
* the table writer's CSV equal to pandas' ``to_csv(index=False)`` byte for
  byte (and its text and LaTeX to ``to_string``/``to_latex``); pandas is
  imported by this test alone.
"""

import json
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch import (
    compare_unreal_style_params, compute_gradient_explanation,
    compute_permutation_feature_importance, depth_analysis,
    generate_feature_permutation_visualization, predict_style_params,
    predict_using_checkpoint, predict_using_saved_models, save_using_checkpoint,
    show_unreal_tensor_buffer, style_hash_lookup, train_network)
from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.data import wikiart as twikiart
from realtime_style_transfer_torch.data.exr import write_exr
from realtime_style_transfer_torch.data.imaging import image_to_uint8
from realtime_style_transfer_torch.data.imaging import load_image as tload_image
from realtime_style_transfer_torch.data.native import read_tensor_buffer, write_tensor_buffer
from realtime_style_transfer_torch.export.onnx_numpy import run_model
from realtime_style_transfer_torch.models.depth import DEPTH_RESOLUTION, load_bundled_depth
from realtime_style_transfer_torch.tracing.checkpoint import read_tree
from realtime_style_transfer_torch.utils import table
from realtime_style_transfer_torch.utils.proto import parse_fields
from realtime_style_transfer_torch.utils.stats import comparison_table
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.data import pipeline as jpipeline
from realtime_style_transfer_tpu.data.imaging import list_image_paths, load_image
from realtime_style_transfer_tpu.export import export_predictor_onnx, export_transfer_onnx
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.training import make_style_transfer_training_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SPEC = "rst-120-15-4-3"
CFG = ShapeConfig.from_spec(SPEC, hdr=False)
RTOL, ATOL = 1e-4, 1e-5
REL = 1e-4


def _png(path):
    return np.asarray(PIL.Image.open(path)).astype(np.int16)


def _but_producer(model_bytes):
    """An ONNX model's top-level fields but its producer name (field 2)."""
    return [(f, v) for f, _w, v in parse_fields(model_bytes) if f != 2]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The dataset, the port's one-epoch run and its weights as a flax tree."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("deploy")
    for sub in ("training", "validation"):
        for d in (root / "content" / sub, root / "style" / sub):
            d.mkdir(parents=True)
        for i in range(3):
            for d in (root / "content" / sub, root / "style" / sub):
                arr = (rng.random((70, 130, 3)) * 255).astype(np.uint8)
                PIL.Image.fromarray(arr).save(d / f"{sub}_{i}.png")
    log_dir = train_network.main([
        "--device", "cpu", "--network_spec", SPEC, "--sdr", "--loss", "dummy",
        "--no_depth_loss", "--epochs", "1", "--batch_size", "2", "--checkpoint_cadence", "1",
        "--log_dir", str(root / "run"), "--content_dir", str(root / "content"),
        "--style_dir", str(root / "style"), "--dtype", "float32"])
    tree = read_tree(log_dir / "weights" / "latest_epoch_weights.npz")
    return types.SimpleNamespace(
        root=root, log_dir=log_dir, tree=tree,
        content=root / "content" / "validation" / "validation_0.png",
        style=root / "style" / "validation" / "validation_0.png",
        base=["--device", "cpu", "--network_spec", SPEC, "--sdr", "--dtype", "float32",
              "-C", str(log_dir)])


@pytest.fixture(scope="module")
def jax_ref(run):
    """One jitted JAX call on the first batch the analysis CLIs read (its
    first sample is the content and style the other CLIs are given): the
    inference model's output and style vector, and the training model's
    baseline and permuted losses and mean |d loss / d content| per channel,
    its dummy tower holding the port's tower weights."""
    args = types.SimpleNamespace(loss="dummy", checkpoint_path=run.log_dir, dtype="float32")
    port_tm, _ = compute_permutation_feature_importance.load_training_state(
        args, TConfig.from_spec(SPEC, hdr=False), torch.device("cpu"))
    tm = make_style_transfer_training_model(CFG, loss_extractor="dummy", with_depth_loss=False,
                                            dtype=jnp.float32)
    tm.loss_variables = jax.tree.map(jnp.asarray, to_flax(port_tm.loss_module.state_dict()))
    variables = jax.tree.map(jnp.asarray, run.tree)

    styles = (load_image(p, CFG.output_shape)
              for p in list_image_paths(run.root / "style" / "validation"))
    content = ((load_image(p, CFG.content_shape), load_image(p, CFG.output_shape))
               for p in list_image_paths(run.root / "content" / "validation"))
    inputs, gt = next(jpipeline.batched(jpipeline.pair_content_and_style(content, styles), 2))

    @jax.jit
    def reference(variables, inputs, gt):
        model = tm.model

        def loss_of(content):
            _, (losses, _) = tm.loss_and_metrics(
                variables["params"], variables["batch_stats"],
                ({**inputs, "content": content}, gt), train=False)
            return jnp.mean(losses["loss"])

        c = inputs["content"]
        rolled = c[jnp.roll(jnp.arange(c.shape[0]), 1)]
        grad = jax.grad(loss_of)(c)
        return (model.apply(variables, c, inputs["style"], train=False),
                model.apply(variables, inputs["style"], method=model.predict_style_params),
                loss_of(c), loss_of(rolled), jnp.mean(jnp.abs(grad), axis=(0, 1, 2)))

    out, params, base, permuted, grads = reference(
        variables, jax.tree.map(jnp.asarray, inputs), jax.tree.map(jnp.asarray, gt))
    return types.SimpleNamespace(output=np.asarray(out)[0], params=np.asarray(params)[0, 0],
                                 content=inputs["content"][0], base=float(base),
                                 permuted=float(permuted), grads=np.asarray(grads))


@pytest.fixture(scope="module")
def exported(run):
    out = run.root / "export"
    result = save_using_checkpoint.main(run.base + ["-o", str(out)])
    return types.SimpleNamespace(dir=out, result=result)


@pytest.fixture(scope="module")
def predicted(run):
    out = run.root / "predicted.png"
    assert predict_using_checkpoint.main(
        run.base + ["-c", str(run.content), "-s", str(run.style), "-o", str(out), "-p"]) == out
    return out


def test_predict_using_checkpoint_within_one_level_of_jax(run, jax_ref, predicted):
    got = _png(predicted)
    assert got.shape == (60, 120, 3)
    assert np.abs(got - image_to_uint8(jax_ref.output)).max() <= 1
    preview = _png(predicted.with_name("predicted_content.png"))
    np.testing.assert_array_equal(preview, image_to_uint8(jax_ref.content[..., :3]))


def test_predict_using_checkpoint_two_styles_with_a_weight_map(run, tmp_path):
    """Two styles with -w: the PNG is the eager net's output on the same
    inputs; without -w the weights are zeros, which is style 1 alone."""
    ramp = tmp_path / "ramp.png"
    PIL.Image.fromarray(np.repeat(np.linspace(0, 255, 120)[None], 60, 0).astype(np.uint8)).save(
        ramp)
    style2 = run.root / "style" / "validation" / "validation_1.png"
    argv = run.base + ["-c", str(run.content), "-s", str(run.style), "-s", str(style2)]
    predict_using_checkpoint.main(argv + ["-w", str(ramp), "-o", str(tmp_path / "dual.png")])
    predict_using_checkpoint.main(argv + ["-o", str(tmp_path / "zeros.png")])
    cfg = TConfig.from_spec(SPEC, num_styles=2, hdr=False)
    model = tcli.build_inference(cfg, device="cpu")
    tcli.load_variables(run.log_dir, model)
    content = torch.from_numpy(tcli.load_content(run.content, cfg)[None])
    styles = torch.from_numpy(tcli.load_styles([run.style, style2], cfg)[None])
    wm = torch.from_numpy(np.asarray(PIL.Image.open(ramp), np.float32)[None, ..., None] / 255.0)
    with torch.no_grad():
        want = model(content, styles, wm)[0].numpy()
        single = model(content, styles[:, :1].expand(-1, 2, -1, -1, -1), torch.zeros_like(wm))
    np.testing.assert_array_equal(_png(tmp_path / "dual.png"), image_to_uint8(want))
    np.testing.assert_array_equal(_png(tmp_path / "zeros.png"), image_to_uint8(single[0].numpy()))


def test_predict_style_params_buffer_matches_jax(run, jax_ref):
    out = run.root / "params.bin"
    params = predict_style_params.main(run.base + ["-s", str(run.style), "-o", str(out)])
    n = plan_from_config(CFG).num_style_parameters
    buf = np.frombuffer(out.read_bytes(), "<f4")
    assert buf.size == params.size == n
    np.testing.assert_array_equal(buf, params)
    np.testing.assert_allclose(buf, jax_ref.params, rtol=RTOL, atol=ATOL)


def test_compare_unreal_style_params_diff_row(run, jax_ref, caplog):
    buf = run.root / "jax_params.bin"
    write_tensor_buffer(buf, jax_ref.params)
    printed = compare_unreal_style_params.main(run.base + ["-s", str(run.style), "-b", str(buf)])
    assert "unreal" in printed and "python" in printed
    (row,) = [line for line in printed.splitlines() if line.startswith("|unreal - python|")]
    assert float(row.split()[-2]) < 1e-4   # the max column
    # a buffer of another length is compared as far as it goes, with a warning
    write_tensor_buffer(buf, jax_ref.params[:-3])
    with caplog.at_level("WARNING", logger="compare_style_params"):
        compare_unreal_style_params.main(run.base + ["-s", str(run.style), "-b", str(buf)])
    assert "check --network_spec" in caplog.text


def test_save_using_checkpoint_writes_every_artifact(run, exported):
    names = ("inference.pt2", "predictor.pt2", "transfer.pt2", "transfer.onnx",
             "predictor.onnx", "config.json", "checkpoint/latest_epoch_weights.npz")
    for name in names:
        assert (exported.dir / name).is_file(), name
    assert sorted(exported.result["sizes"]) == sorted(names[:5] + names[6:])
    assert sorted(exported.result["export_s"]) == ["inference", "predictor", "transfer"]
    assert json.loads((exported.dir / "config.json").read_text())["num_channels"] == 3
    # the ONNX files are the JAX emitter's on the same tree, but for the producer
    plan = plan_from_config(CFG)
    onnx_t = (exported.dir / "transfer.onnx").read_bytes()
    want_t = export_transfer_onnx(run.tree, plan)
    assert _but_producer(onnx_t) == _but_producer(want_t)
    onnx_p = (exported.dir / "predictor.onnx").read_bytes()
    want_p = export_predictor_onnx(run.tree, style_shape=CFG.output_shape,
                                   num_top_parameters=plan.num_style_parameters)
    assert _but_producer(onnx_p) == _but_producer(want_p)
    stylized = run_model(onnx_t, {"content": np.full((1,) + CFG.content_shape, 0.5, np.float32),
                                  "style_params": np.zeros((1, plan.num_style_parameters),
                                                           np.float32)})["stylized"]
    assert stylized.shape == (1,) + CFG.output_shape and np.isfinite(stylized).all()


def test_multi_style_export_raises_as_jax_does(run, tmp_path):
    """The JAX CLI exports ``inference`` without a weight map, which a
    two-style net refuses; so does the port."""
    with pytest.raises(ValueError, match="style_weights required"):
        save_using_checkpoint.main(run.base + ["--num_styles", "2", "-o", str(tmp_path)])


SAVED_PROBE = r"""
import json, sys
from realtime_style_transfer_torch import predict_using_saved_models
predict_using_saved_models.main(sys.argv[1:])
print(json.dumps(sorted(k for k in sys.modules
                        if k.startswith("realtime_style_transfer_torch.models"))))
"""


def test_predict_using_saved_models_builds_no_model(run, exported, predicted):
    """In a fresh interpreter the CLI imports no module of ``models``, and its
    PNG is the checkpoint CLI's."""
    out = run.root / "from_saved.png"
    proc = subprocess.run(
        [sys.executable, "-c", SAVED_PROBE, "-m", str(exported.dir), "-c", str(run.content),
         "-s", str(run.style), "-o", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert np.abs(_png(out) - _png(predicted)).max() <= 1


def test_saved_programs_refuse_another_device(tmp_path):
    """A program exported on the CPU is refused for CUDA, and loads for the CPU."""
    program = torch.export.export(torch.nn.Linear(3, 2), (torch.zeros(1, 3),), strict=False)
    torch.export.save(program, tmp_path / "transfer.pt2")
    with pytest.raises(ValueError, match=r"exported on \['cpu'\], not cuda"):
        predict_using_saved_models.load_exported(tmp_path, "transfer", "cuda")
    loaded = predict_using_saved_models.load_exported(tmp_path, "transfer", "cpu")
    assert loaded.module()(torch.ones(1, 3)).shape == (1, 2)


def test_permutation_importance_matches_jax_and_resumes(run, jax_ref, tmp_path):
    argv = run.base + ["--loss", "dummy", "--content_dir", str(run.root / "content" / "validation"),
                       "--style_dir", str(run.root / "style" / "validation"),
                       "--batch_size", "2", "--max_batches", "1", "-o", str(tmp_path)]
    first = compute_permutation_feature_importance.main(argv)
    assert first["evaluated"] == 2
    cache = pickle.loads((tmp_path / "progress.pkl").read_bytes())
    assert sorted(cache) == [(0, "FinalImage"), (0, "__baseline__")]
    np.testing.assert_allclose(cache[(0, "__baseline__")], jax_ref.base, rtol=REL)
    np.testing.assert_allclose(cache[(0, "FinalImage")], jax_ref.permuted, rtol=REL)
    (row,) = first["rows"]
    assert row == {"channel": "FinalImage", "batches": 1, "std": 0.0,
                   "importance": cache[(0, "FinalImage")] - cache[(0, "__baseline__")]}
    assert (tmp_path / "importance.csv").read_text() == table.to_csv(first["rows"])
    assert (tmp_path / "importance.tex").read_text() == table.to_latex(first["rows"])
    # a second run resumes from progress.pkl and evaluates nothing
    second = compute_permutation_feature_importance.main(argv)
    assert second == {**first, "evaluated": 0}


def test_gradient_explanation_matches_jax(run, jax_ref, tmp_path):
    rows = compute_gradient_explanation.main(
        run.base + ["--loss", "dummy", "--content_dir", str(run.root / "content" / "validation"),
                    "--style_dir", str(run.root / "style" / "validation"), "--batch_size", "2",
                    "--max_batches", "1", "-o", str(tmp_path)])
    (row,) = rows
    assert row["channel"] == "FinalImage"
    np.testing.assert_allclose(row["mean_abs_gradient"], jax_ref.grads.mean(), rtol=REL)
    assert "FinalImage" in (tmp_path / "gradient_attribution.csv").read_text()


def test_feature_permutation_visualization(run, tmp_path):
    written = generate_feature_permutation_visualization.main(
        run.base + ["--content_dir", str(run.root / "content" / "validation"),
                    "-s", str(run.style), "-o", str(tmp_path)])
    assert written == [tmp_path / "unperturbed.png", tmp_path / "swap_FinalImage.png"]
    # three channels, one group: the swap is the second frame stylized
    assert not np.array_equal(_png(written[0]), _png(written[1]))


def test_depth_analysis_matches_jax_resize(tmp_path):
    """The printed table against one built from the bundled MidasLite and
    ``jax.image.resize`` of the scene depth: taller than the net's 384
    rows (the resize shrinks and antialiases) and narrower (it stretches)."""
    rng = np.random.default_rng(5)
    shot = tmp_path / "shot.png"
    PIL.Image.fromarray((rng.random((500, 300, 3)) * 255).astype(np.uint8)).save(shot)
    scene = (rng.random((500, 300)) * 100).astype(np.float32)
    write_exr(tmp_path / "shot_SceneDepth.exr", {"R": scene})
    out = tmp_path / "out"
    printed = depth_analysis.main(["--screenshot", str(shot), "--depth_weights", "bundled",
                                   "-o", str(out), "--device", "cpu"])
    for name in ("rgb.png", "predicted_depth.png", "scene_depth.png"):
        assert (out / name).is_file()
    rgb = tload_image(shot, (DEPTH_RESOLUTION, DEPTH_RESOLUTION, 3))
    with torch.no_grad():
        predicted = load_bundled_depth()(torch.from_numpy(rgb[None]))[0].numpy()
    resized = np.asarray(jax.image.resize(jnp.asarray(scene), predicted.shape, "bilinear"))
    want = comparison_table({"predicted": depth_analysis.normalize01(predicted),
                             "scene_depth_norm": depth_analysis.normalize01(resized)})

    def numbers(text):
        return [[float(v) for v in line.split()[-5:]] for line in text.splitlines()[1:]]

    assert len(numbers(printed)) == 4
    np.testing.assert_allclose(numbers(printed), numbers(want), atol=1e-5)
    # an Orbax directory is refused with the port's message
    with pytest.raises(ValueError, match="Converting a JAX checkpoint"):
        depth_analysis.main(["--screenshot", str(shot), "--depth_weights", str(tmp_path),
                             "-o", str(out), "--device", "cpu"])


def test_show_unreal_tensor_buffer_writes_the_png(tmp_path):
    image = np.random.default_rng(2).random((8, 12, 3)).astype(np.float32) * 1.2 - 0.1
    buf = write_tensor_buffer(tmp_path / "t.bin", image)
    got = show_unreal_tensor_buffer.main([str(buf), "--shape", "8", "12", "3",
                                          "-o", str(tmp_path / "t.png")])
    np.testing.assert_array_equal(got, read_tensor_buffer(buf, (8, 12, 3)))
    np.testing.assert_array_equal(_png(tmp_path / "t.png"), image_to_uint8(image))


def test_style_hash_lookup(tmp_path, monkeypatch, capsys):
    manifest = tmp_path / "manifest.csv"
    manifest.write_text("artist,title,url\nA,One,http://a/1\nB,Two,http://b/2\n")
    monkeypatch.setattr(twikiart, "MANIFEST_FILEPATH", manifest)
    row = twikiart.read_manifest()[1]
    digest = twikiart.image_manifest_to_filepath(row).stem
    assert style_hash_lookup.main([digest]) == row
    assert json.loads(capsys.readouterr().out) == row
    with pytest.raises(SystemExit):
        style_hash_lookup.main(["0" * 40])


CLIS = {
    save_using_checkpoint: ["-C", "x.npz"],
    predict_using_saved_models: ["-m", "x", "-c", "c.png", "-s", "s.png"],
    predict_using_checkpoint: ["-C", "x.npz", "-c", "c.png", "-s", "s.png"],
    predict_style_params: ["-C", "x.npz", "-s", "s.png"],
    compare_unreal_style_params: ["-C", "x.npz", "-s", "s.png", "-b", "b.bin"],
    compute_permutation_feature_importance: ["-C", "x", "--content_dir", "c", "--style_dir", "s"],
    compute_gradient_explanation: ["-C", "x", "--content_dir", "c", "--style_dir", "s"],
    generate_feature_permutation_visualization: ["-C", "x", "--content_dir", "c", "-s", "s"],
    depth_analysis: ["--screenshot", "s.png"],
}


@pytest.mark.parametrize("module", list(CLIS), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_each_cli_runs_on_cuda_by_default(module, monkeypatch, tmp_path):
    """Without --device every CLI asks for CUDA and raises where there is
    none, before it reads or writes a file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(CLIS[module])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("module", [show_unreal_tensor_buffer, style_hash_lookup],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_host_only_clis_run_without_cuda(module, monkeypatch, tmp_path):
    """The two CLIs that do no device work take no --device and run where
    there is no GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as refused:   # argparse: unrecognized --device
        module.main(["--device", "cpu"])
    assert refused.value.code == 2
    if module is show_unreal_tensor_buffer:
        buf = write_tensor_buffer(tmp_path / "t.bin", np.zeros((2, 3, 3), np.float32))
        module.main([str(buf), "--shape", "2", "3", "3", "-o", str(tmp_path / "t.png")])
        assert (tmp_path / "t.png").is_file()
    else:
        manifest = tmp_path / "manifest.csv"
        manifest.write_text("artist,title,url\nA,One,http://a/1\n")
        monkeypatch.setattr(twikiart, "MANIFEST_FILEPATH", manifest)
        row = twikiart.read_manifest()[0]
        assert module.main([twikiart.image_manifest_to_filepath(row).stem]) == row


ROWS = [
    [{"channel": "FinalImage", "importance": 0.0012345678901, "std": 0.0, "batches": 1},
     {"channel": "Base,Color", "importance": -1e-07, "std": 1e16, "batches": 2},
     {"channel": 'a"b', "importance": float("nan"), "std": 3.0, "batches": 3}],
    [{"channel": "FinalImage", "importance": 0.25, "std": 0.5, "batches": 4},
     {"channel": "BaseColor", "importance": 0.125, "std": 0.1, "batches": 4},
     {"channel": "SceneDepth", "importance": 0.25, "std": 3.0, "batches": 4}],
    [{"channel": f"c{i}", "mean_abs_gradient": float(v)} for i, v in
     enumerate(np.random.default_rng(1).standard_normal(9) * 10.0 ** np.arange(-4, 5))],
]


@pytest.mark.parametrize("rows", ROWS, ids=["nan-and-scientific", "ties", "gradients"])
def test_table_writer_matches_pandas(rows):
    import pandas as pd

    column = list(rows[0])[1]
    df = pd.DataFrame(rows).sort_values(column, ascending=False)
    ours = table.sort_rows(rows, column)
    assert table.to_csv(ours) == df.to_csv(index=False)
    assert table.to_string(ours) == df.to_string(index=False)
    assert table.to_latex(ours) == df.to_latex(index=False)
