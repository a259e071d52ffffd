"""The port's video CLI (``python -m realtime_style_transfer_torch.predict_video``),
its checkpoint loader, int8 scales guard and entry twin, held against the JAX
package on the CPU.

One module fixture builds the JAX inference model of a tiny fused-family
config with 17 G-buffer channels (``rst-128-16-8-17``: the 64x128 frames of
``tests/test_video_and_determinism.py``'s fused spec, fed from EXR sets)
through ``realtime_style_transfer_tpu.cli.build_inference(rng_seed=0)``,
writes its variables as the port's checkpoint file and computes the JAX
frames (``model.stylize`` in f32) of seeded G-buffer sets.  The CLI runs in
this process with ``--device cpu``, where the kernel wrappers run their plain
versions.  Limits: the eager f32 path within one uint8 level of JAX's frames;
the fused path within rtol 0.08 / atol 0.03 of them (the port's fused-vs-eager
limit, ``tests/test_torch_fused.py``) and bit-equal to
``video.stylize_video``'s frames.  The int8 scales guard mirrors
``tests/test_quant_guard.py`` on the port.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch import cli as tcli
from realtime_style_transfer_torch import predict_video
from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.data.exr import write_gbuffer_fixture
from realtime_style_transfer_torch.data.hdr_screenshots import (
    find_screenshots, iter_hdr_screenshots)
from realtime_style_transfer_torch.data.imaging import image_to_uint8
from realtime_style_transfer_torch.entry import entry
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.ops.fused_transfer import (
    FusedTransfer, LANE, load_act_scales, save_act_scales, scales_fingerprint)
from realtime_style_transfer_torch.video import stylize_video
from realtime_style_transfer_tpu import cli as jcli
from realtime_style_transfer_tpu.config import ShapeConfig

torch.set_num_threads(2)

SPEC = "rst-128-16-8-17"
N_FRAMES = 3


def _pngs(directory):
    return [np.asarray(PIL.Image.open(p)) for p in sorted(directory.glob("frame_*.png"))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = ShapeConfig.from_spec(SPEC)
    for i in range(N_FRAMES):  # not the model's size: the loader resizes and crops
        write_gbuffer_fixture(root / "frames", f"f{i}", cfg.channels, 70, 130, seed=i,
                              compression="none")
    rng = np.random.default_rng(0)
    styles = []
    for k in range(2):
        styles.append(root / f"style{k}.png")
        PIL.Image.fromarray((rng.random((70, 130, 3)) * 255).astype(np.uint8)).save(styles[k])
    ramp = root / "ramp.png"
    PIL.Image.fromarray(np.repeat(np.linspace(0, 255, 128)[None], 64, 0).astype(np.uint8)).save(
        ramp)
    model, variables = jcli.build_inference(cfg, rng_seed=0)
    variables = jax.device_get(variables)
    ckpt = tcli.save_variables(root / "weights.npz", variables)
    # the JAX frames, f32, on the frames and style the CLI decodes
    tcfg = TConfig.from_spec(SPEC)
    content = np.stack(list(iter_hdr_screenshots(find_screenshots(root / "frames"),
                                                 tcfg.channels, tcfg.content_shape)))
    style = tcli.load_styles(styles[:1], tcfg)[None]
    sp = jax.jit(lambda v, s: model.apply(v, s, method=model.predict_style_params))(
        variables, jnp.asarray(style))
    stylize = jax.jit(lambda v, c, p: model.apply(v, c, p, method=model.stylize))
    want = np.stack([np.asarray(stylize(variables, jnp.asarray(c[None]), sp))[0]
                     for c in content])
    return types.SimpleNamespace(root=root, ckpt=ckpt, styles=styles, ramp=ramp,
                                 variables=variables, jax_stylize=stylize, content=content,
                                 jax_frames=want)


def _main(s, out, *extra, styles=1):
    argv = ["--network_spec", SPEC, "-C", str(s.ckpt), "--frames_dir", str(s.root / "frames"),
            "-o", str(s.root / out), "--device", "cpu", *extra]
    for p in s.styles[:styles]:
        argv += ["-s", str(p)]
    return predict_video.main(argv)


def test_checkpoint_loads_jax_variables_and_stylizes_as_jax(setup, tmp_path):
    cfg = TConfig.from_spec(SPEC)
    model = tcli.build_inference(cfg, device="cpu")
    variables = tcli.load_variables(setup.ckpt, model)
    assert sorted(variables) == ["batch_stats", "params"]
    rng = np.random.default_rng(4)
    sp = (rng.random((1, 1, model.plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    want = np.asarray(setup.jax_stylize(setup.variables, jnp.asarray(setup.content[:1]),
                                        jnp.asarray(sp)))
    with torch.no_grad():
        got = model.stylize(torch.from_numpy(setup.content[:1]), torch.from_numpy(sp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # a checkpoint with one leaf missing, one with a leaf too many, an Orbax directory
    with np.load(setup.ckpt) as data:
        flat = {k: data[k] for k in data.files}
    missing = dict(flat)
    missing.pop("params/transfer/contract_0_conv/bias")
    np.savez(tmp_path / "missing.npz", **missing)
    np.savez(tmp_path / "extra.npz", **flat, **{"params/transfer/extra/bias": np.zeros(3)})
    for name, text in (("missing", "unfilled port parameters"), ("extra", "unconsumed flax leaves")):
        with pytest.raises(ValueError, match=text):
            tcli.load_variables(tmp_path / f"{name}.npz", tcli.build_inference(cfg, device="cpu"))
    with pytest.raises(ValueError, match="Converting a JAX checkpoint"):
        tcli.load_variables(tmp_path, model)


def test_cli_standard_f32_within_one_level_of_jax(setup):
    out = _main(setup, "standard", "--path", "standard", "--dtype", "float32")
    got = _pngs(setup.root / "standard")
    assert out["path"] == "standard" and len(got) == N_FRAMES and out["nonfinite"] == 0
    want = image_to_uint8(setup.jax_frames)
    diff = np.abs(np.stack(got).astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1


def test_cli_fused_within_limits_of_jax_and_equal_to_stylize_video(setup):
    out = _main(setup, "fused", "--path", "fused", "--dtype", "float32")
    got = np.stack(_pngs(setup.root / "fused"))
    assert out["path"] == "fused" and len(got) == N_FRAMES and out["nonfinite"] == 0
    want = setup.jax_frames
    assert np.all(np.abs(got / 255.0 - want) <= 0.03 + 0.08 * np.abs(want))
    # video.stylize_video on the same decoded frames, engine and style
    cfg = TConfig.from_spec(SPEC)
    model = tcli.build_inference(cfg, device="cpu")
    variables = tcli.load_variables(setup.ckpt, model)
    ref = {}
    stylize_video(model, FusedTransfer(variables, plan_from_config(cfg), device="cpu"),
                  tcli.load_styles(setup.styles[:1], cfg), list(setup.content),
                  lambda i, frame: ref.__setitem__(i, image_to_uint8(frame)))
    np.testing.assert_array_equal(got, np.stack([ref[i] for i in range(N_FRAMES)]))


def test_cli_dual_with_weight_map_fused_and_packed(setup):
    fused = _main(setup, "dual", "--path", "fused", "-w", str(setup.ramp), styles=2)
    packed = _main(setup, "dual_packed", "--path", "packed", "-w", str(setup.ramp), styles=2)
    auto = _main(setup, "dual_auto", "-w", str(setup.ramp), "--max_frames", "1",
                 "--profile_dir", str(setup.root / "trace"), styles=2)
    assert (fused["path"], packed["path"], auto["path"]) == ("fused", "packed", "packed")
    f, p = np.stack(_pngs(setup.root / "dual")), np.stack(_pngs(setup.root / "dual_packed"))
    assert f.shape == p.shape == (N_FRAMES, 64, 128, 3)
    assert len(_pngs(setup.root / "dual_auto")) == 1
    assert list((setup.root / "trace").glob("*.pt.trace.json"))  # the torch.profiler trace
    # two bf16 paths of one blend: the fused-vs-packed frame limit (rtol 0.05,
    # atol 0.02) and one uint8 level of rounding
    assert np.all(np.abs(f / 255.0 - p / 255.0) <= 0.02 + 0.05 * p / 255.0 + 1 / 255.0)


def test_cli_int8_calibrates_saves_and_reloads(setup, caplog):
    scales = setup.root / "scales.npz"
    with caplog.at_level(logging.INFO, logger="predict_video"):
        first = _main(setup, "int8", "--path", "fused", "--quant", "int8",
                      "--calibration_frames", "2", "--scales_out", str(scales))
        again = _main(setup, "int8_reload", "--path", "fused", "--quant", "int8",
                      "--calibration_frames", "2", "--scales", str(scales))
        # --max_frames below --calibration_frames: both frames still check
        one = _main(setup, "int8_one", "--path", "fused", "--quant", "int8",
                    "--calibration_frames", "2", "--scales", str(scales), "--max_frames", "1")
    text = caplog.text
    assert "calibrated on 2 frames" in text and "saturation check ok on 2 frames" in text
    assert again["saturation"] is not None and first["saturation"] is None
    assert one["saturation"] == again["saturation"] and one["frames_written"] == 1
    np.testing.assert_array_equal(first["act_scales"], again["act_scales"])
    a, b = _pngs(setup.root / "int8"), _pngs(setup.root / "int8_reload")
    assert len(a) == N_FRAMES
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    loaded, fp = load_act_scales(scales)
    np.testing.assert_array_equal(loaded, first["act_scales"])
    assert fp and len(fp) == 64


@pytest.mark.parametrize("case", ["weights_one_style", "int8_packed", "data_parallel",
                                  "no_device_without_cuda", "no_frames_int8"])
def test_cli_refusals(setup, case, monkeypatch, tmp_path):
    if case == "weights_one_style":
        with pytest.raises(SystemExit, match="needs at least two -s styles"):
            _main(setup, "bad", "-w", str(setup.ramp))
    elif case == "int8_packed":
        with pytest.raises(SystemExit, match="requires the fused path"):
            _main(setup, "bad", "--path", "packed", "--quant", "int8")
    elif case == "data_parallel":
        # --data_parallel is ported (tests/test_torch_parallel.py); it streams
        # through the fused or packed engines only, as the JAX CLI
        with pytest.raises(SystemExit, match="use --path auto, fused or packed"):
            _main(setup, "bad", "--data_parallel", "2", "--path", "standard")
        assert not (setup.root / "bad").exists()
    elif case == "no_device_without_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = ["--network_spec", SPEC, "-C", str(setup.ckpt), "-s", str(setup.styles[0]),
                "--frames_dir", str(setup.root / "frames"), "-o", str(tmp_path / "x")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            predict_video.main(argv)
        assert not (tmp_path / "x").exists()
    else:
        (tmp_path / "empty").mkdir()
        argv = ["--network_spec", SPEC, "-C", str(setup.ckpt), "-s", str(setup.styles[0]),
                "--frames_dir", str(tmp_path / "empty"), "-o", str(tmp_path / "x"),
                "--device", "cpu", "--path", "fused", "--quant", "int8"]
        with pytest.raises(SystemExit, match="no frames found to calibrate"):
            predict_video.main(argv)


# ---- the int8 scales guard (tests/test_quant_guard.py on the port) ----------------


def test_scales_file_roundtrip_with_fingerprint(tmp_path):
    scales = np.random.default_rng(0).random((16, LANE)).astype(np.float32)
    path = tmp_path / "scales.npz"
    save_act_scales(path, scales, "abc123")
    got, fp = load_act_scales(path)
    np.testing.assert_array_equal(got, scales)
    assert fp == "abc123"
    # the exact path even with a .npy suffix (np.savez would append .npz)
    path2 = tmp_path / "scales.npy"
    save_act_scales(path2, scales, "xyz")
    assert path2.exists() and not (tmp_path / "scales.npy.npz").exists()
    got2, fp2 = load_act_scales(path2)
    np.testing.assert_array_equal(got2, scales)
    assert fp2 == "xyz"


def test_legacy_npy_scales_load_without_fingerprint(tmp_path, caplog):
    scales = np.ones((16, LANE), np.float32)
    path = tmp_path / "legacy.npy"
    np.save(path, scales)
    got, fp = load_act_scales(path)
    np.testing.assert_array_equal(got, scales)
    assert fp is None
    variables = {"params": {"k": np.arange(4, dtype=np.float32)}}
    with caplog.at_level(logging.WARNING, logger="predict_video"):
        got, _ = predict_video._get_scales(_args(scales=path), variables,
                                           np.ones((1, 1, 4), np.float32), None)
    np.testing.assert_array_equal(got, scales)
    assert "no provenance fingerprint" in caplog.text


def test_fingerprint_sensitive_to_weights_and_style():
    variables = {"params": {"conv": {"kernel": np.ones((3, 3, 4, 4), np.float32)}}}
    sp = np.ones((1, 1, 8), np.float32)
    base = scales_fingerprint(variables, sp)
    assert base == scales_fingerprint(variables, sp)  # deterministic
    assert base != scales_fingerprint(variables, sp * 1.01)  # style-sensitive
    v2 = {"params": {"conv": {"kernel": np.full((3, 3, 4, 4), 2.0, np.float32)}}}
    assert base != scales_fingerprint(v2, sp)  # checkpoint-sensitive
    w = np.zeros((1, 4, 4, 1), np.float32)
    assert scales_fingerprint(variables, sp, w) != base  # the dual weight map counts


def _args(**over):
    ns = types.SimpleNamespace(scales=None, scales_out=None, force_scales=False,
                               calibration_frames=1)
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


@pytest.fixture()
def guard_env(tmp_path):
    variables = {"params": {"k": np.arange(4, dtype=np.float32)}}
    sp = np.ones((1, 1, 4), np.float32)
    fp = scales_fingerprint(variables, sp, None)
    scales = np.ones((2, LANE), np.float32)
    return variables, sp, fp, scales, tmp_path / "scales.npz"


def test_cli_refuses_fingerprint_mismatch(guard_env):
    variables, sp, _fp, scales, path = guard_env
    save_act_scales(path, scales, "not-the-right-fingerprint")
    with pytest.raises(SystemExit, match="DIFFERENT"):
        predict_video._get_scales(_args(scales=path), variables, sp, None)


def test_cli_force_scales_overrides_and_checks(guard_env, caplog):
    variables, sp, _fp, scales, path = guard_env
    save_act_scales(path, scales, "wrong")
    report = [{"stage": "stem", "max_ratio": 3.0, "clip_events": 1000,
               "n_quantized": 10000}]
    with caplog.at_level("WARNING", logger="predict_video"):
        got, _ = predict_video._get_scales(_args(scales=path, force_scales=True), variables,
                                           sp, None)
        predict_video._check_loaded_scales(report, 1)
    np.testing.assert_array_equal(got, scales)
    assert "force_scales" in caplog.text and "SATURATE" in caplog.text


def test_cli_matching_fingerprint_loads_and_passes_check(guard_env, caplog):
    variables, sp, fp, scales, path = guard_env
    save_act_scales(path, scales, fp)
    report = [{"stage": "stem", "max_ratio": 1.0, "clip_events": 0,
               "n_quantized": 10000}]
    with caplog.at_level("INFO", logger="predict_video"):
        got, got_fp = predict_video._get_scales(_args(scales=path), variables, sp, None)
        predict_video._check_loaded_scales(report, 1)
    np.testing.assert_array_equal(got, scales)
    assert got_fp == fp
    assert "saturation check ok" in caplog.text and "force_scales" not in caplog.text


def test_entry_runs_one_finite_forward():
    forward, args = entry("rst-128-16-8-3", device="cpu")
    out = forward(*args)
    assert tuple(out.shape) == (1, 64, 128, 3) and bool(torch.isfinite(out).all())
