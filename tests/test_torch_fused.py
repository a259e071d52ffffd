"""The port's fused transfer path on the CPU (the stage kernels' plain versions).

``FusedTransfer`` with ``device="cpu"`` runs the same stage loop as on CUDA,
with each wrapper dispatching CPU tensors to its plain PyTorch version.  It is
held against the JAX package's bf16 ``stylize_packed`` and the TF reference
fixture with the JAX fused tests' limits (``tests/test_fused_transfer.py``):
rtol 0.05, atol 0.02, median < 5e-3.  The CUDA kernels themselves are checked
against these plain versions on the card by ``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.data.pipeline import DevicePrefetcher
from realtime_style_transfer_torch.models import inference as tinference
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.models.predictor import StylePredictor as TPredictor
from realtime_style_transfer_torch.models.transfer import StyleTransferNet as TNet
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.conv import (
    conv2d_same,
    conv_transpose_2x,
    pack_transpose_kernel,
)
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.ops.kernels import (
    Prologue,
    conv_stage,
    conv_stage_plain,
    finish,
    make_conv_stage,
)
from realtime_style_transfer_torch.video import stylize_video
from realtime_style_transfer_torch.weights import load_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet
from realtime_style_transfer_tpu.models.transfer_packed import stylize_packed
from realtime_style_transfer_tpu.ops.pallas.fused_transfer import FusedTransfer as JFused

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from convert_keras_weights import convert_transfer  # noqa: E402

torch.set_num_threads(2)

TINY_KW = dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
               num_channels=17, hdr=True)
TINY = ShapeConfig(**TINY_KW)
TPLAN = tplan(TConfig(**TINY_KW))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def flagship_tiny():
    rng = np.random.default_rng(21)
    plan = plan_from_config(TINY)
    net = StyleTransferNet(plan=plan, num_styles=1)
    content = rng.random((1,) + TINY.content_shape).astype(np.float32)
    style_params = (rng.random((1, 1, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(3), content, style_params, train=False))
    return plan, variables, content, style_params


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3


def test_pack_frame_np_matches_jax_bit_for_bit(flagship_tiny):
    plan, variables, content, _ = flagship_tiny
    want = np.asarray(JFused(variables, plan, interpret=True).pack_frame_np(content))
    fused = FusedTransfer(variables, TPLAN, device="cpu")
    got = fused.pack_frame_np(content)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (16, 32, 384)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    device_pack = fused.pack_frame(t(content))
    assert torch.equal(device_pack.view(torch.int16), got.view(torch.int16))


def test_unpack_frame_np_matches_jax(flagship_tiny):
    plan, variables, _, _ = flagship_tiny
    raw = np.random.default_rng(2).random((16, 32, 128)).astype(np.float32)
    want = JFused(variables, plan, interpret=True).unpack_frame_np(raw)
    got = FusedTransfer(variables, TPLAN, device="cpu").unpack_frame_np(t(raw))
    assert got.shape == want.shape == (1, 64, 128, 3)
    np.testing.assert_array_equal(got, want)


def test_fused_cpu_matches_jax_stylize_packed_bf16(flagship_tiny):
    plan, variables, content, style_params = flagship_tiny
    want = np.asarray(stylize_packed(variables, jnp.asarray(content), jnp.asarray(style_params),
                                     plan=plan, dtype=jnp.bfloat16), np.float32)
    fused = FusedTransfer(variables, TPLAN, device="cpu")
    got = fused(t(content), t(style_params)).numpy()
    assert got.shape == want.shape == (1,) + TINY.output_shape
    assert_bf16_close(got, want)


def test_fused_cpu_matches_eager_f32_net_loosely(flagship_tiny):
    _, variables, content, style_params = flagship_tiny
    net = load_flax(TNet(TPLAN), variables)
    with torch.no_grad():
        want = net(t(content), t(style_params)).numpy()
    fused = FusedTransfer(variables, TPLAN, device="cpu")
    prepared = fused.prepare_style(t(style_params))
    got = fused.stylize_prepacked(fused.pack_frame_np(content), prepared).numpy()
    np.testing.assert_allclose(got, want, rtol=0.08, atol=0.03)
    raw = fused.stylize_prepacked_raw(fused.pack_frame_np(content), prepared)
    assert tuple(raw.shape) == (16, 32, 128) and raw.dtype == torch.bfloat16
    assert not raw[:, :, 48:].any()
    np.testing.assert_array_equal(fused.unpack_frame_np(raw), got)


def test_fused_cpu_matches_tf_reference_fixture():
    fixture = REPO / "tests" / "golden" / "reference" / "transfer_tiny"
    w, io = np.load(fixture / "weights.npz"), np.load(fixture / "io.npz")
    fused = FusedTransfer(convert_transfer(w), TPLAN, device="cpu")
    out = fused(t(io["content"]), t(io["style_params"])).numpy()
    err = np.abs(out - io["output"])
    assert err.max() < 5e-2
    assert np.median(err) < 5e-3


@pytest.mark.slow
def test_fused_cpu_matches_jax_fused_interpret(flagship_tiny):
    plan, variables, content, style_params = flagship_tiny
    want = np.asarray(JFused(variables, plan, interpret=True)(
        jnp.asarray(content), jnp.asarray(style_params)), np.float32)
    got = FusedTransfer(variables, TPLAN, device="cpu")(t(content), t(style_params)).numpy()
    assert_bf16_close(got, want)


# ---------------------------------------------------------------------------
# stage wrappers: plain versions, dispatch, counters
# ---------------------------------------------------------------------------


def _bf16(a):
    return t(a).to(torch.bfloat16)


def test_plain_transpose_stage_matches_conv_transpose_and_moments():
    rng = np.random.default_rng(12)
    x = _bf16(rng.random((6, 8, 16)))
    kernel = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    kernel_bf = _bf16(kernel).float()
    packed, (pad_y, pad_x) = pack_transpose_kernel(kernel_bf)
    st = make_conv_stage("e", packed.numpy(), np.tile(bias, 4), in_hw=(6, 8),
                         out_hw=(6, 8), stride=1, pads=(pad_y[0], pad_x[0]), epi="bias",
                         device="cpu", transpose_cout=8)
    out = torch.empty(st.out_shape, dtype=torch.bfloat16)
    stats = torch.zeros((2, 8))
    conv_stage(x, st, out, stats_out=stats)
    want = conv_transpose_2x(x.float()[None], kernel_bf)[0] + t(bias)
    np.testing.assert_allclose(out.float().numpy(), want.to(torch.bfloat16).float().numpy(),
                               rtol=1.6e-2, atol=1e-2 * want.abs().max().item())
    np.testing.assert_allclose(stats[0].numpy(), want.sum(dim=(0, 1)).numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(stats[1].numpy(), (want * want).sum(dim=(0, 1)).numpy(),
                               rtol=1e-4, atol=1e-3)


def test_plain_stage_prologue_applies_cin_before_zero_padding():
    """Out-of-image taps are zero AFTER the transform: the conv pads the
    normalised activation."""
    rng = np.random.default_rng(13)
    x = _bf16(rng.random((8, 8, 8)))
    kernel = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    st = make_conv_stage("r", kernel, np.zeros(8), in_hw=(8, 8), out_hw=(8, 8), stride=1,
                         pads=(1, 1), epi="bias", device="cpu")
    xf = x.float().reshape(-1, 8)
    stats = torch.stack([xf.sum(0), (xf * xf).sum(0)])
    scale, bias = t(rng.random(8) + 0.5), t(rng.random(8) - 0.5)
    pro = Prologue(stats, 64.0, scale, bias, 1e-5, True)
    skip = _bf16(rng.random((8, 8, 8)))
    skip_out = torch.empty_like(x)
    out = torch.empty((8, 8, 8), dtype=torch.bfloat16)
    conv_stage(x, st, out, prologue=pro, skip_in=skip, skip_out=skip_out)
    mean = xf.mean(0)
    var = (xf * xf).mean(0) - mean * mean
    normed = torch.relu((x.float() - mean) / torch.sqrt(var + 1e-5) * scale + bias) + skip.float()
    np.testing.assert_allclose(skip_out.float().numpy(),
                               normed.to(torch.bfloat16).float().numpy(), atol=1e-2)
    want = conv2d_same(skip_out.float()[None], st.weight_oihw())[0]
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)


def test_plain_finish_packs_sigmoid_in_pack_order():
    rng = np.random.default_rng(14)
    x = _bf16(rng.standard_normal((8, 12, 3)))
    xf = x.float().reshape(-1, 3)
    pro = Prologue(torch.stack([xf.sum(0), (xf * xf).sum(0)]), 96.0, torch.ones(3),
                   torch.zeros(3), 1e-5, False)
    out = torch.full((2, 3, 128), 7.0, dtype=torch.bfloat16)
    finish(x, pro, out)
    mean = xf.mean(0)
    std = torch.sqrt((xf * xf).mean(0) - mean * mean + 1e-5)
    want = torch.sigmoid((x.float() - mean) / std)
    np.testing.assert_allclose(kernels.unpack_frame(out, 3).float().numpy(),
                               want.numpy(), atol=1e-2)
    assert not out[:, :, 48:].any()


def test_wrappers_send_cpu_tensors_to_plain_versions_without_counting(flagship_tiny):
    _, variables, content, style_params = flagship_tiny
    kernels.reset_launch_counts()
    fused = FusedTransfer(variables, TPLAN, device="cpu")
    prepared = fused.prepare_style(t(style_params))
    packed = fused.pack_frame_np(content)
    got = fused.stylize_prepacked_raw(packed, prepared)
    plain = fused.stylize_prepacked_raw(packed, prepared, plain=True)
    assert torch.equal(got, plain)
    assert kernels.conv_stage.launches == 0 and kernels.finish.launches == 0
    assert len(fused.steps) == 16


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "flax", "orbax", "ml_dtypes", "realtime_style_transfer_tpu")


def test_port_and_chip_smoke_import_nothing_of_jax():
    files = sorted((REPO / "realtime_style_transfer_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_chip_smoke_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_entry_points_default_to_cuda_and_never_fall_back(flagship_tiny, monkeypatch):
    _, variables, _, _ = flagship_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedTransfer(variables, TPLAN)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinference.make_inference_model(TConfig(**TINY_KW))
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher(iter(()))


def test_unsupported_modes_raise_not_implemented(flagship_tiny):
    _, variables, _, _ = flagship_tiny
    # int8 is ported: without act_scales it raises the JAX package's ValueError
    with pytest.raises(ValueError, match="act_scales"):
        FusedTransfer(variables, TPLAN, quant="int8", device="cpu")
    three = tplan(TConfig(resolution_divider=1, num_channels=17))
    assert three.num_contract_blocks == 3
    # the three-seg plan is ported: the engine builds on TINY3 weights
    tiny3 = tplan(TConfig(resolution_divider=15, bottleneck_res_y=8, bottleneck_num_filters=8,
                          num_channels=17, hdr=True))
    torch.manual_seed(0)
    engine3 = FusedTransfer(to_flax(TNet(tiny3).state_dict()), tiny3, device="cpu")
    assert engine3.three_seg and len(engine3.steps) == engine3.n_conv_stages == 18
    # the reference rejects dual style on this plan, before anything is built
    with pytest.raises(ValueError, match="dual-style is not yet supported on the 3-contract"):
        FusedTransfer(variables, three, num_styles=2, device="cpu")
    with pytest.raises(ValueError, match="1 or 2 styles"):
        FusedTransfer(variables, TPLAN, num_styles=3, device="cpu")
    with pytest.raises(NotImplementedError, match="EfficientNetV2-S"):
        TPredictor(10, "efficientnet")
    with pytest.raises(ValueError):
        FusedTransfer(variables, tplan(TConfig(resolution_divider=16, bottleneck_res_y=30,
                                               bottleneck_num_filters=4, num_channels=3,
                                               hdr=False)), device="cpu")


def test_tpu_only_knobs_are_accepted_and_ignored(flagship_tiny):
    _, variables, content, style_params = flagship_tiny
    base = FusedTransfer(variables, TPLAN, device="cpu")
    knobs = FusedTransfer(variables, TPLAN, device="cpu", direct_ring=False,
                          wmip_resident=False, q_edges=True, wb_expanded=True,
                          k_resident=True)
    prepared = base.prepare_style(t(style_params))
    packed = base.pack_frame_np(content)
    assert torch.equal(base.stylize_prepacked_raw(packed, prepared),
                       knobs.stylize_prepacked_raw(packed, prepared))


# ---------------------------------------------------------------------------
# prefetcher and video loop
# ---------------------------------------------------------------------------


def test_prefetcher_keeps_order_and_reraises_in_order():
    items = [torch.full((2,), float(i)) for i in range(5)]
    got = list(DevicePrefetcher(iter(items), depth=2, device="cpu",
                                prepare=lambda x: x * 2))
    assert [int(g[0]) for g in got] == [0, 2, 4, 6, 8]

    def broken():
        yield torch.zeros(1)
        raise KeyError("source failed")

    it = DevicePrefetcher(broken(), device="cpu")
    assert torch.equal(next(it), torch.zeros(1))
    with pytest.raises(KeyError):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_video_loop_streams_frames_through_the_fused_path():
    cfg = TConfig(feature_extractor="dummy", **TINY_KW)
    model = tinference.make_inference_model(cfg, device="cpu", seed=1)
    fused = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu")
    rng = np.random.default_rng(15)
    style = rng.random(cfg.output_shape, dtype=np.float32)
    frames = [rng.random(cfg.content_shape, dtype=np.float32) for _ in range(3)]
    seen = {}
    kernels.reset_launch_counts()
    run = stylize_video(model, fused, style, frames, seen.__setitem__, depth=2,
                        max_frames=2)
    assert sorted(seen) == [0, 1] and len(run["latency_s"]) == 2
    assert kernels.conv_stage.launches == 0
    with torch.no_grad():
        style_params = model.predict_style_params(t(style)[None, None])
    assert torch.equal(run["style_params"], style_params)
    prepared = fused.prepare_style(style_params)
    for i in seen:
        want = fused.stylize_prepared(t(frames[i])[None], prepared)[0].numpy()
        np.testing.assert_array_equal(seen[i], want)
        assert seen[i].shape == cfg.output_shape
        with torch.no_grad():
            eager = model.transfer(t(frames[i])[None], style_params)[0].numpy()
        np.testing.assert_allclose(seen[i], eager, rtol=0.08, atol=0.03)


@pytest.mark.parametrize("k,stride,cin,window,cin_k", [
    (9, 1, 17, True, 32), (9, 1, 16, True, 16), (3, 1, 128, False, 128),
    (3, 2, 32, False, 32), (2, 1, 8, False, 8)])
def test_stage_layout_picks_path_and_keeps_weights(k, stride, cin, window, cin_k):
    kernel = np.random.default_rng(k + cin).standard_normal((k, k, cin, 8)).astype(np.float32)
    st = make_conv_stage("s", kernel, np.zeros(8), in_hw=(16, 16), out_hw=(16, 16),
                         stride=stride, pads=(k // 2, k // 2), epi="bias", device="cpu",
                         pack_c=384 if cin == 17 else 0)
    assert (st.window, st.cin_k) == (window, cin_k)
    assert st.w.shape[1] % 32 == 0 and (st.kmap is None) == window
    want = _bf16(kernel).float().permute(3, 2, 0, 1)
    assert torch.equal(st.weight_oihw(), want)
    if not window:
        km = st.kmap[:st.k_real].numpy()
        kk = np.arange(st.k_real)
        assert np.array_equal(km >> 20, kk // (k * cin))
        assert np.array_equal((km >> 10) & 1023, (kk // cin) % k)
        assert np.array_equal(km & 1023, kk % cin)
        assert (st.kmap[st.k_real:] == -1).all()


def test_plain_strided_stage_is_one_conv_on_bf16_operands():
    """The plain stage conv equals one F.conv2d on the same bf16 operands."""
    rng = np.random.default_rng(16)
    x = _bf16(rng.random((8, 16, 16)))
    kernel = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    st = make_conv_stage("c", kernel, np.zeros(8), in_hw=(8, 16), out_hw=(4, 8), stride=2,
                         pads=(0, 0), epi="relu", device="cpu")
    out = torch.empty(st.out_shape, dtype=torch.bfloat16)
    conv_stage_plain(x, st, out)
    w = st.weight_oihw()
    want = torch.relu(F.conv2d(F.pad(x.float().permute(2, 0, 1)[None], (0, 1, 0, 1)), w,
                               stride=2))[0].permute(1, 2, 0)
    assert torch.equal(out, want.to(torch.bfloat16))
