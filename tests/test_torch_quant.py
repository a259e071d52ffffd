"""The port's int8 deploy engine on the CPU (the stage kernels' plain versions).

``FusedTransfer(quant="int8")`` calibrated on the port's own bf16 engine is
held against the JAX package's bf16 ``stylize_packed`` with the JAX int8 bar
(``tests/test_fused_quant.py:76-81``: max < 0.06, median < 0.01, PSNR >
35 dB), single and dual style, at that file's TINY config and seeds.  The
calibrate / check reductions, the int8 stage arithmetic and the weight
quantization are held against numpy formulas; the scales-file functions
against ``tests/test_quant_guard.py``'s cases.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models import inference as tinference
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.ops import fused_transfer as tfused
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.conv import depth_to_space_2x, pack_transpose_kernel
from realtime_style_transfer_torch.ops.fused_transfer import (
    FusedTransfer,
    load_act_scales,
    save_act_scales,
    scales_fingerprint,
)
from realtime_style_transfer_torch.ops.kernels import (
    act_stats,
    conv_stage,
    make_conv_stage,
)
from realtime_style_transfer_torch.ops.probe_int8 import make_inputs, probe_band, probe_mm
from realtime_style_transfer_torch.video import stylize_video
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet
from realtime_style_transfer_tpu.models.transfer_packed import stylize_packed
from realtime_style_transfer_tpu.ops.pallas.fused_transfer import FusedTransfer as JFused

torch.set_num_threads(2)

TINY_KW = dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
               num_channels=17, hdr=True)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _build(num_styles: int):
    """The inputs of ``tests/test_fused_quant.py``'s ``_build``."""
    cfg = ShapeConfig(num_styles=num_styles, **TINY_KW)
    plan = plan_from_config(cfg)
    net = StyleTransferNet(plan=plan, num_styles=num_styles)
    rng = np.random.default_rng(21 + num_styles)
    content = rng.random((1,) + cfg.content_shape).astype(np.float32)
    style_params = (rng.random((1, num_styles, plan.num_style_parameters)) * 0.4
                    + 0.8).astype(np.float32)
    weights = None
    if num_styles == 2:
        h, w, _ = cfg.content_shape
        yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None, None]
        weights = np.broadcast_to(yy, (1, h, w, 1)).copy()
    kwargs = {} if weights is None else {"style_weights": weights}
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(3), content, style_params, train=False, **kwargs))
    return plan, variables, content, style_params, weights


@pytest.fixture(scope="module", params=[1, 2], ids=["single", "dual"])
def case(request):
    return (request.param,) + _build(request.param)


@pytest.fixture(scope="module")
def single():
    return _build(1)


def _engine(variables, num_styles=1, **kw):
    return FusedTransfer(variables, tplan(TConfig(num_styles=num_styles, **TINY_KW)),
                         num_styles=num_styles, device="cpu", **kw)


def _quant_pair(variables, content, style_params, weights=None):
    """(bf16 frame, int8 frame, scales): the int8 engine calibrated on the
    bf16 engine's first frame, as the JAX test's ``_quant_pair``."""
    ns = 1 if weights is None else 2
    ft = _engine(variables, ns)
    prepared = ft.prepare_style(t(style_params), None if weights is None else t(weights))
    packed = ft.pack_frame_np(content)
    ref = ft.stylize_prepacked(packed, prepared).numpy()
    scales = ft.calibrate_act_scales([packed], prepared)
    ftq = _engine(variables, ns, quant="int8", act_scales=scales)
    got = ftq.stylize_prepacked(packed, ftq.prepare_style(
        t(style_params), None if weights is None else t(weights))).numpy()
    return ref, got, scales


def _psnr(got, ref):
    return 10 * np.log10(1.0 / max(float(np.mean((got - ref) ** 2)), 1e-12))


def test_int8_matches_jax_bf16_stylize_packed(case):
    num_styles, plan, variables, content, style_params, weights = case
    extra = () if weights is None else (jnp.asarray(weights),)
    want = np.asarray(stylize_packed(variables, jnp.asarray(content), jnp.asarray(style_params),
                                     *extra, plan=plan, dtype=jnp.bfloat16), np.float32)
    _, got, scales = _quant_pair(variables, content, style_params, weights)
    assert scales.shape == (16, 128) and got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() < 0.06, err.max()
    assert np.median(err) < 0.01
    assert _psnr(got, want) > 35.0


def test_calibration_is_the_max_of_each_stage_input(single, monkeypatch):
    """calibrate_act_scales equals, exactly, the per-stage max |x'| of the
    plain stage chain, with x' written out in numpy."""
    _, variables, content, style_params, _ = single
    ft = _engine(variables)
    prepared = ft.prepare_style(t(style_params))
    packed = ft.pack_frame_np(content)
    seen = []
    plain = kernels.conv_stage_plain

    def record(x, st, out, *, prologue=None, skip_in=None, **kw):
        if st.pack_c:  # fold the pack's 16 subpixels to the logical channels
            a = np.abs(x.float().numpy()[..., :16 * st.cin]).reshape(-1, 16, st.cin)
            seen.append(a.max(axis=(0, 1)))
        else:
            xn = x.float().numpy()
            if prologue is not None:
                s = prologue.stats.numpy()
                mean = s[0] / np.float32(prologue.count)
                var = s[1] / np.float32(prologue.count) - mean * mean
                a_ = prologue.scale.numpy() * (np.float32(1) / np.sqrt(var + np.float32(prologue.eps)))
                xn = xn * a_ + (prologue.bias.numpy() - mean * a_)
                if prologue.relu:
                    xn = np.maximum(xn, np.float32(0))
            if skip_in is not None:
                xn = xn + skip_in.float().numpy()
            xb = t(xn).to(torch.bfloat16).float().numpy()
            seen.append(np.abs(xb).reshape(-1, st.cin).max(axis=0))
        return plain(x, st, out, prologue=prologue, skip_in=skip_in, **kw)

    monkeypatch.setattr(tfused, "conv_stage_plain", record)
    ft.stylize_prepacked_raw(packed, prepared, plain=True)
    monkeypatch.undo()
    kernels.reset_launch_counts()
    scales = ft.calibrate_act_scales([packed], prepared)
    assert kernels.act_stats.launches == 0 and kernels.conv_stage.launches == 0
    assert len(seen) == len(ft.steps) == scales.shape[0] == 16
    for i, (step, m) in enumerate(zip(ft.steps, seen)):
        cin = step.stage.cin
        np.testing.assert_array_equal(scales[i, :cin], m, err_msg=step.stage.name)
        assert not scales[i, cin:].any()
    assert (scales[0, :17] > 0).all() and ft.steps[0].stage.cin == 17
    np.testing.assert_array_equal(ft.calibrate_act_scales([packed, packed], prepared), scales)
    np.testing.assert_array_equal(ft.calibrate_act_scales([packed], prepared, plain=True),
                                  scales)


def test_maxed_scales_serve_both_styles(single):
    """Per-style tables combined with np.maximum serve both styles
    (``tests/test_fused_quant.py:107-132``)."""
    _, variables, content, style_params, _ = single
    ft = _engine(variables)
    rng = np.random.default_rng(33)
    strong = (rng.random((1, 1, style_params.shape[-1])) * 0.8 + 1.2).astype(np.float32)
    styles = [style_params, strong]
    packed = ft.pack_frame_np(content)
    preps = [ft.prepare_style(t(s)) for s in styles]
    tables = [ft.calibrate_act_scales([packed], p) for p in preps]
    assert (tables[1] >= tables[0]).mean() > 0.5
    ftq = _engine(variables, quant="int8", act_scales=np.maximum(*tables))
    for s, p in zip(styles, preps):
        ref = ft.stylize_prepacked(packed, p).numpy()
        got = ftq.stylize_prepacked(packed, ftq.prepare_style(t(s))).numpy()
        err = np.abs(got - ref)
        assert err.max() < 0.08 and np.median(err) < 0.02


def test_int8_refusals(single):
    _, variables, content, style_params, _ = single
    with pytest.raises(ValueError, match="act_scales"):
        _engine(variables, quant="int8")
    with pytest.raises(ValueError, match="per-"):
        _engine(variables, quant="int8", act_scales=np.ones((3, 128), np.float32))
    # a JAX-layout table (17 kernels x 512 packed lanes) is refused at build
    with pytest.raises(ValueError, match="per-"):
        _engine(variables, quant="int8", act_scales=np.ones((17, 512), np.float32))
    with pytest.raises(ValueError, match="quant"):
        _engine(variables, quant="fp8")
    ft = _engine(variables)
    prepared = ft.prepare_style(t(style_params))
    packed = ft.pack_frame_np(content)
    scales = ft.calibrate_act_scales([packed], prepared)
    ftq = _engine(variables, quant="int8", act_scales=scales)
    with pytest.raises(ValueError, match="bf16 engine"):
        ftq.calibrate_act_scales([packed], prepared)
    with pytest.raises(ValueError, match="bf16 engine"):
        ftq.check_act_saturation([packed], prepared, scales)
    with pytest.raises(ValueError, match="calibration frame"):
        ft.calibrate_act_scales([], prepared)
    with pytest.raises(ValueError, match="frame to check"):
        ft.check_act_saturation([], prepared, scales)
    with pytest.raises(ValueError, match="act_scales must be"):
        ft.check_act_saturation([packed], prepared, scales[:, :64])
    with pytest.raises(ValueError, match="per-input-channel"):
        make_conv_stage("s", np.zeros((3, 3, 8, 8), np.float32), np.zeros(8), in_hw=(8, 8),
                        out_hw=(8, 8), stride=1, pads=(1, 1), epi="bias", device="cpu",
                        act_scale=np.ones(16, np.float32))


def test_int8_chunk_equals_single_calls_bit_for_bit(single):
    _, variables, content, style_params, _ = single
    ft = _engine(variables)
    scales = ft.calibrate_act_scales([ft.pack_frame_np(content)],
                                     ft.prepare_style(t(style_params)))
    ftq = _engine(variables, quant="int8", act_scales=scales)
    prepared = ftq.prepare_style(t(style_params))
    frames = np.random.default_rng(41).random((2,) + content.shape[1:]).astype(np.float32)
    packed = torch.stack([ftq.pack_frame_np(frames[i:i + 1]) for i in range(2)])
    chunk = ftq.stylize_prepacked_chunk(packed, prepared)
    singles = torch.cat([ftq.stylize_prepacked(packed[i], prepared) for i in range(2)])
    assert torch.equal(chunk, singles)


def test_saturation_report_separates_matching_and_strong_styles(single):
    """``tests/test_fused_quant.py:174-205``, with every input element
    counted once: n_quantized == H * W * cin * frames."""
    _, variables, content, style_params, _ = single
    ft = _engine(variables)
    packed = ft.pack_frame_np(content)
    prep_a = ft.prepare_style(t(style_params))
    scales_a = ft.calibrate_act_scales([packed], prep_a)
    ok = ft.check_act_saturation([packed, packed], prep_a, scales_a)
    assert [r["stage"] for r in ok] == [s.stage.name for s in ft.steps]
    assert max(r["max_ratio"] for r in ok) <= 1.0 + 1e-5
    assert sum(r["clip_events"] for r in ok) == 0
    for r, step in zip(ok, ft.steps):
        h, w = step.stage.in_hw
        assert r["n_quantized"] == h * w * step.stage.cin * 2
    rng = np.random.default_rng(55)
    strong = (rng.random((1, 1, style_params.shape[-1])) * 2.0 + 3.0).astype(np.float32)
    bad = ft.check_act_saturation([packed], ft.prepare_style(t(strong)), scales_a)
    assert max(r["max_ratio"] for r in bad) > 1.25
    assert sum(r["clip_events"] for r in bad) > 0


# ---------------------------------------------------------------------------
# the int8 stage and its weights, written out in numpy
# ---------------------------------------------------------------------------


def _np_quantize_kernel(k, s_row):
    """``fused_transfer.py:768-780`` in numpy."""
    s_c = np.maximum(s_row[:k.shape[2]], 1e-6)
    k_scaled = k * s_c[None, None, :, None]
    s_w = np.abs(k_scaled).reshape(-1, k.shape[3]).max(axis=0)
    s_w = np.maximum(s_w / 127.0, 1e-12)
    return (np.clip(np.rint(k_scaled / s_w), -127, 127).astype(np.int8),
            s_w / 127.0, 127.0 / s_c)


# (kind, kernel shape, input hw, pads, stride, transpose cout)
STAGES = {
    "gather": ((3, 3, 16, 8), (8, 10), (1, 1), 1, 0),
    "transpose": ((3, 3, 8, 4), (6, 8), None, 1, 4),
    "window": ((9, 9, 16, 3), (12, 16), (4, 4), 1, 0),
}


def _int8_stage(kind, rng):
    kshape, hw, pads, stride, tcout = STAGES[kind]
    kernel = (rng.standard_normal(kshape) * 0.2).astype(np.float32)
    if tcout:
        packed, (pad_y, pad_x) = pack_transpose_kernel(torch.from_numpy(kernel))
        kernel, pads = packed.numpy(), (pad_y[0], pad_x[0])
    cin, n = kernel.shape[2], kernel.shape[3]
    s_row = (rng.random(cin) * 2 + 0.5).astype(np.float32)
    s_row[::3] = 63.5  # act_inv = 2 exactly: bf16 x = k + 0.25 gives a tie
    bias = rng.standard_normal(n // 4 if tcout else n).astype(np.float32)
    st = make_conv_stage(kind, kernel, np.tile(bias, 4) if tcout else bias, in_hw=hw,
                         out_hw=hw, stride=stride, pads=pads, epi="bias", device="cpu",
                         transpose_cout=tcout, act_scale=s_row)
    return st, kernel, s_row


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_int8_weights_and_rows_match_the_jax_formula(kind):
    st, kernel, s_row = _int8_stage(kind, np.random.default_rng(61))
    q, dq, inv = _np_quantize_kernel(kernel, s_row)
    assert st.quant and st.w.dtype == torch.int8
    assert st.cin_k == (32 if kind == "window" else st.cin) and st.w.shape[1] % 32 == 0
    np.testing.assert_array_equal(st.weight_oihw().numpy(),
                                  q.astype(np.float32).transpose(3, 2, 0, 1))
    assert not st.w[:, st.k_real:].any()
    np.testing.assert_array_equal(st.dequant.numpy(), dq.astype(np.float32))
    np.testing.assert_array_equal(st.act_inv.numpy(), inv.astype(np.float32))


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_plain_int8_stage_matches_numpy(kind):
    """Quantize (ties to even, +-127 clip), zero padding after it, exact
    integer conv, one rounding to f32, dequant, bias, moments."""
    rng = np.random.default_rng(62)
    st, _, _ = _int8_stage(kind, rng)
    h, w = st.in_hw
    x = np.floor(rng.standard_normal((h, w, st.cin)) * 40) + 0.25  # ties at act_inv 2
    x[0, 0, :] = 300.0  # clips
    xb = t(x).to(torch.bfloat16)
    out = torch.empty(st.out_shape, dtype=torch.bfloat16)
    stats = torch.zeros((2, st.c_log))
    conv_stage(xb, st, out, stats_out=stats)

    xq = np.clip(np.rint(xb.float().numpy() * st.act_inv.numpy()), -127, 127)
    assert (xq == 127).any() and (np.abs(xq) % 2 == 0).any()
    wq = st.weight_oihw().numpy().astype(np.float64)  # (n, cin, kh, kw)
    oh, ow = st.out_hw
    xp = np.zeros((h + st.kh, w + st.kw, st.cin))
    xp[st.pad_top:st.pad_top + h, st.pad_left:st.pad_left + w] = xq
    acc = np.zeros((oh, ow, st.n))
    for ty in range(st.kh):
        for tx in range(st.kw):
            acc += xp[ty:ty + oh, tx:tx + ow] @ wq[:, :, ty, tx].T
    v = acc.astype(np.float32) * st.dequant.numpy() + st.bias.numpy()
    want = t(v).to(torch.bfloat16)
    if st.transpose:
        want = depth_to_space_2x(want[None], st.c_log)[0]
    assert torch.equal(out, want)
    sums = v.sum(axis=(0, 1)).reshape(-1, st.c_log).sum(axis=0)
    np.testing.assert_allclose(stats[0].numpy(), sums, rtol=1e-5, atol=1e-3)


def test_act_stats_counts_each_element_once_under_the_clip_threshold():
    rng = np.random.default_rng(63)
    st, _, _ = _int8_stage("gather", rng)
    x = t(rng.standard_normal(st.in_shape) * 3).to(torch.bfloat16)
    inv = t(np.full(st.cin, 127.0 / 4.0))
    kernels.reset_launch_counts()
    maxima, clips = act_stats(x, st, act_inv=inv)
    a = np.abs(x.float().numpy()).reshape(-1, st.cin)
    np.testing.assert_array_equal(maxima.numpy(), a.max(axis=0))
    np.testing.assert_array_equal(clips.numpy(), (a * np.float32(127 / 4) > 127.5).sum(axis=0))
    assert clips.dtype == torch.int32 and clips.sum() > 0 and kernels.act_stats.launches == 0
    assert not act_stats(x, st)[1].any()


# ---------------------------------------------------------------------------
# scales files, the video flow, the probe
# ---------------------------------------------------------------------------


def test_scales_file_roundtrip_with_fingerprint_and_legacy_npy(tmp_path):
    scales = np.random.default_rng(0).random((16, 128)).astype(np.float32)
    path = tmp_path / "scales.npz"
    save_act_scales(path, scales, "abc123")
    got, fp = load_act_scales(path)
    np.testing.assert_array_equal(got, scales)
    assert fp == "abc123"
    path2 = tmp_path / "scales.npy"
    save_act_scales(path2, scales, "xyz")
    assert path2.exists() and not (tmp_path / "scales.npy.npz").exists()
    assert load_act_scales(path2)[1] == "xyz"
    legacy = tmp_path / "legacy.npy"
    np.save(legacy, np.ones((16, 128), np.float32))
    got, fp = load_act_scales(legacy)
    assert fp is None and got.shape == (16, 128)


def test_fingerprint_sensitive_to_weights_and_style():
    variables = {"params": {"conv": {"kernel": np.ones((3, 3, 4, 4), np.float32)}}}
    sp = np.ones((1, 1, 8), np.float32)
    base = scales_fingerprint(variables, sp)
    assert base == scales_fingerprint(variables, t(sp))  # deterministic, tensors too
    assert base != scales_fingerprint(variables, sp * 1.01)
    v2 = {"params": {"conv": {"kernel": np.full((3, 3, 4, 4), 2.0, np.float32)}}}
    assert base != scales_fingerprint(v2, sp)
    assert scales_fingerprint(variables, sp, np.zeros((1, 4, 4, 1), np.float32)) != base
    renamed = {"params": {"conv2": {"kernel": np.ones((3, 3, 4, 4), np.float32)}}}
    assert base != scales_fingerprint(renamed, sp)


def test_video_int8_delivers_every_frame_through_the_int8_engine():
    cfg = TConfig(feature_extractor="dummy", **TINY_KW)
    model = tinference.make_inference_model(cfg, device="cpu", seed=1)
    variables = to_flax(model.transfer.state_dict())
    fused = FusedTransfer(variables, model.plan, device="cpu")
    rng = np.random.default_rng(64)
    style = rng.random(cfg.output_shape, dtype=np.float32)
    frames = [rng.random(cfg.content_shape, dtype=np.float32) for _ in range(3)]
    seen = {}
    run = stylize_video(model, fused, style, iter(frames), seen.__setitem__, depth=2,
                        quant="int8", variables=variables, calibration_frames=2)
    assert sorted(seen) == [0, 1, 2] and len(run["latency_s"]) == 3
    assert run["saturation"] is None
    prepared = fused.prepare_style(run["style_params"])
    want_scales = fused.calibrate_act_scales(
        [fused.pack_frame_np(f[None]) for f in frames[:2]], prepared)
    np.testing.assert_array_equal(run["act_scales"], want_scales)
    engine = run["engine"]
    assert engine.quant and all(s.stage.quant for s in engine.steps)
    prepared_q = engine.prepare_style(run["style_params"])
    for i, frame in enumerate(frames):
        want = engine.stylize_prepared(t(frame)[None], prepared_q)[0].numpy()
        np.testing.assert_array_equal(seen[i], want)
    # given scales are saturation-checked on the calibration frames
    checked = stylize_video(model, fused, style, frames, lambda i, f: None,
                            quant="int8", variables=variables, act_scales=want_scales,
                            calibration_frames=2)
    assert len(checked["saturation"]) == 16 and len(checked["latency_s"]) == 3
    assert max(r["max_ratio"] for r in checked["saturation"]) <= 1.0 + 1e-5
    with pytest.raises(ValueError, match="variables"):
        stylize_video(model, fused, style, frames, lambda i, f: None, quant="int8")


@pytest.mark.parametrize("arm", ["mm", "band"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_probe_plain_versions(arm, quant):
    x, w, inv = make_inputs(arm, quant, "cpu")
    fn = probe_mm if arm == "mm" else probe_band
    got = fn(x, w, 3) if arm == "mm" else fn(x, w, 3, inv)
    xn = x.float().numpy().astype(np.float64)
    if inv is not None:
        xn = np.clip(np.rint(x.float().numpy() * inv.numpy()), -127, 127).astype(np.float64)
    wn = w.float().numpy().astype(np.float64)
    if arm == "mm":
        want = xn @ wn[0].T
    else:
        xp = np.pad(xn, ((0, 0), (1, 1), (0, 0)))
        want = sum(xp[dy:dy + 10, dx:dx + 240] @ wn[3 * dy + dx].T
                   for dy in range(3) for dx in range(3)).reshape(2400, 128)
    assert got.dtype == torch.float64 and got.shape == (2400, 128)
    if quant:  # integer sums: exact in any order
        np.testing.assert_array_equal(got.numpy(), 3 * want)
    else:
        np.testing.assert_allclose(got.numpy(), 3 * want, rtol=1e-12, atol=1e-9)
    if quant and arm == "band":
        assert (np.abs(xn) == 127).any()


# ---------------------------------------------------------------------------
# against the JAX package's own int8 kernel (interpret mode: slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_int8_matches_jax_int8_fused_interpret(single):
    plan, variables, content, style_params, _ = single
    jft = JFused(variables, plan, interpret=True)
    jprep = jft.prepare_style(jnp.asarray(style_params))
    jpacked = jft.pack_frame(jnp.asarray(content))
    jscales = jft.calibrate_act_scales([jpacked], jprep)
    jq = JFused(variables, plan, interpret=True, quant="int8", act_scales=jscales)
    want = np.asarray(jq.stylize_prepacked(jpacked, jq.prepare_style(
        jnp.asarray(style_params))), np.float32)
    _, got, scales = _quant_pair(variables, content, style_params)
    err = np.abs(got - want)
    assert err.max() < 0.06 and np.median(err) < 0.01
    # the stem's JAX maxima over the pack's (subpixel, channel) lanes, folded
    # by max over the 16 subpixels, are the port's 17 logical channels
    np.testing.assert_array_equal(jscales[0, :16 * 17].reshape(16, 17).max(axis=0),
                                  scales[0, :17])
