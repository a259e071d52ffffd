"""The port's divider-1 (three_seg) plan on the CPU, and the repack probe's plain versions.

``FusedTransfer`` on a 3-contract / 3-expand plan runs c3 as one more stride-2
stage and e2 as one more parity-packed transpose, every stage at true
resolution; the TPU kernel's two grids and its fold2 / unfold2 repacks have no
counterpart in the stage loop.  At ``TINY3`` (64x128 frames, an 8x16x8
bottleneck, 278 style params; ``tests/test_fused_transfer.py:329-347``) the
engine's plain stage chain is held against the JAX eager net with the JAX
package's loose f32 limit (rtol 0.08, atol 0.03,
``test_fused_matches_standard_f32_loosely``), against the port's own eager f32
net with the bf16 limits (rtol 0.05, atol 0.02, median < 5e-3) and, in the
slow tier, against JAX ``stylize_packed`` at f32 and the JAX fused kernel in
interpret mode.  The int8 engine is held to the JAX int8 bar against its bf16
engine (``tests/test_fused_quant.py:220-241``).  The CUDA kernels are held
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
from realtime_style_transfer_torch.models.transfer import StyleTransferNet as TNet
from realtime_style_transfer_torch.ops import fused_transfer as tfused
from realtime_style_transfer_torch.ops import kernels, probe_repack
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.video import stylize_video
from realtime_style_transfer_torch.weights import load_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet
from realtime_style_transfer_tpu.models.transfer_packed import stylize_packed
from realtime_style_transfer_tpu.ops.pallas.fused_transfer import FusedTransfer as JFused

torch.set_num_threads(2)

TINY3_KW = dict(resolution_divider=15, bottleneck_res_y=8, bottleneck_num_filters=8,
                num_channels=17, hdr=True)
TINY3 = ShapeConfig(**TINY3_KW)
TPLAN3 = tplan(TConfig(**TINY3_KW))
STAGES = ["stem", "c1", "c2", "c3"] + [f"res{i}{ab}" for i in range(5) for ab in "ab"] \
    + ["e0", "e1", "e2", "final"]


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def divider1_tiny():
    """``tests/test_fused_transfer.py``'s ``divider1_tiny`` inputs, with the
    JAX eager net's output on them."""
    rng = np.random.default_rng(21)
    plan = plan_from_config(TINY3)
    net = StyleTransferNet(plan=plan, num_styles=1)
    content = rng.random((1,) + TINY3.content_shape).astype(np.float32)
    style_params = (rng.random((1, 1, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(3), content, style_params, train=False))
    want = np.asarray(net.apply(variables, content, style_params, train=False), np.float32)
    return plan, variables, content, style_params, want


def _engine(variables, **kw):
    return FusedTransfer(variables, TPLAN3, device="cpu", **kw)


def test_three_seg_engine_matches_jax_eager_net(divider1_tiny):
    _, variables, content, style_params, want = divider1_tiny
    fused = _engine(variables)
    assert fused.three_seg and [s.stage.name for s in fused.steps] == STAGES
    assert TPLAN3.num_style_parameters == 278
    got = fused(t(content), t(style_params)).numpy()
    assert got.shape == want.shape == (1,) + TINY3.output_shape
    np.testing.assert_allclose(got, want, rtol=0.08, atol=0.03)


def test_three_seg_engine_matches_port_eager_net(divider1_tiny):
    _, variables, content, style_params, _ = divider1_tiny
    net = load_flax(TNet(TPLAN3), variables)
    with torch.no_grad():
        want = net(t(content), t(style_params)).numpy()
    got = _engine(variables)(t(content), t(style_params)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3


def test_three_seg_stage_geometry(divider1_tiny):
    """c3 is a stride-2 gather stage into the bottleneck, e2 a parity-packed
    transpose back to full resolution; the CIN slots are the 10 residual
    convs, e0, e1, e2 and final."""
    _, variables, _, _, _ = divider1_tiny
    fused = _engine(variables)
    by_name = {s.stage.name: s.stage for s in fused.steps}
    assert by_name["c2"].out_shape == (16, 32, 32)
    assert (by_name["c3"].in_shape, by_name["c3"].out_shape, by_name["c3"].stride) == \
        ((16, 32, 32), (8, 16, 32), 2)
    assert by_name["e2"].transpose and by_name["e2"].out_shape == (64, 128, 8)
    assert by_name["final"].window and by_name["final"].cin == 8
    assert fused._slot_channels == (8,) * 10 + (32, 16, 8, 3)
    assert fused._slot_counts[-2:] == (64 * 128,) * 2
    assert fused.n_conv_stages == 18


def test_three_seg_prepacked_contracts(divider1_tiny):
    """``tests/test_fused_transfer.py:372-390`` on the port: the host pack
    equals the device pack and the JAX pack bit for bit, the prepacked call
    and the raw output with the host unpack equal the direct call."""
    plan, variables, content, style_params, _ = divider1_tiny
    fused = _engine(variables)
    prepared = fused.prepare_style(t(style_params))
    direct = fused(t(content), t(style_params)).numpy()
    packed_np = fused.pack_frame_np(content)
    assert torch.equal(fused.pack_frame(t(content)).view(torch.int16),
                       packed_np.view(torch.int16))
    want_pack = np.asarray(JFused(variables, plan, interpret=True).pack_frame_np(content))
    np.testing.assert_array_equal(packed_np.view(torch.int16).numpy().view(np.uint16),
                                  want_pack.view(np.uint16))
    np.testing.assert_array_equal(fused.stylize_prepacked(packed_np, prepared).numpy(), direct)
    raw = fused.stylize_prepacked_raw(packed_np, prepared)
    assert tuple(raw.shape) == (16, 32, 128)
    np.testing.assert_array_equal(fused.unpack_frame_np(raw), direct)


@pytest.mark.parametrize("kw,match", [
    (dict(resolution_divider=15, bottleneck_res_y=8), "dual-style"),
    (dict(resolution_divider=20, bottleneck_res_y=6), "packed widths 24/12"),
], ids=["dual", "bottleneck-width"])
def test_both_packages_refuse_the_same_divider1_plans(kw, match):
    """Dual style on the three-seg plan, and a plan whose bottleneck grid
    width W/8 is not a multiple of 8, are refused by both constructors with
    the JAX package's message, before any weight is read."""
    cfg = dict(kw, bottleneck_num_filters=8, num_channels=17, hdr=True)
    plan, jplan = tplan(TConfig(**cfg)), plan_from_config(ShapeConfig(**cfg))
    assert plan.num_contract_blocks == jplan.num_contract_blocks == 3
    styles = 2 if match == "dual-style" else 1
    with pytest.raises(ValueError, match=match):
        JFused(None, jplan, num_styles=styles, interpret=True)
    with pytest.raises(ValueError, match=match):
        FusedTransfer(None, plan, num_styles=styles, device="cpu")


def test_three_seg_chunk_equals_single_calls_bit_for_bit(divider1_tiny):
    _, variables, content, style_params, _ = divider1_tiny
    fused = _engine(variables)
    prepared = fused.prepare_style(t(style_params))
    frames = np.random.default_rng(41).random((2,) + content.shape[1:]).astype(np.float32)
    packed = torch.stack([fused.pack_frame_np(frames[i:i + 1]) for i in range(2)])
    chunk = fused.stylize_prepacked_chunk(packed, prepared)
    singles = torch.cat([fused.stylize_prepacked(packed[i], prepared) for i in range(2)])
    assert chunk.shape == (2,) + TINY3.output_shape
    assert torch.equal(chunk, singles)


def test_three_seg_calibration_is_the_max_of_each_stage_input(divider1_tiny, monkeypatch):
    """The (18, 128) table equals, exactly, the per-stage max |x'| of the
    plain stage chain (each stage's input after its prologue and skip)."""
    _, variables, content, style_params, _ = divider1_tiny
    fused = _engine(variables)
    prepared = fused.prepare_style(t(style_params))
    packed = fused.pack_frame_np(content)
    seen = []
    plain = kernels.conv_stage_plain

    def record(x, st, out, *, prologue=None, skip_in=None, **kw):
        xb = kernels.stage_input(x, st, prologue, skip_in)
        seen.append(xb.float().abs().reshape(-1, st.cin).amax(dim=0).numpy())
        return plain(x, st, out, prologue=prologue, skip_in=skip_in, **kw)

    monkeypatch.setattr(tfused, "conv_stage_plain", record)
    fused.stylize_prepacked_raw(packed, prepared, plain=True)
    monkeypatch.undo()
    scales = fused.calibrate_act_scales([packed], prepared)
    assert scales.shape == (18, 128) and len(seen) == 18
    for i, (step, m) in enumerate(zip(fused.steps, seen)):
        cin = step.stage.cin
        np.testing.assert_array_equal(scales[i, :cin], m, err_msg=step.stage.name)
        assert not scales[i, cin:].any()


def test_three_seg_int8_close_to_bf16(divider1_tiny):
    """``tests/test_fused_quant.py:220-241`` on the port: calibrate on the
    bf16 engine's frame, then the int8 engine within max 0.06, median 0.01 of
    it; the saturation check passes the matching style."""
    _, variables, content, style_params, _ = divider1_tiny
    fused = _engine(variables)
    prepared = fused.prepare_style(t(style_params))
    packed = fused.pack_frame_np(content)
    ref = fused.stylize_prepacked(packed, prepared).numpy()
    scales = fused.calibrate_act_scales([packed], prepared)
    fq = _engine(variables, quant="int8", act_scales=scales)
    assert all(s.stage.quant for s in fq.steps)
    assert fq.steps[-1].stage.cin_k == 32  # the final conv's 8 channels pad to 32
    got = fq.stylize_prepacked(packed, fq.prepare_style(t(style_params))).numpy()
    err = np.abs(got - ref)
    assert err.max() < 0.06, err.max()
    assert np.median(err) < 0.01
    report = fused.check_act_saturation([packed], prepared, scales)
    assert [r["stage"] for r in report] == STAGES
    assert max(r["max_ratio"] for r in report) <= 1.0 + 1e-5
    assert sum(r["clip_events"] for r in report) == 0


def test_three_seg_int8_refuses_other_layouts(divider1_tiny):
    _, variables, _, _, _ = divider1_tiny
    # the JAX package's (n, 512) packed-lane table, and the flagship's 16 rows
    for shape in ((19, 512), (16, 128)):
        with pytest.raises(ValueError, match=r"act_scales must be \(18, 128\)"):
            _engine(variables, quant="int8", act_scales=np.ones(shape, np.float32))


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
def test_video_loop_on_the_three_seg_engine(quant):
    cfg = TConfig(feature_extractor="dummy", **TINY3_KW)
    model = tinference.make_inference_model(cfg, device="cpu", seed=2)
    variables = to_flax(model.transfer.state_dict())
    fused = FusedTransfer(variables, model.plan, device="cpu")
    rng = np.random.default_rng(17)
    style = rng.random(cfg.output_shape, dtype=np.float32)
    frames = [rng.random(cfg.content_shape, dtype=np.float32) for _ in range(3)]
    seen = {}
    run = stylize_video(model, fused, style, frames, seen.__setitem__, depth=2,
                        quant=quant, variables=variables, calibration_frames=2)
    assert sorted(seen) == [0, 1, 2] and len(run["latency_s"]) == 3
    assert run["style_params"].shape == (1, 1, 278)
    engine = run["engine"] if quant else fused
    assert engine.three_seg and engine.quant == (quant == "int8")
    if quant:
        assert run["act_scales"].shape == (18, 128)
    prepared = engine.prepare_style(run["style_params"])
    for i, frame in enumerate(frames):
        want = engine.stylize_prepared(t(frame)[None], prepared)[0].numpy()
        np.testing.assert_array_equal(seen[i], want)
        assert seen[i].shape == cfg.output_shape and np.isfinite(seen[i]).all()


# ---------------------------------------------------------------------------
# the repack probe's plain versions against the TPU probe's numpy formulas
# (tools/probe_repack_ops.py:104-161, written out here)
# ---------------------------------------------------------------------------


def _want(op, v, w=None, out_c=0):
    if op == "deinterleave":
        return np.concatenate([v[0::2], v[1::2]], axis=-1)
    if op == "interleave":
        out = np.zeros((2 * v.shape[0],) + v.shape[1:], v.dtype)
        out[0::2], out[1::2] = v, w
        return out
    if op == "fold2":
        th, wp, c = v.shape
        rf = v.reshape(th // 2, 2, wp // 2, 2 * c)
        return np.concatenate([rf[:, 0], rf[:, 1]], -1)
    th2, wp2, c2 = v.shape
    half, q = c2 // 2, c2 // 4
    zf = np.stack([v[:, :, :half], v[:, :, half:]], axis=1).reshape(2 * th2, wp2, half)
    w64 = zf.reshape(2 * th2, 2 * wp2, q)
    return np.concatenate([w64, np.zeros((2 * th2, 2 * wp2, out_c - q), v.dtype)], -1)


@pytest.mark.parametrize("name", sorted(probe_repack.CASES))
def test_repack_plain_versions_match_the_probe_formulas(name):
    case = probe_repack.CASES[name]._replace(n=2)
    a, b = probe_repack.make_inputs(case, "cpu", seed=5)
    got = probe_repack.run(case, a, b)
    assert tuple(got.shape) == (2,) + probe_repack.out_shape(case.op, case.in_shape,
                                                             case.out_c)
    lib = probe_repack.run(case, a, b, lib=True)
    for i in range(2):
        want = _want(case.op, a[i].float().numpy(),
                     None if b is None else b[i].float().numpy(), case.out_c)
        np.testing.assert_array_equal(got[i].float().numpy(), want)
    assert torch.equal(lib.view(torch.int16), got.view(torch.int16))
    assert probe_repack.KERNELS[case.op].launches == 0


def test_repack_unfold2_inverts_fold2_on_the_rst1920_c2_output():
    case = probe_repack.CASES["fold2_rst1920_c2"]._replace(n=1)
    a, _ = probe_repack.make_inputs(case, "cpu", seed=6)
    folded = probe_repack.fold2(a)
    assert tuple(folded.shape) == (1, 120, 240, 128)
    assert torch.equal(probe_repack.unfold2(folded, 32), a)


# ---------------------------------------------------------------------------
# slow tier: the JAX packed path at f32 and the JAX fused kernel
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_three_seg_engine_matches_jax_stylize_packed_f32(divider1_tiny):
    """``tests/test_fused_transfer.py:350-369``'s oracle: the bf16 packed
    graph of this plan crashes XLA:CPU, so it runs at f32."""
    plan, variables, content, style_params, _ = divider1_tiny
    want = np.asarray(jax.jit(
        lambda v, c, p: stylize_packed(v, c, p, plan=plan, dtype=jnp.float32)
    )(variables, jnp.asarray(content), jnp.asarray(style_params)), np.float32)
    got = _engine(variables)(t(content), t(style_params)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3


@pytest.mark.slow
def test_three_seg_engine_matches_jax_fused_interpret(divider1_tiny):
    plan, variables, content, style_params, _ = divider1_tiny
    want = np.asarray(JFused(variables, plan, interpret=True)(
        jnp.asarray(content), jnp.asarray(style_params)), np.float32)
    got = _engine(variables)(t(content), t(style_params)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3
