"""Dual style and chunk mode of the port's ``FusedTransfer`` on the CPU.

The stage kernels' plain versions run the dual blend
``f = (x*a + b) + w*(x*da + db)`` in f32; the fused path is held against the
JAX package's bf16 ``stylize_packed`` (rtol 0.05, atol 0.02, median < 5e-3,
the limits of ``tests/test_fused_transfer.py``) at that file's two dual
configs and seeds, against the TF reference fixture ``transfer_dual`` and
against the port's eager dual net.  Chunk mode on the CPU runs the stage loop
once a frame, so it must equal single calls bit for bit.  The CUDA kernels and
the CUDA-graph chunk are held against these on the card by ``chip_smoke.py``.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models import inference as tinference
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.models.transfer import StyleTransferNet as TNet
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.conv import conv2d_same
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer, PreparedStyle
from realtime_style_transfer_torch.ops.kernels import (
    Prologue,
    conv_stage_plain,
    finish_plain,
    make_conv_stage,
)
from realtime_style_transfer_torch.video import stylize_video
from realtime_style_transfer_torch.weights import load_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet
from realtime_style_transfer_tpu.models.transfer_packed import stylize_packed
from realtime_style_transfer_tpu.ops.image_ops import style_weight_mips
from realtime_style_transfer_tpu.ops.style_params import concat_implicit_weight

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from convert_keras_weights import convert_transfer  # noqa: E402

torch.set_num_threads(2)

BASE_KW = dict(bottleneck_num_filters=8, num_channels=17, hdr=True)
# (shape knobs, numpy seed, init key) of the dual tests in tests/test_fused_transfer.py
DUAL_CASES = {
    "div15": (dict(resolution_divider=15, bottleneck_res_y=16), 29, 5),
    "div20": (dict(resolution_divider=20, bottleneck_res_y=12), 31, 7),
}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3


@pytest.fixture(scope="module", params=sorted(DUAL_CASES))
def dual_case(request):
    shape_kw, seed, key = DUAL_CASES[request.param]
    kw = dict(BASE_KW, **shape_kw)
    cfg = ShapeConfig(num_styles=2, **kw)
    plan = plan_from_config(cfg)
    rng = np.random.default_rng(seed)
    content = rng.random((1,) + cfg.content_shape).astype(np.float32)
    style_params = (rng.random((1, 2, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
    weights = rng.random((1,) + cfg.style_weights_shape).astype(np.float32)
    net = StyleTransferNet(plan=plan, num_styles=2)
    variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
        jax.random.PRNGKey(key), content, style_params, style_weights=weights, train=False))
    return request.param, kw, variables, content, style_params, weights


def _fused(kw, variables, num_styles=2):
    return FusedTransfer(variables, tplan(TConfig(num_styles=num_styles, **kw)),
                         num_styles=num_styles, device="cpu")


def test_dual_fused_cpu_matches_jax_stylize_packed_bf16(dual_case):
    _, kw, variables, content, style_params, weights = dual_case
    plan = plan_from_config(ShapeConfig(num_styles=2, **kw))
    want = np.asarray(stylize_packed(variables, jnp.asarray(content), jnp.asarray(style_params),
                                     jnp.asarray(weights), plan=plan, dtype=jnp.bfloat16),
                      np.float32)
    got = _fused(kw, variables)(t(content), t(style_params), t(weights)).numpy()
    assert got.shape == want.shape == content.shape[:3] + (3,)
    assert_bf16_close(got, want)


def test_dual_fused_cpu_matches_eager_dual_net_loosely(dual_case):
    _, kw, variables, content, style_params, weights = dual_case
    net = load_flax(TNet(tplan(TConfig(num_styles=2, **kw)), 2), variables)
    with torch.no_grad():
        want = net(t(content), t(style_params), t(weights)).numpy()
    got = _fused(kw, variables)(t(content), t(style_params), t(weights)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.08, atol=0.03)


def test_dual_weight_map_extremes_give_each_style(dual_case):
    """An all-zero map is style 0 bit for bit (``w * (...)`` adds an exact
    zero to ``x*a + b``); an all-ones map is style 1 up to rounding."""
    _, kw, variables, content, style_params, weights = dual_case
    fused = _fused(kw, variables)
    single = _fused(kw, variables, num_styles=1)
    zeros, ones = np.zeros_like(weights), np.ones_like(weights)
    blend0 = fused(t(content), t(style_params), t(zeros))
    style0 = single(t(content), t(style_params[:, :1]))
    assert torch.equal(blend0, style0)
    blend1 = fused(t(content), t(style_params), t(ones)).numpy()
    style1 = single(t(content), t(style_params[:, 1:])).numpy()
    np.testing.assert_allclose(blend1, style1, rtol=0.02, atol=0.01)


def test_prepare_style_planes_match_jax_weight_mips(dual_case):
    _, kw, variables, _, style_params, weights = dual_case
    fused = _fused(kw, variables)
    prepared = fused.prepare_style(t(style_params), t(weights))
    mips = style_weight_mips(concat_implicit_weight(jnp.asarray(weights)),
                             fused.plan.num_mips)
    hp, wp = fused.hp, fused.wp
    assert [tuple(p.shape) for p in prepared.planes] == [(hp, wp), (2 * hp, 2 * wp),
                                                         (4 * hp, 4 * wp)]
    for plane in prepared.planes:
        want = t(mips[plane.shape[1]][0, :, :, 1])
        assert plane.dtype == torch.bfloat16
        assert torch.equal(plane, want.to(torch.bfloat16))
    # the table: [scale0, bias0, scale1, bias1] per CIN, in slice order
    table = prepared.table
    n_params = fused.plan.num_style_parameters
    assert tuple(table.shape) == (13, 4, 128)
    c0, c12 = fused._slot_channels[0], fused._slot_channels[12]
    assert torch.equal(table[0, 2, :c0], t(style_params[0, 1, :c0]))
    assert torch.equal(table[12, 1, :c12], t(style_params[0, 0, n_params - c12:]))


def test_dual_fused_cpu_matches_tf_reference_fixture():
    fixture = REPO / "tests" / "golden" / "reference" / "transfer_dual"
    w, io = np.load(fixture / "weights.npz"), np.load(fixture / "io.npz")
    kw = dict(BASE_KW, resolution_divider=15, bottleneck_res_y=16)
    out = _fused(kw, convert_transfer(w))(t(io["content"]), t(io["style_params"]),
                                          t(io["style_weights"])).numpy()
    err = np.abs(out - io["output"])
    assert err.max() < 5e-2
    assert np.median(err) < 5e-3


# ---------------------------------------------------------------------------
# plain versions of the dual prologue, written out in numpy
# ---------------------------------------------------------------------------


def _bf16(a):
    return t(a).to(torch.bfloat16)


def _dual_prologue(rng, x, c, relu):
    xf = x.float().reshape(-1, c)
    stats = torch.stack([xf.sum(0), (xf * xf).sum(0)])
    rows = [t(rng.random(c) * 0.4 + 0.8), t(rng.random(c) * 0.4 - 0.2),
            t(rng.random(c) * 0.4 + 0.8), t(rng.random(c) * 0.4 - 0.2)]
    weight = _bf16(rng.random(x.shape[:2]))
    return Prologue(stats, float(xf.shape[0]), rows[0], rows[1], 1e-5, relu,
                    rows[2], rows[3], weight)


def _np_blend(x, pro):
    """(x*a + b) + w*(x*da + db) in float32, one rounding per operation."""
    f32 = np.float32
    stats = pro.stats.numpy()
    n = f32(pro.count)
    mean = stats[0] / n
    var = stats[1] / n - mean * mean
    inv = f32(1) / np.sqrt(var + f32(pro.eps))
    a = pro.scale.numpy() * inv
    b = pro.bias.numpy() - mean * a
    a1 = pro.scale1.numpy() * inv
    da = a1 - a
    db = (pro.bias1.numpy() - mean * a1) - b
    xn = x.float().numpy()
    w = pro.weight.float().numpy()[..., None]
    return (xn * a + b) + w * (xn * da + db)


def test_plain_dual_stage_blends_before_relu_skip_and_zero_padding():
    rng = np.random.default_rng(41)
    x = _bf16(rng.standard_normal((8, 8, 8)))
    kernel = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    st = make_conv_stage("r", kernel, np.zeros(8), in_hw=(8, 8), out_hw=(8, 8), stride=1,
                         pads=(1, 1), epi="bias", device="cpu")
    pro = _dual_prologue(rng, x, 8, True)
    skip = _bf16(rng.random((8, 8, 8)))
    skip_out = torch.empty_like(x)
    out = torch.empty((8, 8, 8), dtype=torch.bfloat16)
    conv_stage_plain(x, st, out, prologue=pro, skip_in=skip, skip_out=skip_out)
    want_in = np.maximum(_np_blend(x, pro), np.float32(0)) + skip.float().numpy()
    assert torch.equal(skip_out, t(want_in).to(torch.bfloat16))
    # the conv pads the blended activation with zeros
    want = conv2d_same(skip_out.float()[None], st.weight_oihw())[0]
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)


def test_plain_dual_finish_blends_before_the_sigmoid():
    rng = np.random.default_rng(42)
    x = _bf16(rng.standard_normal((8, 12, 3)))
    pro = _dual_prologue(rng, x, 3, False)
    out = torch.full((2, 3, 128), 7.0, dtype=torch.bfloat16)
    finish_plain(x, pro, out)
    z = _np_blend(x, pro)
    want = np.float32(1) / (np.float32(1) + np.exp(-z))
    np.testing.assert_allclose(kernels.unpack_frame(out, 3).float().numpy(), want,
                               rtol=0, atol=2.0 ** -8)
    assert not out[:, :, 48:].any()
    # the single-style rows alone are the w == 0 case, bit for bit
    single = Prologue(*pro[:6])
    zero = pro._replace(weight=torch.zeros_like(pro.weight))
    a, b = torch.empty_like(out), torch.empty_like(out)
    finish_plain(x, single, a)
    finish_plain(x, zero, b)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# chunk mode, the dual video loop, the ctypes signatures
# ---------------------------------------------------------------------------

TINY_KW = dict(BASE_KW, resolution_divider=15, bottleneck_res_y=16)


@pytest.fixture(scope="module")
def port_models():
    """The port's own seeded single and dual inference models (dummy predictor)."""
    return {ns: tinference.make_inference_model(
        TConfig(num_styles=ns, feature_extractor="dummy", **TINY_KW), device="cpu", seed=1)
        for ns in (1, 2)}


@pytest.mark.parametrize("num_styles", [1, 2])
def test_chunk_equals_single_frames_bit_for_bit(port_models, num_styles):
    model = port_models[num_styles]
    fused = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan,
                          num_styles=num_styles, device="cpu")
    rng = np.random.default_rng(43 + num_styles)
    sp = t(rng.random((1, num_styles, model.plan.num_style_parameters)) * 0.4 + 0.8)
    weights = t(rng.random((1, 64, 128, 1))) if num_styles == 2 else None
    prepared = fused.prepare_style(sp, weights)
    frames = rng.random((3, 64, 128, 17)).astype(np.float32)
    packed = torch.stack([fused.pack_frame_np(frames[i:i + 1]) for i in range(3)])
    kernels.reset_launch_counts()
    chunk = fused.stylize_prepacked_chunk(packed, prepared)
    singles = torch.cat([fused.stylize_prepacked(packed[i], prepared) for i in range(3)])
    assert chunk.shape == (3, 64, 128, 3) and chunk.dtype == torch.float32
    assert torch.equal(chunk, singles)
    assert kernels.replay_graph.replays == 0 and not fused.chunk_graphs
    with pytest.raises(ValueError, match="frame packs"):
        fused.stylize_prepacked_chunk(packed[0], prepared)


def test_dual_video_loop_delivers_stylize_prepared_frames(port_models):
    model = port_models[2]
    fused = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan, num_styles=2,
                          device="cpu")
    rng = np.random.default_rng(44)
    styles = [rng.random((64, 128, 3), dtype=np.float32) for _ in range(2)]
    weights = rng.random((64, 128, 1), dtype=np.float32)
    frames = [rng.random((64, 128, 17), dtype=np.float32) for _ in range(3)]
    for given in (weights, None):
        seen = {}
        run = stylize_video(model, fused, styles, frames, seen.__setitem__,
                            style_weights=given, depth=2)
        assert sorted(seen) == [0, 1, 2]
        with torch.no_grad():
            sp = model.predict_style_params(t(np.stack(styles))[None])
        assert tuple(sp.shape) == (1, 2, model.plan.num_style_parameters)
        assert torch.equal(run["style_params"], sp)
        w = weights if given is not None else np.zeros_like(weights)
        prepared = fused.prepare_style(sp, t(w)[None])
        for i, got in seen.items():
            want = fused.stylize_prepared(t(frames[i])[None], prepared)[0].numpy()
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="2 style images"):
        stylize_video(model, fused, styles[0], frames, seen.__setitem__)


def test_prepare_style_checks_styles_and_weights(port_models):
    model = port_models[2]
    variables = to_flax(model.transfer.state_dict())
    dual = FusedTransfer(variables, model.plan, num_styles=2, device="cpu")
    single = FusedTransfer(variables, model.plan, device="cpu")
    sp = torch.ones((1, 2, model.plan.num_style_parameters))
    with pytest.raises(ValueError, match="style_weights required"):
        dual.prepare_style(sp)
    with pytest.raises(ValueError, match="num_styles=2"):
        single.prepare_style(sp[:, :1], torch.zeros((1, 64, 128, 1)))
    with pytest.raises(ValueError, match="1-style engine wants"):
        single.prepare_style(sp)
    with pytest.raises(ValueError, match=r"\(1, 64, 128, 1\)"):
        dual.prepare_style(sp, torch.zeros((1, 32, 64, 1)))
    prepared = dual.prepare_style(sp, torch.zeros((1, 64, 128, 1)))
    assert isinstance(prepared, PreparedStyle)
    packed = single.pack_frame_np(np.zeros((1, 64, 128, 17), np.float32))
    with pytest.raises(ValueError, match="prepared style"):
        single.stylize_prepacked(packed, prepared)


_CTYPES = {"const void*": kernels.ctypes.c_void_p, "void*": kernels.ctypes.c_void_p,
           "void**": kernels.ctypes.c_void_p, "int*": kernels.ctypes.c_void_p,
           "float": kernels.ctypes.c_float, "int": kernels.ctypes.c_int}


def test_argtypes_follow_the_extern_c_signatures():
    """A missing or extra ctypes argtype shifts every later argument without
    an error, so each ``extern "C"`` signature is read from its source."""
    found = {}
    for source in kernels.SOURCES:
        text = (kernels.CSRC / source).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{', text, re.S):
            found[name] = [_CTYPES[" ".join(re.sub(r"\w+$", "", p.strip()).split())]
                           for p in params.split(",")]
    assert set(found) == set(kernels._ARGTYPES) == {"rst_conv_stage", "rst_finish",
                                                    "rst_act_stats", "rst_probe",
                                                    "rst_repack", "rst_conv_matmul",
                                                    "rst_conv_matmul_f32",
                                                    "rst_probe_smem", "rst_cin_forward",
                                                    "rst_cin_backward", "rst_cin_forward_sums",
                                                    "rst_cin_forward_apply",
                                                    "rst_cin_backward_sums",
                                                    "rst_cin_backward_apply",
                                                    "rst_graph_input_node",
                                                    "rst_graph_set_input"}
    for name, types in found.items():
        assert kernels._ARGTYPES[name] == types, name
    assert [len(found[n]) for n in ("rst_conv_stage", "rst_finish", "rst_act_stats",
                                    "rst_probe", "rst_repack", "rst_conv_matmul",
                                    "rst_conv_matmul_f32", "rst_probe_smem", "rst_cin_forward",
                                    "rst_cin_backward")] == [47, 16, 23, 13, 12, 22, 19, 11, 16,
                                                             18]
