"""The port's packed path on the CPU: packed-domain convs, the tap-matmul conv
(its plain version), ``stylize_packed``, ``choose_path``, the packed video
loop and the shared-memory probe's plain work arm.

Inputs come from numpy seeds and go through the JAX function and its port.
The JAX tap-matmul kernel runs in Pallas interpret mode, as
``tests/test_pallas_conv.py`` runs it.  Limits are the JAX tests' own: f32
convs rtol/atol 1e-4 (``tests/test_packed_conv.py``,
``tests/test_pallas_conv.py``), f32 ``stylize_packed`` rtol 5e-3 / atol 5e-4
(``tests/test_packed_conv.py:70-147``), bf16 frames rtol 0.05 / atol 0.02
with a median below 5e-3 (``tests/test_fused_transfer.py:90-92``).  The CUDA
kernel is held against the plain version on the card by ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models import inference as tinference
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.models.transfer import StyleTransferNet as TNet
from realtime_style_transfer_torch.models.transfer_packed import (
    PackedTransfer,
    stylize_packed as t_stylize_packed,
)
from realtime_style_transfer_torch.ops import bounds, conv_matmul, packed_conv as tpc
from realtime_style_transfer_torch.ops import probe_smem
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.video import choose_path, stylize_video
from realtime_style_transfer_torch.weights import load_flax, to_flax
from realtime_style_transfer_tpu.config import ShapeConfig
from realtime_style_transfer_tpu.models.inference import plan_from_config
from realtime_style_transfer_tpu.models.transfer import StyleTransferNet
from realtime_style_transfer_tpu.models.transfer_packed import stylize_packed
from realtime_style_transfer_tpu.ops.pallas.conv_matmul import (
    conv_same_batched,
    conv_valid_matmul,
)

# the JAX package's ops/__init__.py exports a function of the module's name
jpc = importlib.import_module("realtime_style_transfer_tpu.ops.packed_conv")

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.02)
    assert np.median(np.abs(got - want)) < 5e-3


# ---------------------------------------------------------------------------
# packed-domain convs
# ---------------------------------------------------------------------------

# tests/test_packed_conv.py's seams, and the rst-1920 final conv (f8 packed)
CONV_SEAMS = [(9, 1, 2, 2), (3, 2, 2, 2), (3, 2, 2, 1), (9, 1, 4, 4), (3, 1, 2, 2),
              (3, 1, 1, 2), (9, 1, 8, 8)]
TRANSPOSE_SEAMS = [(3, 1, 2), (3, 2, 4)]


@pytest.mark.parametrize("k,s,fin,fout", CONV_SEAMS)
def test_packed_conv_kernel_equals_jax_bit_for_bit(k, s, fin, fout):
    kernel = np.random.default_rng(k * 100 + fin).standard_normal((k, k, 5, 7)).astype(np.float32)
    want, want_y, want_x, want_s = jpc.packed_conv_kernel(jnp.asarray(kernel), stride=s,
                                                          fin=fin, fout=fout)
    for source in (kernel, t(kernel)):
        got, got_y, got_x, got_s = tpc.packed_conv_kernel(source, stride=s, fin=fin, fout=fout)
        assert (got_y, got_x, got_s) == (want_y, want_x, want_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,fin,fout", TRANSPOSE_SEAMS)
def test_packed_conv_transpose_kernel_equals_jax_bit_for_bit(k, fin, fout):
    kernel = np.random.default_rng(7 + fin).standard_normal((k, k, 5, 3)).astype(np.float32)
    want, want_y, want_x, want_s = jpc.packed_conv_transpose_kernel(jnp.asarray(kernel),
                                                                    fin=fin, fout=fout)
    got, got_y, got_x, got_s = tpc.packed_conv_transpose_kernel(kernel, fin=fin, fout=fout)
    assert (got_y, got_x, got_s) == (want_y, want_x, want_s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("k,s,fin,fout", CONV_SEAMS)
def test_packed_conv_matches_jax(k, s, fin, fout, backend):
    rng = np.random.default_rng(1234)
    h, w, cin, cout = 16, 24, 5, 7
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want = jpc.packed_conv(jpc.pack(jnp.asarray(x), fin), jnp.asarray(kernel), stride=s,
                           fin=fin, fout=fout)
    got = tpc.packed_conv(tpc.pack(t(x), fin), kernel, stride=s, fin=fin, fout=fout,
                          backend=backend)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    logical = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (s, s), "SAME",
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(tpc.unpack(got, fout, cout).numpy(), np.asarray(logical),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,fin,fout", TRANSPOSE_SEAMS)
def test_packed_conv_transpose_2x_matches_jax(k, fin, fout):
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((1, 12, 16, 5)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 5, 3)).astype(np.float32)
    want = jpc.packed_conv_transpose_2x(jpc.pack(jnp.asarray(x), fin), jnp.asarray(kernel),
                                        fin=fin, fout=fout)
    got = tpc.packed_conv_transpose_2x(tpc.pack(t(x), fin), t(kernel), fin=fin, fout=fout)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_packed_routing_keeps_the_jax_rule(monkeypatch):
    """backend='pallas' takes the tap-matmul kernel only at packed stride 1
    with an even packed output height; the fused contract path always does,
    and refuses a packed stride other than 1."""
    calls = []
    plain = conv_matmul.conv_valid_matmul_plain

    def count(*args, **kwargs):
        calls.append(kwargs.get("epilogue", "none"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(conv_matmul, "conv_valid_matmul_plain", count)
    kernel = np.random.default_rng(0).standard_normal((3, 3, 4, 4)).astype(np.float32)
    x = torch.rand((2, 8, 12, 16))  # fin 2: a (16, 24, 4) logical tensor
    tpc.packed_conv(x, kernel, stride=1, fin=2, fout=2, backend="pallas")
    assert calls == ["none", "none"]  # one a batch item
    tpc.packed_conv(x, kernel, stride=2, fin=2, fout=2, backend="pallas")  # packed stride 2
    tpc.packed_conv(x[:, :7], kernel, stride=1, fin=2, fout=2, backend="pallas")  # odd height
    tpc.packed_conv(x, kernel, stride=1, fin=2, fout=2, backend="xla")
    assert calls == ["none", "none"]
    ones = np.ones(4, np.float32)
    tpc.packed_conv_fused_contract(x[:, :7], kernel, ones, ones, ones, fin=2, fout=2)
    assert calls[2:] == ["contract", "contract"]
    with pytest.raises(ValueError, match="packed stride 1"):  # fin 1 -> fout 2: packed stride 2
        tpc.packed_conv_fused_contract(torch.rand((1, 16, 24, 4)), kernel, ones, ones, ones,
                                       fin=1, fout=2)
    with pytest.raises(ValueError, match="backend"):
        tpc.packed_conv(x, kernel, stride=1, fin=2, fout=2, backend="mosaic")


def test_fused_contract_matches_jax_interpret():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 12, 12)).astype(np.float32)  # fin 2, logical cin 3
    kernel = (rng.standard_normal((9, 9, 3, 8)) * 0.1).astype(np.float32)
    bias, shift = rng.standard_normal((2, 8)).astype(np.float32)
    scale = (rng.random(8) + 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jpc.packed_conv_fused_contract(jnp.asarray(x), jnp.asarray(kernel),
                                              jnp.asarray(bias), jnp.asarray(scale),
                                              jnp.asarray(shift), fin=2, fout=2)
    got = tpc.packed_conv_fused_contract(t(x), t(kernel), bias, scale, shift, fin=2, fout=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the tap-matmul conv (plain version on the CPU) against JAX's kernel
# ---------------------------------------------------------------------------


def _jax_valid(x, kernel, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(conv_valid_matmul(jnp.asarray(x), jnp.asarray(kernel), **{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}))


@pytest.mark.parametrize("shape,k,cout", [
    ((12, 20, 8), 5, 6),
    ((16, 16, 4), 3, 6),
    ((8, 24, 17), 9, 6),
    ((6, 10, 68), 5, 128),   # packed-stem-like: cin 68, 5x5, cout 128
])
def test_conv_valid_matmul_matches_jax_interpret(shape, k, cout):
    rng = np.random.default_rng(sum(shape) + k)
    hp, wp, cin = shape[0] + k - 1, shape[1] + k - 1, shape[2]
    x = rng.standard_normal((hp, wp, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    got = conv_matmul.conv_valid_matmul(t(x), t(kernel))
    assert tuple(got.shape) == shape[:2] + (cout,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_valid(x, kernel), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("epilogue", ["contract", "bias"])
def test_conv_valid_matmul_epilogues_match_jax_interpret(epilogue):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((10, 12, 4)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    bias, shift = rng.standard_normal((2, 6)).astype(np.float32)
    scale = (rng.random(6) + 0.5).astype(np.float32)
    kw = dict(bias=bias, epilogue=epilogue)
    if epilogue == "contract":
        kw.update(scale=scale, shift=shift)
    got = conv_matmul.conv_valid_matmul(t(x), t(kernel), **kw)
    np.testing.assert_allclose(got.numpy(), _jax_valid(x, kernel, **kw), rtol=1e-4, atol=1e-4)


def test_conv_same_batched_matches_jax_interpret():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 5, 7)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(conv_same_batched(jnp.asarray(x), jnp.asarray(kernel)))
    got = conv_matmul.conv_same_batched(t(x), t(kernel))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_conv_matmul_rounds_once_to_bf16():
    """bf16 operands: the f32 sum of exact products, the f32 epilogue, one
    rounding to bf16 at the end."""
    rng = np.random.default_rng(13)
    x = t(rng.standard_normal((7, 9, 6))).to(torch.bfloat16)
    kernel = t(rng.standard_normal((3, 3, 6, 5)) * 0.3).to(torch.bfloat16)
    bias, scale, shift = (t(v) for v in rng.standard_normal((3, 5)))
    got = conv_matmul.conv_valid_matmul(x, kernel, bias=bias, scale=scale, shift=shift,
                                        epilogue="contract")
    acc = torch.nn.functional.conv2d(x.double().permute(2, 0, 1)[None],
                                     kernel.double().permute(3, 2, 0, 1))[0].permute(1, 2, 0)
    want = torch.relu(torch.relu(acc.float() + bias) * scale + shift).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the f32 sum and the exact sum differ in the last f32 bits, so at most one bf16 step
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= float(2.0 ** -7 * want.float().abs().max())
    assert float((diff > 0).float().mean()) < 0.05


def test_conv_matmul_wrapper_checks_and_counts_only_kernel_launches():
    conv_matmul.conv_valid_matmul.launches = 0
    x, kernel = torch.rand((6, 6, 3)), torch.rand((3, 3, 3, 2))
    conv_matmul.conv_valid_matmul(x, kernel)
    conv_matmul.conv_same_batched(x[None], kernel)
    assert conv_matmul.conv_valid_matmul.launches == 0
    with pytest.raises(ValueError, match="epilogue"):
        conv_matmul.conv_valid_matmul(x, kernel, epilogue="relu")
    with pytest.raises(ValueError, match="larger than the input"):
        conv_matmul.conv_valid_matmul(x[:2], kernel)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        conv_matmul.conv_valid_matmul(x.to("meta"), kernel.to("meta"))


# ---------------------------------------------------------------------------
# stylize_packed against JAX, the eager net and FusedTransfer
# ---------------------------------------------------------------------------

# tests/test_packed_conv.py:70-147: (divider, bottleneck_y, styles)
PACKED_CONFIGS = {
    "flagship_family": (16, 15, 1),   # 2 contracts / 2 expands
    "flagship_family_dual": (16, 15, 2),
    "divider1_family": (8, 15, 1),    # 3 contracts / 3 expands
    "one_contract": (16, 30, 1),      # a plan only the packed path serves
}


@pytest.fixture(scope="module")
def packed_cases():
    """Per config: the JAX plan, variables, inputs and the JAX xla outputs
    at f32 and bf16."""
    cases = {}
    for name, (divider, by, styles) in PACKED_CONFIGS.items():
        rng = np.random.default_rng(divider * 100 + by + styles)
        cfg = ShapeConfig(resolution_divider=divider, bottleneck_res_y=by,
                          bottleneck_num_filters=4, num_channels=3, hdr=False,
                          num_styles=styles)
        plan = plan_from_config(cfg)
        net = StyleTransferNet(plan=plan, num_styles=styles)
        content = rng.random((2,) + cfg.content_shape).astype(np.float32)
        sp = (rng.random((2, styles, plan.num_style_parameters)) * 0.4 + 0.8).astype(np.float32)
        weights = (rng.random((2,) + cfg.style_weights_shape).astype(np.float32)
                   if styles == 2 else None)
        kw = {} if weights is None else {"style_weights": weights}
        variables = jax.device_get(jax.jit(net.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), content, sp, train=False, **kw))
        # op by op: XLA's whole-graph CPU compile of the bf16 packed path takes
        # minutes a config (and fails on the divider-1 family's f8 final conv)
        want = {dt_name: np.asarray(stylize_packed(variables, content, sp, weights, plan=plan,
                                                   dtype=dt))
                for dt_name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
        want["eager"] = np.asarray(net.apply(variables, content, sp, train=False, **kw))
        cases[name] = dict(cfg=cfg, plan=tplan(TConfig(
            resolution_divider=divider, bottleneck_res_y=by, bottleneck_num_filters=4,
            num_channels=3, hdr=False, num_styles=styles)), jplan=plan, variables=variables,
            content=content, sp=sp, weights=weights, want=want)
    return cases


def _port(case, dtype, backend):
    w = None if case["weights"] is None else t(case["weights"])
    return t_stylize_packed(case["variables"], t(case["content"]), t(case["sp"]), w,
                            plan=case["plan"], dtype=dtype, conv_backend=backend).numpy()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(PACKED_CONFIGS))
def test_stylize_packed_matches_jax_f32(packed_cases, name, backend):
    case = packed_cases[name]
    got = _port(case, torch.float32, backend)
    assert got.shape == case["want"]["f32"].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, case["want"]["f32"], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got, case["want"]["eager"], rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(PACKED_CONFIGS))
def test_stylize_packed_matches_jax_bf16(packed_cases, name, backend):
    case = packed_cases[name]
    assert_bf16_close(_port(case, torch.bfloat16, backend), case["want"]["bf16"])


def _jax_pallas(case, dtype):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(stylize_packed(case["variables"], case["content"], case["sp"],
                                         case["weights"], plan=case["jplan"], dtype=dtype,
                                         conv_backend="pallas"))


def test_stylize_packed_pallas_matches_jax_pallas_interpret(packed_cases):
    case = packed_cases["flagship_family"]
    np.testing.assert_allclose(_port(case, torch.float32, "pallas"),
                               _jax_pallas(case, jnp.float32), rtol=5e-3, atol=5e-4)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["flagship_family_dual", "divider1_family", "one_contract"])
def test_stylize_packed_pallas_matches_jax_pallas_interpret_slow(packed_cases, name):
    case = packed_cases[name]
    np.testing.assert_allclose(_port(case, torch.float32, "pallas"),
                               _jax_pallas(case, jnp.float32), rtol=5e-3, atol=5e-4)
    assert_bf16_close(_port(case, torch.bfloat16, "pallas"), _jax_pallas(case, jnp.bfloat16))


def test_stylize_packed_refusals(packed_cases):
    case = packed_cases["flagship_family_dual"]
    with pytest.raises(ValueError, match="style_weights required"):
        t_stylize_packed(case["variables"], t(case["content"]), t(case["sp"]),
                         plan=case["plan"], dtype=torch.float32)
    shallow = tplan(TConfig(resolution_divider=16, bottleneck_res_y=60,
                            bottleneck_num_filters=4, num_channels=3, hdr=False))
    assert shallow.num_contract_blocks == 0
    with pytest.raises(ValueError, match=">=1 contract block"):
        PackedTransfer(case["variables"], shallow, device="cpu")
    engine = PackedTransfer(case["variables"], case["plan"], num_styles=2, device="cpu")
    with pytest.raises(ValueError, match="another plan, dtype"):
        t_stylize_packed(engine, t(case["content"]), t(case["sp"]), t(case["weights"]),
                         plan=case["plan"], dtype=torch.float32)
    with pytest.raises(ValueError, match="conv_backend"):
        engine(t(case["content"]), t(case["sp"]), t(case["weights"]), conv_backend="mosaic")
    with pytest.raises(ValueError, match="2-style engine got 1"):
        engine(t(case["content"]), t(case["sp"][:, :1]))


TINY_KW = dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
               num_channels=17, hdr=True)


@pytest.fixture(scope="module")
def port_tiny():
    """The port's own TINY model (64x128x17 frames, 2 contracts), one style
    and two, with seeded weights; variables through the weight bridge."""
    out = {}
    for styles in (1, 2):
        cfg = TConfig(feature_extractor="dummy", num_styles=styles, **TINY_KW)
        model = tinference.make_inference_model(cfg, device="cpu", seed=4 + styles)
        out[styles] = (cfg, model, to_flax(model.transfer.state_dict()))
    return out


@pytest.mark.parametrize("styles", [1, 2])
def test_stylize_packed_matches_port_eager_net_and_fused(port_tiny, styles):
    cfg, model, variables = port_tiny[styles]
    rng = np.random.default_rng(30 + styles)
    content = t(rng.random((1,) + cfg.content_shape))
    sp = t(rng.random((1, styles, model.plan.num_style_parameters)) * 0.4 + 0.8)
    weights = t(rng.random((1,) + cfg.output_shape[:2] + (1,))) if styles == 2 else None
    with torch.no_grad():
        eager = model.transfer(content, sp, weights).numpy()
    engine = PackedTransfer(variables, model.plan, num_styles=styles, dtype=torch.float32,
                            device="cpu")
    for backend in ("xla", "pallas"):
        np.testing.assert_allclose(engine(content, sp, weights, conv_backend=backend).numpy(),
                                   eager, rtol=5e-3, atol=5e-4)
    fused = FusedTransfer(variables, model.plan, num_styles=styles, device="cpu")
    want = fused(content, sp, weights).numpy()
    got = t_stylize_packed(variables, content, sp, weights, plan=model.plan,
                           conv_backend="pallas").numpy()
    assert_bf16_close(got, want)


def test_weight_bridge_round_trip_feeds_the_packed_path(port_tiny):
    """Variables with the ``transfer`` level, and a net loaded back through
    the bridge, give the same frames."""
    cfg, model, variables = port_tiny[1]
    nested = {"params": {"transfer": variables["params"]},
              "batch_stats": {"transfer": variables["batch_stats"]}}
    rng = np.random.default_rng(40)
    content = t(rng.random((1,) + cfg.content_shape))
    sp = t(rng.random((1, 1, model.plan.num_style_parameters)))
    a = t_stylize_packed(variables, content, sp, plan=model.plan, dtype=torch.float32)
    b = t_stylize_packed(nested, content, sp, plan=model.plan, dtype=torch.float32)
    reloaded = load_flax(TNet(model.plan), variables)
    c = t_stylize_packed(to_flax(reloaded.state_dict()), content, sp, plan=model.plan,
                         dtype=torch.float32)
    assert torch.equal(a, b) and torch.equal(a, c)


# ---------------------------------------------------------------------------
# choose_path and the packed video loop
# ---------------------------------------------------------------------------


def _cli_rule(config, plan, platform):
    """predict_video_using_checkpoint.py:403-414, as written there."""
    return "fused" if (
        (plan.num_contract_blocks, plan.num_expand_blocks) in ((2, 2), (3, 3))
        and (plan.input_shape[1] // (4 * plan.num_contract_blocks - 4)) % 8 == 0
        and plan.bottleneck_num_filters <= 128
        and config.num_styles <= (1 if plan.num_contract_blocks == 3 else 2)
        and platform not in ("cpu",)
    ) else "packed"


@pytest.mark.parametrize("spec,styles,device,want", [
    ("rst-960-120-128-17", 1, "cuda", "fused"),
    ("rst-960-120-128-17", 2, "cuda", "fused"),
    ("rst-1920-120-128-17", 1, "cuda", "fused"),
    ("rst-1920-120-128-17", 2, "cuda", "packed"),   # the dual three-seg plan
    ("rst-960-120-128-17", 1, "cpu", "packed"),
    ("rst-960-120-256-17", 1, "cuda", "packed"),    # > 128 bottleneck filters
    ("rst-960-240-128-17", 1, "cuda", "packed"),    # one contract
    ("rst-480-120-128-3", 1, "cuda", "packed"),     # one contract
    ("rst-640-80-128-17", 2, "cuda", "fused"),
    ("rst-1920-120-128-17", 3, "cuda", "packed"),
])
def test_choose_path_is_the_cli_rule(spec, styles, device, want):
    tcfg = TConfig.from_spec(spec, num_styles=styles)
    jcfg = ShapeConfig.from_spec(spec, num_styles=styles)
    plan = tplan(tcfg)
    got = choose_path(tcfg, plan, device)
    assert got == _cli_rule(jcfg, plan_from_config(jcfg), device)
    assert got == want


@pytest.mark.parametrize("styles", [1, 2])
def test_packed_video_loop_streams_stylize_packed_frames(port_tiny, styles):
    cfg, model, variables = port_tiny[styles]
    engine = PackedTransfer(variables, model.plan, num_styles=styles, device="cpu")
    rng = np.random.default_rng(50 + styles)
    style = [rng.random(cfg.output_shape, dtype=np.float32) for _ in range(styles)]
    frames = [rng.random(cfg.content_shape, dtype=np.float32) for _ in range(3)]
    ramp = np.broadcast_to(np.linspace(0, 1, cfg.output_shape[0], dtype=np.float32)
                           [:, None, None], cfg.output_shape[:2] + (1,)).copy()
    seen = {}
    run = stylize_video(model, engine, style if styles == 2 else style[0], frames,
                        seen.__setitem__, depth=2, conv_backend="pallas",
                        style_weights=ramp if styles == 2 else None)
    assert sorted(seen) == [0, 1, 2] and len(run["latency_s"]) == 3
    with torch.no_grad():
        sp = model.predict_style_params(torch.from_numpy(np.stack(style))[None])
    assert torch.equal(run["style_params"], sp)
    weights = torch.from_numpy(ramp)[None] if styles == 2 else None
    for i, frame in seen.items():
        assert frame.shape == cfg.output_shape and frame.dtype == np.float32
        want = engine(t(frames[i])[None], sp, weights, conv_backend="pallas")[0].numpy()
        np.testing.assert_array_equal(frame, want)


def test_packed_video_loop_refuses_int8_and_fused_refuses_a_conv_backend(port_tiny):
    cfg, model, variables = port_tiny[1]
    engine = PackedTransfer(variables, model.plan, device="cpu")
    style = np.zeros(cfg.output_shape, np.float32)
    with pytest.raises(ValueError, match="requires the fused path \\(got 'packed'\\)"):
        stylize_video(model, engine, style, [], lambda i, f: None, quant="int8",
                      variables=variables)
    fused = FusedTransfer(variables, model.plan, device="cpu")
    with pytest.raises(ValueError, match="conv_backend"):
        stylize_video(model, fused, style, [], lambda i, f: None, conv_backend="pallas")


# ---------------------------------------------------------------------------
# the shared-memory probe's plain arms, and the bounds of the on-path launches
# ---------------------------------------------------------------------------


def test_probe_work_plain_matches_numpy():
    x, w = probe_smem.make_work_inputs("cpu", seed=3)
    got = probe_smem.work(x, w, 8)
    assert tuple(got.shape) == (probe_smem.M, probe_smem.C) and probe_smem.work.launches == 0
    xf, wf = x.float().numpy().astype(np.float64), w.float().numpy().astype(np.float64)
    want = 8 * sum(xf @ wf[i] for i in range(probe_smem.TAPS))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_probe_fill_plain_and_sweep():
    words = np.arange(100, dtype=np.uint64)
    for b in (0, 7):
        want = 0
        for v in ((words * 2654435761 + b) & 0xFFFFFFFF).tolist():
            want ^= v
        assert int(probe_smem.fill_plain(400, 8)[b]) == want
    optin = 232448
    sizes = probe_smem.sweep_bytes(optin)
    assert sizes[-2:] == [optin, optin + 1024]
    assert [s // 1024 for s in sizes[:-2]] == [48, 64, 96, 128, 160, 192]
    with pytest.raises(ValueError, match="on CUDA"):
        probe_smem.try_alloc(49152, "cpu")


@pytest.mark.parametrize("name,gflop,mb,ms", [
    ("3 rst-960 stem", 50.14, 46.0, 0.0507),
    ("3 rst-960 final", 6.37, 18.1, 0.0064),
    ("3 rst-1920 stem", 200.5, 181.9, 0.2028),
    ("3 rst-1920 final", 50.96, 43.1, 0.0515),
])
def test_conv_matmul_bounds_of_the_on_path_launches(name, gflop, mb, ms):
    _, label, seam = name.split()
    plan = tplan(TConfig.from_spec({"rst-960": "rst-960-120-128-17",
                                    "rst-1920": "rst-1920-120-128-17"}[label]))
    ops, n_bytes = bounds.conv_matmul_work(*bounds.conv_matmul_launches(plan)[seam])
    assert round(ops / 1e9, 2 if gflop < 100 else 1) == gflop
    assert round(n_bytes / 1e6, 1) == mb
    row = bounds.table()[name]
    assert round(row[0], 4) == ms and row[1] == "operations"
