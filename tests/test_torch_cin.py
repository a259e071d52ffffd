"""The port's CIN kernel wrapper (TPU kernel row 2) against JAX ``cin_pallas``.

On the CPU the wrapper runs the kernel's plain version; the JAX side runs
``cin_pallas`` in Pallas interpret mode, as ``tests/test_pallas_cin.py``
does.  Limits are that file's: f32 rtol 2e-4 / atol 2e-4, bf16 rtol 2e-2 /
atol 2e-2, gradients rtol 1e-3 / atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.ops import cin as tcin
from realtime_style_transfer_torch.ops import normalization as tnorm
from realtime_style_transfer_torch.ops.style_params import StyleParamCursor
from realtime_style_transfer_tpu.ops import normalization as jnorm
from realtime_style_transfer_tpu.ops.pallas.cin import cin_pallas
from realtime_style_transfer_tpu.ops.style_params import StyleParamCursor as JCursor

torch.set_num_threads(2)
SHAPES = [(2, 8, 16, 128), (1, 12, 10, 32), (2, 6, 4, 3)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, _, _, c = shape
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    scale = rng.random((b, 1, 1, c)).astype(np.float32) + 0.5
    bias = rng.standard_normal((b, 1, 1, c)).astype(np.float32)
    return x, scale, bias


def _jax_cin(x, scale, bias):
    with pltpu.force_tpu_interpret_mode():
        return cin_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cin_matches_jax_cin_pallas(shape, dtype):
    x, scale, bias = _inputs(shape)
    want = np.asarray(_jax_cin(jnp.asarray(x).astype(dtype), scale, bias), np.float32)
    got = tcin.cin(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
                   torch.from_numpy(bias))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_cin_gradients_match_jax(shape):
    """Gradients of sum(cin^2) for x, scale and bias: the port's backward
    repeats ``_cin_bwd``, at every channel count (the custom VJP holds below
    MIN_CHANNELS too)."""
    x, scale, bias = _inputs(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(jnp.square(cin_pallas(*a, 1e-5))),
                        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias)]
    (tcin.cin(*leaves) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)


def test_min_channels_routing():
    """Below 64 channels the plain CIN runs (its three bf16 roundings); from
    64 on, the kernel's function (one rounding), which differs in bf16."""
    for c, kernel_route in ((32, False), (64, True)):
        x, scale, bias = _inputs((1, 6, 8, c), seed=2)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        s, b = torch.from_numpy(scale), torch.from_numpy(bias)
        got = tcin.cin(xb, s, b)
        plain_cin = tnorm.conditional_instance_norm(xb, s, b)
        one_rounding = tcin.cin_normalize_plain(
            xb, tcin.cin_stats_plain(xb), s.reshape(1, c), b.reshape(1, c), 1e-5)
        assert torch.equal(got, one_rounding if kernel_route else plain_cin)
        assert torch.equal(got, plain_cin) != kernel_route


def test_launch_counters_stay_zero_on_cpu():
    tcin.reset_launch_counts()
    x, scale, bias = _inputs((2, 8, 16, 128))
    tcin.cin(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    tcin.cin_stats(torch.from_numpy(x))
    assert (tcin.cin_stats.launches, tcin.cin_normalize.launches) == (0, 0)


def test_cin_plain_equals_cin_on_the_cpu():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 8, 16, 128), seed=3))
    xb = x.to(torch.bfloat16)
    assert torch.equal(tcin.cin(xb, scale, bias), tcin.cin_plain(xb, scale, bias))


def test_stats_are_the_f32_moments():
    """The plain stats against float64 moments (rtol 1e-5: f32 sums of 128
    values); the JAX kernel adds sum * (1/HW) per H tile, the port once."""
    x, _, _ = _inputs((2, 8, 16, 128), seed=4)
    got = tcin.cin_stats_plain(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    want = np.stack([x64.mean(axis=(1, 2)), (x64 * x64).mean(axis=(1, 2))], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tcin.cin_stats(x)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cin_from_cursor_matches_jax(use_pallas):
    """One style through the cursor, f32: ``use_pallas`` takes ``cin`` in
    both packages, else the plain CIN."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8, 64)).astype(np.float32)
    params = (rng.random((2, 1, 1, 256)).astype(np.float32) + 0.5)
    with pltpu.force_tpu_interpret_mode():
        cur = JCursor(jnp.asarray(params))
        want = [jnorm.cin_from_cursor(jnp.asarray(x), cur, None, use_pallas=use_pallas)
                for _ in range(2)]
    tcur = StyleParamCursor(torch.from_numpy(params))
    got = [tnorm.cin_from_cursor(torch.from_numpy(x), tcur, None, use_pallas=use_pallas)
           for _ in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
