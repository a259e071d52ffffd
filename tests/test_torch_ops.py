"""Core ops of the PyTorch port against the JAX package, in f32 on the CPU.

Inputs come from numpy seeds; both sides see the same arrays.  Limit: atol
1e-5 (f32 convolutions and reductions summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.ops import conv as tconv
from realtime_style_transfer_torch.ops import image_ops as timg
from realtime_style_transfer_torch.ops import normalization as tnorm
from realtime_style_transfer_torch.ops import packed_conv as tpacked
from realtime_style_transfer_torch.ops import style_params as tsp
from realtime_style_transfer_tpu.ops import conv as jconv
from realtime_style_transfer_tpu.ops import image_ops as jimg
from realtime_style_transfer_tpu.ops import normalization as jnorm
from realtime_style_transfer_tpu.ops.packed_conv import pack as jpack
from realtime_style_transfer_tpu.ops import style_params as jsp

torch.set_num_threads(2)
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [3, 5, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(12, 16), (11, 14)])
def test_conv2d_same_matches_lax_same(k, stride, hw):
    rng = np.random.default_rng(k * 10 + stride)
    x = (rng.standard_normal((2,) + hw + (5,)) * 0.1).astype(np.float32)
    kernel = (rng.standard_normal((k, k, 5, 4)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, kernel, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    got = tconv.conv2d_same(t(x), t(kernel).permute(3, 2, 0, 1), t(bias), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("size,k,s,want", [
    (480, 3, 2, (0, 1)), (240, 5, 2, (1, 2)), (64, 9, 5, (2, 3)), (480, 9, 1, (4, 4)),
])
def test_same_pads_are_tf_asymmetric(size, k, s, want):
    assert tconv.same_pads(size, k, s) == want


def test_depthwise_conv_matches_lax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 10, 12, 6)).astype(np.float32)
    kernel = rng.standard_normal((5, 5, 1, 6)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, kernel, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=6)
    got = tconv.conv2d_same(t(x), t(kernel).permute(3, 2, 0, 1), stride=2, groups=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_conv_transpose_2x_matches_jax_and_lax(k):
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((2, 6, 7, 4)) * 0.1).astype(np.float32)
    kernel = (rng.standard_normal((k, k, 4, 3)) * 0.1).astype(np.float32)
    got = tconv.conv_transpose_2x(t(x), t(kernel)).numpy()
    want_fn = np.asarray(jconv.conv_transpose_2x(jnp.asarray(x), jnp.asarray(kernel)))
    want_lax = np.asarray(jax.lax.conv_transpose(
        x, kernel, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        transpose_kernel=False))
    assert got.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(got, want_fn, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_lax, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_pack_transpose_kernel_matches_jax(k):
    kernel = np.random.default_rng(k).standard_normal((k, k, 2, 3)).astype(np.float32)
    got, pads = tconv.pack_transpose_kernel(t(kernel))
    want, want_pads = jconv.pack_transpose_kernel(jnp.asarray(kernel))
    assert pads == want_pads
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tconv._axis_classes(k) == jconv._axis_classes(k)


def test_pack_unpack_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 5)).astype(np.float32)
    got = tpacked.pack(t(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpack(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpacked.unpack(got, 4, 5).numpy(), x)


@pytest.mark.parametrize("blend", [False, True])
def test_conditional_instance_norm_matches_jax(blend):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 6, 8, 4)) * 3 + 1).astype(np.float32)
    params = rng.standard_normal((2, 1, 2 if blend else 1, 8)).astype(np.float32)
    weights = rng.random((2, 6, 8, 2)).astype(np.float32) if blend else None
    jc = jsp.StyleParamCursor(jnp.asarray(params))
    tc = tsp.StyleParamCursor(t(params))
    want = jnorm.cin_from_cursor(jnp.asarray(x), jc,
                                 None if weights is None else jnp.asarray(weights))
    got = tnorm.cin_from_cursor(t(x), tc, None if weights is None else t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    jc.assert_consumed()
    tc.assert_consumed()
    mean_t, var_t = tnorm.instance_moments(t(x))
    mean_j, var_j = jnorm.instance_moments(jnp.asarray(x))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=ATOL)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=ATOL * 10)


def test_cursor_slice_order_and_overflow():
    params = np.arange(2 * 10, dtype=np.float32).reshape(1, 2, 10)
    tc, jc = tsp.StyleParamCursor(t(params)), jsp.StyleParamCursor(jnp.asarray(params))
    for n in (3, 4, 3):
        np.testing.assert_array_equal(tc.take(n).numpy(), np.asarray(jc.take(n)))
    tc.assert_consumed()
    with pytest.raises(ValueError):
        tc.take(1)
    with pytest.raises(ValueError):
        tsp.StyleParamCursor(t(params)).assert_consumed()


def test_style_weight_helpers_match_jax():
    rng = np.random.default_rng(5)
    w = rng.random((1, 16, 32, 1)).astype(np.float32)
    full_t = tsp.concat_implicit_weight(t(w))
    full_j = jsp.concat_implicit_weight(jnp.asarray(w))
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), atol=ATOL)
    mips_t = timg.style_weight_mips(full_t, 3)
    mips_j = jimg.style_weight_mips(full_j, 3)
    assert sorted(mips_t) == sorted(mips_j) == [4, 8, 16, 32]
    for width in mips_j:
        np.testing.assert_allclose(mips_t[width].numpy(), np.asarray(mips_j[width]),
                                   atol=ATOL)
    params = rng.standard_normal((1, 1, 2, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.apply_style_weights(full_t, t(params)).numpy(),
        np.asarray(jsp.apply_style_weights(full_j, jnp.asarray(params))), atol=ATOL)
    single = t(params[:, :, :1])
    assert tsp.apply_style_weights(full_t, single) is single


def test_gram_and_total_variation_match_jax():
    x = np.random.default_rng(9).standard_normal((2, 6, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(timg.gram_matrix(t(x)).numpy(),
                               np.asarray(jimg.gram_matrix(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(timg.total_variation(t(x)).numpy(),
                               np.asarray(jimg.total_variation(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-4)
