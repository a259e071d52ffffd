"""The port's CIN kernel wrappers (TPU kernel row 2) against JAX ``cin_pallas``.

On the CPU the wrappers run the kernels' plain versions; the JAX side runs
``cin_pallas`` in Pallas interpret mode, as ``tests/test_pallas_cin.py``
does, and its backward ``_cin_bwd``.  Limits are that file's: f32 rtol 2e-4
/ atol 2e-4, bf16 rtol 2e-2 / atol 2e-2, gradients rtol 1e-3 / atol 1e-3.
The kernel itself runs only on the card (``chip_smoke.py`` phase 8); here a
numpy replay of its index map checks that its blocks cover every value once
and stay inside the shared memory :func:`cin_plan` gives them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.ops import cin as tcin
from realtime_style_transfer_torch.ops import normalization as tnorm
from realtime_style_transfer_torch.halo_profile import CIN_PHASES, profiled_source
from realtime_style_transfer_torch.ops.kernels import CSRC
from realtime_style_transfer_torch.ops.style_params import StyleParamCursor
from realtime_style_transfer_tpu.ops import normalization as jnorm
from realtime_style_transfer_tpu.ops.pallas.cin import _cin_bwd, cin_pallas
from realtime_style_transfer_tpu.ops.style_params import StyleParamCursor as JCursor

torch.set_num_threads(2)
SHAPES = [(2, 8, 16, 128), (1, 12, 10, 32), (2, 6, 4, 3)]
ODD = (3, 17, 23, 72)   # H * W and C odd against the kernel's vectors and groups


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
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 8, 16, 128)))
    leaf = x.clone().requires_grad_(True)
    tcin.cin(leaf, scale, bias).sum().backward()
    rows = scale.reshape(2, 128), bias.reshape(2, 128)
    _, stats = tcin.cin_forward(x, *rows, 1e-5)
    tcin.cin_backward(x, torch.ones_like(x), stats, rows[0], 1e-5)
    assert (tcin.cin_forward.launches, tcin.cin_backward.launches) == (0, 0)


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
    rows = torch.zeros((1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tcin.cin_forward(x, rows, rows, 1e-5)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        tcin.cin_backward(x, x, torch.zeros((1, 2, 64), device="meta"), rows, 1e-5)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_and_backward_match_jax_at_an_odd_shape(dtype):
    """The wrappers' plain versions (what they run on the CPU) against
    ``cin_pallas`` and ``_cin_bwd`` where H * W and C fit no vector or group
    of the kernel; the backward from the forward's saved moments."""
    x, scale, bias = _inputs(ODD, seed=6)
    g = np.random.default_rng(7).standard_normal(ODD).astype(np.float32)
    b, _, _, c = ODD
    tdt = getattr(torch, dtype)
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    rows = torch.from_numpy(scale).reshape(b, c), torch.from_numpy(bias).reshape(b, c)
    out, stats = tcin.cin_forward(xt, *rows, 1e-5)
    dx, dscale, dbias = tcin.cin_backward(xt, gt, stats, rows[0], 1e-5)
    xj, gj = jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype)
    want = _jax_cin(xj, scale, bias)
    wdx, wdscale, wdbias = _cin_bwd(1e-5, (xj, jnp.asarray(scale), jnp.asarray(bias)), gj)
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert out.dtype == dx.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(wdx, np.float32),
                               rtol=max(tol, 1e-3), atol=max(tol, 1e-3))
    for got, w in ((dscale, wdscale), (dbias, wdbias)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w).reshape(b, c), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("shape", [ODD, (2, 8, 16, 128)])
def test_saved_moments_backward_equals_the_recomputing_one(shape):
    """The backward from the forward's (B, 2, C) moments against ``_cin_bwd``'s
    recomputed ones, f32: within 1e-5 (the moments differ only in the order
    of their f32 sums)."""
    x, scale, _ = (torch.from_numpy(a) for a in _inputs(shape, seed=8))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(shape).astype(np.float32))
    b, _, _, c = shape
    row = scale.reshape(b, c)
    saved = tcin.cin_backward_plain(x, g, tcin.cin_stats_plain(x), row, 1e-5)
    again = tcin.cin_backward_plain(x, g, None, row, 1e-5)
    for got, want in zip(saved, again):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_constants_follow_cin_cu():
    text = (CSRC / "cin.cu").read_text()
    for name, value in (("NT", tcin.THREADS), ("SMEM_CAP", tcin.SMEM_CAP),
                        ("AUX_FLOATS", tcin.AUX_FLOATS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_the_training_shape(dtype, backward):
    """(4, 120, 240, 128): one item of 873 rows a block on 132 SMs; bf16's
    forward keeps every row in shared memory (x read once), the backward and
    f32 keep what fits and read the rest again."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    plan = tcin.cin_plan(4, 120 * 240, 128, itemsize, backward)
    assert (plan.parts, plan.rows, plan.blocks) == (33, 873, 132)
    assert plan.smem_bytes <= tcin.SMEM_CAP
    row_bytes = 128 * itemsize * (2 if backward else 1)
    assert plan.pix_sm == min(873, (tcin.SMEM_CAP - 6 * 4 * 128) // row_bytes)
    assert (plan.pix_sm == plan.rows) == (dtype == torch.bfloat16 and not backward)


def test_plan_for_many_images_and_one():
    """More images than blocks: one item an image, several items a block;
    one large image: 132 parts, most rows read a second time."""
    plan = tcin.cin_plan(200, 64, 128, 2)
    assert (plan.parts, plan.rows, plan.blocks, plan.pix_sm) == (1, 64, 132, 128)
    plan = tcin.cin_plan(1, 480 * 960, 128, 2)
    assert (plan.parts, plan.rows, plan.blocks) == (132, 3491, 132)
    assert plan.pix_sm == (tcin.SMEM_CAP - 6 * 4 * 128) // 256 < plan.rows
    assert tcin.cin_plan(1, 5, 65, 2).parts == 5


def test_wrappers_refuse_rows_wider_than_a_block():
    x = torch.zeros((1, 2, 2, 4104), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tcin._launch_plan(x, False)
    assert tcin._vectors(4104, 2) == 513 and tcin._vectors(72, 2) == 9
    assert tcin._vectors(65, 2) == 65 and tcin._vectors(100, 4) == 25


def _replay(plan, b, hw, c, itemsize, tensors):
    """cin.cu's index map in numpy: how often each (image, pixel, channel)
    is loaded and stored, and each block's shared slots."""
    vec_w = 16 // itemsize if c % (16 // itemsize) == 0 else 1
    nvec = c // vec_w
    nvp = 1 if nvec <= 1 else 1 << (nvec - 1).bit_length()
    lanes = tcin.THREADS // nvp
    tid = np.arange(tcin.THREADS)
    vec, lane = tid & (nvp - 1), tid // nvp
    active = vec < nvec
    hits = np.zeros((b, hw, c), np.int64)
    aux = -(-6 * 4 * c // 16) * 16
    assert plan.smem_bytes == aux + plan.pix_sm * c * itemsize * tensors <= tcin.SMEM_CAP
    items = b * plan.parts
    for block in range(plan.blocks):
        kept = []
        for j, item in enumerate(range(block, items, plan.blocks)):
            img, r0 = item // plan.parts, (item % plan.parts) * plan.rows
            nrows = max(0, min(plan.rows, hw - r0))
            n = np.where(active & (lane < nrows), -(-(nrows - lane) // lanes), 0)
            i = np.arange(n.max(initial=0))[None, :]
            live = i < n[:, None]
            r = (lane[:, None] + i * lanes)[live]
            ch = (vec * vec_w)[:, None].repeat(i.shape[1], 1)[live]
            assert (r < nrows).all()
            for k in range(vec_w):
                np.add.at(hits, (img, r0 + r, ch + k), 1)
            srow = j * plan.rows + r
            kept += list((srow * nvec + ch // vec_w)[srow < plan.pix_sm])
        kept = np.asarray(kept, np.int64)
        assert len(np.unique(kept)) == len(kept)
        # a slot is one vector: the block's rows in shared memory hold them
        assert ((kept + 1) * vec_w * itemsize <= plan.pix_sm * c * itemsize).all()
    return hits


@pytest.mark.parametrize("b, hw, c, itemsize, backward, blocks", [
    (4, 120 * 240, 128, 2, False, 132), (4, 120 * 240, 128, 4, True, 132),
    (3, 17 * 23, 72, 2, False, 132), (3, 17 * 23, 72, 4, True, 7), (1, 5, 65, 2, False, 132),
    (2, 391, 77, 4, False, 16), (9, 40, 128, 2, True, 4), (2, 128, 128, 2, True, 132)])
def test_kernel_index_map_covers_each_value_once(b, hw, c, itemsize, backward, blocks):
    plan = tcin.cin_plan(b, hw, c, itemsize, backward, blocks)
    hits = _replay(plan, b, hw, c, itemsize, 2 if backward else 1)
    assert (hits == 1).all()


def test_halo_profile_marks_every_phase_of_the_cin_kernel():
    """cin_kernel closes each phase with ``// PROFILE LAP i``, in order;
    halo_profile.py turns each into a clock64 counter."""
    source = (CSRC / "cin.cu").read_text()
    phases = CIN_PHASES["cin_kernel"]

    def body(text):
        b = text[text.index("cin_kernel(const Params p"):]
        return b[:b.index("\n}\n")]

    assert [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", body(source))] == \
        list(range(len(phases)))
    profiled = body(profiled_source(source))
    assert [int(i) for i in re.findall(r"LAP\((\d)\);", profiled)] == list(range(len(phases)))
    assert "p.counters[blockIdx.x * 8 + i]" in profiled and "PROFILE LAP" not in profiled
