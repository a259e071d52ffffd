"""The wgmma path of ``csrc/conv_matmul.cu`` on the CPU: its plan, its weight
slices, its step table and its tiles.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
its plain version.  These tests hold the Python side that lays its operands
out (``ops/conv_matmul.py``: ``tap_plan``, ``pack_taps``) against the
kernel's source constants, replay the kernel's data flow from those layouts
(plane-major input chunks read through the step table's wgmma descriptors,
weight slices in core-matrix order, m64 tiles of 8 x 8 pixels) in float64
and hold it against the conv itself and against the JAX package's
``conv_valid_matmul`` in Pallas interpret mode.

Limits: the replay multiplies bf16 values exactly in float64, so it equals a
float64 conv up to the order of its sums (relative 1e-12); against JAX's f32
kernel, JAX's own f32 limit, rtol 1e-4 + atol 1e-4
(``tests/test_pallas_conv.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.halo_profile import MATMUL_PHASES, profiled_source
from realtime_style_transfer_torch.models.inference import make_inference_model, plan_from_config
from realtime_style_transfer_torch.models.transfer_packed import PackedTransfer
from realtime_style_transfer_torch.ops import conv_matmul as cm
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops import packed_conv as tpc
from realtime_style_transfer_torch.ops.bounds import conv_matmul_launches
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.ops.pallas.conv_matmul import conv_valid_matmul as jax_valid

SOURCE = (kernels.CSRC / "conv_matmul.cu").read_text()
SMEM_CAP = 232448  # the H100's opt-in shared memory a block (PERF.md, TPU kernel row 5)
STATIC_SMEM = 12 * 8  # the kernel's mbarriers: full, empty (RING each), chunk_full, chunk_empty

# (kh, kw, cin, cout): the four launches of the packed path
ON_PATH = {f"{spec} {seam}": (k, k, cin, cout)
           for spec in ("rst-960-120-128-17", "rst-1920-120-128-17")
           for seam, (_, _, k, _, cin, cout) in conv_matmul_launches(
               plan_from_config(ShapeConfig.from_spec(spec))).items()}
# tests/test_pallas_conv.py's shapes (chip_smoke.py phase 7), the widest kernel,
# and 1x1 kernels (a lone plane paired with the zero pixels after the tile)
TEST_SHAPES = {"k5 cin8 cout6": (5, 5, 8, 6), "k3 cin4 cout6": (3, 3, 4, 6),
               "k9 cin17 cout6": (9, 9, 17, 6), "k3 cin5 cout7": (3, 3, 5, 7),
               "k15 cin20 cout300": (15, 15, 20, 300), "k1 cin8 cout16": (1, 1, 8, 16),
               "k1 cin20 cout8": (1, 1, 20, 8)}
SHAPES = dict(ON_PATH, **TEST_SHAPES)


def _weights(shape, seed):
    kernel = np.random.default_rng(seed).standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
    return torch.from_numpy(kernel.astype(np.float32)).to(torch.bfloat16)


def _slice_values(taps):
    """The weight slices as float64 [column block][slice][n // 8][16-byte unit
    of K][n % 8][8 values]."""
    pl = taps.plan
    return taps.slices.reshape(pl.col_blocks, pl.nk, pl.bn // 8, cm.KSTEPS * 2, 8, 16) \
        .contiguous().view(torch.bfloat16).double()


def _b_operand(bvals, cb, s):
    """Step s's B operand, (16 K values, bn columns), as wgmma reads it: K
    bytes 32 * (s % KSTEPS) .. + 31 of slice s // KSTEPS."""
    kt, ks = divmod(s, cm.KSTEPS)
    b = bvals[cb, kt, :, 2 * ks:2 * ks + 2]  # [n // 8][2 units][n % 8][8]
    return b.permute(1, 3, 0, 2).reshape(16, -1)


def _tiles(pl):
    """(row, column) of each m64 tile's top-left pixel in a block, in
    warpgroup order: tile i of the block at 8 * (i // 2), 8 * (i % 2)."""
    return [(8 * (i // 2), 8 * (i % 2)) for i in range(2 * pl.rw)]


def emulate(x: torch.Tensor, taps: cm.TapWeights) -> torch.Tensor:
    """conv_wgmma_kernel's sums in float64: each block's chunks laid out
    plane-major as the kernel loads them, each step's A read through its
    descriptor (start, LBO from the step word; SBO one tile row), B from the
    slices, the m64 rows mapped back to their 8 x 8 pixels."""
    pl = taps.plan
    hp, wp, cin = x.shape
    h, w = hp - pl.kh + 1, wp - pl.kw + 1
    bh = 8 * pl.rw
    xd = torch.zeros(hp + bh + pl.kh, wp + cm.BLOCK_W + pl.kw, 8 * pl.planes,
                     dtype=torch.float64)
    xd[:hp, :wp, :cin] = x.double()  # zeros outside the image and past Cin
    bvals = _slice_values(taps)
    words = taps.steps.tolist()
    rows, k16 = torch.arange(64)[:, None], torch.arange(16)[None, :]
    out = torch.zeros(h, w, pl.col_blocks * pl.bn, dtype=torch.float64)
    grid_x, grid_y = pl.grid(h, w)
    tiles_x = -(-w // cm.BLOCK_W)
    for bx in range(grid_x):
        oy0, ox0 = (bx // tiles_x) * bh, (bx % tiles_x) * cm.BLOCK_W
        tile = xd[oy0:oy0 + pl.th, ox0:ox0 + pl.tw]
        for cb in range(grid_y):
            acc = torch.zeros(2 * pl.rw, 64, pl.bn, dtype=torch.float64)
            chunk, buf = -1, None
            for s, word in enumerate(words):
                if (word >> cm.STEP_NEW_CHUNK) & 1:
                    chunk += 1
                    p0 = chunk * pl.cp
                    pc = min(pl.cp, pl.planes - p0)
                    buf = torch.zeros(pl.chunk_bytes // 2, dtype=torch.float64)
                    planes = buf[:pl.cp * pl.plane_px * 8].view(pl.cp, pl.plane_px, 8)
                    planes[:pc, :pl.th * pl.tw] = tile[..., 8 * p0:8 * (p0 + pc)] \
                        .reshape(pl.th * pl.tw, pc, 8).permute(1, 0, 2)
                start = (word & cm.STEP_FIELD) * 16
                lbo = ((word >> 14) & cm.STEP_FIELD) * 16
                b = _b_operand(bvals, cb, s)
                for i, (ty, tx) in enumerate(_tiles(pl)):
                    addr = (start + (ty * pl.tw + tx) * 16 + (rows // 8) * pl.tw * 16
                            + (k16 // 8) * lbo + (rows % 8) * 16 + (k16 % 8) * 2)
                    assert int(addr.max()) < 2 * buf.numel()  # inside the chunk buffer
                    acc[i] += buf[addr // 2] @ b
            for i, (ty, tx) in enumerate(_tiles(pl)):
                for r in range(64):
                    oy, ox = oy0 + ty + r // 8, ox0 + tx + r % 8
                    if oy < h and ox < w:
                        out[oy, ox, cb * pl.bn:(cb + 1) * pl.bn] = acc[i, r]
    return out[..., :pl.cout]


def _conv64(x, kernel):
    return torch.nn.functional.conv2d(x.double().permute(2, 0, 1)[None],
                                      kernel.double().permute(3, 2, 0, 1))[0].permute(1, 2, 0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_weight_slices_round_trip_to_the_hwio_kernel(name):
    """Reading the slices back through the step table gives every weight of
    the HWIO kernel exactly once, and zeros everywhere else."""
    kh, kw, cin, cout = SHAPES[name]
    kernel = _weights(SHAPES[name], 1)
    taps = cm.pack_taps(kernel)
    pl = taps.plan
    bvals = _slice_values(taps)
    back = torch.zeros(kh * kw, 8 * pl.planes, pl.col_blocks * pl.bn, dtype=torch.float64)
    seen = torch.zeros(kh * kw, 8 * pl.planes, dtype=torch.int64)
    for s, (_, first, second) in enumerate(pl.steps):
        for cb in range(pl.col_blocks):
            b = _b_operand(bvals, cb, s)
            for half, pair in enumerate((first, second)):
                vals = b[8 * half:8 * half + 8]
                if pair is None:
                    assert not vals.any()
                    continue
                tap, plane = pair
                back[tap, 8 * plane:8 * plane + 8, cb * pl.bn:(cb + 1) * pl.bn] = vals
                seen[tap, 8 * plane:8 * plane + 8] += cb == 0
    assert (seen == 1).all()
    assert not back[:, cin:].any() and not back[..., cout:].any()
    assert torch.equal(back[:, :cin, :cout].reshape(kh, kw, cin, cout), kernel.double())


@pytest.mark.parametrize("name,hw", [
    ("rst-960-120-128-17 stem", (9, 21)), ("rst-960-120-128-17 final", (17, 19)),
    ("rst-1920-120-128-17 stem", (8, 16)), ("rst-1920-120-128-17 final", (9, 17)),
    ("k5 cin8 cout6", (12, 20)), ("k3 cin4 cout6", (16, 16)), ("k9 cin17 cout6", (8, 24)),
    ("k3 cin5 cout7", (8, 10)), ("k15 cin20 cout300", (5, 7)), ("k1 cin8 cout16", (9, 17)),
    ("k1 cin20 cout8", (16, 33)),
])
def test_the_kernels_data_flow_is_the_conv(name, hw):
    """The replay of the kernel's reads (chunks, step descriptors, slices,
    m64 tiles) equals the conv, ragged edges and odd widths included, and
    reads only inside its chunk buffers."""
    kh, kw, cin, cout = SHAPES[name]
    g = torch.Generator().manual_seed(sum(SHAPES[name]))
    x = torch.randn((hw[0] + kh - 1, hw[1] + kw - 1, cin), generator=g).to(torch.bfloat16)
    kernel = _weights(SHAPES[name], 2)
    want = _conv64(x, kernel)
    got = emulate(x, cm.pack_taps(kernel))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("name", ["rst-960-120-128-17 stem", "k3 cin5 cout7", "k9 cin17 cout6",
                                  "k1 cin8 cout16", "k1 cin20 cout8"])
def test_zero_weights_read_only_the_receptive_field(name):
    """An Inf in the input reaches only the outputs whose receptive field
    holds it, as in the conv: the core matrices with zero weights (a lone
    last tap's partner, padding steps, a 1x1 kernel's lone plane) read
    pixels of the same outputs' field or zeros, never 0 x Inf.  The Infs
    sit in the last channel, just right of one output's field in the first
    column block, at the first block's last column (whose next pixel is the
    next tile row's first), and at the second block's first tile column."""
    kh, kw, cin, cout = SHAPES[name]
    h, w = 11, 2 * cm.BLOCK_W + 3
    g = torch.Generator().manual_seed(sum(SHAPES[name]) + 1)
    x = torch.randn((h + kh - 1, w + kw - 1, cin), generator=g).to(torch.bfloat16)
    for iy, ix in ((kh + 1, kw + 4), (kh + 2, cm.BLOCK_W - 1 + kw), (4, cm.BLOCK_W)):
        x[iy, ix, cin - 1] = float("inf")
    kernel = _weights(SHAPES[name], 5)
    want = _conv64(x, kernel)
    got = emulate(x, cm.pack_taps(kernel))
    finite = torch.isfinite(want)
    assert not finite.all() and torch.equal(torch.isfinite(got), finite)
    assert float((got - want)[finite].abs().max()) <= 1e-12 * float(want[finite].abs().max())


@pytest.mark.parametrize("epilogue", ["none", "contract"])
def test_the_kernels_data_flow_matches_jax_interpret(epilogue):
    """At the packed stem's geometry (5x5, 68 -> 128: one chunk of 5 planes
    with its last plane paired across taps, one of 4), the replay with the
    f32 epilogue matches the JAX package's kernel in interpret mode."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((12, 21, 68)).astype(np.float32)
    kernel = (rng.standard_normal((5, 5, 68, 128)) * 0.05).astype(np.float32)
    bias, shift = (rng.standard_normal((2, 128)) * 0.1).astype(np.float32)
    scale = (rng.random(128) + 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kb = torch.from_numpy(kernel).to(torch.bfloat16)
    acc = emulate(xb, cm.pack_taps(kb)).float()
    kw = dict(epilogue=epilogue)
    if epilogue == "contract":
        kw.update(bias=bias, scale=scale, shift=shift)
        acc = torch.relu(torch.relu(acc + torch.from_numpy(bias)) * torch.from_numpy(scale)
                         + torch.from_numpy(shift))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_valid(jnp.asarray(xb.float().numpy()), jnp.asarray(kb.float().numpy()),
                                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()}))
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,cout", [((1, 1), 8), ((8, 16), 48), ((9, 17), 192),
                                     ((23, 37), 7), ((120, 240), 128), ((17, 33), 300)])
def test_blocks_cover_each_output_pixel_and_column_once(hw, cout):
    """The launch grid's blocks, their m64 tiles and each tile's 64 rows, and
    the column blocks, write every output (pixel, column) exactly once."""
    pl = cm.tap_plan(3, 3, 16, cout)
    h, w = hw
    seen = torch.zeros(h, w, cout, dtype=torch.int64)
    grid_x, grid_y = pl.grid(h, w)
    tiles_x = -(-w // cm.BLOCK_W)
    for bx in range(grid_x):
        oy0, ox0 = (bx // tiles_x) * 8 * pl.rw, (bx % tiles_x) * cm.BLOCK_W
        for cb in range(grid_y):
            n0, n1 = cb * pl.bn, min((cb + 1) * pl.bn, cout)
            for ty, tx in _tiles(pl):
                for r in range(64):
                    oy, ox = oy0 + ty + r // 8, ox0 + tx + r % 8
                    if oy < h and ox < w:
                        seen[oy, ox, n0:n1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("name", list(SHAPES) + ["k15 cin512 cout192", "k15 cin256 cout256",
                                                 "k15 cin68 cout128", "k15 cin4 cout6"])
def test_plans_fit_the_shared_memory(name):
    """Each on-path shape, the test shapes and the widest kernel
    (MAX_TAPS_PER_AXIS taps an axis) at wide and narrow Cin and Cout fit a
    block's shared memory on the H100, the step words' fields hold their
    offsets, the planes are 128-byte aligned for the TMA boxes, and a 1x1
    kernel's planes hold a zero pixel after its tile for each of its own."""
    if name in SHAPES:
        shape = SHAPES[name]
    else:
        k, cin, cout = (int(v) for v in re.findall(r"\d+", name))
        shape = (k, k, cin, cout)
    pl = cm.tap_plan(*shape)
    assert max(shape[:2]) <= cm.MAX_TAPS_PER_AXIS
    assert pl.smem_bytes <= cm.MAX_DYN_BYTES and pl.smem_bytes + STATIC_SMEM <= SMEM_CAP
    assert pl.plane_px >= pl.th * pl.tw * (2 if shape[:2] == (1, 1) else 1)
    assert pl.nchunks * pl.cp >= pl.planes and pl.nbuf == (1 if pl.nchunks == 1 else 2)
    assert len(pl.steps) % cm.KSTEPS == 0 and pl.cp * pl.plane_px * 16 < 16 * cm.STEP_FIELD
    assert pl.plane_px % 8 == 0


def test_the_plan_follows_the_geometry():
    """Cout picks the column block (the whole Cout up to 256) and with it
    the rows a warpgroup; Cin picks the chunks: one for a narrow input, two
    halves for the stem's 9 planes, 64 channels a chunk for the finals."""
    stem = cm.tap_plan(5, 5, 68, 128)
    assert (stem.bn, stem.rw, stem.planes, stem.cp, stem.nchunks) == (128, 1, 9, 5, 2)
    assert stem.k == 1856  # 25 taps x 4 + 13 paired steps, each chunk padded to 4 steps
    final960, final1920 = cm.tap_plan(3, 3, 256, 48), cm.tap_plan(3, 3, 512, 192)
    assert (final960.bn, final960.rw, final960.cp, final960.nchunks) == (48, 2, 8, 4)
    assert (final1920.bn, final1920.rw, final1920.cp, final1920.nchunks) == (192, 1, 8, 8)
    assert final960.k == 9 * 256 and final1920.k == 9 * 512  # no padding
    test = cm.tap_plan(3, 3, 4, 6)
    assert (test.bn, test.rw, test.nchunks, test.col_blocks) == (8, 2, 1, 1)
    assert cm.tap_plan(3, 3, 4, 300).col_blocks == 2
    for shape in ON_PATH.values():
        assert cm.tap_plan(*shape) == cm.tap_plan(*shape)  # a function of the shape alone
    assert cm.path_of(torch.bfloat16) == "wgmma" and cm.path_of(torch.float32) == "f32"
    with pytest.raises(ValueError, match="at most 15 taps"):
        cm.tap_plan(17, 3, 4, 6)


def test_constants_match_the_source():
    """The Python mirror's constants and (bn, rw) table are the kernel's."""
    consts = dict(re.findall(r"constexpr (?:int|uint32_t) (\w+) = ([^;]+);", SOURCE))
    assert int(consts["RING"]) == cm.RING and int(consts["SLICE_BYTES"]) == cm.SLICE_BYTES
    assert int(consts["BW"]) == cm.BLOCK_W and int(consts["STEP_NEW_CHUNK"]) == cm.STEP_NEW_CHUNK
    assert int(consts["STEP_FIELD"], 16) == cm.STEP_FIELD
    assert eval(consts["MAX_DYN_BYTES"]) == cm.MAX_DYN_BYTES
    launched = {(int(bn), int(rw)) for bn, rw in re.findall(r"launch_wgmma<(\d+), (\d)>", SOURCE)}
    assert launched == set(cm.ROWS.items()) and tuple(sorted(cm.ROWS)) == cm.BLOCK_N


def test_halo_profile_marks_every_phase_of_the_wgmma_kernel():
    """conv_wgmma_kernel and the f32 path's conv_fma_kernel close each phase
    with ``// PROFILE LAP i``, in order; halo_profile.py turns each into a
    clock64 counter and leaves the launchers and the C entries after the
    f32 kernel alone."""
    profiled = profiled_source(SOURCE)
    for name, params in (("conv_wgmma_kernel", "Params"), ("conv_fma_kernel", "FmaParams")):
        body = SOURCE[SOURCE.index(f"{name}(const {params} p"):]
        body = body[:body.index("\n}\n")]
        phases = MATMUL_PHASES[name]
        assert [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", body)] == \
            list(range(len(phases)))
        kernel = profiled[profiled.index(f"{name}(const {params} p"):]
        kernel = kernel[:kernel.index("\n}\n")]
        assert [int(i) for i in re.findall(r"  LAP\((\d)\);", kernel)] == list(range(len(phases)))
        assert "p.counters[blockIdx.x * 8 + i]" in kernel and "PROFILE LAP" not in kernel
    assert profiled.endswith(SOURCE[SOURCE.index("// The f32 path's launch"):])


def test_plain_version_takes_packed_weights_and_device_rows():
    """The plain version runs on the HWIO kernel a TapWeights holds (Cin
    zero-padded to a multiple of 8), on an input with the kernel's own Cin
    or the padded one, and an epilogue row that is already an f32 device row
    is used as it is."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((9, 11, 12), generator=g).to(torch.bfloat16)
    kernel = _weights((3, 3, 12, 8), 4)
    taps = cm.pack_taps(kernel)
    assert taps.plan.cin == 12 and taps.kernel.shape == (3, 3, 16, 8)
    assert torch.equal(taps.kernel[:, :, :12], kernel) and not taps.kernel[:, :, 12:].any()
    assert cm.pack_taps(taps.kernel).kernel is taps.kernel
    rows = [torch.rand(8, generator=g) for _ in range(3)]
    kw = dict(bias=rows[0], scale=rows[1], shift=rows[2], epilogue="contract")
    want = cm.conv_valid_matmul_plain(x, kernel, **kw)
    for xin in (x, torch.nn.functional.pad(x, (0, 4))):
        got = cm.conv_valid_matmul_plain(xin, taps, **kw)
        assert float((got.float() - want.float()).abs().max()) == 0.0
    with pytest.raises(ValueError, match="want x"):
        cm.conv_valid_matmul_plain(x[..., :11], taps, **kw)
    assert all(a is b for a, b in zip(cm._epilogue_rows(8, x.device, *rows), rows))
    zeros, numpy_row, _ = cm._epilogue_rows(8, x.device, None, np.full(8, 1.5), None)
    assert torch.equal(zeros, torch.zeros(8)) and torch.equal(numpy_row, torch.full((8,), 1.5))


def test_packed_transfer_packs_its_tap_weights_once(monkeypatch):
    """PackedTransfer packs the stem's and the final conv's weights for the
    kernel at assembly; a frame hands the packed weights to the tap matmul
    and packs nothing."""
    model = make_inference_model(ShapeConfig.from_spec("rst-120-15-4-3"), seed=0, device="cpu")
    engine = PackedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu")
    stem, final = engine.contracts[0].conv, engine.final.conv
    for conv in (stem, final):
        assert isinstance(conv.taps, cm.TapWeights) and conv.taps.kernel.shape[2] % 8 == 0
        cin = conv.weight.shape[2]
        assert torch.equal(conv.taps.kernel[:, :, :cin], conv.weight)
        assert not conv.taps.kernel[:, :, cin:].any()
    assert all(c.conv.taps is None for c in engine.contracts[1:])
    got = []

    def record(x, kernel, **kw):
        got.append(kernel)
        return cm.conv_valid_matmul_plain(x, kernel, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a frame packed weights")

    monkeypatch.setattr(cm, "pack_taps", refuse)
    h, w, c = model.plan.input_shape
    content = torch.rand((1, h, w, c))
    sp = torch.rand((1, 1, model.plan.num_style_parameters)) + 0.5
    engine(content, sp, conv_backend="pallas", plain=True)
    assert got == []  # plain=True takes the plain matmul directly
    out = engine(content, sp, conv_backend="pallas")
    pp = torch.rand((1, 6, 10, stem.weight.shape[2]))
    seen = []
    tpc.run_fused_contract(pp, stem, dict(epilogue="none"),
                           matmul=lambda x, k, **kw: seen.append(x.shape) or record(x, k, **kw))
    assert got == [stem.taps] and out.shape == (1, h, w, 3)
    assert seen[0][2] == stem.taps.kernel.shape[2]  # channels padded with the pixels


# ---- the f32 path: conv_fma_kernel ----------------------------------------------

# (kh, kw, cin, cout): the four launches of the packed path, tests/test_pallas_conv.py's
# shapes and its contract, bias and conv_same_batched cases (cin 4, 5, 8, 17, 20; cout
# 6, 7; 1x1 to 9x9 taps), the 5x5 68 -> 128 test shape, and a Cout past the widest tile
F32_TEST_SHAPES = {"k5 cin8 cout6": (5, 5, 8, 6), "k3 cin4 cout6": (3, 3, 4, 6),
                   "k9 cin17 cout6": (9, 9, 17, 6), "k3 cin5 cout7": (3, 3, 5, 7),
                   "k1 cin20 cout16": (1, 1, 20, 16), "k5 cin68 cout128": (5, 5, 68, 128),
                   "k3 cin20 cout300": (3, 3, 20, 300)}
F32_SHAPES = dict(ON_PATH, **F32_TEST_SHAPES)


def _f32_weights(shape, seed):
    kernel = np.random.default_rng(seed).standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
    return torch.from_numpy(kernel.astype(np.float32))


def _fma_lanes(pl):
    """Each consumer lane's place: (warp row, warp column start, K-group g,
    column group ng) as arrays over (8 warps, 32 lanes)."""
    wpr = cm.FMA_COLS // pl.tm
    warp = torch.arange(cm.FMA_WARPS)[:, None].expand(cm.FMA_WARPS, 32)
    lane = torch.arange(32)[None, :].expand(cm.FMA_WARPS, 32)
    return warp // wpr, (warp % wpr) * pl.tm, lane // pl.ng, lane % pl.ng


def _fma_stores(pl, oy0, ox0, cb, h, w):
    """The (warp, lane, pixel j, q, e) sums a block stores and where:
    K-group g stores pixels j = g, g + kgw, ...; columns past Cout and
    pixels past the output are not stored."""
    r, c0, g, ng = _fma_lanes(pl)
    idx = torch.stack(torch.meshgrid(torch.arange(cm.FMA_WARPS), torch.arange(32),
                                     torch.arange(pl.tm), torch.arange(pl.tq), torch.arange(4),
                                     indexing="ij"), -1).reshape(-1, 5)
    wv, lv, jv, qv, ev = idx.unbind(1)
    oy, ox = oy0 + r[wv, lv], ox0 + c0[wv, lv] + jv
    n = cb * pl.bn + 4 * (ng[wv, lv] + pl.ng * qv) + ev
    keep = (jv % pl.kgw == g[wv, lv]) & (oy < h) & (ox < w) & (n < pl.cout)
    return idx[keep], oy[keep], ox[keep], n[keep]


def emulate_fma(x: torch.Tensor, fw: cm.FmaWeights) -> torch.Tensor:
    """conv_fma_kernel's sums in float64: each stage's TMA box (zeros
    outside the image and past Cin) and weight slice, each lane's float4
    reads of A (its pixels' channel quad; with a window, pixel tx + j of
    the quad's window) and B (its 32-lane row of the slice) in the
    kernel's K order, the K-groups' butterfly, the stores; every output
    written exactly once."""
    pl = fw.plan
    hp, wp, cin = x.shape
    h, w = hp - pl.kh + 1, wp - pl.kw + 1
    xd = torch.zeros(hp + pl.rows + pl.kh, wp + cm.FMA_COLS + pl.kw, pl.cin_x,
                     dtype=torch.float64)
    xd[:hp, :wp, :cin] = x.double()
    slices = fw.slices.double()
    out = torch.zeros(h, w, pl.cout, dtype=torch.float64)
    writes = torch.zeros(h, w, pl.cout, dtype=torch.int64)
    r, c0, g, _ = _fma_lanes(pl)
    j = torch.arange(pl.tm)
    grid_x, grid_y = pl.grid(h, w)
    tiles_x = -(-w // cm.FMA_COLS)
    for bx in range(grid_x):
        oy0, ox0 = (bx // tiles_x) * pl.rows, (bx % tiles_x) * cm.FMA_COLS
        for cb in range(grid_y):
            acc = torch.zeros(cm.FMA_WARPS, 32, pl.tm, pl.tq, 4, dtype=torch.float64)
            for s in range(pl.stages):
                c, ty = divmod(s, pl.kh)
                box = xd[oy0 + ty:oy0 + ty + pl.rows, ox0:ox0 + pl.twc, c * pl.cc:(c + 1) * pl.cc]
                wst = slices[cb, s].reshape(pl.kw, pl.ni, 4, pl.tq, 32, 4)
                order = ([(tx, i) for i in range(pl.ni) for tx in range(pl.kw)] if pl.window
                         else [(tx, i) for tx in range(pl.kw) for i in range(pl.ni)])
                for tx, i in order:
                    cols = c0[..., None] + tx + j                        # (8, 32, tm)
                    quad = 4 * (i * pl.kgw + g)                          # (8, 32)
                    assert int(cols.max()) < pl.twc and int(quad.max()) + 4 <= pl.cc
                    a = box[r[..., None, None], cols[..., None],
                            quad[..., None, None] + torch.arange(4)]     # (8, 32, tm, 4)
                    b = wst[tx, i].permute(2, 0, 1, 3)                   # (32, 4, tq, 4)
                    acc += torch.einsum("wljk,lkqe->wljqe", a, b)
            # the butterfly: each lane ends with its pixel group's sum over g
            tot = acc.reshape(cm.FMA_WARPS, pl.kgw, pl.ng, pl.tm, pl.tq, 4).sum(1)
            tot = tot[:, None].expand(-1, pl.kgw, -1, -1, -1, -1).reshape(acc.shape)
            idx, oy, ox, n = _fma_stores(pl, oy0, ox0, cb, h, w)
            out[oy, ox, n] = tot[tuple(idx.t())]
            writes.index_put_((oy, ox, n), torch.ones_like(n), accumulate=True)
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("name", list(F32_SHAPES))
def test_fma_weight_slices_round_trip_to_the_hwio_kernel(name):
    """Reading the stage slices back through the kernel's lane map (stage
    (chunk, tap row), tap, quad, channel, column quad, lane) gives every
    weight of the HWIO kernel exactly once, and zeros past Cin and Cout."""
    kh, kw, cin, cout = F32_SHAPES[name]
    kernel = _f32_weights(F32_SHAPES[name], 1)
    fw = cm.pack_fma(kernel)
    pl = fw.plan
    assert tuple(fw.slices.shape) == (pl.col_blocks, pl.stages, kw * pl.cc * pl.bn)
    back = torch.full((kh, kw, pl.cin_x, pl.col_blocks * pl.bn), float("nan"), dtype=torch.float64)
    vals = fw.slices.double().reshape(pl.col_blocks, pl.nchunks, kh, kw, pl.ni, 4, pl.tq, 32, 4)
    lane = torch.arange(32)
    for cb in range(pl.col_blocks):
        for c in range(pl.nchunks):
            for i in range(pl.ni):
                for kk in range(4):
                    for q in range(pl.tq):
                        ch = c * pl.cc + 4 * (i * pl.kgw + lane // pl.ng) + kk      # (32,)
                        n = cb * pl.bn + 4 * (lane % pl.ng + pl.ng * q)            # (32,)
                        cols = n[:, None] + torch.arange(4)
                        assert torch.isnan(back[:, :, ch[:, None], cols]).all()  # once
                        back[:, :, ch[:, None], cols] = vals[cb, c, :, :, i, kk, q]
    assert not torch.isnan(back).any()
    assert not back[:, :, cin:].any() and not back[..., cout:].any()
    assert torch.equal(back[:, :, :cin, :cout], kernel.double())
    assert torch.equal(fw.kernel[:, :, :cin], kernel) and not fw.kernel[:, :, cin:].any()


@pytest.mark.parametrize("name,hw", [
    ("rst-960-120-128-17 stem", (9, 21)), ("rst-960-120-128-17 final", (6, 19)),
    ("rst-1920-120-128-17 stem", (8, 16)), ("rst-1920-120-128-17 final", (5, 17)),
    ("k5 cin8 cout6", (12, 20)), ("k3 cin4 cout6", (16, 16)), ("k9 cin17 cout6", (8, 24)),
    ("k3 cin5 cout7", (8, 10)), ("k1 cin20 cout16", (9, 17)), ("k5 cin68 cout128", (12, 21)),
    ("k3 cin20 cout300", (5, 7)),
])
def test_the_fma_kernels_data_flow_is_the_conv(name, hw):
    """The replay of conv_fma_kernel's reads (TMA boxes, weight slices,
    lanes' quads, K-groups) equals the conv, ragged edges, odd Cin and
    Cout and column blocks included, reading only inside its boxes and
    writing each output once."""
    kh, kw, cin, cout = F32_SHAPES[name]
    g = torch.Generator().manual_seed(sum(F32_SHAPES[name]))
    x = torch.randn((hw[0] + kh - 1, hw[1] + kw - 1, cin), generator=g)
    kernel = _f32_weights(F32_SHAPES[name], 2)
    want = _conv64(x, kernel)
    got = emulate_fma(x, cm.pack_fma(kernel))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_the_fma_kernels_data_flow_is_conv_same_batched():
    """conv_same_batched's case (2, 12, 16, 5) 3x3 -> 7 through the replay,
    one call an image on the once-padded batch, is the SAME conv."""
    g = torch.Generator().manual_seed(11)
    xs = torch.randn((2, 12, 16, 5), generator=g)
    kernel = _f32_weights((3, 3, 5, 7), 3)
    fw = cm.pack_fma(kernel)
    xp = torch.nn.functional.pad(xs, (0, 0, 1, 1, 1, 1))
    for i in range(2):
        want = _conv64(xp[i], kernel)
        got = emulate_fma(xp[i], fw)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("name", ["rst-960-120-128-17 final", "k3 cin5 cout7", "k1 cin20 cout16"])
def test_fma_zero_weights_read_only_the_receptive_field(name):
    """An Inf in the input reaches only the outputs whose receptive field
    holds it: the padded channels and columns carry zero weights on zero
    pixels, and no stored sum meets a pixel outside its field."""
    kh, kw, cin, cout = F32_SHAPES[name]
    h, w = 9, cm.FMA_COLS + 3
    g = torch.Generator().manual_seed(sum(F32_SHAPES[name]) + 1)
    x = torch.randn((h + kh - 1, w + kw - 1, cin), generator=g)
    for iy, ix in ((kh + 1, kw + 2), (2, cm.FMA_COLS - 1 + kw), (4, cm.FMA_COLS)):
        x[iy, ix, cin - 1] = float("inf")
    kernel = _f32_weights(F32_SHAPES[name], 5)
    want = _conv64(x, kernel)
    got = emulate_fma(x, cm.pack_fma(kernel))
    finite = torch.isfinite(want)
    assert not finite.all() and torch.equal(torch.isfinite(got), finite)
    assert float((got - want)[finite].abs().max()) <= 1e-12 * float(want[finite].abs().max())


@pytest.mark.parametrize("epilogue,shape", [("none", (3, 3, 256, 48)), ("contract", (5, 5, 68, 128)),
                                            ("bias", (3, 3, 5, 7))])
def test_the_fma_kernels_data_flow_matches_jax_interpret(epilogue, shape):
    """At the packed final's and stem's geometry and a test shape, the f32
    replay with the f32 epilogue matches the JAX package's kernel in
    interpret mode at f32, within JAX's f32 limit."""
    kh, kw, cin, cout = shape
    rng = np.random.default_rng(23)
    x = rng.standard_normal((6 + kh - 1, 19 + kw - 1, cin)).astype(np.float32)
    kernel = (rng.standard_normal(shape) / np.sqrt(kh * kw * cin)).astype(np.float32)
    bias, shift = (rng.standard_normal((2, cout)) * 0.1).astype(np.float32)
    scale = (rng.random(cout) + 0.5).astype(np.float32)
    acc = emulate_fma(torch.from_numpy(x), cm.pack_fma(torch.from_numpy(kernel))).float()
    kw_ = dict(epilogue=epilogue)
    if epilogue != "none":
        kw_["bias"] = bias
        acc = acc + torch.from_numpy(bias)
    if epilogue == "contract":
        kw_.update(scale=scale, shift=shift)
        acc = torch.relu(torch.relu(acc) * torch.from_numpy(scale) + torch.from_numpy(shift))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_valid(jnp.asarray(x), jnp.asarray(kernel),
                                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw_.items()}))
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,cout", [((1, 1), 6), ((4, 16), 48), ((9, 17), 192),
                                     ((23, 37), 7), ((120, 240), 48), ((17, 33), 300),
                                     ((240, 480), 128)])
def test_fma_blocks_cover_each_output_once(hw, cout):
    """The launch grid's blocks, their warps' pixels, the K-groups' share of
    the stores and the column blocks write every output (pixel, column)
    exactly once."""
    pl = cm.fma_plan(3, 3, 64, cout)
    h, w = hw
    seen = torch.zeros(h, w, cout, dtype=torch.int64)
    grid_x, grid_y = pl.grid(h, w)
    tiles_x = -(-w // cm.FMA_COLS)
    for bx in range(grid_x):
        oy0, ox0 = (bx // tiles_x) * pl.rows, (bx % tiles_x) * cm.FMA_COLS
        for cb in range(grid_y):
            _, oy, ox, n = _fma_stores(pl, oy0, ox0, cb, h, w)
            seen.index_put_((oy, ox, n), torch.ones_like(n), accumulate=True)
    assert (seen == 1).all()


@pytest.mark.parametrize("name", list(F32_SHAPES) + ["k15 cin512 cout192", "k15 cin256 cout48",
                                                     "k15 cin68 cout128", "k15 cin4 cout6"])
def test_fma_plans_fit_the_shared_memory(name):
    """Each on-path and test shape and 15 x 15 kernels at wide and narrow
    Cin and Cout fit a block's shared memory on the H100 in at least two
    stage buffers; a chunk is a whole number of each K-group's quads, and
    the TMA box's dimensions stay within 256."""
    if name in F32_SHAPES:
        shape = F32_SHAPES[name]
    else:
        k, cin, cout = (int(v) for v in re.findall(r"\d+", name))
        shape = (k, k, cin, cout)
    pl = cm.fma_plan(*shape)
    static = 2 * cm.FMA_MAX_BUF * 8  # the full and empty mbarriers
    assert pl.smem_bytes <= cm.MAX_DYN_BYTES and pl.smem_bytes + static <= SMEM_CAP
    assert 2 <= pl.nbuf <= cm.FMA_MAX_BUF and pl.stage_bytes % 128 == 0
    assert pl.cc % (4 * pl.kgw) == 0 and pl.cc <= 256 and pl.twc <= 256
    assert pl.cin_x >= shape[2] and pl.cin_x - shape[2] < pl.cc
    assert pl.bn >= min(shape[3], cm.FMA_WIDE_BN) and pl.col_blocks * pl.bn >= shape[3]


def test_the_fma_plan_follows_the_geometry():
    """Cout picks the tile (the narrowest that holds it); Cin picks the
    chunk: no padded channel on the packed path, and the most buffers."""
    stem, final960, final1920 = (cm.fma_plan(5, 5, 68, 128), cm.fma_plan(3, 3, 256, 48),
                                 cm.fma_plan(3, 3, 512, 192))
    assert (stem.bn, stem.tm, stem.kgw, stem.cc, stem.nchunks, stem.nbuf, stem.window) == \
        (128, 16, 1, 4, 17, 4, 5)
    assert (final960.bn, final960.tm, final960.kgw, final960.cc, final960.stages, final960.nbuf,
            final960.window) == (48, 4, 8, 128, 6, 2, 3)
    assert (final1920.bn, final1920.tm, final1920.kgw, final1920.cc, final1920.stages,
            final1920.nbuf, final1920.window, final1920.col_blocks) == (96, 8, 4, 64, 24, 2, 0, 2)
    for shape in ON_PATH.values():
        pl = cm.fma_plan(*shape)
        assert pl.cin_x == shape[2] and pl.col_blocks * pl.bn == shape[3]  # no padding
        assert pl == cm.fma_plan(*shape)  # a function of the shape alone
    test = cm.fma_plan(3, 3, 5, 7)
    assert (test.bn, test.cin_x, test.col_blocks, test.window) == (48, 32, 1, 3)
    assert cm.fma_plan(3, 3, 20, 300).col_blocks == 4  # column blocks of FMA_WIDE_BN


def test_fma_constants_match_the_source():
    """The Python mirror of conv_fma_kernel's constants and its (bn, tm)
    instantiations are the source's."""
    consts = dict(re.findall(r"constexpr int (FMA_\w+) = ([^;]+);", SOURCE))
    assert int(consts["FMA_WARPS"]) == cm.FMA_WARPS and int(consts["FMA_COLS"]) == cm.FMA_COLS
    assert int(consts["FMA_MAX_BUF"]) == cm.FMA_MAX_BUF
    launched = {tuple(int(v) for v in m) for m in
                re.findall(r"launch_fma<(\d+), (\d+), (\d+), (\d+)>\(p, map, s\)", SOURCE)}
    assert launched == {t + (0,) for t in cm.FMA_TILES.values()} | \
        {cm.FMA_TILES[bn] + (kw,) for bn, kw in cm.FMA_WINDOWS.items()}
    dispatch = {(int(bn), int(tm)) for bn, tm in
                re.findall(r"bn == (\d+) && tm == (\d+)\) err = ", SOURCE)}
    assert dispatch == {(bn, t[0]) for bn, t in cm.FMA_TILES.items()}
    windows = {(int(bn), int(kw)) for bn, kw in
               re.findall(r"bn == (\d+) && tm == \d+\) err = kw == (\d+) \?", SOURCE)}
    assert windows == set(cm.FMA_WINDOWS.items())
    for bn, (tm, tq, ng) in cm.FMA_TILES.items():
        assert 4 * tq * ng == bn and (cm.FMA_COLS // tm) * (tm // 2) == cm.FMA_WARPS
        assert tm % (32 // ng) == 0 or (32 // ng) % tm == 0
    assert cm.FMA_WIDE_BN in cm.FMA_TILES


def test_the_plain_version_takes_fma_weights():
    """The plain version runs on the HWIO kernel an FmaWeights holds (Cin
    zero-padded to whole chunks), on an input with the kernel's own Cin or
    the padded one, and gives the unpacked kernel's result."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn((9, 11, 5), generator=g)
    kernel = _f32_weights((3, 3, 5, 7), 9)
    fw = cm.pack_fma(kernel)
    assert fw.plan.cin == 5 and fw.kernel.shape == (3, 3, fw.plan.cin_x, 7)
    rows = [torch.rand(7, generator=g) for _ in range(3)]
    kw = dict(bias=rows[0], scale=rows[1], shift=rows[2], epilogue="contract")
    want = cm.conv_valid_matmul_plain(x, kernel, **kw)
    for xin in (x, torch.nn.functional.pad(x, (0, fw.plan.cin_x - 5))):
        got = cm.conv_valid_matmul_plain(xin, fw, **kw)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="want x"):
        cm.conv_valid_matmul_plain(x[..., :4], fw, **kw)


def test_f32_packed_transfer_packs_its_fma_weights_once(monkeypatch):
    """An f32 PackedTransfer packs the stem's and the final conv's weights
    for conv_fma_kernel at assembly, with no padded channel; a frame hands
    them to the tap matmul and packs nothing."""
    model = make_inference_model(ShapeConfig.from_spec("rst-120-15-4-3"), seed=0, device="cpu")
    engine = PackedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu",
                            dtype=torch.float32)
    stem, final = engine.contracts[0].conv, engine.final.conv
    for conv in (stem, final):
        assert isinstance(conv.taps, cm.FmaWeights)
        assert conv.taps.kernel.shape[2] == conv.taps.plan.cin_x
        assert torch.equal(conv.taps.kernel[:, :, :conv.weight.shape[2]], conv.weight)
    assert all(c.conv.taps is None for c in engine.contracts[1:])
    got = []

    def record(x, kernel, **kw):
        got.append(kernel)
        return cm.conv_valid_matmul_plain(x, kernel, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a frame packed weights")

    monkeypatch.setattr(cm, "pack_fma", refuse)
    h, w, c = model.plan.input_shape
    content = torch.rand((1, h, w, c))
    sp = torch.rand((1, 1, model.plan.num_style_parameters)) + 0.5
    want = engine(content, sp, conv_backend="pallas", plain=True)
    out = engine(content, sp, conv_backend="pallas")
    assert torch.equal(out, want) and out.dtype == torch.float32
    pp = torch.rand((1, 6, 10, stem.weight.shape[2]))
    tpc.run_fused_contract(pp, stem, dict(epilogue="none"), matmul=record)
    assert got == [stem.taps]
