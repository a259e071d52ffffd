"""The paths of ``csrc/conv_stage.cu`` on the CPU: which stages take each
(window, halo, strided), the launch grid and moment scratch their tiles give,
their shared memory, where the kernels read each input pixel and weight.

The kernels run only on the card, where ``chip_smoke.py`` holds them against
their plain versions; these tests hold the Python side that picks each
stage's path, lays out its weights and sizes its launches against the tile
constants of the CUDA source, and replay the kernels' index arithmetic, on
engines built on the CPU as ``ops/bounds.py`` builds them.
"""

import re

import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.halo_profile import (
    CASES,
    PHASES,
    _stage,
    load_package,
    profiled_source,
)
from realtime_style_transfer_torch.ops.bounds import cpu_engine
from realtime_style_transfer_torch.ops.kernels import (
    halo_pitch,
    halo_pixels,
    halo_slices,
    halo_smem_bytes,
    make_conv_stage,
    stage_path,
    window_cols,
    window_k_row,
    window_pitch,
    window_pixel_bytes,
    window_rows,
    window_smem_bytes,
)

SOURCE = (kernels.CSRC / "conv_stage.cu").read_text()
# tests/test_torch_fused.py's TINY and tests/test_torch_three_seg.py's TINY3
TINY_PLANS = {
    "tiny": dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
                 num_channels=17, hdr=True),
    "tiny3": dict(resolution_divider=15, bottleneck_res_y=8, bottleneck_num_filters=8,
                  num_channels=17, hdr=True),
}
# conv_stage launches a frame by path
SPECS = {"rst-960-120-128-17": {"strided": 2, "window": 2, "halo": 12},
         "rst-1920-120-128-17": {"strided": 3, "window": 2, "halo": 13}}
SMEM_CAP = 232448  # the H100's opt-in shared memory a block (PERF.md, TPU kernel row 5)


def cu_constants():
    """Every file-scope ``constexpr int NAME = expr;`` of conv_stage.cu,
    evaluated in order."""
    found = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SOURCE, re.M):
        found[name] = eval(expr.split("//")[0], {}, dict(found))
    return found


CU = cu_constants()


def expected_path(name: str) -> str:
    """The path a stage of the fused net takes, by its role."""
    if name in ("stem", "final"):
        return "window"
    if name.startswith(("res", "e")):
        return "halo"
    return "strided"


def halo_grid(oh: int, ow: int, n: int, block_n: int):
    return (-(-oh // CU["HALO_TH"]) * -(-ow // CU["HALO_TW"]), -(-n // block_n))


def test_halo_constants_match_the_source():
    assert (CU["HALO_TH"], CU["HALO_TW"], CU["RING"], CU["SLICE_BYTES"],
            CU["MAX_DYN_BYTES"]) == (kernels.HALO_TH, kernels.HALO_TW, kernels.RING,
                                     kernels.SLICE_BYTES, kernels.MAX_DYN_BYTES)
    # a warp holds one m16 tile a tile row, two rows a warp
    assert CU["HALO_TW"] == 16 and CU["HALO_ROWS"] * CU["H_THREADS"] // 32 == CU["HALO_TH"]
    assert re.search(r"PATH_STRIDED = 0, PATH_WINDOW = 1, PATH_HALO = 2", SOURCE)
    assert kernels.PATHS == {"strided": 0, "window": 1, "halo": 2}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_full_width_stages_take_the_path_of_their_role(spec):
    engine = cpu_engine(plan_from_config(ShapeConfig.from_spec(spec)))
    paths = {s.stage.name: s.stage.path for s in engine.steps}
    assert paths == {name: expected_path(name) for name in paths}
    assert {p: sum(q == p for q in paths.values()) for p in kernels.PATHS} == SPECS[spec]
    for s in engine.steps:
        st = s.stage
        assert st.path == stage_path(st.stride, st.kh, st.kw)
        if st.path == "halo":  # the stride-1 convs of at most 9 taps
            assert st.stride == 1 and st.kh * st.kw <= 9 and st.cin_k == st.cin
        if st.path == "strided":  # the contracts
            assert st.stride == 2 and st.cin_k == st.cin and st.k_row == st.kw * st.cin
        if st.path == "window":  # the 9x9 stem and final
            assert st.stride == 1 and st.kh * st.kw > 9 and st.cin_k == window_pitch(st.cin, False)
        assert st.wslices is not None and not hasattr(st, "kmap")


@pytest.mark.parametrize("tiny", sorted(TINY_PLANS))
def test_tiny_plan_stages_take_the_path_of_their_role(tiny):
    plan = plan_from_config(ShapeConfig(**TINY_PLANS[tiny]))
    engine = cpu_engine(plan)
    for s in engine.steps:
        assert s.stage.path == expected_path(s.stage.name), s.stage.name
    quant = cpu_engine(plan, quant="int8",
                       act_scales=np.ones((len(engine.steps), kernels.MAX_CIN), np.float32))
    assert [s.stage.path for s in quant.steps] == [s.stage.path for s in engine.steps]


@pytest.mark.parametrize("oh,ow,cout,k,transpose", [
    (120, 240, 128, 3, False), (73, 147, 128, 3, False), (5, 11, 128, 3, False),
    (240, 480, 16, 3, True), (480, 960, 8, 3, True), (9, 19, 8, 3, False)])
def test_grid_and_moment_scratch_follow_the_halo_tile(oh, ow, cout, k, transpose):
    cin = 32 if transpose else 128
    kernel = np.ones((k, k, cin, cout), np.float32)
    if transpose:  # the parity-packed 2x2 conv of an expand stage
        kernel, pads = np.ones((2, 2, cin, 4 * cout), np.float32), (1, 1)
    else:
        pads = (k // 2, k // 2)
    n = kernel.shape[3]
    st = make_conv_stage("s", kernel, np.zeros(n), in_hw=(oh, ow), out_hw=(oh, ow), stride=1,
                         pads=pads, epi="bias", device="cpu",
                         transpose_cout=cout if transpose else 0)
    assert st.path == "halo"
    grid = halo_grid(oh, ow, n, st.block_n)
    assert st.grid == grid
    # conv_stage.cu's scratch_fits: a [2, block_n] partial a block and one a
    # group of GROUP blocks; a ticket a group and one for the stage
    groups = -(-grid[0] // CU["GROUP"]) * grid[1]
    assert st.partials.numel() == (grid[0] * grid[1] + groups) * 2 * st.block_n
    assert st.tickets.numel() == groups + 1 and not st.tickets.any()


def test_halo_tiles_write_each_pixel_once():
    """The tile of block x (row-major over the grid of tiles) and its
    skip_out pixels, as the kernel maps them, cover an odd grid once."""
    oh, ow = 73, 147
    seen = np.zeros((oh, ow), np.int32)
    tiles_x = -(-ow // CU["HALO_TW"])
    for bx in range(halo_grid(oh, ow, 8, 8)[0]):
        by = bx // tiles_x
        oy0, ox0 = by * CU["HALO_TH"], (bx - by * tiles_x) * CU["HALO_TW"]
        seen[oy0:oy0 + CU["HALO_TH"], ox0:ox0 + CU["HALO_TW"]] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("cin", [8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("esize", [1, 2])
def test_halo_pitch_is_an_odd_number_of_16_byte_units(cin, esize):
    pitch = halo_pitch(cin, esize)
    assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
    assert cin * esize <= pitch < cin * esize + 32


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_halo_blocks_fit_the_shared_memory(spec, quant):
    """Every halo stage's dynamic bytes under the kernel's cap, with the
    static BlockState under the H100's 232448 a block; the residual convs
    fit two blocks an SM (228 KB, 1 KB reserved a block)."""
    plan = plan_from_config(ShapeConfig.from_spec(spec))
    engine = cpu_engine(plan)
    if quant:
        engine = cpu_engine(plan, quant="int8", act_scales=np.ones(
            (engine.n_conv_stages, kernels.MAX_CIN), np.float32))
    # BlockState, the ring's mbarriers and flush_moments' flag, with room for alignment
    static = 4 * kernels.MAX_CIN * (5 if quant else 4) + 8 * kernels.RING + 128
    halo = [s.stage for s in engine.steps if s.stage.path == "halo"]
    assert len(halo) == SPECS[spec]["halo"]
    for st in halo:
        assert st.quant == quant
        assert st.smem_bytes == halo_smem_bytes(st.kh, st.kw, st.cin_k, st.block_n, quant)
        assert st.smem_bytes <= kernels.MAX_DYN_BYTES
        assert st.smem_bytes + static <= SMEM_CAP
        if st.name.startswith("res"):
            assert 2 * (st.smem_bytes + static + 1024) <= 228 * 1024


def test_halo_smem_mirror_counts_tile_and_ring():
    # res0b..res4b: a 10 x 18 halo of 128 bf16 channels (272-byte pixels) and
    # three 128 x 128-byte weight slices
    assert halo_smem_bytes(3, 3, 128, 128, False) == 49024 + 49152
    # int8: 144-byte pixels; the ring's bytes hold the 46080-byte raw bf16 halo
    # first; the epilogue's 128 x 132 f32 tile, partials and slots are larger
    assert halo_smem_bytes(3, 3, 128, 128, True) == 4 * (128 * 132 + 2048 + 2048)
    assert halo_smem_bytes(3, 3, 128, 8, True) == 25984 + 46080
    # a 2x2 tile of 16 channels: the epilogue's f32 tile sets the bytes
    assert halo_smem_bytes(2, 2, 16, 32, False) == 4 * (128 * 36 + 2048 + 512)


@pytest.mark.parametrize("n,k_pad,dtype", [(128, 1152, torch.bfloat16), (128, 1152, torch.int8),
                                            (40, 224, torch.bfloat16), (8, 64, torch.int8)])
def test_halo_slices_hold_each_weight_byte_where_wgmma_reads_it(n, k_pad, dtype):
    """Byte b of K of weight row r sits in slice b // SLICE_BYTES of column
    block r // block_n, at core matrix (r % block_n // 8, b % SLICE_BYTES //
    16), row r % 8; the padding is zero."""
    rng = np.random.default_rng(n + k_pad)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k_pad), dtype=np.int8))
    if dtype == torch.bfloat16:
        w = torch.from_numpy(rng.standard_normal((n, k_pad), dtype=np.float32)).to(dtype)
    block_n = min(128, max(8, 1 << (n - 1).bit_length()))
    sl = halo_slices(w, block_n)
    raw = w.view(torch.uint8).numpy()
    sb = kernels.SLICE_BYTES
    nb, nk = -(-n // block_n), -(-raw.shape[1] // sb)
    assert sl.dtype == torch.uint8 and sl.numel() == nb * nk * block_n * sb
    flat = sl.reshape(nb, nk, block_n * sb).numpy()
    got = np.zeros((nb * block_n, nk * sb), np.uint8)
    for r in range(nb * block_n):
        for b in range(nk * sb):
            kt, kb = divmod(b, sb)
            off = (r % block_n // 8) * sb * 8 + kb // 16 * 128 + (r % 8) * 16 + kb % 16
            got[r, b] = flat[r // block_n, kt, off]
    assert np.array_equal(got[:n, :raw.shape[1]], raw)
    assert not got[n:].any() and not got[:, raw.shape[1]:].any()


def _kernel_body(text, name):
    body = text[text.index(f"{name}(const Params p) {{"):]
    return body[:body.index("\n}\n")]


def test_halo_profile_counts_every_phase_of_the_kernel():
    """conv_halo_kernel and conv_window_kernel mark the end of each phase
    with ``// PROFILE LAP i``, in order; halo_profile.py closes one counter
    at each marker of both kernels, and the rest of the source is
    untouched."""
    kernel = profiled_source(SOURCE)
    for name, phases in PHASES.items():
        marked = _kernel_body(SOURCE, name)
        assert [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", marked)] == \
            list(range(len(phases)))
        body = _kernel_body(kernel, name)
        assert [int(i) for i in re.findall(r"  LAP\((\d)\);", body)] == \
            list(range(len(phases)))
        assert "PROFILE LAP" not in body and "p.counters[blockIdx.x * 8 + i]" in body
    head = SOURCE[:SOURCE.index("conv_halo_kernel(const Params p) {")]
    assert kernel.startswith(head) and kernel.endswith(SOURCE[SOURCE.index(
        "// Whether the stage's moment scratch holds"):])


@pytest.mark.parametrize("kshape,stride,kw,match", [
    ((3, 3, 12, 8), 1, {}, "halo path needs an NHWC input with cin % 8"),
    ((2, 2, 16, 8), 1, dict(pack_c=64), "halo path needs an NHWC input"),
    ((3, 3, 12, 8), 2, {}, "strided path needs an NHWC input with cin % 8"),
    ((3, 3, 1024, 8), 1, {}, "over the halo path's"),
    ((3, 3, 136, 8), 1, dict(act_scale=np.ones(136, np.float32)), "int8 stage takes <= 128"),
])
def test_make_conv_stage_refuses_a_geometry_no_path_takes(kshape, stride, kw, match):
    with pytest.raises(ValueError, match=match):
        make_conv_stage("s", np.ones(kshape, np.float32), np.zeros(kshape[3]), in_hw=(16, 16),
                        out_hw=(16 // stride, 16 // stride), stride=stride, pads=(1, 1),
                        epi="bias", device="cpu", **kw)


# ---- the strided path: the halo kernel at stride 2 on a parity-split tile -----


def _strided_stage(hw, cin=32, cout=16, quant=False):
    """A 3x3 stride-2 stage on an input of grid ``hw`` with TF SAME pads."""
    out_hw = tuple(-(-d // 2) for d in hw)
    pads = tuple(max((o - 1) * 2 + 3 - d, 0) // 2 for o, d in zip(out_hw, hw))
    return make_conv_stage("s", np.ones((3, 3, cin, cout), np.float32), np.zeros(cout),
                           in_hw=hw, out_hw=out_hw, stride=2, pads=pads, epi="relu",
                           device="cpu",
                           act_scale=np.ones(cin, np.float32) if quant else None)


def _halo_col(r, pw):
    """conv_stage.cu's halo_col: the input column of pixel r of a halo row."""
    odd = int(r >= pw)
    return 2 * (r - odd * pw) + odd


@pytest.mark.parametrize("hw", [(480, 960), (240, 480), (73, 147), (5, 11), (3, 2)])
def test_strided_grid_writes_each_output_pixel_once(hw):
    """A strided stage's grid is the halo path's 8x16 output tiles; block x's
    tile (row-major over the grid of tiles) covers an odd grid once, and the
    moment scratch follows the grid."""
    st = _strided_stage(hw)
    assert st.path == "strided"
    oh, ow = st.out_hw
    assert st.grid == halo_grid(oh, ow, st.n, st.block_n)
    seen = np.zeros((oh, ow), np.int32)
    tiles_x = -(-ow // CU["HALO_TW"])
    for bx in range(st.grid[0]):
        by = bx // tiles_x
        oy0, ox0 = by * CU["HALO_TH"], (bx - by * tiles_x) * CU["HALO_TW"]
        seen[oy0:oy0 + CU["HALO_TH"], ox0:ox0 + CU["HALO_TW"]] += 1
    assert (seen == 1).all()
    groups = -(-st.grid[0] // CU["GROUP"]) * st.grid[1]
    assert st.partials.numel() == (st.grid[0] * st.grid[1] + groups) * 2 * st.block_n
    assert st.tickets.numel() == groups + 1


@pytest.mark.parametrize("kh,kw", [(3, 3), (2, 2), (5, 5), (1, 1)])
def test_strided_tile_holds_each_tap_where_the_kernel_reads_it(kh, kw):
    """conv_halo_kernel at S2: the fill puts input pixel (y0 + hy, x0 +
    halo_col(r)) at tile pixel hy * hc + r; the A row of output (w, x) at tap
    (ty, tx) is tile pixel 2 w hc + x plus HaloK's offset, ty hc + (tx & 1)
    (hc / 2) + tx / 2.  That must be input pixel (2 w + ty, 2 x + tx) from
    (y0, x0) for every pixel of the tile, so an m16 A tile (16 consecutive x)
    is 16 consecutive tile pixels."""
    assert "return (ty * hc + (tx & 1) * (hc >> 1) + (tx >> 1)) * pitch + cb;" in SOURCE
    assert "return 2 * (r - odd * pw) + odd;" in SOURCE
    assert "tile + (SY * warp * hc + a_col) * pitch" in SOURCE
    th, tw = CU["HALO_TH"], CU["HALO_TW"]
    pw = tw + (kw - 1) // 2
    hc = 2 * pw
    assert (2 * th + kh - 2) * hc == halo_pixels(kh, kw, True)
    filled = [divmod(q, hc) for q in range(halo_pixels(kh, kw, True))]
    filled = [(hy, _halo_col(r, pw)) for hy, r in filled]
    for w in range(th):
        for x in range(tw):
            for ty in range(kh):
                for tx in range(kw):
                    q = 2 * w * hc + x + ty * hc + (tx & 1) * (hc >> 1) + (tx >> 1)
                    assert filled[q] == (2 * w + ty, 2 * x + tx)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_strided_and_window_blocks_fit_the_shared_memory(spec, quant):
    """Every strided and window stage's dynamic bytes under its path's cap,
    with the static shared memory beside them under the H100's 232448 a
    block; a window block of the stem or the final fits two an SM."""
    plan = plan_from_config(ShapeConfig.from_spec(spec))
    engine = cpu_engine(plan)
    if quant:
        engine = cpu_engine(plan, quant="int8", act_scales=np.ones(
            (engine.n_conv_stages, kernels.MAX_CIN), np.float32))
    static = 4 * kernels.MAX_CIN * (5 if quant else 4) + 8 * kernels.RING + 128
    stages = [s.stage for s in engine.steps if s.stage.path in ("strided", "window")]
    assert len(stages) == SPECS[spec]["strided"] + SPECS[spec]["window"]
    for st in stages:
        if st.path == "strided":
            assert st.smem_bytes == halo_smem_bytes(3, 3, st.cin, st.block_n, quant, True)
            assert st.smem_bytes <= kernels.MAX_DYN_BYTES
        else:
            assert st.smem_bytes == window_smem_bytes(9, 9, st.cin, st.block_n, quant,
                                                      st.pack_c > 0)
            assert st.smem_bytes <= kernels.MAX_DYN_BYTES
            assert 2 * (st.smem_bytes + static + 1024) <= 228 * 1024
        assert st.smem_bytes + static <= SMEM_CAP


def test_strided_smem_mirror_counts_tile_and_ring():
    # c1: 17 rows of two planes of 17 pixels, 32 bf16 channels (80-byte
    # pixels), and three 16 x 128-byte weight slices
    assert halo_pixels(3, 3, True) == 17 * 34
    assert halo_smem_bytes(3, 3, 32, 16, False, True) == 46336 + 6144
    # int8: 48-byte pixels; the ring's bytes hold the raw bf16 tile first
    assert halo_smem_bytes(3, 3, 32, 16, True, True) == 27776 + 578 * 64


# ---- the window path: the 9x9 stages over a pixel-major window ----------------


def test_window_constants_match_the_source():
    assert (CU["BM"], CU["MAX_DYN_BYTES"]) == (kernels.WINDOW_BM, kernels.MAX_DYN_BYTES)
    # two warpgroups; window_rows(bn) / 2 output rows a warpgroup
    assert CU["W_THREADS"] == 256
    assert "constexpr int window_rows(int bn) { return bn <= 32 ? 4 : 2; }" in SOURCE
    assert [window_rows(bn) for bn in (8, 16, 32, 64, 128)] == [4, 4, 4, 2, 2]


@pytest.mark.parametrize("cin,quant,pitch,k_row,cols,smem", [
    (17, False, 18, 176, 76, 32896 + 31104 + 3 * 32 * 128),   # the stem
    (17, True, 20, 192, 76, 18304 + 31104 + 3 * 32 * 128),
    (16, False, 16, 144, 76, 43776 + 3 * 8 * 128),            # the final conv
    (16, True, 16, 160, 76, 14592 + 29184 + 3 * 8 * 128),
    (8, False, 8, 80, 76, 4 * (256 * 12 + 2048 + 128)),       # rst-1920's final
    (8, True, 8, 96, 76, 7296 + 14592 + 3 * 8 * 128),
])
def test_window_mirrors_size_the_window(cin, quant, pitch, k_row, cols, smem):
    """A tap of K holds cin rounded up to a 32-bit word (2 bf16, 4 int8), a
    window pixel the same bytes, 16 more where a tap is whole 32-byte K steps
    (the final conv's 16 bf16 channels: 48 bytes); a tap row of K is 9 taps
    rounded up to a wgmma K step; a window row holds the 64
    output columns plus the pixels the last column's K run reaches, rounded
    up to 4; the block holds 12 such rows, the raw bf16 rows the fill stages
    (the stem's from the pack and the int8 stages'; a bf16 stage on an NHWC
    input fills its window directly) and the weight ring (block_n 32 for the
    stem, 8 for the final), or the epilogue's f32 tile if that is larger."""
    bn = 32 if cin == 17 else 8
    assert (window_pitch(cin, quant), window_k_row(9, cin, quant)) == (pitch, k_row)
    tap = pitch * (1 if quant else 2)
    assert window_pixel_bytes(cin, quant) == (tap + 16 if tap % 32 == 0 else tap)
    assert window_cols(9, cin, quant) == cols
    assert 64 + 1 + (k_row - 1) // pitch <= cols  # the last column's run stays in the row
    assert window_smem_bytes(9, 9, cin, bn, quant, pack=cin == 17) == smem


@pytest.mark.parametrize("cin,quant", [(17, False), (17, True), (16, False), (16, True),
                                       (8, True), (3, False)])
def test_window_weights_sit_where_the_kernel_reads_them(cin, quant):
    """K index ty * k_row + kk of a window stage's weights multiplies window
    operand x * cp + kk of row oy + ty for output column x: input pixel x +
    kk // cp, channel kk % cp, so tap (ty, kk // cp).  Every weight sits
    there, the pad channels and the tail of each run are zero, weight_oihw
    reads the weights back, and the stem's K is at most 1.26x its 1377."""
    rng = np.random.default_rng(cin + quant)
    kernel = rng.standard_normal((9, 9, cin, 8)).astype(np.float32)
    scale = (rng.random(cin) + 0.5).astype(np.float32) if quant else None
    st = make_conv_stage("w", kernel, np.zeros(8), in_hw=(16, 16), out_hw=(16, 16), stride=1,
                         pads=(4, 4), epi="bias", device="cpu",
                         pack_c=384 if cin == 17 else 0, act_scale=scale)
    assert st.path == "window" and st.quant == quant
    cp, run = st.cin_k, st.k_row
    assert (cp, run) == (window_pitch(cin, quant), window_k_row(9, cin, quant))
    assert (cp * (1 if quant else 2)) % 4 == 0 and (run * (1 if quant else 2)) % 32 == 0
    want = kernels.quantize_kernel(kernel, scale)[0].astype(np.float32) if quant \
        else torch.from_numpy(kernel).to(torch.bfloat16).float().numpy()
    w = st.w.float().numpy()
    for k in range(w.shape[1]):
        ty, kk = divmod(k, run)
        tx, c = divmod(kk, cp)
        if ty < 9 and tx < 9 and c < cin:
            assert np.array_equal(w[:, k], want[ty, tx, c])
        else:
            assert not w[:, k].any(), k
    assert np.array_equal(st.weight_oihw().numpy(), want.transpose(3, 2, 0, 1))
    if cin == 17:
        assert st.k_real == (1728 if quant else 1584) and st.k_real <= 1.26 * 1377


@pytest.mark.parametrize("hw,n", [((480, 960), 32), ((480, 960), 3), ((73, 147), 3),
                                  ((5, 11), 3), ((20, 70), 64)])
def test_window_grid_writes_each_output_pixel_once(hw, n):
    """Block x of a window stage owns window_rows(block_n) output rows of 64
    columns (row-major over the grid of tiles): an odd grid once."""
    st = make_conv_stage("w", np.ones((9, 9, 16, n), np.float32), np.zeros(n), in_hw=hw,
                         out_hw=hw, stride=1, pads=(4, 4), epi="bias", device="cpu")
    rows, tiles_x = window_rows(st.block_n), -(-hw[1] // kernels.WINDOW_BM)
    assert st.grid == (-(-hw[0] // rows) * tiles_x, -(-n // st.block_n))
    seen = np.zeros(hw, np.int32)
    for bx in range(st.grid[0]):
        by = bx // tiles_x
        oy0, ox0 = by * rows, (bx - by * tiles_x) * kernels.WINDOW_BM
        seen[oy0:oy0 + rows, ox0:ox0 + kernels.WINDOW_BM] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("label", ["stem", "c1", "final", "res0b"])
def test_halo_profile_lays_out_other_roots_with_their_own_code(label):
    """halo_profile.py imports another checkout's package under a name of its
    own and lays each stage out with that package's ``make_conv_stage``: on
    this checkout, a module apart from this one that gives the same stage."""
    other = load_package(kernels.CSRC.parents[1], "_test_halo_profile_root")
    assert other is not kernels and other.__name__ == "_test_halo_profile_root.ops.kernels"
    assert other.BUILD_DIR == kernels.BUILD_DIR
    _, path, kshape, _, pack_input, _ = next(c for c in CASES if c[0] == label)
    kernel = np.random.default_rng(0).standard_normal(kshape).astype(np.float32)
    hw = (16, 24)
    for quant in (False, True):
        mine = _stage(kernels, label, path, kshape, kernel, hw, pack_input, quant, "cpu")
        theirs = _stage(other, label, path, kshape, kernel, hw, pack_input, quant, "cpu")
        assert isinstance(theirs, other.ConvStage) and not isinstance(theirs, kernels.ConvStage)
        assert (theirs.path, theirs.cin_k, theirs.grid) == (mine.path, mine.cin_k, mine.grid)
        assert torch.equal(theirs.wslices, mine.wslices) and torch.equal(theirs.w, mine.w)
