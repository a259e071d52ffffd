"""The halo path of ``csrc/conv_stage.cu`` on the CPU: which stages take it,
the launch grid and moment scratch its tiles give, and its shared memory.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against its plain version; these tests hold the Python side that picks each
stage's path and sizes its launches against the tile constants of the CUDA
source, on engines built on the CPU as ``ops/bounds.py`` builds them.
"""

import re

import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig
from realtime_style_transfer_torch.models.inference import plan_from_config
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.halo_profile import PHASES, profiled_source
from realtime_style_transfer_torch.ops.bounds import cpu_engine
from realtime_style_transfer_torch.ops.kernels import (
    halo_pitch,
    halo_slices,
    halo_smem_bytes,
    make_conv_stage,
    stage_path,
)

SOURCE = (kernels.CSRC / "conv_stage.cu").read_text()
# tests/test_torch_fused.py's TINY and tests/test_torch_three_seg.py's TINY3
TINY_PLANS = {
    "tiny": dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
                 num_channels=17, hdr=True),
    "tiny3": dict(resolution_divider=15, bottleneck_res_y=8, bottleneck_num_filters=8,
                  num_channels=17, hdr=True),
}
SPECS = {"rst-960-120-128-17": 12, "rst-1920-120-128-17": 13}  # halo launches a frame
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
    return "gather"


def halo_grid(oh: int, ow: int, n: int, block_n: int):
    return (-(-oh // CU["HALO_TH"]) * -(-ow // CU["HALO_TW"]), -(-n // block_n))


def test_halo_constants_match_the_source():
    assert (CU["HALO_TH"], CU["HALO_TW"], CU["RING"], CU["SLICE_BYTES"],
            CU["MAX_HALO_BYTES"]) == (kernels.HALO_TH, kernels.HALO_TW, kernels.RING,
                                      kernels.SLICE_BYTES, kernels.MAX_HALO_BYTES)
    # a warp holds one m16 tile a tile row, two rows a warp
    assert CU["HALO_TW"] == 16 and CU["HALO_ROWS"] * CU["H_THREADS"] // 32 == CU["HALO_TH"]
    assert re.search(r"PATH_GATHER = 0, PATH_WINDOW = 1, PATH_HALO = 2", SOURCE)
    assert kernels.PATHS == {"gather": 0, "window": 1, "halo": 2}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_full_width_stages_take_the_path_of_their_role(spec):
    engine = cpu_engine(plan_from_config(ShapeConfig.from_spec(spec)))
    paths = {s.stage.name: s.stage.path for s in engine.steps}
    assert paths == {name: expected_path(name) for name in paths}
    assert sum(p == "halo" for p in paths.values()) == SPECS[spec]
    for s in engine.steps:
        st = s.stage
        assert st.path == stage_path(st.stride, st.kh, st.kw)
        if st.path == "halo":  # the stride-1 convs of at most 9 taps
            assert st.stride == 1 and st.kh * st.kw <= 9 and st.cin_k == st.cin


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
    assert len(halo) == SPECS[spec]
    for st in halo:
        assert st.quant == quant
        assert st.smem_bytes == halo_smem_bytes(st.kh, st.kw, st.cin_k, st.block_n, quant)
        assert st.smem_bytes <= kernels.MAX_HALO_BYTES
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


def test_halo_profile_counts_every_phase_of_the_kernel():
    """conv_halo_kernel marks the end of each phase with ``// PROFILE LAP i``,
    in order; halo_profile.py closes one counter at each marker, and the rest
    of the source is untouched."""
    marked = SOURCE[SOURCE.index("conv_halo_kernel(const Params p) {"):]
    marked = marked[:marked.index("\n}\n")]
    assert [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", marked)] == \
        list(range(len(PHASES)))
    kernel = profiled_source(SOURCE)
    body = kernel[kernel.index("conv_halo_kernel(const Params p) {"):]
    body = body[:body.index("\n}\n")]
    assert [int(i) for i in re.findall(r"  LAP\((\d)\);", body)] == list(range(len(PHASES)))
    assert "PROFILE LAP" not in body
    head = SOURCE[:SOURCE.index("conv_halo_kernel(const Params p) {")]
    assert kernel.startswith(head) and kernel.endswith(SOURCE[SOURCE.index(
        "// Whether the stage's moment scratch holds"):])


@pytest.mark.parametrize("kshape,stride,kw,match", [
    ((3, 3, 12, 8), 1, {}, "halo path needs an NHWC input with cin % 8"),
    ((2, 2, 16, 8), 1, dict(pack_c=64), "halo path needs an NHWC input"),
    ((3, 3, 12, 8), 2, {}, "gather path needs an NHWC input with cin % 8"),
    ((3, 3, 1024, 8), 1, {}, "over the halo path's"),
    ((3, 3, 136, 8), 1, dict(act_scale=np.ones(136, np.float32)), "int8 stage takes <= 128"),
])
def test_make_conv_stage_refuses_a_geometry_no_path_takes(kshape, stride, kw, match):
    with pytest.raises(ValueError, match=match):
        make_conv_stage("s", np.ones(kshape, np.float32), np.zeros(kshape[3]), in_hw=(16, 16),
                        out_hw=(16 // stride, 16 // stride), stride=stride, pads=(1, 1),
                        epi="bias", device="cpu", **kw)
