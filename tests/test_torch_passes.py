"""The port's two byte-bound passes on the CPU: ``finish`` and ``act_stats``.

``csrc/finish.cu`` and ``csrc/act_stats.cu`` run only on the card, where
``chip_smoke.py`` holds them against their plain versions bit for bit.  Here
the parts that decide what they compute are held instead: the numpy replays
of their index maps (``kernels.finish_map``, ``kernels.stem_stats_map``),
which follow the kernels' loops over the grids their wrappers launch
(``finish_plan``, ``act_stats_plan``), against the plain versions and the
JAX package's f4 pack; the plain ``act_stats`` maxing and adding into given
rows; and the calibrate / check loop that launches one ``act_stats`` a conv
stage into one table a call.
"""

import numpy as np
import pytest
import torch

import re

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.halo_profile import PASS_PHASES, profiled_source
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.models.inference import plan_from_config as tplan
from realtime_style_transfer_torch.ops import fused_transfer as tfused
from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops.bounds import stage_inputs
from realtime_style_transfer_torch.ops.fused_transfer import FusedTransfer
from realtime_style_transfer_torch.ops.kernels import (
    Prologue,
    act_stats,
    act_stats_plain,
    act_stats_plan,
    cin_affine,
    finish_map,
    finish_plain,
    finish_plan,
    make_conv_stage,
    stem_stats_map,
)
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.ops.packed_conv import pack as jax_pack

torch.set_num_threads(2)

TINY_KW = dict(resolution_divider=15, bottleneck_res_y=16, bottleneck_num_filters=8,
               num_channels=17, hdr=True)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        torch.bfloat16)


def _prologue(rng, x, dual=False):
    xf = x.float().reshape(-1, x.shape[-1])
    c = xf.shape[1]
    second = ()
    if dual:
        second = (torch.from_numpy(rng.random(c, dtype=np.float32) * 0.4 + 0.8),
                  torch.from_numpy(rng.random(c, dtype=np.float32) * 0.4 - 0.2),
                  torch.from_numpy(rng.random(x.shape[:2], dtype=np.float32)).to(torch.bfloat16))
    return Prologue(torch.stack([xf.sum(0), (xf * xf).sum(0)]).contiguous(), float(xf.shape[0]),
                    torch.from_numpy(rng.random(c, dtype=np.float32) * 0.4 + 0.8),
                    torch.from_numpy(rng.random(c, dtype=np.float32) * 0.4 - 0.2), 1e-5,
                    False, *second)


# ---------------------------------------------------------------------------
# finish: the index map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [3, 5, 16])
@pytest.mark.parametrize("hw, sms", [((12, 28), 132), ((8, 268), 2), ((8, 268), 4), ((16, 36), 2)],
                         ids=["wp7", "wp67-tiles", "wp67-odd-px0", "wp9"])
def test_finish_map_writes_each_output_once_and_gives_the_plain_frame(c, hw, sms):
    """The replay of finish.cu's map (staged rows, shifts, the thread's
    vector) writes every element of the packed frame once; the frame it
    makes from the plain per-pixel values equals ``finish_plain`` bit for
    bit, and its weight-plane reads are each value's own pixel."""
    h, w = hw
    rng = np.random.default_rng(70 + c)
    x = _bf16(rng, (h, w, c), 2.0)
    out_c = -(-16 * c // 128) * 128
    out_idx, src, wsrc = finish_map(h, w, c, out_c, sms=sms)
    n_out = (h // 4) * (w // 4) * out_c
    np.testing.assert_array_equal(np.bincount(out_idx, minlength=n_out), np.ones(n_out))
    real = src >= 0
    np.testing.assert_array_equal(wsrc[real], src[real] // c)
    assert (wsrc[~real] == -1).all()
    for dual in (False, True):
        pro = _prologue(rng, x, dual)
        y = torch.sigmoid(cin_affine(x.float(), pro)).to(torch.bfloat16)
        frame = torch.zeros(n_out, dtype=torch.bfloat16)
        frame[torch.from_numpy(out_idx[real])] = y.reshape(-1)[torch.from_numpy(src[real])]
        want = finish_plain(x, pro, torch.empty((h // 4, w // 4, out_c), dtype=torch.bfloat16))
        assert torch.equal(frame.reshape(want.shape), want)


@pytest.mark.parametrize("c", [3, 16])
def test_finish_map_follows_the_jax_f4_pack(c):
    """Where the map reads a value, the JAX package's f4 pack (the order of
    its kernel's packed output) holds the same value."""
    h, w = 12, 28
    x = _bf16(np.random.default_rng(80 + c), (h, w, c))
    out_c = -(-16 * c // 128) * 128
    out_idx, src, _ = finish_map(h, w, c, out_c)
    frame = np.zeros((h // 4) * (w // 4) * out_c, np.float32)
    real = src >= 0
    frame[out_idx[real]] = x.float().numpy().reshape(-1)[src[real]]
    want = np.asarray(jax_pack(x.float().numpy()[None], 4)[0], np.float32)
    frame = frame.reshape(h // 4, w // 4, out_c)
    np.testing.assert_array_equal(frame[..., :16 * c], want)
    assert not frame[..., 16 * c:].any()


@pytest.mark.parametrize("spec", ["rst-960-120-128-17", "rst-1920-120-128-17"])
def test_finish_plan_gives_every_sm_two_blocks_within_shared_memory(spec):
    plan = tplan(TConfig.from_spec(spec))
    h, w, c = plan.output_shape
    for dual in (False, True):
        fp = finish_plan(h, w, c, dual)
        assert fp.tpx % (kernels.PASS_THREADS // (2 * c)) == 0
        assert fp.grid[0] * fp.grid[1] >= 2 * kernels.SMS
        assert fp.grid == (-(-(w // 4) // fp.tpx), h // 4) and fp.smem <= 48 * 1024
    assert finish_plan(16, 64, 128, sms=1).tpx == 8  # staged rows of 4 * 8 * 128 values


# ---------------------------------------------------------------------------
# act_stats: rows, the stem's map, the grid
# ---------------------------------------------------------------------------


def _stage(cin, hw, pack_c=0):
    kernel = np.zeros((3, 3, cin, 8), np.float32)
    return make_conv_stage("s", kernel, np.zeros(8, np.float32), in_hw=hw, out_hw=hw,
                           stride=1, pads=(1, 1), epi="relu", device="cpu", pack_c=pack_c)


def test_plain_act_stats_maxes_and_adds_into_the_given_rows():
    """Two inputs into one pair of rows: the max of the two maxima and the
    int64 sum of the two clip counts, exactly; no launch on the CPU."""
    rng = np.random.default_rng(90)
    st = _stage(16, (6, 10))
    inv = torch.full((16,), 127.0 / 3.0)
    xs = [_bf16(rng, st.in_shape, s) for s in (2.0, 4.0)]
    pro = _prologue(rng, xs[0])
    skip = _bf16(rng, st.in_shape)
    max_row, clip_row = torch.zeros(16), torch.zeros(16, dtype=torch.int64)
    kernels.reset_launch_counts()
    ones = [act_stats(x, st, pro._replace(relu=True), skip, inv) for x in xs]
    for x in xs:
        got = act_stats(x, st, pro._replace(relu=True), skip, inv, max_out=max_row,
                        clips_out=clip_row)
        assert got[0] is max_row and got[1] is clip_row
    assert kernels.act_stats.launches == 0
    vals = [np.abs(kernels.stage_input(x, st, pro._replace(relu=True), skip).float().numpy())
            .reshape(-1, 16) for x in xs]
    np.testing.assert_array_equal(max_row.numpy(), np.maximum(*(v.max(axis=0) for v in vals)))
    want_clips = sum((v * np.float32(127 / 3) > 127.5).sum(axis=0) for v in vals)
    np.testing.assert_array_equal(clip_row.numpy(), want_clips)
    assert clip_row.dtype == torch.int64 and clip_row.sum() > 0
    np.testing.assert_array_equal(max_row.numpy(), np.maximum(ones[0][0].numpy(), ones[1][0].numpy()))
    np.testing.assert_array_equal(clip_row.numpy(), (ones[0][1] + ones[1][1]).numpy())
    # without act_inv the clip row stays as it was
    act_stats_plain(xs[0], st, max_out=max_row, clips_out=clip_row)
    np.testing.assert_array_equal(clip_row.numpy(), want_clips)


@pytest.mark.parametrize("cin", [3, 17, 18])
@pytest.mark.parametrize("hpwp, sms", [((3, 7), 132), ((12, 25), 1)], ids=["small", "ranges"])
def test_stem_map_reads_each_pack_value_once_under_its_logical_channel(cin, hpwp, sms):
    """The replay of act_stats.cu's reads of a frame pack covers each
    (pixel, channel < 16*cin) once, and counts each under the logical
    channel the JAX package's f4 pack put there."""
    hp, wp = hpwp
    pack_c = -(-16 * cin // 128) * 128
    pix, chan, logical = stem_stats_map(hp, wp, cin, pack_c, sms=sms)
    assert chan.max() < 16 * cin
    counts = np.bincount(pix * 16 * cin + chan, minlength=hp * wp * 16 * cin)
    np.testing.assert_array_equal(counts, np.ones(hp * wp * 16 * cin))
    frame = np.broadcast_to(np.arange(cin, dtype=np.float32), (1, 4 * hp, 4 * wp, cin))
    packed = np.asarray(jax_pack(frame, 4)[0], np.float32).reshape(hp * wp, 16 * cin)
    np.testing.assert_array_equal(packed[pix, chan], logical)


def test_the_twins_constants_are_the_kernels():
    """The grid twins size what the kernels launch: their constants are the
    sources' own."""
    fin = (kernels.CSRC / "finish.cu").read_text()
    stats = (kernels.CSRC / "act_stats.cu").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const(fin, "NTHREADS") == const(stats, "NTHREADS") == kernels.PASS_THREADS
    assert const(stats, "LOADS") == kernels.STATS_LOADS
    assert "const int pitch = ((4 * tpx * C + 7) & ~7) + 16;" in fin
    assert kernels._pitch(4 * 84 * 3) == ((4 * 84 * 3 + 7) & ~7) + 16


def test_halo_profile_marks_every_phase_of_the_act_stats_kernel():
    """act_stats_kernel closes each phase with ``// PROFILE LAP i``, in
    order; halo_profile.py turns each into a clock64 counter."""
    source = (kernels.CSRC / "act_stats.cu").read_text()
    phases = PASS_PHASES["act_stats_kernel"]

    def body(text):
        b = text[text.index("act_stats_kernel(const Params p"):]
        return b[:b.index("\n}\n")]

    assert [int(i) for i in re.findall(r"// PROFILE LAP (\d+)", body(source))] == \
        list(range(len(phases)))
    profiled = body(profiled_source(source))
    assert [int(i) for i in re.findall(r"  LAP\((\d)\);", profiled)] == list(range(len(phases)))
    assert "p.counters[blockIdx.x * 8 + i]" in profiled and "PROFILE LAP" not in profiled


@pytest.mark.parametrize("spec", ["rst-960-120-128-17", "rst-1920-120-128-17"])
def test_act_stats_plan_fills_every_sm_and_covers_each_pixel_once(spec):
    for name, (h, w, c), _affine, _skip in stage_inputs(tplan(TConfig.from_spec(spec))):
        pack = name == "stem"
        npix, nv = ((h // 4) * (w // 4), 2 * c) if pack else (h * w, c // 8)
        p = act_stats_plan(npix, nv)
        step = p.ppb * kernels.STATS_LOADS
        assert p.pixels % step == 0 and (p.blocks - 1) * p.pixels < npix <= p.blocks * p.pixels
        assert p.blocks >= min(-(-npix // step), kernels.STATS_BLOCKS_PER_SM * kernels.SMS) * 0.8
        assert p.blocks <= kernels.STATS_BLOCKS_PER_SM * kernels.SMS, name


# ---------------------------------------------------------------------------
# the calibrate / check loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = TConfig(**TINY_KW)
    model = make_inference_model(cfg, device="cpu", seed=5)
    ft = FusedTransfer(to_flax(model.transfer.state_dict()), model.plan, device="cpu")
    rng = np.random.default_rng(91)
    packs = [ft.pack_frame_np(rng.random((1,) + cfg.content_shape, dtype=np.float32) * s)
             for s in (1.0, 3.0)]
    prep = ft.prepare_style(torch.from_numpy(
        rng.random(model.plan.num_style_parameters, dtype=np.float32) * 0.4 + 0.8))
    return ft, packs, prep


def test_calibrate_over_two_frames_is_the_max_of_the_one_frame_tables(tiny, monkeypatch):
    ft, (a, b), prep = tiny
    one = [ft.calibrate_act_scales([p], prep) for p in (a, b)]
    rows = []

    def record(x, st, prologue, skip_in, act_inv, max_out, clips_out):
        rows.append((max_out, clips_out))
        return act_stats_plain(x, st, prologue, skip_in, act_inv, max_out, clips_out)

    monkeypatch.setattr(tfused, "act_stats_plain", record)
    both = ft.calibrate_act_scales([a, b], prep, plain=True)
    monkeypatch.undo()
    np.testing.assert_array_equal(both, np.maximum(*one))
    assert both.dtype == np.float32 and both.shape == (ft.n_conv_stages, 128)
    assert np.array_equal(ft.calibrate_act_scales([a, b], prep), both)
    # each launch wrote its stage's row of one table a call
    assert len(rows) == 2 * ft.n_conv_stages
    bases = {(m.untyped_storage().data_ptr(), c.untyped_storage().data_ptr()) for m, c in rows}
    assert len(bases) == 1
    assert [m.storage_offset() for m, _ in rows] == 2 * [128 * i
                                                         for i in range(ft.n_conv_stages)]


def test_check_over_two_frames_adds_the_one_frame_clip_events(tiny):
    ft, (a, b), prep = tiny
    scales = ft.calibrate_act_scales([a], prep) * 0.5
    one = [ft.check_act_saturation([p], prep, scales) for p in (a, b)]
    both = ft.check_act_saturation([a, b], prep, scales)
    assert [r["stage"] for r in both] == [s.stage.name for s in ft.steps]
    for i, r in enumerate(both):
        assert r["clip_events"] == one[0][i]["clip_events"] + one[1][i]["clip_events"]
        assert r["max_ratio"] == max(one[0][i]["max_ratio"], one[1][i]["max_ratio"])
        assert r["n_quantized"] == one[0][i]["n_quantized"] + one[1][i]["n_quantized"]
    assert sum(r["clip_events"] for r in both) > 0
