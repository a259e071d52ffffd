"""The redesigned matmul probes on the CPU: the port's probes against the TPU
probes' own Pallas kernels, and the plan that deals their repetitions over
the card.

``csrc/probe_int8.cu`` and ``csrc/probe_smem.cu``'s work arm run one kernel
(``csrc/probe_rep.cuh``) only on the card, where ``chip_smoke.py`` holds it
against its plain version.  Here:

- the port's wrappers (on a CPU tensor, their plain versions) against
  ``tools/probe_int8_mxu.py``'s ``make_pallas_mm`` and ``make_band_mm`` and
  ``tools/probe_vmem_cap.py``'s ``_work_kernel``, one repetition (the work
  kernel two), in Pallas interpret mode, loaded by path (the port never
  imports them), weights transposed from the port's (taps, n, k) to JAX's
  (k, n).  Limits: int8 exactly; bf16 1e-5 x max|want| (both sides take the
  same bf16 values and sum in f32 or float64);
- the plan (``ops/probe_rep.py`` ``rep_plan``): every (group, repetition)
  of every part is computed once, the partial slots are distinct, the
  shared memory stays within the H100's 232448 bytes a block, and a float64
  replay of the kernel's partials (:func:`rep_replay` below), added in the
  plan's order, equals the plain result (int8 exactly, bf16 within 1e-12
  relative: only the order of float64 sums differs);
- the int8 arms' refusal of an ``nrep`` whose s32 sums could wrap.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from realtime_style_transfer_torch.ops import kernels
from realtime_style_transfer_torch.ops import probe_int8 as pi
from realtime_style_transfer_torch.ops import probe_rep as pr
from realtime_style_transfer_torch.ops import probe_smem as ps

TOOLS = Path(__file__).resolve().parents[1] / "tools"
SMEM_CAP = 232448  # the H100's opt-in shared memory a block (PERF.md, TPU kernel row 5)
ARMS = [("mm", False), ("mm", True), ("band", False), ("band", True), ("work", False)]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def int8_probe():
    return _tool("probe_int8_mxu")


@pytest.fixture(scope="module")
def vmem_probe():
    return _tool("probe_vmem_cap")


def smem_bytes(plan):
    """The kernel's dynamic shared memory (csrc/probe_rep.cuh RepLayout): the
    weights' staging, which mm's two x tiles reuse; the band's three windows
    reuse it too, and its two bf16 input rows follow."""
    es = 1 if plan.quant else 2
    kp = pr.C * es // 16
    w = plan.taps * pr.C * pr.C * es
    if plan.arm == "band":
        return max(w, 3 * kp * pr.PITCH * 16) + 2 * 16 * pr.PITCH * 16
    return max(w, 2 * kp * pr.TILE * 16)


def block_of(plan, u):
    """The part-local block of part-local unit u (csrc/probe_rep.cuh
    rep_block_of)."""
    return -(-(u + 1) * plan.bpp // plan.units) - 1


def rep_segments(plan):
    """(block, part, group, first repetition, repetitions) of every segment,
    in block order: what each block of the launch computes."""
    out = []
    for b in range(plan.blocks):
        part, lb = divmod(b, plan.bpp)
        u0, u1 = lb * plan.units // plan.bpp, (lb + 1) * plan.units // plan.bpp
        for g in range(u0 // plan.nrep, (u1 - 1) // plan.nrep + 1):
            r0 = max(u0, g * plan.nrep) - g * plan.nrep
            r1 = min(u1, (g + 1) * plan.nrep) - g * plan.nrep
            out.append((b, part, g, r0, r1 - r0))
    return out


def rep_contributors(plan, tile):
    """The part-local blocks whose partials a tile's outputs add, in order."""
    lo = block_of(plan, tile * plan.nrep)
    return list(range(lo, block_of(plan, (tile + 1) * plan.nrep - 1) + 1))


def _group_product(plan, part, g, x, w):
    """float64 (TILE, C) product of one group for one repetition; pixels
    past the row are zero (mm, work) or read zero columns (band)."""
    if plan.arm == "band":
        r, j = divmod(g, plan.tiles_x)
        row = F.pad(x[r + part], (0, 0, 1, pr.TILE * plan.tiles_x - plan.width + 1))
        return sum(row[pr.TILE * j + dx:pr.TILE * j + dx + pr.TILE] @ w[3 * part + dx].T
                   for dx in range(3))
    xt = F.pad(x[pr.TILE * g:pr.TILE * (g + 1)],
               (0, 0, 0, max(0, pr.TILE * (g + 1) - plan.width)))
    if plan.arm == "work":
        return sum(xt @ w[t] for t in range(3))
    return xt @ w[0].T


def rep_replay(plan, x, w, act_inv=None):
    """The launch replayed in float64: each segment's partial (its
    repetitions' products added in turn), then each tile's outputs as the
    kernel adds them (parts in order, blocks in order).  The band's int8 arm
    quantizes x with ``act_inv`` first."""
    xf = x.float() if act_inv is None else kernels.quantize_plain(x, act_inv)
    xd, wd = xf.double(), w.double()
    partial = {}
    for b, part, g, _r0, count in rep_segments(plan):
        prod = _group_product(plan, part, g, xd, wd)
        acc = torch.zeros_like(prod)
        for _ in range(count):
            acc += prod
        partial[b + part * plan.groups + g] = acc
    out = torch.zeros((plan.rows_out * plan.width, pr.C), dtype=torch.float64)
    for tile in range(plan.groups):
        acc = torch.zeros((pr.TILE, pr.C), dtype=torch.float64)
        for part in range(plan.parts):
            for lb in rep_contributors(plan, tile):
                acc += partial[part * plan.bpp + lb + part * plan.groups + tile]
        r, j = divmod(tile, plan.tiles_x)
        n = min(pr.TILE, plan.width - pr.TILE * j)
        out[r * plan.width + pr.TILE * j:r * plan.width + pr.TILE * j + n] = acc[:n]
    return out


def _check(got, want, quant):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if quant:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_mm_matches_the_tpu_probe(int8_probe, monkeypatch, quant):
    monkeypatch.setenv("RST_PLATFORM", "cpu")
    x, w, _ = pi.make_inputs("mm", quant, "cpu", seed=11)
    jx = jnp.asarray(x.numpy() if quant else x.float().numpy(), jnp.int8 if quant else jnp.bfloat16)
    jw = jnp.asarray(w[0].T.numpy() if quant else w[0].T.float().numpy(),
                     jnp.int8 if quant else jnp.bfloat16)
    call = int8_probe.make_pallas_mm(jnp.int8 if quant else jnp.bfloat16,
                                     jnp.int32 if quant else jnp.float32)
    _check(pi.probe_mm(x, w, 1), call(jx, jw), quant)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_band_matches_the_tpu_probe(int8_probe, monkeypatch, quant):
    monkeypatch.setenv("RST_PLATFORM", "cpu")
    x, w, inv = pi.make_inputs("band", quant, "cpu", seed=12)
    if inv is None:
        inv = torch.full((pi.C,), 127.0 / 4.0)  # read by the TPU kernel's int8 arm only
    call, x_shape, k_shape, _ = int8_probe.make_band_mm(jnp.int8 if quant else jnp.bfloat16,
                                                        jnp.int32 if quant else jnp.float32)
    assert x_shape == tuple(x.shape) and k_shape == (3, 3, pi.C, pi.C)
    taps = w.reshape(3, 3, pi.C, pi.C).transpose(2, 3)  # (dy, dx, n, k) -> (dy, dx, k, n)
    jk = jnp.asarray(taps.numpy() if quant else taps.float().numpy(),
                     jnp.int8 if quant else jnp.bfloat16)
    want = call(jnp.asarray(x.float().numpy(), jnp.bfloat16), jk,
                jnp.asarray(inv.numpy()[None], jnp.float32))
    _check(pi.probe_band(x, w, 1, inv if quant else None), want, quant)


def test_work_matches_the_tpu_probe(vmem_probe):
    reps = 2
    rng = np.random.default_rng(13)
    row = rng.standard_normal((1, ps.C), dtype=np.float32)
    w = torch.from_numpy(rng.standard_normal((ps.TAPS, ps.C, ps.C), dtype=np.float32)).to(
        torch.bfloat16)
    call = pl.pallas_call(
        functools.partial(vmem_probe._work_kernel, reps=reps),
        out_shape=jax.ShapeDtypeStruct((1, ps.C), jnp.float32),
        scratch_shapes=[pltpu.VMEM((ps.M, ps.C), jnp.float32),
                        pltpu.VMEM((ps.M, ps.C), jnp.bfloat16)],
        interpret=True)
    want = call(jnp.asarray(row), jnp.asarray(w.float().numpy(), jnp.bfloat16))
    # the TPU kernel broadcasts one f32 row to every bf16 row of x
    x = torch.from_numpy(row).to(torch.bfloat16).expand(ps.M, ps.C).contiguous()
    _check(ps.work(x, w, reps)[:1], want, False)


@pytest.mark.parametrize("arm,quant", ARMS)
@pytest.mark.parametrize("nrep,sms", [(1, 132), (3, 132), (16, 132), (64, 132), (64, 7),
                                      (115, 132)])
def test_plan_covers_every_unit_once(arm, quant, nrep, sms):
    plan = pr.rep_plan(arm, nrep, quant, sms=sms)
    assert plan.blocks <= sms and plan.bpp <= plan.units
    assert smem_bytes(plan) <= SMEM_CAP
    seen = {}
    slots = set()
    for b, part, g, r0, count in rep_segments(plan):
        assert b // plan.bpp == part and count >= 1
        slot = b + part * plan.groups + g
        assert slot not in slots and slot < plan.slots
        slots.add(slot)
        for r in range(r0, r0 + count):
            seen[(part, g, r)] = seen.get((part, g, r), 0) + 1
    assert len(seen) == plan.parts * plan.groups * nrep and set(seen.values()) == {1}
    # the outputs of a tile add exactly the blocks that wrote its partials
    for tile in range(plan.groups):
        blocks = {b % plan.bpp for b, _, g, _, _ in rep_segments(plan) if g == tile}
        assert rep_contributors(plan, tile) == sorted(blocks)


def test_plan_shapes_match_the_kernel_source():
    """The plan's tiles, windows, slots and shared memory are the constants
    and the layout of csrc/probe_rep.cuh."""
    src = (kernels.CSRC / "probe_rep.cuh").read_text()
    for name, value in (("REP_TILE", pr.TILE), ("REP_PITCH", pr.PITCH), ("REP_THREADS", 256)):
        assert f"constexpr int {name} = {value};" in src
    assert "constexpr int REP_WIN = REP_TILE + 2;" in src and pr.WIN == pr.TILE + 2
    assert "constexpr int REP_SLOT = 16 * REP_THREADS * 4;" in src and pr.SLOT == 16 * 256 * 4
    band = pr.rep_plan("band", pi.NREP)
    assert (band.groups, band.parts, band.tiles_x, band.taps) == (20, 3, 2, 3)
    # mm and work: the x tiles in the weights' staging; the band: rows after the windows
    assert [smem_bytes(pr.rep_plan(a, pi.NREP, q)) for a, q in ARMS] == \
        [65536, 32768, 174080, 121856, 98304]
    assert "MODE != REP_BAND ? 0 :" in src
    assert ps.work_plan(8).taps == 3 and ps.work_plan(8).groups == 19


@pytest.mark.parametrize("arm,quant", ARMS)
@pytest.mark.parametrize("nrep,sms", [(5, 132), (16, 40)])
def test_replay_of_the_partials_equals_the_plain_product(arm, quant, nrep, sms):
    plan = pr.rep_plan(arm, nrep, quant, sms=sms)
    if arm == "work":
        x, w = ps.make_work_inputs("cpu", seed=14)
        xd, wd = x.double(), w.double()
        got, want = rep_replay(plan, x, w), nrep * sum(xd @ wd[t] for t in range(ps.TAPS))
    else:
        x, w, inv = pi.make_inputs(arm, quant, "cpu", seed=14)
        got, want = rep_replay(plan, x, w, inv), pi.probe_plain(x, w, nrep, inv)
    assert got.dtype == torch.float64 and got.shape == want.shape
    if quant:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * want.abs().max().item())


@pytest.mark.parametrize("arm,ks,limit", [("mm", 1, 1040), ("band", 3, 115)])
def test_int8_arms_refuse_an_nrep_past_the_s32_range(arm, ks, limit):
    assert pi.max_nrep(ks) == limit
    # the worst repetition, every operand at 127, still fits at the limit
    assert limit * ks * ks * pi.C * 127 ** 2 <= 2 ** 31 - 1 < (limit + 1) * ks * ks * pi.C * 127 ** 2
    x, w, inv = pi.make_inputs(arm, True, "cpu", seed=15)
    fn = pi.probe_mm if arm == "mm" else functools.partial(pi.probe_band, act_inv=inv)
    with pytest.raises(ValueError, match="overflows the int8 arm's s32 sums"):
        fn(x, w, limit + 1)
    with pytest.raises(ValueError, match="nrep must be at least 1"):
        fn(x, w, 0)
    assert torch.equal(fn(x, w, limit), pi.probe_plain(x, w, limit, inv))
    # the bf16 arm's f32 sums do not wrap
    xb, wb, _ = pi.make_inputs(arm, False, "cpu", seed=15)
    fb = pi.probe_mm if arm == "mm" else pi.probe_band
    assert torch.isfinite(fb(xb, wb, limit + 1)).all()


def test_rep_plan_refuses_unknown_arms():
    with pytest.raises(ValueError, match="rep_plan"):
        pr.rep_plan("conv", 4)
    with pytest.raises(ValueError, match="rep_plan"):
        pr.rep_plan("work", 4, quant=True)
    with pytest.raises(ValueError, match="rep_plan"):
        pr.rep_plan("mm", 0)


def test_probe_kernel_phases_instrument():
    """halo_profile.py's counters go into the probes' kernel at its four
    PROFILE LAP markers, in order, and write p.counters."""
    from realtime_style_transfer_torch.halo_profile import PROBE_PHASES, profiled_source

    text = profiled_source((kernels.CSRC / "probe_rep.cuh").read_text())
    assert [int(i) for i in re.findall(r"LAP\((\d+)\);", text)] == \
        list(range(len(PROBE_PHASES["probe_rep_kernel"])))
    assert "p.counters[blockIdx.x * 8 + i] = _c[i];" in text
