"""The port's spatial mesh axis on the CPU: rows sharded over a group.

Most tests run the ranks of a spatial group as threads of this process: a
:class:`ThreadShard` is a ``RowShard`` whose two collectives (``all_gather``
and the in-place ``all_reduce_``) meet at a barrier, so the halo exchange,
the gather along H and the moment sums run as they do over gloo or NCCL,
each rank's autograd graph in its own thread.  The whole frame's result on
one rank is the yardstick.  The two-rank gloo tests against JAX's
``DistributedTrainer`` and ``DistributedStylizer`` on ``make_mesh(2,
spatial=2)`` are in ``tests/test_torch_parallel.py`` (one spawn of ranks for
both axes), the CLI's ``--mesh 1,2`` in ``tests/test_torch_train_cli.py``.

Limits.  Convs, batch norms and the whole net in f32 against the unsharded
ones: rtol 1e-5 + atol 1e-5 x max for outputs (the rows are the same sums in
another order only where a halo crosses a boundary: none), gradients rtol
1e-4 + atol 1e-5 x max (the weight gradient is a sum over ranks).  The split
CIN against the one-pass plain versions: f32 rtol 1e-5 + atol 1e-5 x max
(moments and outputs; dscale and dbias, f32 sums in another grouping, rtol
1e-4); bf16 within one bf16 ulp (rtol 1.6e-2 + atol 1e-2 x max, phase 2's
limit on the card).  Against JAX's ``conditional_instance_norm``:
``tests/test_torch_cin.py``'s f32 2e-4, and in bf16 the JAX package's bf16
limit (rtol 0.05, atol 0.02, median below 5e-3: its plain CIN rounds to
bf16 three times where the kernel's fold rounds once).  The whole net's
parameter gradients: rtol 1e-4 with an absolute floor of 1e-5 of the net's
largest gradient (f32 noise around a gradient of 0).
"""

import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.models.layers import BatchNorm, Conv, ConvTranspose, normal_
from realtime_style_transfer_torch.models.transfer import StyleTransferNet, make_transfer_plan
from realtime_style_transfer_torch.ops import cin as tcin
from realtime_style_transfer_torch.ops import normalization as tnorm
from realtime_style_transfer_torch.ops.conv import same_pads
from realtime_style_transfer_torch.parallel import RowShard, row_split
from realtime_style_transfer_tpu.ops import normalization as jnorm

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
EPS = 1e-5


class _Meeting:
    """Where the threads of one group meet for a collective."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n

    def exchange(self, i, t):
        self.slots[i] = t.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


@dataclasses.dataclass(frozen=True)
class ThreadShard(RowShard):
    meeting: Any = None

    def all_gather(self, t):
        return self.meeting.exchange(self.index, t)

    def all_reduce_(self, t):
        parts = self.meeting.exchange(self.index, t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)


def run_group(bounds, fn):
    """``fn(shard)`` on a thread a rank of ``bounds``; the ranks' results."""
    meeting = _Meeting(len(bounds))
    results, errors = [None] * len(bounds), []

    def rank(i):
        try:
            results[i] = fn(ThreadShard(None, i, bounds, meeting))
        except BaseException as e:  # noqa: BLE001 - reraised below
            errors.append(e)
            meeting.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(len(bounds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def close(got, want, rtol=1e-5, atol_frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


# ---------------------------------------------------------------------------
# the row split
# ---------------------------------------------------------------------------


def test_row_split_aligns_boundaries_and_splits_unevenly():
    # tests/test_parallel.py's TINY frame: 60 rows, a 15-row bottleneck (2 contracts)
    assert row_split(60, 2, 4) == ((0, 32), (32, 60))
    assert row_split(480, 2, 4) == ((0, 240), (240, 480))
    assert row_split(56, 3, 4) == ((0, 20), (20, 40), (40, 56))
    assert row_split(60, 15, 4)[-1] == (56, 60)
    with pytest.raises(ValueError, match="multiple of 4"):
        row_split(62, 2, 4)
    with pytest.raises(ValueError, match="fewer than the 16 ranks"):
        row_split(60, 16, 4)
    shard = RowShard(None, 1, row_split(60, 2, 4))
    assert shard.level(28) == (60, 32) and shard.level(7) == (15, 8)
    assert shard.pixels(14, 30) == 30 * 30
    with pytest.raises(ValueError):
        shard.level(5)


def test_same_pads_of_the_sharded_convs():
    """The pads each sharded conv takes from its neighbours (the frame's TF
    SAME pads; a shard's own height would give others): 9x9 and 3x3 stride 1
    read 4 and 1 rows each side; the 3x3 stride-2 contract on an even height
    pads 0 above and 1 below, so it reads one row of the next rank only."""
    assert same_pads(60, 9, 1) == (4, 4) and same_pads(15, 3, 1) == (1, 1)
    assert same_pads(60, 3, 2) == (0, 1) and same_pads(30, 3, 2) == (0, 1)
    assert same_pads(28, 3, 2) == (0, 1) and same_pads(7, 3, 2) == (1, 1)


# ---------------------------------------------------------------------------
# the sharded convs and batch norm against the unsharded ones
# ---------------------------------------------------------------------------


def _layer(kind, cin, cout, gen):
    def init(t, g):
        return normal_(t, 0.1, g)

    if kind == "transpose2x":
        return ConvTranspose(cin, cout, 3, 2, gen=gen, init=init)
    if kind == "transpose9":
        return ConvTranspose(cin, cout, 9, 1, gen=gen, init=init)
    kernel, stride = {"stem9": (9, 1), "res3": (3, 1), "contract3": (3, 2)}[kind]
    layer = Conv(cin, cout, kernel, stride=stride, gen=gen, init=init)
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
    return layer


# (kind, the level of its input: rows are the full frame's >> level)
CONVS = [("stem9", 0), ("res3", 2), ("contract3", 0), ("contract3", 1),
         ("transpose2x", 2), ("transpose2x", 1), ("transpose9", 0)]


@pytest.mark.parametrize("height, bounds", [
    (64, row_split(64, 2, 4)), (60, row_split(60, 2, 4)), (56, row_split(56, 3, 4))],
    ids=["even", "uneven", "three-uneven"])
@pytest.mark.parametrize("kind, level", CONVS, ids=[f"{k}-l{lv}" for k, lv in CONVS])
def test_sharded_conv_matches_the_unsharded_conv(kind, level, height, bounds):
    gen = torch.Generator().manual_seed(0)
    layer = _layer(kind, 5, 6, gen)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, height >> level, 12, 5)).astype(np.float32))
    x.requires_grad_(True)
    want = layer(x)
    g = torch.from_numpy(rng.standard_normal(tuple(want.shape)).astype(np.float32))
    want_dx, want_dw = torch.autograd.grad(want, [x, layer.weight], g)

    def rank(shard):
        a, b = shard.bounds[shard.index]
        local = x.detach()[:, a >> level:b >> level].clone().requires_grad_(True)
        out = shard.gather(layer(local, rows=shard))
        dx, dw = torch.autograd.grad(out, [local, layer.weight], g)
        return out.detach(), dx, dw

    results = run_group(bounds, rank)
    for out, _, _ in results:
        close(out, want.detach())
    close(torch.cat([r[1] for r in results], 1), want_dx, 1e-4)
    close(sum(r[2] for r in results), want_dw, 1e-4)


def test_sharded_batch_norm_uses_the_frames_moments():
    bn = BatchNorm(4, 1e-3)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 60, 8, 4)).astype(np.float32) * 3)
    g = torch.from_numpy(rng.standard_normal((2, 60, 8, 4)).astype(np.float32))
    x.requires_grad_(True)
    want = bn(x, train=True)
    want_update = bn.batch_update
    want_dx = torch.autograd.grad(want, x, g)[0]

    def rank(shard):
        local = shard.take(x.detach()).clone().requires_grad_(True)
        out = bn(local, train=True, rows=shard)
        update = bn.batch_update
        return out.detach(), torch.autograd.grad(out, local, shard.take(g))[0], update

    results = run_group(row_split(60, 2, 4), rank)
    close(torch.cat([r[0] for r in results], 1), want.detach())
    close(torch.cat([r[1] for r in results], 1), want_dx, 1e-4)
    for _, _, (mean, var) in results:
        close(mean, want_update[0])
        close(var, want_update[1])


# ---------------------------------------------------------------------------
# the split CIN (TPU kernel rows 2 and 2'): sums, the group's all-reduce, apply
# ---------------------------------------------------------------------------


def _cin_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, _, _, c = shape
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal(shape).astype(np.float32)
    scale = rng.random((b, c)).astype(np.float32) + 0.5
    bias = rng.standard_normal((b, c)).astype(np.float32)
    return x, g, scale, bias


def _bf16_close(got, want):
    close(got.float(), want.float(), 1.6e-2, 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (3, 17, 23, 72)], ids=["even", "odd"])
def test_split_cin_over_two_row_halves_matches_the_one_pass(shape, dtype):
    """Each half's sums, added (the all-reduce), then each half's apply:
    forward and backward against cin_forward_plain / cin_backward_plain on
    the whole tensor, and the output against JAX's
    conditional_instance_norm."""
    xn, gn, scale_n, bias_n = _cin_inputs(shape)
    x, g = torch.from_numpy(xn).to(dtype), torch.from_numpy(gn).to(dtype)
    scale, bias = torch.from_numpy(scale_n), torch.from_numpy(bias_n)
    b, h, w, c = shape
    cut = h // 2
    halves = [(x[:, :cut], g[:, :cut]), (x[:, cut:], g[:, cut:])]
    sums = sum(tcin.cin_forward_sums(xh.contiguous()) for xh, _ in halves)
    applied = [tcin.cin_forward_apply(xh.contiguous(), sums, h * w, scale, bias, EPS)
               for xh, _ in halves]
    out = torch.cat([o for o, _ in applied], 1)
    want, want_stats = tcin.cin_forward_plain(x, scale, bias, EPS)
    for _, stats in applied:
        close(stats, want_stats)
    (close if dtype == torch.float32 else _bf16_close)(out, want)
    jax_out = np.asarray(jnorm.conditional_instance_norm(
        jnp.asarray(xn).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(scale_n[:, None, None]), jnp.asarray(bias_n[:, None, None])), np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), jax_out, rtol=2e-4, atol=2e-4)
    else:   # JAX's plain CIN rounds to bf16 three times, the kernel's fold once
        err = np.abs(out.float().numpy() - jax_out)
        assert (err <= 0.02 + 0.05 * np.abs(jax_out)).all() and np.median(err) < 5e-3

    stats = want_stats
    shares = [tcin.cin_backward_sums(xh.contiguous(), gh.contiguous(), stats)
              for xh, gh in halves]
    bsums = shares[0] + shares[1]
    dx = torch.cat([tcin.cin_backward_apply(xh.contiguous(), gh.contiguous(), stats, bsums,
                                            h * w, scale, EPS) for xh, gh in halves], 1)
    want_dx, want_dscale, want_dbias = tcin.cin_backward_plain(x, g, stats, scale, EPS)
    inv = torch.rsqrt((stats[:, 1] - stats[:, 0] ** 2) + EPS)
    close(bsums[:, 0], want_dbias, 1e-4)
    close(inv * bsums[:, 1], want_dscale, 1e-4)
    if dtype == torch.float32:
        close(dx, want_dx, 1e-4)
    else:
        _bf16_close(dx, want_dx)


@pytest.mark.parametrize("c", [128, 16], ids=["kernel", "below-min-channels"])
def test_cin_split_autograd_over_a_group(c):
    """cin_split on three uneven row shards (threads) against cin_plain on the
    whole tensor: the output, dx, and the sum of the ranks' dscale and dbias
    (each rank's share)."""
    shape = (2, 12, 10, c)
    xn, gn, scale_n, bias_n = _cin_inputs(shape, seed=3)
    x = torch.from_numpy(xn).requires_grad_(True)
    scale = torch.from_numpy(scale_n).reshape(2, 1, 1, c).requires_grad_(True)
    bias = torch.from_numpy(bias_n).reshape(2, 1, 1, c).requires_grad_(True)
    g = torch.from_numpy(gn)
    if c >= tcin.MIN_CHANNELS:
        want = tcin.cin_plain(x, scale, bias)
    else:
        want = tnorm.conditional_instance_norm(x, scale, bias)
    want_grads = torch.autograd.grad(want, [x, scale, bias], g)
    bounds = row_split(12, 3, 4)

    def rank(shard):
        leaves = [shard.take(x.detach()).clone().requires_grad_(True),
                  scale.detach().clone().requires_grad_(True),
                  bias.detach().clone().requires_grad_(True)]
        out = tcin.cin_split(*leaves, shard, plain=True)
        return out.detach(), torch.autograd.grad(out, leaves, shard.take(g))

    results = run_group(bounds, rank)
    close(torch.cat([r[0] for r in results], 1), want.detach())
    close(torch.cat([r[1][0] for r in results], 1), want_grads[0], 1e-4)
    for k in (1, 2):
        close(sum(r[1][k] for r in results), want_grads[k], 1e-4)


# ---------------------------------------------------------------------------
# the whole transfer net on sharded rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_styles", [1, 2])
def test_transfer_net_on_sharded_rows_matches_the_whole_frame(num_styles):
    """A 32x64 net with a 64-filter core (the residual CINs on cin_split's
    kernel path, plain versions here; the expand CINs below MIN_CHANNELS) in
    train mode on three uneven row shards: the gathered output, and the sum
    of the ranks' parameter gradients, against the net on the whole frame;
    two styles blend by a weight map cut to each rank's rows."""
    plan = make_transfer_plan((32, 64, 3), (32, 64, 3), 8, 64)
    net = StyleTransferNet(plan, num_styles, use_pallas=num_styles == 1,
                           generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    content = torch.from_numpy(rng.random((2, 32, 64, 3)).astype(np.float32))
    params = torch.from_numpy((rng.random((2, num_styles, plan.num_style_parameters)) * 0.4
                               + 0.8).astype(np.float32))
    weights = (torch.from_numpy(rng.random((2, 32, 64, 1)).astype(np.float32))
               if num_styles > 1 else None)
    names = [n for n, _ in net.named_parameters()]
    want = net(content, params, weights, train=True, plain=True)
    g = torch.from_numpy(rng.standard_normal(tuple(want.shape)).astype(np.float32))
    want_grads = torch.autograd.grad(want, list(net.parameters()), g)
    bounds = row_split(32, 3, 4)

    def rank(shard):
        out = net(content, params, weights, train=True, plain=True, rows=shard)
        return out.detach(), torch.autograd.grad(out, list(net.parameters()), g)

    results = run_group(bounds, rank)
    for out, _ in results:
        close(out, want.detach(), 1e-5, 1e-5)
    # a gradient that is f32 rounding noise around 0 (a conv bias that a norm
    # cancels) is held to the noise floor, 1e-5 of the net's largest gradient
    floor = 1e-5 * max(float(gr.abs().max()) for gr in want_grads)
    for i, name in enumerate(names):
        got = sum(r[1][i] for r in results)
        np.testing.assert_allclose(got.numpy(), want_grads[i].numpy(), rtol=1e-4, atol=floor,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the multichip dry run
# ---------------------------------------------------------------------------


def test_entry_multichip_dry_run_passes_its_four_checks():
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "realtime_style_transfer_torch.entry",
                          "multichip", "2", "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    lines = run.stdout.splitlines()
    for start in ("train 2-step ok: mesh={'data': 2, 'spatial': 1}",
                  "latency batch-1 ok: mesh={'data': 1, 'spatial': 2} out=(1, 60, 120, 3)",
                  "dual-style ok: mesh={'data': 2, 'spatial': 1} out=(2, 60, 120, 3)",
                  "fused-per-chip ok: mesh={'data': 2, 'spatial': 1} out=(2, 64, 128, 3)",
                  "dryrun_multichip ok: mesh={'data': 2, 'spatial': 1}"):
        assert sum(line.startswith(start) for line in lines) == 1, (start, run.stdout)
