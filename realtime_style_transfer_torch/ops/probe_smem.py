"""The shared-memory cap probe: how far a block's dynamic shared memory can be
raised, and whether reserving more costs a fixed workload anything.

Port of ``tools/probe_vmem_cap.py``'s two questions to Hopper
(``csrc/probe_smem.cu``).  The TPU probe raised Mosaic's scoped-VMEM cap; on
Hopper the cap is the opt-in dynamic shared memory of one block
(``cudaFuncAttributeMaxDynamicSharedMemorySize`` up to the device's
``sharedMemPerBlockOptin``), which bounds the input tile of
``csrc/conv_matmul.cu``.

- :func:`try_alloc` (the TPU ``try_alloc``): set the cap to ``bytes``, launch
  one block an SM that fills the whole buffer and reads it back; the result is
  held against :func:`fill_plain`.  Refused sizes come back with
  ``alloc_ok=False`` and the CUDA error.
- :func:`work` (the TPU ``_work_kernel``): ``reps`` times the three
  ``(2400, 128) @ (128, 128)`` bf16 tap matmuls, f32 accumulation, on the
  int8 probe's kernel (``csrc/probe_rep.cuh``: the weights in registers by
  ``wgmma``, (tile, repetition) units over one block an SM, partials added in
  a fixed order; :func:`work_plan`), a block taking ``max(own, reserve)``
  bytes of shared memory, ``own`` being the kernel's, static and dynamic
  (:attr:`work.own_bytes`); its plain version :func:`work_plain` is the same
  sum in f32 torch.  ``chip_smoke.py`` times it under each reservation at 32
  repetitions and by the slope between 8 and REPS_SLOPE_HI, and reports the
  blocks per SM and the kernel's own bytes (a reservation at or below them
  is a no-op).

Each wrapper sends a CPU tensor to its plain version and counts its kernel
launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch

from . import kernels
from .probe_rep import SLOT, RepPlan, rep_plan

M, C, TAPS = 2400, 128, 3  # the TPU probe's workload (tools/probe_vmem_cap.py:113)
REPS = (8, 32)             # the TPU probe's k_lo, k_hi
REPS_SLOPE_HI = 512        # the slope's high count (REPS' 24 repetitions, 5 us, are within the spread)
SWEEP_KB = (48, 64, 96, 128, 160, 192)


def sweep_bytes(optin: int) -> List[int]:
    """The sizes to try: the fixed sweep below the cap, the cap itself and
    1 KB above it (which must be refused)."""
    return [kb * 1024 for kb in SWEEP_KB if kb * 1024 < optin] + [optin, optin + 1024]


def _call(mode: int, n_bytes: int, blocks: int, reps: int, x, w, out,
          partials=None) -> Dict[str, int]:
    info = (ctypes.c_int * 4)()
    err = kernels._lib("probe_smem.cu").rst_probe_smem(
        mode, n_bytes, blocks, reps, 0 if x is None else x.shape[0], kernels._ptr(x),
        kernels._ptr(w), kernels._ptr(out), kernels._ptr(partials), ctypes.addressof(info),
        kernels._stream(out))
    return {"error": int(err), "optin": info[0], "blocks_per_sm": info[1], "sms": info[2],
            "own": info[3]}


def fill_plain(n_bytes: int, blocks: int) -> np.ndarray:
    """Per block b, the XOR of the words ``i * 2654435761 + b`` (mod 2^32),
    i < n_bytes / 4: what :func:`try_alloc`'s blocks read back."""
    i = np.arange(n_bytes // 4, dtype=np.uint64) * np.uint64(2654435761)
    return np.array([np.bitwise_xor.reduce(((i + np.uint64(b)) & np.uint64(0xFFFFFFFF))
                                           .astype(np.uint32)) for b in range(blocks)],
                    dtype=np.uint32)


def try_alloc(n_bytes: int, device) -> Dict[str, object]:
    """Fill and read back ``n_bytes`` of dynamic shared memory in one block an
    SM -> ``{"bytes", "alloc_ok", "blocks_per_sm", "optin", "error"}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the shared-memory probe runs on CUDA, not {dev}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(sms, dtype=torch.int32, device=dev)
    res = _call(0, n_bytes, sms, 0, None, None, out)
    ok = res["error"] == 0
    if ok:
        try_alloc.launches += 1
        got = out.cpu().numpy().view(np.uint32)
        ok = bool(np.array_equal(got, fill_plain(n_bytes, sms)))
    return {"bytes": n_bytes, "alloc_ok": ok, "blocks_per_sm": res["blocks_per_sm"],
            "optin": res["optin"], "error": res["error"]}


try_alloc.launches = 0


def work_plain(x: torch.Tensor, w: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps * sum_t x @ w[t]`` in f32: (M, 128) bf16 by (3, 128, 128) bf16
    (tap, k, n) -> (M, 128) f32."""
    xf, wf = x.float(), w.float()
    return reps * sum(xf @ wf[t] for t in range(w.shape[0]))


def work_plan(reps: int, rows: int = M, sms: int = kernels.SMS) -> RepPlan:
    """The work launch's plan: (tile, repetition) units over one block an SM
    (``ops.probe_rep.rep_plan``'s ``work`` arm)."""
    return rep_plan("work", reps, width=rows, sms=sms)


def work(x: torch.Tensor, w: torch.Tensor, reps: int, reserve: int = 0) -> torch.Tensor:
    """The fixed workload, ``reps`` times, a block taking ``max(own,
    reserve)`` bytes of shared memory; a CPU tensor runs :func:`work_plain`."""
    if x.device.type == "cpu":
        return work_plain(x, w, reps)
    if x.device.type != "cuda":
        raise ValueError(f"the shared-memory probe runs on CUDA or the CPU, not {x.device}")
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or x.shape[1:] != (C,) \
            or tuple(w.shape) != (TAPS, C, C) or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"work: want contiguous bf16 x (m, {C}) and w ({TAPS}, {C}, {C}), "
                         f"got {x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    plan = work_plan(reps, m, kernels._sm_count(x.device))
    out = torch.empty((m, C), dtype=torch.float32, device=x.device)
    partials = torch.empty(plan.slots * SLOT, dtype=torch.float32, device=x.device)
    res = _call(1, reserve, plan.blocks, reps, x, w, out, partials)
    if res["error"]:
        raise RuntimeError(f"probe_smem work: CUDA error {res['error']} at launch "
                           f"({reserve} bytes reserved)")
    work.launches += 1
    work.blocks_per_sm = res["blocks_per_sm"]
    work.own_bytes = res["own"]
    return out


work.launches = 0
work.blocks_per_sm = 0
work.own_bytes = 0


def make_work_inputs(device, seed: int = 0):
    """The TPU probe's operands: x (2400, 128) and w (3, 128, 128) standard
    normal, bf16 (the TPU probe broadcasts ones for x; a seeded x makes the
    check see every row)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, C), dtype=np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((TAPS, C, C), dtype=np.float32)).to(torch.bfloat16)
    return x.to(device), w.to(device)
