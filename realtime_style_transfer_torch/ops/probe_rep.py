"""The plan of ``csrc/probe_rep.cuh``, the kernel of both matmul probes.

``ops/probe_int8.py`` (its mm and band arms) and ``ops/probe_smem.py`` (its
work arm) launch one cooperative kernel of one block an SM, which deals
(tile, repetition) units over the blocks and adds their partial sums in a
fixed order; :func:`rep_plan` gives the grid and the partials' scratch of a
launch.
"""

from __future__ import annotations

from typing import NamedTuple

from . import kernels

C = 128              # K and N of every product
M, BAND_H, BAND_W = 2400, 10, 240  # the probes' shapes (tools/probe_int8_mxu.py)
TILE = 128           # pixels a tile: the kernel's wgmma N (REP_TILE)
WIN, PITCH = TILE + 2, 136  # a band window row's pixels, and a plane's (REP_WIN, REP_PITCH)
SLOT = 16 * 256 * 4  # sums a partial: 128 pixels x 128 columns (REP_SLOT)


class RepPlan(NamedTuple):
    """How the kernel deals an arm's units over the card.

    A unit is a (group, repetition) pair; a group is a tile of TILE pixels
    (mm, work: over the rows of x) or, for the band, an (output row, tile)
    pair of one part.  The blocks are cut into ``parts`` (the band's three
    tap rows dy, each holding taps 3 dy .. 3 dy + 2) of ``bpp`` blocks; a
    part's ``groups * nrep`` units are dealt to its blocks in contiguous
    runs.  A block writes one partial a group it touches, at slot ``block +
    part * groups + group`` (global block index), and the outputs add, for
    each tile, every part's partials, parts in order, blocks in order."""

    arm: str        # "mm", "band" or "work"
    quant: bool
    nrep: int
    width: int      # pixels a row: mm and work the rows of x
    rows_out: int   # the band's output rows, else 1
    tiles_x: int    # tiles a row
    groups: int     # groups a part
    parts: int
    bpp: int        # blocks a part
    taps: int       # taps a block holds in registers

    @property
    def blocks(self) -> int:
        return self.parts * self.bpp

    @property
    def units(self) -> int:
        """Units a part."""
        return self.groups * self.nrep

    @property
    def slots(self) -> int:
        """Partials the scratch holds, SLOT sums each."""
        return self.parts * (self.bpp + self.groups)


def rep_plan(arm: str, nrep: int, quant: bool = False, width: int = 0, rows_out: int = 0,
             sms: int = kernels.SMS) -> RepPlan:
    """The plan of one launch on ``sms`` SMs: one block an SM (``sms //
    parts`` a part), fewer where the units are fewer.  ``width`` and
    ``rows_out`` default to the probes' shapes."""
    if arm not in ("mm", "band", "work") or nrep < 1 or (arm == "work" and quant):
        raise ValueError(f"rep_plan: no {arm!r} arm with nrep={nrep}, quant={quant}")
    band = arm == "band"
    width = width or (BAND_W if band else M)
    rows_out = (rows_out or BAND_H) if band else 1
    tiles_x = -(-width // TILE)
    groups = rows_out * tiles_x if band else tiles_x
    parts = 3 if band else 1
    bpp = min(sms // parts, groups * nrep)
    return RepPlan(arm, quant, nrep, width, rows_out, tiles_x, groups, parts, bpp,
                   1 if arm == "mm" else 3)
