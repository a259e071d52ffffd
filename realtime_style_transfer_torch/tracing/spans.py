"""Spans of the served frame, on the clock of the device trace.

The recorder is off by default.  Each site on the frame path tests the
module global :data:`on` and, while it is false, does nothing more: no
allocation, closure or context manager.  Inside ``with recording() as
record:`` the sites fill ``record``, a plain list that holds one
:class:`Span` a span once the block has closed::

    if spans.on:
        spans.begin("stage.res0a")
    ...
    if spans.on:
        spans.end()

:func:`begin_frame` opens the top-level span of one ``stylize_prepacked``
or ``stylize_prepacked_chunk`` call and gives it, and every span opened
inside it, a new frame id.  Spans are stamped with :func:`now`, the wall
clock in ns (``time.time_ns``), which is the clock of ``torch.profiler``'s
events: its CUPTI timestamps are converted to Unix ns.  So a span can be laid
over the runtime calls and kernels of a trace taken at the same time.

Records are kept in memory only, for the caller to read; nothing is exported.
The frame loop runs on one thread, and so does the recorder.  The launch
counters are not part of it: they stay attributes of the kernel wrappers
(``kernels.conv_stage.launches`` and the others).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, NamedTuple

now = time.time_ns  # the device trace's clock


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int     # 0 for a span that its call, by raising, left open
    parent: int     # index in the record of the enclosing span, -1 at the top
    frame: int      # id of the stylize_prepacked or _chunk call, -1 outside one


on = False          # the one test at each site
_record: list = []  # [name, start, end, parent, frame] a span, while recording
_open: List[int] = []  # indices of the open spans, innermost last
_frame = -1


def begin(name: str) -> None:
    """Open a span inside the innermost open one."""
    parent = _open[-1] if _open else -1
    _open.append(len(_record))
    _record.append([name, now(), 0, parent, _frame])


def begin_frame(name: str) -> None:
    """Open the top-level span of a new frame id.  Spans that a call which
    raised left open are dropped from the stack here (their end stays 0)."""
    global _frame
    _frame += 1
    _open.clear()
    begin(name)


def end() -> None:
    """Close the innermost open span."""
    _record[_open.pop()][2] = now()


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Turn the recorder on for the block; yields the record, which holds
    the block's spans in the order they opened once the block has closed."""
    global on, _record, _frame
    if on:
        raise RuntimeError("spans are already being recorded")
    record: list = []
    _record, _frame = record, -1
    _open.clear()
    on = True
    try:
        yield record
    finally:
        on = False
        _record = []
        _open.clear()
        record[:] = [Span(*s) for s in record]
