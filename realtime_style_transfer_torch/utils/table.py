"""Tables of records without pandas: sort, text, CSV and LaTeX.

The analysis CLIs (:mod:`..compute_permutation_feature_importance`,
:mod:`..compute_gradient_explanation`) write their results as the JAX
scripts do with a pandas ``DataFrame``: ``sort_values(column, ascending=
False)``, then ``to_string``, ``to_csv`` and ``to_latex``, each with
``index=False``.  The chip machine has no pandas, so these functions write
the same text from a list of dicts (one a row, the same keys in each):

* :func:`sort_rows`: descending by one column, ties in their first order,
  NaN last (pandas' sort of a handful of rows).
* :func:`to_csv`: pandas' CSV: ``repr`` of each float (``""`` for NaN),
  ``str`` of the rest, minimal quoting, ``"\\n"`` line ends.
* :func:`to_string`: pandas' text layout: right-justified columns one space
  apart, a number column's header after one space; a float column in
  ``%.6f`` with its common trailing zeros trimmed, or in ``%.6e`` when a
  value lies below 1e-6 in magnitude (not zero), or above 1e6 while the
  widest fixed cell is longer than 12.
* :func:`to_latex`: pandas' ``booktabs`` tabular: ``l`` for a text column,
  ``r`` for a number column, floats in ``%.6f``.
"""

from __future__ import annotations

import csv
import io
import math
import re
from typing import Dict, List, Sequence

Row = Dict[str, object]

_FIXED = re.compile(r"^\s*[+-]?[0-9]+\.[0-9]*$")


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def sort_rows(rows: Sequence[Row], column: str) -> List[Row]:
    """``rows`` sorted by ``column``, largest first; equal values keep their
    order and NaN goes last."""
    nan = [r for r in rows if _is_nan(r[column])]
    rest = [r for r in rows if not _is_nan(r[column])]
    return sorted(rest, key=lambda r: r[column], reverse=True) + nan


def _columns(rows: Sequence[Row]) -> List[str]:
    return list(rows[0]) if rows else []


def to_csv(rows: Sequence[Row]) -> str:
    out = io.StringIO()
    writer = csv.writer(out, lineterminator="\n")
    columns = _columns(rows)
    writer.writerow(columns)
    for r in rows:
        writer.writerow(["" if _is_nan(r[c]) else repr(r[c]) if isinstance(r[c], float)
                         else str(r[c]) for c in columns])
    return out.getvalue()


def _float_cells(values: Sequence[float]) -> List[str]:
    def fixed(v):
        return "NaN" if _is_nan(v) else f"{v:.6f}"

    cells = [fixed(v) for v in values]
    while True:
        numbers = [c for c in cells if _FIXED.match(c)]
        if not numbers or not all(c.endswith("0") for c in numbers):
            break
        cells = [c[:-1] if _FIXED.match(c) else c for c in cells]
    cells = [c + "0" if _FIXED.match(c) and c.endswith(".") else c for c in cells]
    finite = [abs(v) for v in values if not _is_nan(v)]
    too_long = max(len(c) for c in cells) > 12
    if any(0 < a < 1e-6 for a in finite) or (too_long and any(a > 1e6 for a in finite)):
        cells = ["NaN" if _is_nan(v) else f"{v:.6e}" for v in values]
    return cells


def to_string(rows: Sequence[Row]) -> str:
    columns = _columns(rows)
    cols = []
    for c in columns:
        values = [r[c] for r in rows]
        header = c
        if values and all(isinstance(v, float) for v in values):
            cells, header = _float_cells(values), " " + c
        else:
            cells = [str(v) for v in values]
            if values and all(isinstance(v, int) for v in values):
                header = " " + c
        width = max([len(header)] + [len(s) for s in cells])
        cols.append([header.rjust(width)] + [s.rjust(width) for s in cells])
    return "\n".join(" ".join(line) for line in zip(*cols))


def to_latex(rows: Sequence[Row]) -> str:
    columns = _columns(rows)

    def cell(v) -> str:
        if isinstance(v, float):
            return "NaN" if _is_nan(v) else f"{v:.6f}"
        return str(v)

    spec = "".join("l" if any(isinstance(r[c], str) for r in rows) else "r" for c in columns)
    lines = [f"\\begin{{tabular}}{{{spec}}}", "\\toprule", " & ".join(columns) + " \\\\",
             "\\midrule"]
    lines += [" & ".join(cell(r[c]) for c in columns) + " \\\\" for r in rows]
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)
