"""Numeric parity tooling: summary stats + comparison tables.

The port's copy of ``realtime_style_transfer_tpu/utils/stats.py``: quick
mean/var/min/max summaries and side-by-side tables for buffer comparisons.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


def describe(array) -> Dict[str, float]:
    a = np.asarray(array, dtype=np.float64)
    return {
        "mean": float(a.mean()),
        "var": float(a.var()),
        "min": float(a.min()),
        "max": float(a.max()),
        "count": int(a.size),
    }


def comparison_table(named_arrays: Mapping[str, Sequence], *,
                     floatfmt: str = "12.6f") -> str:
    """Render stats for several arrays (and their pairwise diff if exactly two)."""
    named = {name: np.asarray(a, np.float64) for name, a in named_arrays.items()}
    if len(named) == 2:
        (n1, a1), (n2, a2) = named.items()
        if a1.shape == a2.shape:
            named[f"{n1} - {n2}"] = a1 - a2
            named[f"|{n1} - {n2}|"] = np.abs(a1 - a2)
    cols = ["mean", "var", "min", "max", "count"]
    width = max(len(n) for n in named) + 2
    lines = [" " * width + "".join(f"{c:>14}" for c in cols)]
    for name, arr in named.items():
        s = describe(arr)
        cells = "".join(
            f"{s[c]:>14{'' if c == 'count' else '.6f'}}" if c != "count"
            else f"{s[c]:>14d}"
            for c in cols
        )
        lines.append(f"{name:<{width}}" + cells)
    return "\n".join(lines)
