"""Model summary capture: parameter tables as text.

Port of ``realtime_style_transfer_tpu/tracing/textsummary.py``.  The port's
parameters are a ``state_dict``-named mapping of tensors; they are rendered
under their flax paths and layouts (:func:`..weights.flax_key`), in the
order ``jax.tree_util`` flattens a flax tree (sorted keys), so both packages
print the same table for the same model.
"""

from __future__ import annotations

from typing import Iterator, List, Mapping, Tuple

import torch

from ..weights import flax_key


def flax_leaves(params: Mapping[str, torch.Tensor]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(``/``-joined flax path, tensor) of a port parameter mapping, each
    tensor on its device (a conv kernel as an HWIO view), in
    ``jax.tree_util`` order (keys sorted at each level)."""
    named = []
    for key, value in params.items():
        collection, path, oihw = flax_key(key, value.ndim)
        if collection != "params":
            raise ValueError(f"{key} is not a parameter")
        named.append((path, value.permute(2, 3, 1, 0) if oihw else value))
    for path, value in sorted(named, key=lambda item: item[0]):
        yield "/".join(path), value


def capture_model_summary(params: Mapping[str, torch.Tensor], detailed: bool = False) -> str:
    rows: List[str] = []
    total = 0
    for name, leaf in flax_leaves(params):
        count = leaf.numel()
        total += count
        if detailed:
            rows.append(f"{name:<80} {str(tuple(leaf.shape)):<20} {count:>12,}")
        else:
            rows.append(f"{name:<80} {count:>12,}")
    rows.append("-" * 94)
    rows.append(f"{'total parameters':<80} {total:>12,}")
    return "\n".join(rows)


def count_parameters(params: Mapping[str, torch.Tensor]) -> int:
    return sum(leaf.numel() for _, leaf in flax_leaves(params))
