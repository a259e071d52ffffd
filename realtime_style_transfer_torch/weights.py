"""Weight bridge between flax variable trees and the port's ``state_dict``.

A flax tree ``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays,
or a flat mapping such as an ``.npz`` keyed by ``/``-joined flax paths) maps
to ``state_dict`` keys made of the same module path joined by ``.``:

=====================  ===========================  ==========================
flax leaf              port leaf                    layout
=====================  ===========================  ==========================
``params/.../kernel``  ``....weight``               HWIO -> OIHW (a depthwise
                                                    ``(kh, kw, 1, C)`` becomes
                                                    ``(C, 1, kh, kw)``); the
                                                    transpose convs
                                                    ``expand_<i>_conv`` stay HWIO
``params/.../bias``    ``....bias``
``params/.../scale``   ``....weight`` (batch norm)
``batch_stats/.../mean``  ``....running_mean``
``batch_stats/.../var``   ``....running_var``
=====================  ===========================  ==========================

Both directions raise on a leaf they do not consume; with ``expected``,
:func:`from_flax` also raises on a port parameter it does not fill.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

_TRANSPOSE = re.compile(r"(^|\.)expand_\d+_conv$")
_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(variables) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """Yield (flax path, array) for a nested tree or a ``/``-keyed mapping."""
    keys = list(variables.files if hasattr(variables, "files") else variables.keys())
    for key in keys:
        value = variables[key]
        if isinstance(value, Mapping):
            for path, leaf in _flatten(value):
                yield (key,) + path, leaf
        else:
            yield tuple(str(key).split("/")), np.asarray(value)


def _is_transpose(module_path: str) -> bool:
    return _TRANSPOSE.search(module_path) is not None


def from_flax(variables, expected: Optional[Union[nn.Module, Mapping]] = None
              ) -> "OrderedDict[str, torch.Tensor]":
    """flax variables -> the port's ``state_dict`` (f32 CPU tensors)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, value in _flatten(variables):
        collection, *modules, leaf = path
        module = ".".join(modules)
        if collection == "params" and leaf in _PARAM_LEAVES:
            name = _PARAM_LEAVES[leaf]
            t = torch.from_numpy(np.array(value, np.float32))
            if leaf == "kernel" and not _is_transpose(module):
                t = t.permute(3, 2, 0, 1).contiguous()
        elif collection == "batch_stats" and leaf in _STAT_LEAVES:
            name = _STAT_LEAVES[leaf]
            t = torch.from_numpy(np.array(value, np.float32))
        else:
            raise ValueError(f"flax leaf {'/'.join(path)} has no port counterpart")
        key = f"{module}.{name}"
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = t
    if expected is not None:
        _check_keys(out, expected)
    return out


def _check_keys(got: Mapping[str, torch.Tensor], expected) -> None:
    want = expected.state_dict() if isinstance(expected, nn.Module) else expected
    extra = sorted(set(got) - set(want))
    missing = sorted(set(want) - set(got))
    if extra or missing:
        raise ValueError(f"weight bridge mismatch: unconsumed flax leaves {extra}, "
                         f"unfilled port parameters {missing}")
    for key, value in want.items():
        if tuple(got[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: flax shape {tuple(got[key].shape)} != port "
                             f"shape {tuple(value.shape)}")


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The port's ``state_dict`` -> nested flax variables of numpy arrays."""
    tree: Dict[str, dict] = {}
    for key, value in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        a = value.detach().cpu().float()
        if leaf == "weight" and a.ndim == 4:
            collection, name = "params", "kernel"
            if not _is_transpose(module):
                a = a.permute(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 1:
            collection, name = "params", "scale"
        elif leaf == "bias":
            collection, name = "params", "bias"
        elif leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        else:
            raise ValueError(f"port leaf {key} has no flax counterpart")
        node = tree.setdefault(collection, {})
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a.numpy())
    return tree


def load_flax(module: nn.Module, variables) -> nn.Module:
    """Fill ``module`` from flax ``variables``; every leaf must match."""
    module.load_state_dict(from_flax(variables, expected=module), strict=True)
    return module
