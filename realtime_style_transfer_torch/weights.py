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
``batch_stats/.../variance``  ``....running_variance``  (EfficientNet B3's
                                                    ``Normalization``)
=====================  ===========================  ==========================

Both directions raise on a leaf they do not consume; with ``expected``,
:func:`from_flax` also raises on a port parameter it does not fill.

A JAX ``TrainState`` (``step``, ``params``, ``batch_stats`` and optax's
RMSprop ``opt_state``) becomes the port's :class:`..models.training.TrainState`
through :func:`state_from_flax` (its ``nu`` tree takes the parameters'
layouts), and :func:`state_to_flax` gives the way back, so a step in each
package can be compared leaf by leaf.  The frozen loss and depth towers load
through :func:`load_flax`.
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
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var", "variance": "running_variance"}


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
        key = f"{module}.{name}" if module else name
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


def flax_key(key: str, ndim: int) -> Tuple[str, Tuple[str, ...], bool]:
    """(collection, path in it, whether the layout is OIHW) of the port leaf
    ``key`` of ``ndim`` dimensions: the flax name :func:`to_flax` gives it."""
    module, _, leaf = key.rpartition(".")
    oihw = False
    if leaf == "weight" and ndim == 4:
        collection, name = "params", "kernel"
        oihw = not _is_transpose(module)
    elif leaf == "weight" and ndim == 1:
        collection, name = "params", "scale"
    elif leaf == "bias":
        collection, name = "params", "bias"
    elif leaf in _STAT_LEAVES.values():
        collection, name = "batch_stats", leaf[len("running_"):]
    else:
        raise ValueError(f"port leaf {key} has no flax counterpart")
    path = (*module.split("."), name) if module else (name,)
    return collection, path, oihw


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The port's ``state_dict`` -> nested flax variables of numpy arrays."""
    tree: Dict[str, dict] = {}
    for key, value in state_dict.items():
        a = value.detach().cpu().float()
        collection, path, oihw = flax_key(key, a.ndim)
        if oihw:
            a = a.permute(2, 3, 1, 0)
        node = tree.setdefault(collection, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a.numpy())
    return tree


def load_flax(module: nn.Module, variables) -> nn.Module:
    """Fill ``module`` from flax ``variables``; every leaf must match."""
    module.load_state_dict(from_flax(variables, expected=module), strict=True)
    return module


def state_from_flax(jax_state, training_model):
    """A JAX ``TrainState`` (its arrays as numpy, or anything ``np.asarray``
    takes) -> the port's ``TrainState`` on ``training_model``'s device."""
    from .models.training import TrainState
    from .optim import RMSPropState

    model = training_model.model
    dev = training_model.device
    sd = from_flax({"params": jax_state.params, "batch_stats": jax_state.batch_stats},
                   expected=model)
    params = {k: sd[k].to(dev) for k, _ in model.named_parameters()}
    batch_stats = {k: sd[k].to(dev) for k, _ in model.named_buffers()}
    nu = from_flax({"params": jax_state.opt_state[0].nu})
    if set(nu) != set(params):
        raise ValueError("the optimizer's nu tree does not match the parameters")
    return TrainState(torch.tensor(int(np.asarray(jax_state.step)), dtype=torch.int32),
                      params, batch_stats, RMSPropState({k: nu[k].to(dev) for k in params}))


def state_to_flax(state) -> Dict[str, object]:
    """The port's ``TrainState`` -> ``{"step", "params", "batch_stats",
    "nu"}`` as nested flax trees of numpy arrays (``params`` without the
    ``"params"`` level, as a JAX ``TrainState`` holds them)."""
    tree = to_flax({**state.params, **state.batch_stats})
    return {"step": int(state.step), "params": tree["params"],
            "batch_stats": tree.get("batch_stats", {}),
            "nu": to_flax(state.opt_state.nu)["params"]}
