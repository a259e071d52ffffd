"""RMSprop with the arithmetic of the installed optax, for the training step.

``optax.rmsprop(1e-3, decay=0.9, eps=1e-7)`` (the JAX training model's
optimizer) in optax 0.2.6 keeps ``nu`` from 0 and, with its default
``eps_in_sqrt=True``, updates

    nu = (1 - decay) * g**2 + decay * nu
    p  = p + (rsqrt(nu + eps) * g) * (-learning_rate)

``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead, so it is not
used.  Like optax, :class:`RMSProp` is functional: ``init(params)`` and
``update(grads, state) -> (updates, state)`` on dicts of tensors, and
:func:`apply_updates` adds the updates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class RMSPropState:
    nu: Tensors   # the moving mean of g**2, one tensor a parameter


class RMSProp:
    def __init__(self, learning_rate: float = 1e-3, decay: float = 0.9, eps: float = 1e-7):
        self.learning_rate = learning_rate
        self.decay = decay
        self.eps = eps

    def init(self, params: Tensors) -> RMSPropState:
        return RMSPropState({k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Tensors, state: RMSPropState) -> Tuple[Tensors, RMSPropState]:
        d = self.decay
        nu = {k: (1 - d) * (g * g) + d * state.nu[k] for k, g in grads.items()}
        updates = {k: (torch.rsqrt(nu[k] + self.eps) * g) * (-self.learning_rate)
                   for k, g in grads.items()}
        return updates, RMSPropState(nu)


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``p + u`` in each parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
