"""RMSprop and Adam with the arithmetic of the installed optax.

``optax.rmsprop(1e-3, decay=0.9, eps=1e-7)`` (the JAX training model's
optimizer) in optax 0.2.6 keeps ``nu`` from 0 and, with its default
``eps_in_sqrt=True``, updates

    nu = (1 - decay) * g**2 + decay * nu
    p  = p + (rsqrt(nu + eps) * g) * (-learning_rate)

``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps`` instead, so it is not
used.  ``optax.adam(lr)`` (the depth pretraining's optimizer, b1 0.9, b2
0.999, eps 1e-8, eps_root 0) keeps ``mu`` and ``nu`` from 0 and an int32
count, and updates

    mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu;  count += 1
    p  = p + (-learning_rate) * ((mu / (1 - b1**count))
                                 / (sqrt(nu / (1 - b2**count)) + eps))

with the bias corrections ``1 - b**count`` in f32.  Like optax, both are
functional: ``init(params)`` and ``update(grads, state) -> (updates,
state)`` on dicts of tensors, and :func:`apply_updates` adds the updates.
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


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor   # int32 scalar, on the parameters' device
    mu: Tensors
    nu: Tensors


class Adam:
    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps

    def init(self, params: Tensors) -> AdamState:
        device = next(iter(params.values())).device if params else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Tensors, state: AdamState) -> Tuple[Tensors, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32, device=count.device) ** count.to(f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32, device=count.device) ** count.to(f32)
        updates = {k: (-self.learning_rate)
                   * ((mu[k] / bc1.to(mu[k].dtype))
                      / (torch.sqrt(nu[k] / bc2.to(nu[k].dtype)) + self.eps))
                   for k in grads}
        return updates, AdamState(count, mu, nu)


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``p + u`` in each parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
