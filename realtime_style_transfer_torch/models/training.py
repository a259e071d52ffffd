"""Training model: the train and eval steps over the inference graph and a
frozen loss tower.

Port of ``realtime_style_transfer_tpu/models/training.py``.  The training
model is the single-style inference model plus a frozen loss tower (and,
with the depth loss, a frozen MidasLite); the per-component loss dict is
also the metrics dict.  As in the JAX package the steps are functions of a
:class:`TrainState`: ``train_step(state, batch) -> (state, metrics)`` and
``eval_step(state, batch) -> metrics``.  The model's parameters and batch
norm statistics live in the state and reach the module through
``torch.func.functional_call``; the loss and depth parameters are frozen
(``requires_grad_(False)``) and live outside the optimizer state.

* ``remat=True`` wraps the forward in ``torch.utils.checkpoint`` (non
  re-entrant).  The recompute reruns the forward, so the CIN kernel runs
  twice a step; the batch norms' new statistics are taken from the first
  pass, as ``jax.checkpoint`` leaves them.
* ``use_pallas=True`` sends each CIN of 64 channels or more to the CUDA
  kernel (:mod:`..ops.cin`); ``plain=True`` on a step runs the kernel's plain
  version in its place (the oracle on the card).
* Entry points run on CUDA unless ``device="cpu"``.
* ``rows`` on a step runs the transfer net on this rank's rows of each frame
  (``parallel.spatial``); the loss towers then see the gathered frame.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import ShapeConfig
from ..optim import RMSProp, RMSPropState, apply_updates
from .depth import make_depth_loss_fn, make_midas
from .inference import StyleTransferInference, make_inference_model
from .layers import BatchNorm
from .losses import loss_extractor as make_loss_extractor
from .losses import make_style_loss_function

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Trainable parameters, batch norm running statistics and the optimizer
    state, keyed by the inference model's ``state_dict`` names."""

    step: torch.Tensor       # int32 scalar
    params: Tensors
    batch_stats: Tensors
    opt_state: RMSPropState


class StyleTransferTrainingModel:
    """The inference module, a frozen loss tower and the optimizer.

    ``loss_extractor`` is one of ``{"vgg", "mobilenet", "efficientnet",
    "efficientnet_v2s", "dummy"}``, built frozen.  A config whose
    ``feature_extractor`` is ``"efficientnet"`` (or ``"mobilenet"``) trains
    its predictor's batch norms on batch statistics.  Weights are drawn
    from ``seed``: the model from ``seed``, the loss tower from ``seed + 1``,
    a MidasLite without ``depth_variables`` from ``seed + 2``.
    """

    def __init__(
        self,
        config: ShapeConfig,
        *,
        loss_extractor: str = "vgg",
        with_depth_loss: Optional[bool] = None,
        depth_variables: Optional[Any] = None,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        remat: bool = False,
        tower_mode: str = "split",
        optimizer: Optional[RMSProp] = None,
        device=None,
        seed: int = 0,
    ):
        self.config = config
        # training always builds the single-style inference graph
        self.train_config = (config if config.num_styles == 1
                             else dataclasses.replace(config, num_styles=1))
        self.device = resolve_device(device)
        self.model: StyleTransferInference = make_inference_model(
            self.train_config, dtype=dtype, use_pallas=use_pallas, device=self.device,
            seed=seed)
        self.remat = remat
        self.with_depth_loss = (config.with_depth_loss if with_depth_loss is None
                                else with_depth_loss)
        # Keras RMSprop defaults: lr 1e-3, rho 0.9
        self.optimizer = optimizer or RMSProp(learning_rate=1e-3, decay=0.9, eps=1e-7)
        self._batch_norms = [(name, m) for name, m in self.model.named_modules()
                             if isinstance(m, BatchNorm)]

        self.loss_module = self._frozen(make_loss_extractor(
            loss_extractor, dtype=dtype, generator=torch.Generator().manual_seed(seed + 1)))
        depth_loss_fn = None
        self.depth_module = None
        if self.with_depth_loss:
            if depth_variables is None:
                logging.getLogger(__name__).warning(
                    "depth loss enabled WITHOUT pretrained weights: the depth term is a "
                    "random signal (pass depth_variables, for example "
                    "depth.load_depth_checkpoint(depth.BUNDLED_DEPTH_CHECKPOINT))")
            self.depth_module = self._frozen(make_midas(
                depth_variables, dtype=dtype, generator=torch.Generator().manual_seed(seed + 2)))
            depth_loss_fn = make_depth_loss_fn(self.depth_module)
        self.compute_loss = make_style_loss_function(
            self.loss_module, self.loss_module.factors, depth_loss_fn, tower_mode=tower_mode)

    def _frozen(self, module: torch.nn.Module) -> torch.nn.Module:
        return module.to(self.device).eval().requires_grad_(False)

    # ---- state ------------------------------------------------------------

    def init_state(self) -> TrainState:
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        batch_stats = {k: v.detach().clone() for k, v in self.model.named_buffers()}
        return TrainState(torch.zeros((), dtype=torch.int32), params, batch_stats,
                          self.optimizer.init(params))

    # ---- steps ------------------------------------------------------------

    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _batch(self, batch):
        inputs, ground_truth = batch
        return ({k: self._tensor(v) for k, v in inputs.items()},
                {k: self._tensor(v) for k, v in ground_truth.items()})

    def _forward(self, params: Tensors, batch_stats: Tensors, inputs: Tensors, *,
                 train: bool, plain: bool, rows=None) -> Tuple[torch.Tensor, Tensors]:
        """The prediction, and the batch norm statistics after the forward."""

        def forward(variables, content, style, style_weights):
            return functional_call(self.model, variables, (content, style, style_weights),
                                   {"train": train, "plain": plain, "rows": rows})

        args = ({**params, **batch_stats}, inputs["content"], inputs["style"],
                inputs.get("style_weights"))
        if not train:
            return forward(*args), batch_stats
        for _, m in self._batch_norms:
            m.batch_update = None
        if self.remat:
            prediction = checkpoint(forward, *args, use_reentrant=False)
        else:
            prediction = forward(*args)
        new_stats = dict(batch_stats)
        for name, m in self._batch_norms:
            new_stats[f"{name}.running_mean"], new_stats[f"{name}.running_var"] = m.batch_update
        return prediction, new_stats

    def loss_and_metrics(self, params: Tensors, batch_stats: Tensors, batch, *, train: bool,
                         plain: bool = False, rows=None):
        """(mean loss, (per-sample loss components, batch norm statistics))."""
        inputs, ground_truth = self._batch(batch)
        prediction, new_stats = self._forward(params, batch_stats, inputs, train=train,
                                              plain=plain, rows=rows)
        losses = self.compute_loss(prediction, ground_truth)
        return torch.mean(losses["loss"]), (losses, new_stats)

    def value_and_grad(self, state: TrainState, batch, *, plain: bool = False, rows=None):
        """(mean loss, loss components, new batch statistics, gradients) of
        the training forward at ``state.params``."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        total, (losses, new_stats) = self.loss_and_metrics(
            params, state.batch_stats, batch, train=True, plain=plain, rows=rows)
        names = list(params)
        grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True,
                                    materialize_grads=True)
        return total.detach(), losses, new_stats, dict(zip(names, grads))

    def train_step(self, state: TrainState, batch, *, plain: bool = False
                   ) -> Tuple[TrainState, Tensors]:
        _, losses, new_stats, grads = self.value_and_grad(state, batch, plain=plain)
        updates, opt_state = self.optimizer.update(grads, state.opt_state)
        params = apply_updates({k: v.detach() for k, v in state.params.items()}, updates)
        metrics = {name: torch.mean(v.detach()) for name, v in losses.items()}
        return TrainState(state.step + 1, params, new_stats, opt_state), metrics

    def eval_step(self, state: TrainState, batch, *, plain: bool = False,
                  rows=None) -> Tensors:
        with torch.no_grad():
            _, (losses, _) = self.loss_and_metrics(state.params, state.batch_stats, batch,
                                                   train=False, plain=plain, rows=rows)
        return {name: torch.mean(v) for name, v in losses.items()}

    # ---- inference passthrough ------------------------------------------------

    def predict(self, state: TrainState, inputs) -> torch.Tensor:
        with torch.no_grad():
            inputs = {k: self._tensor(v) for k, v in inputs.items()}
            return self._forward(state.params, state.batch_stats, inputs, train=False,
                                 plain=False)[0]


def make_style_transfer_training_model(config: ShapeConfig,
                                       **kwargs) -> StyleTransferTrainingModel:
    return StyleTransferTrainingModel(config, **kwargs)
