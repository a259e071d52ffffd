"""Data-parallel train and eval steps over the data mesh.

Port of ``realtime_style_transfer_tpu/parallel/train.py``.  The JAX step is
one jitted function over replicated parameters and a batch sharded over the
``data`` axis; GSPMD inserts the gradient all-reduce, and a train-mode batch
norm normalizes with the global batch's moments.  Here each rank runs the
training model's step on its slice, and the step makes the collectives JAX
gets implicitly:

* every train-mode :class:`..models.layers.BatchNorm` forms its mean and
  variance from per-channel sums of x and x^2 all-reduced over the group
  (:func:`..models.layers.batch_moments_reduced`, differentiable), so its
  output and the running statistics it commits are the global batch's;
* the gradients, of a loss that is the mean over the rank's slice, are
  all-reduced with SUM and divided by the group's size: the gradient of the
  mean over the global batch;
* the metrics are all-reduced the same way before any ``.item()``.

The CINs are per instance and need nothing.  The initial state and the
frozen loss and depth towers are rank 0's, by a broadcast; the optimizer
then updates the same parameters with the same gradients on every rank, so
the state stays replicated.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from ..models.layers import batch_moments_reduced
from ..models.training import StyleTransferTrainingModel, TrainState
from ..optim import apply_updates
from .mesh import DATA_AXIS, Mesh, replicate, shard_batch


class DistributedTrainer:
    """Wraps a ``StyleTransferTrainingModel`` with data-parallel steps."""

    def __init__(self, training_model: StyleTransferTrainingModel, mesh: Mesh):
        dev = training_model.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != mesh.device:
            raise ValueError(f"the training model is on {training_model.device}, this "
                             f"rank's device is {mesh.device}")
        self.tm = training_model
        self.mesh = mesh
        # the frozen towers are constants of the step: rank 0's on every rank
        for module in (training_model.loss_module, training_model.depth_module):
            if module is not None:
                mesh.broadcast_module_(module)

    def _moments(self, sums: torch.Tensor):
        return self.mesh.all_reduce_sum_autograd(sums), self.mesh.size

    def _mean_over_ranks(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ranks' mean of each tensor, in one all-reduce."""
        names = list(tensors)
        if not names:
            return {}
        flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in names])
        flat = self.mesh.all_reduce_sum(flat) / self.mesh.size
        out, at = {}, 0
        for k in names:
            t = tensors[k]
            out[k] = flat[at:at + t.numel()].reshape(t.shape).to(t.dtype)
            at += t.numel()
        return out

    # ---- steps ------------------------------------------------------------

    def train_step(self, state: TrainState, batch, *, plain: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on this rank's slice ``batch`` (see :meth:`shard_batch`)."""
        tm = self.tm
        moments = (batch_moments_reduced(self._moments) if self.mesh.group is not None
                   else contextlib.nullcontext())
        with moments:
            _, losses, new_stats, grads = tm.value_and_grad(state, batch, plain=plain)
        grads = self._mean_over_ranks(grads)
        updates, opt_state = tm.optimizer.update(grads, state.opt_state)
        params = apply_updates({k: v.detach() for k, v in state.params.items()}, updates)
        metrics = self._mean_over_ranks({name: torch.mean(v.detach())
                                         for name, v in losses.items()})
        return TrainState(state.step + 1, params, new_stats, opt_state), metrics

    def eval_step(self, state: TrainState, batch, *, plain: bool = False
                  ) -> Dict[str, torch.Tensor]:
        return self._mean_over_ranks(self.tm.eval_step(state, batch, plain=plain))

    # ---- placement --------------------------------------------------------

    def init_state(self) -> TrainState:
        """The training model's initial state, rank 0's on every rank."""
        return replicate(self.tm.init_state(), self.mesh)

    def shard_batch(self, batch):
        """This rank's slice of the global ``batch`` on its device."""
        return shard_batch(batch, self.mesh)

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape[DATA_AXIS]
