"""Train and eval steps over the ``(data, spatial)`` mesh.

Port of ``realtime_style_transfer_tpu/parallel/train.py``.  The JAX step is
one jitted function over replicated parameters and a batch sharded over the
``data`` axis, its activations' H over ``spatial``; GSPMD inserts the
gradient all-reduce and the conv halo exchanges, and a train-mode batch norm
normalizes with the global batch's moments.  Here each rank runs the
training model's step on its data index's slice of the batch, the transfer
net on its spatial index's rows of each frame (:mod:`.spatial`), and the
step makes the collectives JAX gets implicitly:

* every train-mode :class:`..models.layers.BatchNorm` forms its mean and
  variance from per-channel sums of x and x^2 all-reduced over the whole
  mesh (:func:`..models.layers.batch_moments_reduced`, differentiable), so
  its output and the running statistics it commits are the global batch's;
  on a spatial axis, whose ranks hold uneven row shards, the element count
  is all-reduced with the sums (without one, every rank holds a batch of one
  size and the count is known);
* the transfer net's convs exchange halo rows and its CINs all-reduce their
  sums within the spatial group, and its output is gathered along H there,
  so every rank of the group runs the loss towers on the whole frames and
  computes the same loss, while the gather's backward hands each rank only
  its rows' gradient;
* the parameter gradients are all-reduced with SUM over the whole mesh (a
  rank's gradient is its rows' share of its data slice's, the predictor
  running replicated in the group) and divided by the data axis' size: the
  gradient of the mean over the global batch;
* the metrics are averaged over the data group before any ``.item()``.

The initial state and the frozen loss and depth towers are rank 0's, by a
broadcast; the optimizer then updates the same parameters with the same
gradients on every rank, so the state stays replicated.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Tuple

import torch

from ..models.layers import batch_moments_reduced
from ..models.training import StyleTransferTrainingModel, TrainState
from ..optim import apply_updates
from .distributed import all_reduce_, all_reduce_moments, sum_autograd
from .mesh import DATA_AXIS, Mesh, frame_rows, replicate, shard_batch


class DistributedTrainer:
    """Wraps a ``StyleTransferTrainingModel`` with steps on the mesh."""

    def __init__(self, training_model: StyleTransferTrainingModel, mesh: Mesh):
        dev = training_model.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != mesh.device:
            raise ValueError(f"the training model is on {training_model.device}, this "
                             f"rank's device is {mesh.device}")
        self.tm = training_model
        self.mesh = mesh
        self.rows = frame_rows(mesh, training_model.model.plan)
        # the frozen towers are constants of the step: rank 0's on every rank
        for module in (training_model.loss_module, training_model.depth_module):
            if module is not None:
                mesh.broadcast_module_(module)

    def _moments(self, sums: torch.Tensor, count: int):
        reduce_ = functools.partial(all_reduce_, group=self.mesh.world)
        if self.rows is None:   # the ranks hold batches of one size: the count is known
            return sum_autograd(sums, reduce_), count * self.mesh.size
        return all_reduce_moments(sums, count, reduce_)

    def _mean(self, tensors: Dict[str, torch.Tensor], group, divisor: int
              ) -> Dict[str, torch.Tensor]:
        """The sum of each tensor over ``group`` divided by ``divisor``, in one
        all-reduce."""
        names = list(tensors)
        if not names:
            return {}
        flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in names])
        if group is not None:
            all_reduce_(flat, group)
        flat = flat / divisor
        out, at = {}, 0
        for k in names:
            t = tensors[k]
            out[k] = flat[at:at + t.numel()].reshape(t.shape).to(t.dtype)
            at += t.numel()
        return out

    def _metrics(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The data group's mean (the ranks of a spatial group agree)."""
        return self._mean(tensors, self.mesh.group, self.mesh.size)

    # ---- steps ------------------------------------------------------------

    def train_step(self, state: TrainState, batch, *, plain: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on this rank's slice ``batch`` (see :meth:`shard_batch`)."""
        tm = self.tm
        moments = (batch_moments_reduced(self._moments) if self.mesh.world is not None
                   else contextlib.nullcontext())
        with moments:
            _, losses, new_stats, grads = tm.value_and_grad(state, batch, plain=plain,
                                                            rows=self.rows)
        grads = self._mean(grads, self.mesh.world, self.mesh.size)
        updates, opt_state = tm.optimizer.update(grads, state.opt_state)
        params = apply_updates({k: v.detach() for k, v in state.params.items()}, updates)
        metrics = self._metrics({name: torch.mean(v.detach()) for name, v in losses.items()})
        return TrainState(state.step + 1, params, new_stats, opt_state), metrics

    def eval_step(self, state: TrainState, batch, *, plain: bool = False
                  ) -> Dict[str, torch.Tensor]:
        return self._metrics(self.tm.eval_step(state, batch, plain=plain, rows=self.rows))

    # ---- placement --------------------------------------------------------

    def init_state(self) -> TrainState:
        """The training model's initial state, rank 0's on every rank."""
        return replicate(self.tm.init_state(), self.mesh)

    def shard_batch(self, batch):
        """This rank's slice of the global ``batch`` on its device (whole
        frames: the transfer net takes this rank's rows of them)."""
        return shard_batch(batch, self.mesh)

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape[DATA_AXIS]
