"""Epoch-loop trainer: the training model's steps, device prefetch,
callbacks, resume.

Port of ``realtime_style_transfer_tpu/trainer.py``: per-epoch training and
validation, the callback fan-out and the same logs (the metrics' epoch
means, ``val_*``, ``epoch_time``, ``steps``).  Each batch, a tree of numpy
arrays, reaches the training model's device through
:class:`.data.pipeline.DevicePrefetcher`; after each step the host reads
every metric (one ``.item()`` a metric), as the JAX trainer's
``jax.device_get(metrics)`` does.  The port is eager: the steps are the
training model's own methods.

``Trainer(mesh=...)`` trains data-parallel over the ranks of a
:func:`.parallel.make_mesh` mesh through
:class:`.parallel.DistributedTrainer`: each rank's prefetcher carries its
slice of every global batch (the batch size stays the global one, as in
JAX), the state starts as rank 0's, and the metrics are the global batch's.

``Trainer.timings`` records, for every training step, the host's wait for
the prefetcher and the step itself up to its metrics on the host, in
seconds by ``time.perf_counter``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .data.pipeline import DevicePrefetcher
from .models.training import StyleTransferTrainingModel, TrainState
from .tracing.callbacks import Callback
from .tracing.checkpoint import CheckpointManager

log = logging.getLogger(__name__)

class Trainer:
    def __init__(
        self,
        training_model: StyleTransferTrainingModel,
        *,
        mesh=None,
        log_dir: Optional[Path] = None,
        callbacks: Sequence[Callback] = (),
        metrics_writer=None,
    ):
        self.tm = training_model
        self.mesh = mesh
        self.log_dir = Path(log_dir) if log_dir else None
        self.callbacks: List[Callback] = list(callbacks)
        self.metrics_writer = metrics_writer
        if mesh is not None:
            from .parallel.train import DistributedTrainer

            self._dist = DistributedTrainer(training_model, mesh)
            self._train_step = self._dist.train_step
            self._eval_step = self._dist.eval_step
        else:
            self._dist = None
            self._train_step = training_model.train_step
            self._eval_step = training_model.eval_step
        # one entry a training step: (epoch, wait_s, step_s)
        self.timings: List[tuple] = []

    # ---- state ------------------------------------------------------------

    def init_state(self) -> TrainState:
        """The training model's initial state (its weights come from the
        model's seed; over a mesh, rank 0's)."""
        if self._dist is not None:
            return self._dist.init_state()
        return self.tm.init_state()

    def resume(self, state: TrainState, checkpoints: CheckpointManager):
        """Restore the latest checkpoint if one exists, each tensor in the
        dtype of its counterpart in ``state``; returns (state, epoch to start
        from)."""
        restored = checkpoints.restore_latest(self.tm, like=state)
        if restored is None:
            return state, 0
        epoch = checkpoints.latest_epoch()
        log.info("resuming from epoch %d", epoch)
        return restored, epoch + 1

    # ---- loops ------------------------------------------------------------

    def _run_epoch(self, state, batches, *, train: bool, prefetch: int = 2,
                   epoch: int = 0):
        sums: Dict[str, float] = {}
        count = 0
        if self._dist is not None:
            from .parallel.mesh import host_shard

            batches = (host_shard(batch, self.mesh) for batch in batches)
        prefetcher = DevicePrefetcher(batches, depth=prefetch, device=self.tm.device)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(prefetcher)
            except StopIteration:
                break
            t1 = time.perf_counter()
            if train:
                state, metrics = self._train_step(state, batch)
            else:
                metrics = self._eval_step(state, batch)
            metrics = {name: value.item() for name, value in metrics.items()}
            if train:
                self.timings.append((epoch, t1 - t0, time.perf_counter() - t1))
            for name, value in metrics.items():
                sums[name] = sums.get(name, 0.0) + float(value)
            count += 1
        means = {name: value / max(count, 1) for name, value in sums.items()}
        return state, means, count

    def fit(
        self,
        state: TrainState,
        make_train_iter: Callable[[], Iterable],
        make_validation_iter: Optional[Callable[[], Iterable]] = None,
        *,
        epochs: int = 300,
        initial_epoch: int = 0,
        prefetch: int = 2,
    ) -> TrainState:
        for cb in self.callbacks:
            cb.on_train_begin(self)
        for epoch in range(initial_epoch, epochs):
            t0 = time.perf_counter()
            state, train_metrics, steps = self._run_epoch(
                state, make_train_iter(), train=True, prefetch=prefetch, epoch=epoch
            )
            logs = dict(train_metrics)
            if make_validation_iter is not None:
                _, val_metrics, _ = self._run_epoch(
                    state, make_validation_iter(), train=False, prefetch=prefetch
                )
                logs.update({f"val_{k}": v for k, v in val_metrics.items()})
            logs["epoch_time"] = time.perf_counter() - t0
            logs["steps"] = steps
            log.info(
                "epoch %d: %s",
                epoch,
                " ".join(f"{k}={v:.5g}" for k, v in sorted(logs.items())),
            )
            for cb in self.callbacks:
                cb.on_epoch_end(epoch, state, logs)
        for cb in self.callbacks:
            cb.on_train_end()
        return state
