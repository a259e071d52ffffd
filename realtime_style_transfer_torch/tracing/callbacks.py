"""Training callbacks: image summaries, metrics, histograms, gradients, checkpoints.

Port of ``realtime_style_transfer_tpu/tracing/callbacks.py``, on the same
protocol the trainer drives::

    on_train_begin(trainer) / on_epoch_end(epoch, state, logs) / on_train_end()

and with the same tags, so a port run's ``metrics.jsonl`` has the JAX run's
tag set: leaves are named by their flax paths (``transfer/contract_0_conv/
kernel``, through :func:`.textsummary.flax_leaves`), histograms have 30
buckets between each leaf's minimum and maximum, counted as
``jnp.histogram`` counts them.  The statistics are reduced on the tensor's
device, one host copy a leaf.  The gradients are the training step's own,
:meth:`..models.training.StyleTransferTrainingModel.value_and_grad` through
the training graph (batch norm on batch statistics).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..data.imaging import tensor_to_image
from .checkpoint import CheckpointManager
from .metrics import MetricsWriter
from .textsummary import flax_leaves

log = logging.getLogger(__name__)


class Callback:
    def on_train_begin(self, trainer) -> None:  # noqa: D401
        pass

    def on_epoch_end(self, epoch: int, state, logs: Mapping[str, float]) -> None:
        pass

    def on_train_end(self) -> None:
        pass


class MetricsCallback(Callback):
    """Split train/val scalars into the metrics sinks."""

    def __init__(self, writer: MetricsWriter):
        self.writer = writer

    def on_epoch_end(self, epoch, state, logs) -> None:
        self.writer.write_split_scalars(logs, epoch)


class CheckpointCallback(Callback):
    """Cadence + latest + weights saves per epoch."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager

    def on_epoch_end(self, epoch, state, logs) -> None:
        self.manager.save_epoch(epoch, state)


class SummaryImageCallback(Callback):
    """Write style/content once, and val+train predictions each epoch as PNGs
    (and TensorBoard image events, with a ``prediction_time`` scalar, end
    minus start, that waits for the prediction on the host)."""

    def __init__(self, log_dir, training_model, validation_batch, training_batch):
        self.dir = Path(log_dir) / "images"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.tm = training_model
        self.batches = {"validation": validation_batch, "training": training_batch}
        self.writer: Optional[MetricsWriter] = None
        self._wrote_inputs = False

    def on_train_begin(self, trainer) -> None:
        self.writer = getattr(trainer, "metrics_writer", None)

    def _write_inputs_once(self) -> None:
        if self._wrote_inputs:
            return
        for subset, (inputs, _gt) in self.batches.items():
            style = np.asarray(inputs["style"])[0, 0]
            content_rgb = np.asarray(inputs["content"])[0][..., :3]
            tensor_to_image(style).save(self.dir / f"{subset}_style.png")
            tensor_to_image(content_rgb).save(self.dir / f"{subset}_content.png")
        self._wrote_inputs = True

    def on_epoch_end(self, epoch, state, logs) -> None:
        self._write_inputs_once()
        for subset, (inputs, _gt) in self.batches.items():
            start = time.perf_counter()
            prediction = self.tm.predict(state, inputs).float().cpu().numpy()
            elapsed = time.perf_counter() - start
            image = tensor_to_image(prediction[0])
            path = self.dir / f"{subset}_prediction_{epoch:05d}.png"
            image.save(path)
            if self.writer is not None:
                self.writer.write_scalar(f"{subset}/prediction_time", elapsed, epoch)
                self.writer.write_image_png(
                    f"{subset}/prediction", path.read_bytes(),
                    image.height, image.width, epoch,
                )


NUM_HISTOGRAM_BINS = 30


def _leaf_stats(x: torch.Tensor, histogram: bool) -> Dict[str, Any]:
    """mean, var, min, max, sum, sum of squares (and the histogram) of one
    leaf in f32 on its device, copied to the host once."""
    x = x.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    scalars = [x.mean(), x.var(unbiased=False), lo, hi, x.sum(), (x * x).sum()]
    if histogram:
        # a constant leaf still gets one populated bucket
        hi_edge = torch.where(hi > lo, hi, lo + 1.0)
        edges = lo + (hi_edge - lo) * torch.linspace(0.0, 1.0, NUM_HISTOGRAM_BINS + 1,
                                                     device=x.device)
        # jnp.histogram: searchsorted(edges, x, 'right'), the last edge in the
        # last bucket, anything outside the edges dropped
        idx = torch.bucketize(x, edges, right=True)
        idx = torch.where(x == edges[-1], NUM_HISTOGRAM_BINS, idx)
        counts = torch.bincount(idx, minlength=NUM_HISTOGRAM_BINS + 2)
        host = torch.cat([torch.stack(scalars), edges[1:],
                          counts[1:NUM_HISTOGRAM_BINS + 1].float()]).cpu().numpy()
    else:
        host = torch.stack(scalars).cpu().numpy()
    out = dict(zip(("mean", "var", "min", "max", "sum", "sum_squares"), host[:6]))
    if histogram:
        out["bucket_limit"] = host[6:6 + NUM_HISTOGRAM_BINS]
        out["bucket"] = host[6 + NUM_HISTOGRAM_BINS:]
    return out


def _tree_stats(tree: Mapping[str, torch.Tensor], *, histogram: bool = False
                ) -> Dict[str, Dict[str, Any]]:
    """Per-leaf summary stats (and fixed-bin histograms) by flax path."""
    return {name: _leaf_stats(leaf, histogram) for name, leaf in flax_leaves(tree)}


def _write_tree_summaries(writer: MetricsWriter, prefix: str, tree, epoch: int,
                          *, histogram: bool) -> None:
    for name, s in _tree_stats(tree, histogram=histogram).items():
        writer.write_scalar(f"{prefix}/{name}/mean", float(s["mean"]), epoch)
        writer.write_scalar(f"{prefix}/{name}/var", float(s["var"]), epoch)
        if histogram:
            writer.write_histogram(
                f"{prefix}/{name}",
                bucket_limits=np.asarray(s["bucket_limit"]).tolist(),
                buckets=np.asarray(s["bucket"]).astype(np.float64).tolist(),
                minimum=float(s["min"]), maximum=float(s["max"]),
                total=float(s["sum"]), sum_squares=float(s["sum_squares"]),
                step=epoch,
            )


class HistogramCallback(Callback):
    """Per-layer weight histograms every ``every`` epochs."""

    def __init__(self, writer: MetricsWriter, every: int = 1):
        self.writer = writer
        self.every = every

    def on_epoch_end(self, epoch, state, logs) -> None:
        if epoch % self.every:
            return
        _write_tree_summaries(self.writer, "weights", state.params, epoch,
                              histogram=True)


class GradientsCallback(Callback):
    """Gradient stats on a pinned datapoint every ``every`` epochs, taken
    through the training graph by the training model's ``value_and_grad``."""

    def __init__(self, writer: MetricsWriter, training_model, pinned_batch,
                 every: int = 1):
        self.writer = writer
        self.tm = training_model
        self.batch = pinned_batch
        self.every = every

    def on_epoch_end(self, epoch, state, logs) -> None:
        if epoch % self.every:
            return
        grads = self.tm.value_and_grad(state, self.batch)[3]
        _write_tree_summaries(self.writer, "gradients", grads, epoch,
                              histogram=True)
