"""Checkpoints and resume as ``.npz`` files: epoch cadence, latest, weights.

Port of ``realtime_style_transfer_tpu/tracing/checkpoint.py`` without Orbax.
A run directory holds

* ``ckpt/<epoch>.npz``        saved on Orbax's rule for ``save_interval_steps
  = cadence``: when the directory holds no checkpoint yet or ``epoch %
  cadence == 0`` (and the epoch is past the newest), keeping the newest
  ``keep`` (5);
* ``latest_ckpt/<epoch>.npz`` every epoch, keeping 1;
* ``weights/latest_epoch_weights.npz`` every epoch: ``params`` and
  ``batch_stats`` only, the artifact the inference tools load
  (``cli.load_variables`` takes the run directory).

A state file is :func:`..weights.state_to_flax`'s tree (``step``,
``params``, ``batch_stats``, ``nu``), flattened to ``/``-joined keys as the
port's checkpoint files are; :func:`..weights.state_from_flax` restores it.
Each file is written to a temporary name and renamed, so a reader never sees
half of one.  An Orbax directory of the JAX package is refused: convert it
where JAX runs (README, "Converting a JAX checkpoint").
"""

from __future__ import annotations

import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional

import numpy as np

log = logging.getLogger(__name__)

WEIGHTS_NAME = "weights"
WEIGHTS_FILE = "latest_epoch_weights.npz"


def orbax_refusal(path) -> ValueError:
    return ValueError(
        f"{path} is a directory (an Orbax checkpoint of the JAX package?): the "
        "port reads one .npz file keyed by /-joined flax paths; convert the run "
        "where JAX runs, as README.md says under 'Converting a JAX checkpoint'")


def write_tree(path: Path, tree: Mapping) -> Path:
    """Write a nested tree of arrays as one ``.npz`` of ``/``-joined keys,
    through a temporary file and a rename."""
    from ..weights import _flatten

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **{"/".join(keys): leaf for keys, leaf in _flatten(tree)})
    tmp.replace(path)
    return path


def read_tree(path) -> Dict[str, object]:
    """An ``.npz`` of ``/``-joined keys as a nested dict of numpy arrays."""
    tree: Dict[str, object] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = np.array(data[key])
    return tree


def state_tree(state) -> Dict[str, object]:
    """A port ``TrainState`` as its state file's tree."""
    from ..weights import state_to_flax

    tree = state_to_flax(state)
    tree["step"] = np.asarray(tree["step"], np.int64)
    return tree


def restore_state(tree: Mapping, training_model, like=None):
    """A state file's tree -> a ``TrainState`` on ``training_model``'s
    device, through :func:`..weights.state_from_flax`; with ``like`` (a
    state of the same model) every tensor takes the dtype of its
    counterpart there, so an f32 optimizer state stays f32 under bf16
    compute."""
    import torch

    from ..optim import RMSPropState
    from ..weights import state_from_flax

    view = SimpleNamespace(step=tree["step"], params=tree["params"],
                           batch_stats=tree.get("batch_stats", {}),
                           opt_state=(SimpleNamespace(nu=tree["nu"]),))
    state = state_from_flax(view, training_model)
    if like is None:
        return state

    def cast(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
        return {k: v.to(dtype=want[k].dtype) for k, v in got.items()}

    return type(state)(state.step.to(like.step.dtype), cast(state.params, like.params),
                       cast(state.batch_stats, like.batch_stats),
                       RMSPropState(cast(state.opt_state.nu, like.opt_state.nu)))


def _epochs(directory: Path) -> List[int]:
    return sorted(int(p.stem) for p in directory.glob("*.npz") if p.stem.isdigit())


class _EpochFiles:
    """``<directory>/<epoch>.npz`` files kept on Orbax's save rule."""

    def __init__(self, directory: Path, interval: int, keep: Optional[int]):
        self.directory = directory
        self.interval = interval
        self.keep = keep

    def epochs(self) -> List[int]:
        return _epochs(self.directory)

    def should_save(self, epoch: int) -> bool:
        saved = self.epochs()
        if saved and saved[-1] >= epoch:
            return False
        return not saved or epoch % self.interval == 0

    def save(self, epoch: int, tree: Mapping) -> bool:
        if not self.should_save(epoch):
            return False
        write_tree(self.directory / f"{epoch}.npz", tree)
        saved = self.epochs()
        if self.keep is not None:
            for old in saved[:max(len(saved) - self.keep, 0)]:
                (self.directory / f"{old}.npz").unlink()
        return True


class CheckpointManager:
    def __init__(self, log_dir, *, cadence: int = 10, keep: int = 5):
        self.log_dir = Path(log_dir)
        self.cadence = cadence
        self._ckpt = _EpochFiles(self.log_dir / "ckpt", cadence, keep)
        self._latest = _EpochFiles(self.log_dir / "latest_ckpt", 1, 1)

    # ---- save ---------------------------------------------------------------

    def save_epoch(self, epoch: int, state) -> None:
        tree = state_tree(state)
        self._ckpt.save(epoch, tree)
        self._latest.save(epoch, tree)
        self.save_weights(state, tree)

    def save_weights(self, state, tree: Optional[Mapping] = None) -> Path:
        """Params-only artifact for the inference tools."""
        tree = tree or state_tree(state)
        return write_tree(self.log_dir / WEIGHTS_NAME / WEIGHTS_FILE,
                          {"params": tree["params"], "batch_stats": tree["batch_stats"]})

    # ---- restore --------------------------------------------------------------

    def epochs(self) -> List[int]:
        """The epochs under ``ckpt/``."""
        return self._ckpt.epochs()

    def latest_epoch(self) -> Optional[int]:
        saved = self._latest.epochs()
        return saved[-1] if saved else None

    def restore_latest(self, training_model, like=None):
        """The ``latest_ckpt`` state (see :func:`restore_state`), or None."""
        epoch = self.latest_epoch()
        if epoch is None:
            if (self.log_dir / "latest_ckpt").is_dir() and any(
                    (self.log_dir / "latest_ckpt").iterdir()):
                raise orbax_refusal(self.log_dir / "latest_ckpt")
            return None
        return restore_state(read_tree(self.log_dir / "latest_ckpt" / f"{epoch}.npz"),
                             training_model, like)

    def restore_epoch(self, epoch: int, training_model, like=None):
        return restore_state(read_tree(self.log_dir / "ckpt" / f"{epoch}.npz"),
                             training_model, like)


def weights_file(checkpoint) -> Path:
    """The weights artifact of a run directory, of its ``weights/``
    directory, or ``checkpoint`` itself when it is a file."""
    base = Path(checkpoint)
    if not base.is_dir():
        return base
    for path in (base / WEIGHTS_NAME / WEIGHTS_FILE, base / WEIGHTS_FILE):
        if path.is_file():
            return path
    raise orbax_refusal(base)


def load_weights(checkpoint) -> Dict[str, object]:
    """``{"params": ..., "batch_stats": ...}`` of a run's weights artifact
    (:func:`weights_file` finds it) as nested numpy trees."""
    restored = read_tree(weights_file(checkpoint))
    if not restored.get("params"):
        raise ValueError(f"{checkpoint}: the weights artifact holds no params")
    return restored
