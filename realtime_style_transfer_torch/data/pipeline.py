"""Dataset assembly (cache, split, pair, batch) and the device prefetcher.

Port of ``realtime_style_transfer_tpu/data/pipeline.py``.  The dataset half
is plain Python iterators over numpy trees (dicts and tuples of arrays), the
JAX package's code: ``save_sample``/``load_sample`` write and read the same
``.npz`` spec format, so each package reads the other's cache files.  A
failing sample is logged and dropped, never fatal (``SkipSample`` drops it
without the warning).

``DevicePrefetcher`` pulls from its source on a daemon thread, runs
``prepare`` (for the fused path: the host-side frame pack into pinned
memory) and copies every tensor or numpy leaf of the item (a tensor, or a
tree of dicts, tuples and lists such as a training batch ``(inputs,
ground_truth)``) to the device on a side CUDA stream, so item i+1's
preparation and copy overlap item i's kernels.  The consumer's stream waits
on the item's event and each leaf is recorded on it.  Order is kept; a
source exception re-raises at the consuming ``next()`` in order, and an
ended prefetcher keeps raising ``StopIteration``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import queue
import random
import threading
from pathlib import Path
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from .. import resolve_device

log = logging.getLogger(__name__)


class SkipSample(Exception):
    """Raised by a loader to drop a sample without an error-level log."""


# ---------------------------------------------------------------------------
# npz round trip for nested (dict / tuple / array) samples
# ---------------------------------------------------------------------------


def _flatten(value: Any, prefix: str, out: Dict[str, np.ndarray]):
    """Flatten a nested dict/tuple/list of arrays into npz keys + a spec."""
    if isinstance(value, dict):
        return {
            "kind": "dict",
            "items": {
                str(k): _flatten(v, f"{prefix}.{k}", out)
                for k, v in value.items()
            },
        }
    if isinstance(value, (tuple, list)):
        return {
            "kind": "tuple" if isinstance(value, tuple) else "list",
            "items": [
                _flatten(v, f"{prefix}.{i}", out) for i, v in enumerate(value)
            ],
        }
    out[prefix] = np.asarray(value)
    return {"kind": "array", "key": prefix}


def _unflatten(spec: Dict[str, Any], arrays) -> Any:
    kind = spec["kind"]
    if kind == "dict":
        return {k: _unflatten(s, arrays) for k, s in spec["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_unflatten(s, arrays) for s in spec["items"]]
        return tuple(seq) if kind == "tuple" else seq
    return arrays[spec["key"]]


def save_sample(path: Path, value: Any) -> None:
    """Write a nested numpy sample as one ``.npz`` (atomic rename)."""
    arrays: Dict[str, np.ndarray] = {}
    spec = _flatten(value, "v", arrays)
    arrays["__spec__"] = np.frombuffer(
        json.dumps(spec).encode("utf-8"), np.uint8
    )
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


def load_sample(path: Path) -> Any:
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"]).decode("utf-8"))
        return _unflatten(spec, {k: z[k] for k in z.files if k != "__spec__"})


class IndexedDataset:
    """Re-iterable dataset over ``items`` with log-and-skip + disk cache.

    ``loader(item)`` produces a numpy pytree.  Failures are logged and the
    item skipped (reference fault-tolerance, ``common.py:117-118``); with a
    ``cache_dir`` each successful load is persisted as an ``.npz`` keyed by
    the item's repr, so later epochs/processes read decoded tensors instead
    of re-decoding (the ``.cache(filename)`` role, ``wikiart.py:188-204``).
    Failed items are retried every pass (a transient error must not poison
    the cache).
    """

    def __init__(
        self,
        items: Sequence[Any],
        loader: Callable[[Any], Any],
        cache_dir: Optional[Path] = None,
    ):
        self.items = list(items)
        self.loader = loader
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self) -> int:
        return len(self.items)

    def _cache_path(self, item: Any) -> Path:
        digest = hashlib.sha1(repr(item).encode("utf-8")).hexdigest()
        return self.cache_dir / f"{digest}.npz"

    def __iter__(self) -> Iterator[Any]:
        for item in self.items:
            if self.cache_dir is not None:
                cached = self._cache_path(item)
                if cached.exists():
                    try:
                        yield load_sample(cached)
                        continue
                    except Exception as e:  # noqa: BLE001 — corrupt cache
                        log.warning("corrupt cache %s (%s); reloading", cached, e)
            try:
                value = self.loader(item)
            except SkipSample as e:
                log.debug("skipping %r: %s", item, e)
                continue
            except Exception as e:  # noqa: BLE001 — log-and-skip parity
                log.warning("could not load %r: %s", item, e)
                continue
            if self.cache_dir is not None:
                try:
                    save_sample(self._cache_path(item), value)
                except Exception as e:  # noqa: BLE001 — cache is best-effort
                    log.warning("could not cache %r: %s", item, e)
            yield value


def split_train_validation(
    items: Sequence[Any], *, seed: Optional[int] = None, fraction: float = 0.8
) -> Tuple[List[Any], List[Any]]:
    """Deterministic 80/20 split (reference ``wikiart.py:161-166``).

    With a ``seed`` the items are shuffled first (same RNG contract as the
    reference's ``random.Random(seed).shuffle``); without one the input
    order is kept, so the split is reproducible either way.
    """
    items = list(items)
    if seed is not None:
        random.Random(seed).shuffle(items)
    cut = int(len(items) * fraction)
    return items[:cut], items[cut:]


def pair_content_and_style(
    content: Iterable[Any],
    style: Iterable[np.ndarray],
    style_weights_shape: Optional[Sequence[int]] = None,
) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Min-zip content with style into (inputs, ground_truth) samples.

    Parity with ``pair_up_content_and_style_datasets`` (``common.py:132-169``):
    * a content item is ``(content, ground_truth)`` or a single array (then it
      is its own ground truth);
    * the style image gains a leading ``num_styles`` axis;
    * multi-style configs get an all-zero ``style_weights`` plane
      (``common.py:139-140`` — training always runs single-style weights).
    """
    for content_item, style_image in zip(content, style):
        if isinstance(content_item, (tuple, list)):
            content_image, ground_truth = content_item
        else:
            content_image = ground_truth = content_item
        style_stacked = np.asarray(style_image, np.float32)[None]
        inputs = {
            "content": np.asarray(content_image, np.float32),
            "style": style_stacked,
        }
        if style_weights_shape is not None:
            inputs["style_weights"] = np.zeros(
                tuple(style_weights_shape), np.float32
            )
        gt = {
            "content": np.asarray(ground_truth, np.float32),
            "style": style_stacked,
        }
        yield inputs, gt


def _stack(samples: List[Any]) -> Any:
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        out = [_stack([s[i] for s in samples]) for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    return np.stack([np.asarray(s) for s in samples])


def batched(samples: Iterable[Any], batch_size: int) -> Iterator[Any]:
    """Stack consecutive samples into batches; drop the ragged remainder.

    (The reference's ``.batch(batch_size)``; remainder dropped so every step
    sees a static batch shape — XLA recompiles on shape change.)
    """
    bucket: List[Any] = []
    for sample in samples:
        bucket.append(sample)
        if len(bucket) == batch_size:
            yield _stack(bucket)
            bucket = []


def get_single_sample(samples: Optional[Iterable[Any]]) -> Optional[Any]:
    """First sample of an (unbatched) iterable, re-batched to batch 1.

    Parity with ``get_single_sample_from_dataset`` (``common.py:213-216``);
    returns ``None`` when the iterable is empty or ``None``.
    """
    if samples is None:
        return None
    for sample in samples:
        return _tree_map(lambda x: np.asarray(x)[None], sample)
    return None


def _tree_map(fn, value):
    """``fn`` on every leaf of nested dicts, tuples, lists and dataclass
    instances (a ``TrainState``)."""
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        out = [_tree_map(fn, v) for v in value]
        return tuple(out) if isinstance(value, tuple) else out
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(**{f.name: _tree_map(fn, getattr(value, f.name))
                              for f in dataclasses.fields(value)})
    return fn(value)


_END = object()


def _to_device(value: Any, device: torch.device, pin: bool) -> Any:
    """``value`` with every tensor and numpy leaf on ``device`` (numpy leaves
    pinned first when ``pin``); other leaves are kept."""
    if isinstance(value, dict):
        return {k: _to_device(v, device, pin) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        out = [_to_device(v, device, pin) for v in value]
        return tuple(out) if isinstance(value, tuple) else out
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
        if pin:
            value = value.pin_memory()
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=pin)
    return value


def _tensor_leaves(value: Any) -> Iterator[torch.Tensor]:
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensor_leaves(v)
    elif isinstance(value, torch.Tensor):
        yield value


class DevicePrefetcher:
    """Depth-``depth`` pipeline of items from ``source`` (through
    ``prepare``) to ``device`` (default CUDA)."""

    def __init__(self, source: Iterable[Any], depth: int = 2, *, device=None,
                 prepare: Optional[Callable[[Any], Any]] = None):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._finished = False

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for item in source:
                    host = prepare(item) if prepare is not None else item
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            dev = _to_device(host, self.device, True)
                            event = torch.cuda.Event()
                            event.record(self._stream)
                    else:
                        dev, event = _to_device(host, self.device, False), None
                    self._queue.put(("item", (dev, event)))
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                self._queue.put(("error", e))
            else:
                self._queue.put(("end", _END))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            # the end or error record comes once; keep raising instead of
            # blocking on the finished worker's empty queue
            raise StopIteration
        kind, value = self._queue.get()
        if kind == "item":
            dev, event = value
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                # the side stream allocated these tensors: tell the caching
                # allocator each is in use on the consumer's stream too
                for leaf in _tensor_leaves(dev):
                    leaf.record_stream(stream)
            return dev
        self._finished = True
        if kind == "error":
            raise value
        raise StopIteration
