"""Device prefetcher: prepare frames on a worker thread, copy them early.

Port of ``DevicePrefetcher`` in ``realtime_style_transfer_tpu/data/pipeline.py``.
A daemon thread pulls from the source, runs ``prepare`` (for the fused path:
the host-side frame pack into pinned memory) and issues the host-to-device
copy on a side CUDA stream, so frame i+1's pack and copy overlap frame i's
kernels.  The consumer's stream waits on each copy's event before it uses the
tensor.  Order is kept; a source exception re-raises at the consuming
``next()`` in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Optional

import torch

from .. import resolve_device

_END = object()


class DevicePrefetcher:
    """Depth-``depth`` pipeline of tensors from ``source`` (through
    ``prepare``) to ``device`` (default CUDA)."""

    def __init__(self, source: Iterable[Any], depth: int = 2, *, device=None,
                 prepare: Optional[Callable[[Any], torch.Tensor]] = None):
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
                            dev = host.to(self.device, non_blocking=True)
                            event = torch.cuda.Event()
                            event.record(self._stream)
                    else:
                        dev, event = host.to(self.device), None
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
            raise StopIteration
        kind, value = self._queue.get()
        if kind == "item":
            dev, event = value
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                # the side stream allocated this tensor: tell the caching
                # allocator it is in use on the consumer's stream too
                dev.record_stream(stream)
            return dev
        self._finished = True
        if kind == "error":
            raise value
        raise StopIteration
