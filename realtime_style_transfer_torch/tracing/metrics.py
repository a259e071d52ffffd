"""Metrics sinks: a JSONL event stream and TensorBoard event files.

Port of ``realtime_style_transfer_tpu/tracing/metrics.py``.  Scalars land in
both formats: JSONL (one event a line, ``{"step": n, "tag":
"training/loss", "value": v, "time": t}``) and a TensorBoard event file
(:mod:`.tensorboard`).  Histograms get their bucket payloads in both sinks;
image summaries go to the event file, beside the PNGs the image callback
writes.  ``val_``-prefixed logs go under ``validation/``, the rest under
``training/``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

from .tensorboard import EventFileWriter


class MetricsWriter:
    def __init__(self, log_dir, *, tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._events: Optional[EventFileWriter] = (
            EventFileWriter(self.log_dir) if tensorboard else None
        )

    def write_scalar(self, tag: str, value, step: int) -> None:
        self._file.write(
            json.dumps(
                {"step": int(step), "tag": tag, "value": float(value),
                 "time": time.time()}
            )
            + "\n"
        )
        if self._events is not None:
            self._events.add_scalar(tag, float(value), int(step))

    def write_scalars(self, metrics: Mapping[str, float], step: int,
                      prefix: str = "") -> None:
        for name, value in metrics.items():
            self.write_scalar(prefix + name, value, step)
        self.flush()

    def write_split_scalars(self, logs: Mapping[str, float], step: int) -> None:
        """``val_``-prefixed keys -> validation/, the rest -> training/."""
        for name, value in logs.items():
            if name.startswith("val_"):
                self.write_scalar(f"validation/{name[4:]}", value, step)
            else:
                self.write_scalar(f"training/{name}", value, step)
        self.flush()

    def write_histogram(self, tag: str, *, bucket_limits: Sequence[float],
                        buckets: Sequence[float], minimum: float, maximum: float,
                        total: float, sum_squares: float, step: int) -> None:
        num = float(sum(buckets))
        self._file.write(
            json.dumps(
                {"step": int(step), "tag": tag, "time": time.time(),
                 "histogram": {
                     "min": float(minimum), "max": float(maximum), "num": num,
                     "sum": float(total), "sum_squares": float(sum_squares),
                     "bucket_limit": [float(v) for v in bucket_limits],
                     "bucket": [float(v) for v in buckets],
                 }}
            )
            + "\n"
        )
        if self._events is not None:
            self._events.add_histogram_raw(
                tag, int(step), minimum=float(minimum), maximum=float(maximum),
                num=num, total=float(total), sum_squares=float(sum_squares),
                bucket_limits=bucket_limits, buckets=buckets,
            )

    def write_image_png(self, tag: str, png_bytes: bytes, height: int,
                        width: int, step: int) -> None:
        if self._events is not None:
            self._events.add_image_png(tag, png_bytes, height, width, step)

    def write_text(self, tag: str, text: str, step: int = 0) -> None:
        path = self.log_dir / f"{tag.replace('/', '_')}.txt"
        path.write_text(text)

    def flush(self) -> None:
        self._file.flush()
        if self._events is not None:
            self._events.flush()

    def close(self) -> None:
        self._file.close()
        if self._events is not None:
            self._events.close()


def read_metrics(log_dir) -> Dict[str, list]:
    """Load a metrics.jsonl back into {tag: [(step, value), ...]} (scalars only)."""
    out: Dict[str, list] = {}
    path = Path(log_dir) / "metrics.jsonl"
    if not path.exists():
        return out
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if "value" in ev:
                out.setdefault(ev["tag"], []).append((ev["step"], ev["value"]))
    return out
