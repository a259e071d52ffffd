"""TensorBoard event-file writer with no TensorFlow dependency.

Port of ``realtime_style_transfer_tpu/tracing/tensorboard.py``: the TFRecord
framing (length, masked CRC32C, payload, masked CRC32C) and hand-encoded
``Event``/``Summary`` protobufs (scalars, histograms, images), byte for byte
the JAX package's, so ``tensorboard --logdir <run>`` reads a run of either
package.  Field numbers follow ``tensorflow/core/util/event.proto`` and
``tensorflow/core/framework/summary.proto``.

Every event carries a wall time; the ``add_*`` methods and the constructor
(whose version record is the file's first event) take it as ``wall_time``,
``time.time()`` when it is not given.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path
from typing import Optional, Sequence

from ..utils.proto import enc_bytes as _bytes
from ..utils.proto import enc_double as _double
from ..utils.proto import enc_float as _float
from ..utils.proto import enc_int64 as _int64
from ..utils.proto import enc_packed_doubles as _packed_doubles
from ..utils.proto import enc_string as _string
from ..utils.proto import parse_fields as _parse_fields

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def encode_histogram_proto(
    *,
    minimum: float,
    maximum: float,
    num: float,
    total: float,
    sum_squares: float,
    bucket_limits: Sequence[float],
    buckets: Sequence[float],
) -> bytes:
    """``HistogramProto`` (summary.proto fields 1-7)."""
    return (
        _double(1, minimum)
        + _double(2, maximum)
        + _double(3, num)
        + _double(4, total)
        + _double(5, sum_squares)
        + _packed_doubles(6, bucket_limits)
        + _packed_doubles(7, buckets)
    )


def _summary_value(tag: str, payload: bytes) -> bytes:
    return _bytes(1, _string(1, tag) + payload)  # Summary.value is field 1


def _event(step: int, summary: bytes, wall_time: Optional[float] = None) -> bytes:
    return (
        _double(1, time.time() if wall_time is None else wall_time)
        + _int64(2, int(step))
        + _bytes(5, summary)
    )


class EventFileWriter:
    """Append-only ``events.out.tfevents.*`` writer (scalars/histograms/images)."""

    def __init__(self, log_dir, *, filename_suffix: str = "",
                 wall_time: Optional[float] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}{filename_suffix}"
        )
        self.path = self.log_dir / name
        self._file = open(self.path, "ab")
        # TensorBoard requires the version record first.
        self._write_record(_double(1, time.time() if wall_time is None else wall_time)
                           + _string(3, "brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", _masked_crc(data)))
        # Events are epoch-cadence; flush per record so readers (TensorBoard's
        # polling loader, tests) always see whole records.
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int, *,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(
            _event(step, _summary_value(tag, _float(2, float(value))), wall_time)
        )

    def add_histogram_raw(
        self,
        tag: str,
        step: int,
        *,
        minimum: float,
        maximum: float,
        num: float,
        total: float,
        sum_squares: float,
        bucket_limits: Sequence[float],
        buckets: Sequence[float],
        wall_time: Optional[float] = None,
    ) -> None:
        histo = encode_histogram_proto(
            minimum=minimum, maximum=maximum, num=num, total=total,
            sum_squares=sum_squares, bucket_limits=bucket_limits, buckets=buckets,
        )
        self._write_record(_event(step, _summary_value(tag, _bytes(5, histo)), wall_time))

    def add_image_png(self, tag: str, png_bytes: bytes, height: int, width: int,
                      step: int, *, colorspace: int = 3,
                      wall_time: Optional[float] = None) -> None:
        image = (
            _int64(1, height) + _int64(2, width) + _int64(3, colorspace)
            + _bytes(4, png_bytes)
        )
        self._write_record(_event(step, _summary_value(tag, _bytes(4, image)), wall_time))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


# ---------------------------------------------------------------------------
# Decoder: reads back what the writer wrote (tests, tooling).
# ---------------------------------------------------------------------------


def read_events(path):
    """Parse an event file into ``[{step, tag, kind, value}, ...]``."""
    raw = Path(path).read_bytes()
    events = []
    pos = 0
    while pos < len(raw):
        (length,) = struct.unpack("<Q", raw[pos:pos + 8])
        (len_crc,) = struct.unpack("<I", raw[pos + 8:pos + 12])
        if len_crc != _masked_crc(raw[pos:pos + 8]):
            raise ValueError("length CRC mismatch")
        data = raw[pos + 12:pos + 12 + length]
        (data_crc,) = struct.unpack("<I", raw[pos + 12 + length:pos + 16 + length])
        if data_crc != _masked_crc(data):
            raise ValueError("data CRC mismatch")
        pos += 16 + length

        step, summary, file_version = 0, None, None
        for field, _wire, value in _parse_fields(data):
            if field == 2:
                step = value
            elif field == 3:
                file_version = value.decode()
            elif field == 5:
                summary = value
        if file_version is not None:
            events.append({"kind": "file_version", "value": file_version})
            continue
        if summary is None:
            continue
        for field, _wire, value in _parse_fields(summary):
            if field != 1:
                continue
            tag, kind, payload = None, None, None
            for f2, _w2, v2 in _parse_fields(value):
                if f2 == 1:
                    tag = v2.decode()
                elif f2 == 2:
                    kind, payload = "scalar", v2
                elif f2 == 5:
                    histo = {"bucket_limit": [], "bucket": []}
                    names = {1: "min", 2: "max", 3: "num", 4: "sum",
                             5: "sum_squares"}
                    for f3, _w3, v3 in _parse_fields(v2):
                        if f3 in names:
                            histo[names[f3]] = v3
                        elif f3 in (6, 7):
                            vals = [
                                struct.unpack("<d", v3[i:i + 8])[0]
                                for i in range(0, len(v3), 8)
                            ]
                            histo["bucket_limit" if f3 == 6 else "bucket"] = vals
                    kind, payload = "histogram", histo
                elif f2 == 4:
                    img = {}
                    for f3, _w3, v3 in _parse_fields(v2):
                        if f3 == 1:
                            img["height"] = v3
                        elif f3 == 2:
                            img["width"] = v3
                        elif f3 == 4:
                            img["png"] = v3
                    kind, payload = "image", img
            events.append({"step": step, "tag": tag, "kind": kind,
                           "value": payload})
    return events
