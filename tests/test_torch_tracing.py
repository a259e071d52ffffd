"""The port's tracing and utilities against the JAX package's, on the CPU:
CRC32C, the TensorBoard event files (the same bytes for a scalar, a
histogram and an image at a fixed wall time, read back by either package's
``read_events``), the metrics JSONL (equal but for its time fields), the
model summary and parameter count on a converted state, the per-leaf
statistics and 30-bucket histograms of the callbacks, ``utils/stats``,
``utils/proto``, the log file and the rate-limited stream."""

import io
import json
import logging
import types

import numpy as np
import pytest
import torch

from realtime_style_transfer_torch.config import ShapeConfig as TConfig
from realtime_style_transfer_torch.models.inference import make_inference_model
from realtime_style_transfer_torch.tracing import callbacks as tcb
from realtime_style_transfer_torch.tracing import logsetup as tlog
from realtime_style_transfer_torch.tracing import tensorboard as ttb
from realtime_style_transfer_torch.tracing import textsummary as tsum
from realtime_style_transfer_torch.tracing.metrics import MetricsWriter as TWriter
from realtime_style_transfer_torch.tracing.metrics import read_metrics as tread
from realtime_style_transfer_torch.utils import proto as tproto
from realtime_style_transfer_torch.utils import stats as tstats
from realtime_style_transfer_torch.weights import to_flax
from realtime_style_transfer_tpu.tracing import callbacks as jcb
from realtime_style_transfer_tpu.tracing import tensorboard as jtb
from realtime_style_transfer_tpu.tracing import textsummary as jsum
from realtime_style_transfer_tpu.tracing.metrics import MetricsWriter as JWriter
from realtime_style_transfer_tpu.tracing.metrics import read_metrics as jread
from realtime_style_transfer_tpu.utils import proto as jproto
from realtime_style_transfer_tpu.utils import stats as jstats

WALL = 1234567890.25
TINY = dict(resolution_divider=16, bottleneck_res_y=15, bottleneck_num_filters=4,
            num_channels=3, hdr=False, feature_extractor="dummy")


def test_crc32c_known_vectors():
    assert ttb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ttb.crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"a", bytes(range(256)) * 3):
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb._masked_crc(data) == jtb._masked_crc(data)


def _write_all(writer, **wall):
    writer.add_scalar("training/loss", 0.5, 1, **wall)
    writer.add_histogram_raw("weights/conv/kernel", 7, minimum=-1.0, maximum=1.0,
                             num=12.0, total=2.5, sum_squares=4.0,
                             bucket_limits=[0.0, 0.5, 1.0], buckets=[3.0, 4.0, 5.0], **wall)
    writer.add_image_png("validation/prediction", b"\x89PNG fake bytes", 6, 8, 2, **wall)
    writer.close()


def _event_file(directory):
    files = sorted(directory.glob("events.out.tfevents.*"))
    assert len(files) == 1, files
    return files[0]


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    # the JAX writer reads the clock for every wall time: fix it; the port's
    # takes the wall time as an argument
    monkeypatch.setattr(jtb, "time", types.SimpleNamespace(time=lambda: WALL))
    _write_all(jtb.EventFileWriter(tmp_path / "jax"))
    _write_all(ttb.EventFileWriter(tmp_path / "port", wall_time=WALL), wall_time=WALL)
    port, jax_file = _event_file(tmp_path / "port"), _event_file(tmp_path / "jax")
    assert port.read_bytes() == jax_file.read_bytes()
    assert port.name.split(".", 4)[-1] == jax_file.name.split(".", 4)[-1]  # host name
    events = ttb.read_events(port)
    assert events == jtb.read_events(jax_file)
    assert events[0] == {"kind": "file_version", "value": "brain.Event:2"}
    assert [(e["kind"], e["tag"], e["step"]) for e in events[1:]] == [
        ("scalar", "training/loss", 1), ("histogram", "weights/conv/kernel", 7),
        ("image", "validation/prediction", 2)]
    histo = events[2]["value"]
    assert histo["bucket"] == [3.0, 4.0, 5.0] and histo["sum_squares"] == 4.0
    assert events[3]["value"] == {"height": 6, "width": 8, "png": b"\x89PNG fake bytes"}


def test_read_events_rejects_a_corrupt_record(tmp_path):
    writer = ttb.EventFileWriter(tmp_path)
    writer.add_scalar("a", 1.0, 0)
    writer.close()
    path = _event_file(tmp_path)
    raw = bytearray(path.read_bytes())
    raw[-6] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_events(path)


def _drive(writer):
    writer.write_split_scalars({"loss": 1.5, "val_loss": 2.5, "steps": 3}, 0)
    writer.write_scalars({"a": 1.0}, 1, prefix="p/")
    writer.write_histogram("weights/x", bucket_limits=[0.5, 1.0], buckets=[2.0, 1.0],
                           minimum=0.0, maximum=1.0, total=1.5, sum_squares=1.25, step=2)
    writer.write_image_png("training/prediction", b"png", 2, 3, 2)
    writer.write_text("model/summary", "text")
    writer.close()


def test_metrics_writer_matches_jax(tmp_path):
    _drive(TWriter(tmp_path / "port"))
    _drive(JWriter(tmp_path / "jax"))

    def lines(d):
        out = []
        for line in (d / "metrics.jsonl").read_text().splitlines():
            event = json.loads(line)
            assert isinstance(event.pop("time"), float)
            out.append(event)
        return out

    assert lines(tmp_path / "port") == lines(tmp_path / "jax")
    assert tread(tmp_path / "port") == jread(tmp_path / "jax")
    assert (tmp_path / "port" / "model_summary.txt").read_text() == "text"
    kinds = [e["kind"] for e in ttb.read_events(_event_file(tmp_path / "port"))]
    assert kinds == [e["kind"] for e in jtb.read_events(_event_file(tmp_path / "jax"))]
    assert tread(tmp_path / "missing") == {}


@pytest.fixture(scope="module")
def tiny_params():
    model = make_inference_model(TConfig(**TINY), device="cpu", seed=3)
    return {k: v.detach() for k, v in model.named_parameters()}


@pytest.mark.parametrize("detailed", [False, True])
def test_model_summary_and_count_match_jax(tiny_params, detailed):
    flax_params = to_flax(tiny_params)["params"]
    assert tsum.count_parameters(tiny_params) == jsum.count_parameters(flax_params) == \
        sum(v.numel() for v in tiny_params.values())
    text = tsum.capture_model_summary(tiny_params, detailed=detailed)
    assert text == jsum.capture_model_summary(flax_params, detailed=detailed)
    assert "transfer" in text and "total parameters" in text


def test_tree_stats_match_jax(tiny_params):
    got = tcb._tree_stats(tiny_params, histogram=True)
    want = jcb._tree_stats(to_flax(tiny_params)["params"], histogram=True)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        for key in ("mean", "var", "sum", "sum_squares"):
            np.testing.assert_allclose(g[key], np.asarray(w[key]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {key}")
        for key in ("min", "max"):
            assert g[key] == np.asarray(w[key]), (name, key)
        np.testing.assert_allclose(g["bucket_limit"], np.asarray(w["bucket_limit"]),
                                   rtol=1e-6, atol=1e-7)
        assert len(g["bucket"]) == tcb.NUM_HISTOGRAM_BINS
        # an element on a bucket edge may land one bucket over where the two
        # linspaces round the edge differently
        diff = np.abs(g["bucket"] - np.asarray(w["bucket"])).sum()
        assert diff <= 2, (name, g["bucket"], w["bucket"])
        assert g["bucket"].sum() == np.asarray(w["bucket"]).sum(), name
    constant = tcb._leaf_stats(torch.full((3, 4), 2.0), True)
    assert constant["bucket"][0] == 12 and constant["bucket"][1:].sum() == 0


def test_stats_and_proto_match_jax(rng):
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = a + rng.standard_normal((5, 7)).astype(np.float32) * 0.1
    assert tstats.describe(a) == jstats.describe(a)
    assert tstats.comparison_table({"x": a, "y": b}) == jstats.comparison_table({"x": a, "y": b})
    assert tstats.comparison_table({"x": a}) == jstats.comparison_table({"x": a})
    payload = (tproto.enc_int64(1, -3) + tproto.enc_double(2, 0.5) + tproto.enc_float(3, 1.5)
               + tproto.enc_string(4, "tag") + tproto.enc_packed_int64s(5, [1, -2, 300]))
    assert payload == (jproto.enc_int64(1, -3) + jproto.enc_double(2, 0.5)
                       + jproto.enc_float(3, 1.5) + jproto.enc_string(4, "tag")
                       + jproto.enc_packed_int64s(5, [1, -2, 300]))
    fields = list(tproto.parse_fields(payload))
    assert fields == list(jproto.parse_fields(payload))
    assert tproto.parse_packed_int64s(fields[-1][2]) == [1, -2, 300]


def test_enable_logfile_writes_the_run_log(tmp_path):
    handler = tlog.enable_logfile(tmp_path / "run")
    try:
        logging.getLogger("rst.test").warning("hello %d", 7)
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()
    text = (tmp_path / "run" / "log.txt").read_text()
    assert "WARNING rst.test | hello 7" in text
    logging.getLogger("rst.test").warning("after")
    assert "after" not in (tmp_path / "run" / "log.txt").read_text()


def test_rate_limited_stream_drops_bursts(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(tlog.time, "monotonic", lambda: clock[0])
    out = io.StringIO()
    stream = tlog.RateLimitedStream(out, min_interval_s=0.25)
    for _ in range(4):
        stream.write("same\n")
    clock[0] += 1.0
    stream.write("same\n")          # past the interval: written
    stream.write("other\n")
    stream.flush()
    assert out.getvalue() == "same\n[3 duplicate lines suppressed]\nsame\nother\n"
    assert stream.getvalue() == out.getvalue()  # other attributes pass through
    formatted = tlog.ColorFormatter().format(logging.LogRecord(
        "x", logging.WARNING, __file__, 1, "msg", None, None))
    assert formatted.startswith(tlog.COLORS[logging.WARNING]) and "msg" in formatted
