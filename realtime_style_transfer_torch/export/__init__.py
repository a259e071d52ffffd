"""Deployable-artifact exporters: ONNX here; the ``torch.export`` programs
are written by :mod:`..save_using_checkpoint`."""

from .onnx import export_predictor_onnx, export_transfer_onnx  # noqa: F401
