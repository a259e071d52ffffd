"""Backbones of the style predictor."""
