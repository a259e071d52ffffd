"""The benchmark of ``realtime_style_transfer_torch``: ``python3 rst_bench/run.py``."""
