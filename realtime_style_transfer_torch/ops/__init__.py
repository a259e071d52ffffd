"""Core ops of the port: CIN, style-param cursor, convs, and the fused transfer path
with its CUDA kernels."""
