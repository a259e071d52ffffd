"""``conv_window_kernel_roofline.dual``: ``conv_window_kernel`` (the stem and the
final conv) in two-style frames, against its bound with the final's weight
plane and second-style rows read."""

from ._roofline_dual import share


def read(o):
    return share(o, "conv_window_kernel")
