"""``conv_window_kernel_roofline``: ``conv_window_kernel`` (the stem and the final conv,
the window path of ``csrc/conv_stage.cu``) against its frozen bound."""

from ._roofline import share


def read(o):
    return share(o, "conv_window_kernel")
