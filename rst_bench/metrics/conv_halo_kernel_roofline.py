"""``conv_halo_kernel_roofline``: ``conv_halo_kernel`` (the residual convs, res0a, the
contracts c1.. and the expands e0.., the halo and strided paths of
``csrc/conv_stage.cu``) against its frozen bound."""

from ._roofline import share


def read(o):
    return share(o, "conv_halo_kernel")
