"""``conv_halo_kernel_roofline.dual``: ``conv_halo_kernel`` (res0a, the residual
convs, the contracts and the expands) in two-style frames, against its bound
with the blend's weight planes and second-style rows read."""

from ._roofline_dual import share


def read(o):
    return share(o, "conv_halo_kernel")
