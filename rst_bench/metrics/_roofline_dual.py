"""A ``conv_stage.cu`` kernel's share of its roofline over a traced window of
two-style frames: :mod:`._roofline`'s share against the dual yardstick
(:func:`..yardstick_dual.path_bounds`, which adds the blend's reads)."""

from ..yardstick_dual import path_bounds


def share(o, kernel: str):
    if o.trace is None:
        return None
    seconds, launches = o.trace.kernel(kernel)
    bound, per_frame = path_bounds(o.cfg)[kernel]
    if not launches or not seconds or not per_frame:
        return None
    return 100.0 * bound / per_frame * launches / seconds
