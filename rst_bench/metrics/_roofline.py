"""A ``conv_stage.cu`` kernel's share of its roofline over a traced window:
the frozen least time of its launches (:func:`..yardstick.path_bounds`, per
launch of a frame, times the launches the trace holds) over their device
time in the trace."""

from ..yardstick import path_bounds


def share(o, kernel: str):
    if o.trace is None:
        return None
    seconds, launches = o.trace.kernel(kernel)
    bound, per_frame = path_bounds(o.cfg)[kernel]
    if not launches or not seconds or not per_frame:
        return None
    return 100.0 * bound / per_frame * launches / seconds
