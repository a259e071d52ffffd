"""``mfu.frames``: the whole frame's share of the card's bf16 peak over the
traced window, all from the trace: the frozen operations of a frame times the
frames the card finished there (one ``finish_kernel`` launch a frame), over
the trace's span from its first device activity to its last, against the
data sheet's 989 TFLOP/s."""

from ..yardstick import PEAK_FLOPS, frame_flops


def read(o):
    if o.trace is None or not o.trace.span_s:
        return None
    _seconds, frames = o.trace.kernel("finish_kernel")
    if not frames:
        return None
    return 100.0 * frame_flops(o.cfg) * frames / o.trace.span_s / PEAK_FLOPS["bf16"]
