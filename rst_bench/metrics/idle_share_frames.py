"""``idle_share.frames``: the share of the traced window's wall span in which
no CUDA activity ran, from the union of the trace's device intervals."""


def read(o):
    if o.trace is None or not o.trace.window_s:
        return None
    return 100.0 * (1.0 - o.trace.busy_s / o.trace.window_s)
