"""``blend_launches_per_frame.dual``: launches a frame that blend two styles,
from the program's own counters: the ``blends`` that the chunk graph's
``captured`` recorded (``conv_stage.blends`` + ``finish.blends`` across the
recording) over the frames it holds.  None where the program counts no
blends."""


def read(o):
    return o.readings.get("blend_launches_per_frame")
