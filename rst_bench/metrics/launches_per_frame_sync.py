"""``launches_per_frame.sync``: kernel launches a frame from the program's
own counters (``conv_stage.launches``, ``finish.launches`` and
``replay_graph.replays``), over the window's frames."""


def read(o):
    frames = o.readings["frames"]
    return o.readings["launches"] / frames if frames else None
