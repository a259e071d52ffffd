"""``host_ms.sync``: host ms a frame spends inside ``stylize_prepacked``
(its 17 launches from Python and the tensors around them), the benchmark's
own span around each call before the synchronize, mean over the window."""


def read(o):
    frames = o.readings["frames"]
    return o.readings["host_s"] / frames * 1e3 if frames else None
