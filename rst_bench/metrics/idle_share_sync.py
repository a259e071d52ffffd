"""``idle_share.sync``: ``idle_share.frames`` in the closed loop, where the
card waits on the host's launches and the synchronize."""

from .idle_share_frames import read  # noqa: F401
