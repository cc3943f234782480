"""Frames whose detections reached the host in the stream cell's
untraced window, over the window's whole time (its closed loop's rate)."""

from benchlib import readers


def read(ctx):
    return readers.items_per_s(ctx)
