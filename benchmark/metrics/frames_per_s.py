"""Frames whose detections reached the host in the untraced window, over the window's whole time."""

from benchlib import readers


def read(ctx):
    return readers.items_per_s(ctx)
