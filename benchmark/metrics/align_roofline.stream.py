"""The proposals' align: the least time its inputs need (bytes at 3.35 TB/s, FLOPs at 67 TFLOP/s) over the device ms of stage align_proposals, in %."""

from benchlib import readers


def read(ctx):
    return readers.roofline(ctx, "align_proposals", "align_proposals")
