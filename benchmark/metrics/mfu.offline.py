"""The whole step's share of the chip's peak: the reference's model
FLOPs per item x items over the untraced window's whole time (the host's
clock), as a share of 989 TFLOP/s (dense bf16)."""

from benchlib import readers


def read(ctx):
    return readers.mfu(ctx)
