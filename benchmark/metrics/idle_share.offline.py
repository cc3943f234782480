"""1 - the union of device-busy intervals over the traced window's wall, in %."""

from benchlib import readers


def read(ctx):
    return readers.idle_share(ctx)
