"""Device launches per batch in the program's stage pnp."""

from benchlib import readers


def read(ctx):
    return readers.stage_launches(ctx, "pnp")
