"""Device ms per batch in the program's stage(s) pnp."""

from benchlib import readers


def read(ctx):
    return readers.stage_ms(ctx, ('pnp',))
