"""Device ms per batch in the program's stage(s) rpn_proposals."""

from benchlib import readers


def read(ctx):
    return readers.stage_ms(ctx, ('rpn_proposals',))
