"""Device ms per batch in the program's stage(s) backbone_fpn."""

from benchlib import readers


def read(ctx):
    return readers.stage_ms(ctx, ('backbone_fpn',))
