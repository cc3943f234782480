"""Device ms per batch in the program's stage(s) score_3d_nms."""

from benchlib import readers


def read(ctx):
    return readers.stage_ms(ctx, ('score_3d_nms',))
