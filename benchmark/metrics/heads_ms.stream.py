"""Device ms per batch in the program's stage(s) bbox_head_nms, global_head_mc, noc_head."""

from benchlib import readers


def read(ctx):
    return readers.stage_ms(ctx, ('bbox_head_nms', 'global_head_mc', 'noc_head'))
