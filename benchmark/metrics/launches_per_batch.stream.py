"""Every device launch of the traced window, per batch."""


def read(ctx):
    r = ctx.reduced
    return None if r is None else r.launches / r.units
