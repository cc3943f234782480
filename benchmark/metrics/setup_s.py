"""Process start to the first timed request or step: imports, weights, builds or cache loads, warm-up."""


def read(ctx):
    return ctx.setup_s
