"""95th percentile of every request's latency in the untraced window, in ms."""

from benchlib import readers


def read(ctx):
    return readers.latency_p95_ms(ctx)
