"""The share of the traced slice in which no operation ran on the card:
100 x (1 - busy / window), busy the union of the profiler's device
intervals."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
