"""The engine's decode step: the benchmark's spans around ``Engine.step``
in the traced slice, their total over their count, in ms (a step ends
with the fetch of its tokens, so a span holds the device's work too)."""


def read(ctx):
    ts, te = ctx.slice
    d = [b - a for a, b, _ in ctx.run.decode_spans if ts <= a and b <= te]
    return 1e3 * sum(d) / len(d) if d else None
