"""The engine's prefill: the benchmark's spans around
``Engine.advance_prefill`` in the traced slice, their total over the
prompt tokens they dispatched, in ms. A chunk's logits stay on the
device, so a span is the host's enqueue of the chunk."""


def read(ctx):
    ts, te = ctx.slice
    spans = [(b - a, n) for a, b, n, _, _ in ctx.run.prefill_spans
             if ts <= a and b <= te]
    tokens = sum(n for _, n in spans)
    return 1e3 * sum(d for d, _ in spans) / tokens if tokens else None
