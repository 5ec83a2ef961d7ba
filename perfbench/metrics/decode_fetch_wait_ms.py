"""The host waiting for the device in a decode step: the program's
``engine.fetch`` scopes (``Engine._fetch``, the step's one device-to-host
copy of its ids) inside the benchmark's ``Engine.step`` spans of the
traced slice, their mean duration in ms."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    return scopes.mean_ms(scopes.inside(
        scopes.interval(host, "engine.fetch"),
        scopes.interval(host, "Engine.step")))
