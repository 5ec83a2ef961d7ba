"""The host's enqueue of a decode step: the program's
``engine.decode[...]`` scopes (``Engine._dispatch``) inside the
benchmark's ``Engine.step`` spans of the traced slice, their mean
duration in ms (the forward's launches and the token selection; the
step's fetch lies outside)."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    return scopes.mean_ms(scopes.inside(
        scopes.interval(host, "engine.decode["),
        scopes.interval(host, "Engine.step")))
