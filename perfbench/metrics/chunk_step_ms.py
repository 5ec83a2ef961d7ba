"""The scheduler steps that carry a prefill chunk, the steps that set the
tail of the gaps between tokens: the program's ``sched.step`` scopes of
the traced slice that hold an ``engine.prefill[...]`` scope, their mean
duration in ms."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    return scopes.mean_ms(scopes.holding(
        scopes.interval(host, "sched.step"),
        scopes.interval(host, "engine.prefill[")))
