"""The scheduler's own host cost a step: the time in the program's
``sched.step`` scopes of the traced slice that neither an ``engine.*``
scope nor one of the benchmark's ``Engine.*`` spans around the engine's
entry points covers, over the steps, in ms."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    steps = scopes.interval(host, "sched.step")
    if not steps:
        return None
    engine = scopes.interval(host, "engine.") + scopes.interval(
        host, "Engine.")
    own = [scopes.uncovered(s, scopes.inside(engine, [s])) for s in steps]
    return 1e-3 * sum(own) / len(steps)
