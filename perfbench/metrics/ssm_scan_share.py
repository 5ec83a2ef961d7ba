"""How much of the SSM block's prefill recurrence runs as the card's scan:
of the program's ``ssm.recurrence`` scopes (a layer's recurrence over a
chunk) inside its ``engine.prefill[...]`` scopes in the traced slice, the
share that holds an ``ssm.scan`` scope (the scan's launch), in %. 0 for a
program that runs the recurrence step by step; nothing is returned when
the slice holds no such ``ssm.recurrence`` scope."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    loops = scopes.inside(scopes.interval(host, "ssm.recurrence"),
                          scopes.interval(host, "engine.prefill["))
    if not loops:
        return None
    scans = scopes.holding(loops, scopes.interval(host, "ssm.scan"))
    return 100.0 * len(scans) / len(loops)
