"""Recurrence steps the SSM block runs for each prompt token it prefills:
the program's ``ssm.step`` scopes (one a time step of a layer, padded
steps included) inside its ``engine.prefill[...]`` scopes in the traced
slice, over the slice's prompt tokens x ``n_layers``. 1.0 when no padded
step runs; a chunk padded to its bucket reads more. Nothing is returned
when the slice holds no such scope (a program without them)."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    steps = scopes.inside(scopes.interval(host, "ssm.step"),
                          scopes.interval(host, "engine.prefill["))
    tokens = ctx.work["prompt_tokens"]
    if not steps or not tokens:
        return None
    return len(steps) / (tokens * ctx.arch["n_layers"])
