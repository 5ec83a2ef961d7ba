"""What the SSM block's per-token prefill loop costs the host: the host
time of the program's ``ssm.recurrence`` scopes (a layer's loop over a
chunk) inside its ``engine.prefill[...]`` scopes in the traced slice,
over the prompt tokens the slice's chunks prefilled, in ms. Nothing is
returned when the slice holds no such scope (a program without them)."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    loops = scopes.inside(scopes.interval(host, "ssm.recurrence"),
                          scopes.interval(host, "engine.prefill["))
    tokens = ctx.work["prompt_tokens"]
    if not loops or not tokens:
        return None
    return 1e-3 * sum(e - s for s, e in loops) / tokens
