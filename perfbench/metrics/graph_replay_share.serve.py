"""The engine's dispatches replayed from CUDA graphs while serving: of the
program's ``engine.decode[...]`` and ``engine.prefill[...]`` scopes of the
traced slice, the share that holds a ``cudaGraphLaunch`` runtime call, in
%. Nothing is returned when the slice holds none of those scopes."""
from perfbench.harness import scopes


def read(ctx):
    host = ctx.trace._cpu
    dispatches = sorted(scopes.interval(host, "engine.decode[")
                        + scopes.interval(host, "engine.prefill["))
    if not dispatches:
        return None
    replays = scopes.holding(dispatches,
                             scopes.interval(host, "cudaGraphLaunch"))
    return 100.0 * len(replays) / len(dispatches)
