"""CUDA kernel launches a decode step: the profiler's ``cudaLaunchKernel``
and ``cuLaunchKernel`` calls inside the ``Engine.step`` spans of the traced
slice, over the number of those spans."""


def read(ctx):
    n = ctx.trace.span_count.get("Engine.step", 0)
    return ctx.trace.launches_in.get("Engine.step", 0) / n if n else None
