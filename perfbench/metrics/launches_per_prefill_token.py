"""CUDA kernel launches a prompt token: the profiler's ``cudaLaunchKernel``
and ``cuLaunchKernel`` calls inside the ``Engine.advance_prefill`` spans
of the traced slice, over the prompt tokens those chunks prefilled."""


def read(ctx):
    tokens = ctx.work["prompt_tokens"]
    if not tokens:
        return None
    return ctx.trace.launches_in.get("Engine.advance_prefill", 0) / tokens
