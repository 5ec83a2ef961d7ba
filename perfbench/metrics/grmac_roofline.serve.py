"""The GR-MAC kernel's share of its roofline while serving: the least time
(``harness.roofline.bound_ms``) of every GR-MAC call of the dispatches in
the traced slice (M = lanes x bucket in a prefill chunk, lanes in a
decode step), over the device time of the kernels whose name contains
``grmac``, in %. Nothing is returned when the profiler's count of those
kernels is not the dispatches' count of calls."""
from perfbench.harness import roofline


def read(ctx):
    projs, n_r = ctx.projections, ctx.n_r
    lanes = ctx.cell.mix["engine"]["batch_slots"]
    w = ctx.work
    calls = roofline.calls_per_forward(projs)
    bound = w["decode_steps"] * roofline.forward_bound_ms(projs, n_r, lanes)
    n = w["decode_steps"] * calls
    for bucket, count in w["prefill_dispatches"].items():
        bound += count * roofline.forward_bound_ms(projs, n_r,
                                                   lanes * bucket)
        n += count * calls
    secs, launched = ctx.trace.device_seconds("grmac")
    if not launched or launched != n:
        return None
    return 100.0 * bound * 1e-3 / secs
