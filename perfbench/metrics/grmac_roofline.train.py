"""The GR-MAC kernel's share of its roofline while training: the least
time of every GR-MAC call of the train steps in the traced slice (each
step's forward at M = batch x sequence, and remat's recomputation of the
layers without the LM head), over the device time of the kernels whose
name contains ``grmac``, in %. Nothing is returned when the profiler's
count of those kernels is not the steps' count of calls."""
from perfbench.harness import roofline


def read(ctx):
    projs, n_r, mix = ctx.projections, ctx.n_r, ctx.cell.mix
    m = mix["batch"] * mix["seq_len"]
    per_step = (roofline.forward_bound_ms(projs, n_r, m)
                + roofline.forward_bound_ms(projs, n_r, m, head=False))
    calls = (roofline.calls_per_forward(projs)
             + roofline.calls_per_forward(projs, head=False))
    secs, launched = ctx.trace.device_seconds("grmac")
    if not ctx.steps or launched != ctx.steps * calls:
        return None
    return 100.0 * ctx.steps * per_step * 1e-3 / secs
