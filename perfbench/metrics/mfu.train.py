"""The model's share of the card's peak while training: the model flops of
the train steps inside the traced slice (6 x the matmul weights x tokens,
plus 12 L H Dh S a token for attention forward and backward) over (the
slice's seconds x 989e12), in %."""
from perfbench.harness.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.steps or ctx.seconds <= 0:
        return None
    return 100.0 * ctx.steps * ctx.flops_per_step / (ctx.seconds * PEAK_FLOPS)
