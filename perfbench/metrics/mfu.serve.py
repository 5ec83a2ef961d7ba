"""The model's share of the card's peak while serving: the model flops of
the traced slice over (its seconds x 989e12, the dense bf16 rate), in %.
Model flops: 2 x the matmul weights (every projection and the LM head)
for each token a forward was needed for (prompt tokens prefilled and
decode lanes that decode; padding and frozen lanes excluded), attention's
score and value products over the keys each of them attended (4 L H Dh a
key), and the SSD recurrence's own flops (``harness.roofline``)."""
from perfbench.harness.roofline import PEAK_FLOPS


def read(ctx):
    flops = ctx.work["model_flops"]
    if not flops or ctx.seconds <= 0:
        return None
    return 100.0 * flops / (ctx.seconds * PEAK_FLOPS)
