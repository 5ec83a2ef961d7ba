"""Peaks of the chip and the least time of a GR-MAC call, summed over the
projections a configuration's reference lists.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its 700 W limit.

``bound_ms`` is the least time one (M, K) @ (K, N) GR-MAC call can take:
each input byte read once (x in float32, the weight as 4-bit codes) and
the float32 output written once at the HBM rate, against the larger of
the values dot on the bf16 tensor cores (exact for these formats) and
ten float32 operations for each (row, K-block, column) epilogue (scale,
divide, 1/delta, rint, *delta, max, min, renormalizing scale, product,
accumulate) on the float32 pipe.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
EPILOGUE_OPS = 10
PEAK_FLOPS = BF16_TC_FLOPS      # the denominator of every mfu


def bound_ms(m: int, k: int, n: int, n_r: int, w_bits: float = 4) -> float:
    t_bytes = (4 * (m * k + m * n) + k * n * w_bits / 8) / HBM_BYTES_S
    t_ops = max(2 * m * k * n / BF16_TC_FLOPS,
                EPILOGUE_OPS * m * (-(-k // n_r)) * n / F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops)


def forward_bound_ms(projs: list, n_r: int, m: int, head: bool = True
                     ) -> float:
    """Least time of one forward's GR-MAC calls at M rows. ``projs``: the
    (K, N, calls) of every projection, the LM head last, as the
    configuration's reference counts them (``projections``); without the
    head when ``head`` is False (a remat recomputation)."""
    if not head:
        projs = projs[:-1]
    return sum(c * bound_ms(m, k, n, n_r) for k, n, c in projs)


def calls_per_forward(projs: list, head: bool = True) -> int:
    return sum(c for _, _, c in (projs if head else projs[:-1]))


def matmul_params(projs: list) -> int:
    """Weights that multiply each token: every projection, the LM head
    included, the embedding lookup not."""
    return sum(k * n * c for k, n, c in projs)
