"""The plain PyTorch version of the GR-MAC matmul.

It states the semantics the CUDA kernel (``kernels/grmac_matmul.py``)
must reproduce, runs every CPU path of the port, and is what the kernel is
held against on the card. It mirrors ``repro.kernels.ref`` operation for
operation:

The K dimension is processed in blocks of ``n_r`` (one analog CIM column
accumulation + one ADC conversion per block). Inputs are pre-scaled into
[-1, 1]; weights arrive already quantized onto their format grid. All math
in float32.

  row:   xq = Q_fmt_x(x);  g = 2^{E(xq)};  num = xq_blk @ wq_blk
         den = Σ_k g_blk (per row);  v = num * 2^{e_max_x} / den
         out += Q_ADC(v) * den * 2^{-e_max_x}
  unit:  additionally gw = 2^{E(wq)} and den = g_blk @ gw_blk (per row×col),
         v = num * 2^{e_max_x + e_max_w} / den, renormalized accordingly.
  conv:  v = (xq_blk @ wq_blk) / n_r;  out += Q_ADC(v) * n_r
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FPFormat, decompose, pow2i, quantize
from repro_torch.core.mac import adc_quantize

__all__ = ["grmac_matmul_ref"]


def grmac_matmul_ref(
    x: torch.Tensor,
    wq: torch.Tensor,
    *,
    fmt_x: FPFormat,
    fmt_w: FPFormat,
    n_r: int = 32,
    enob: float = 8.0,
    granularity: str = "row",
) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32; ``K`` a multiple of ``n_r``.

    Block terms are laid out (B, M, N) with B = K / n_r blocks.
    """
    x = x.to(torch.float32)
    wq = wq.to(torch.float32)
    m, k = x.shape
    k2, n = wq.shape
    if k != k2 or k % n_r:
        raise ValueError(f"shapes ({m},{k})x({k2},{n}) need equal K, a "
                         f"multiple of n_r={n_r}")
    b = k // n_r
    xq = quantize(x, fmt_x)
    xb = xq.reshape(m, b, n_r).transpose(0, 1)          # (B, M, n_r)
    wb = wq.reshape(b, n_r, n)                          # (B, n_r, N)
    num = torch.bmm(xb, wb)                             # (B, M, N)

    if granularity == "conv":
        v = num / n_r
        z = adc_quantize(v, enob) * n_r
        return z.sum(dim=0)

    _, _, ex = decompose(xq, fmt_x)
    gxb = pow2i(ex).reshape(m, b, n_r).transpose(0, 1)  # (B, M, n_r)

    if granularity == "row":
        den = gxb.sum(dim=-1, keepdim=True)             # (B, M, 1)
        v = num * 2.0**fmt_x.e_max / den
        z = adc_quantize(v, enob) * (den * 2.0**-fmt_x.e_max)
        return z.sum(dim=0)

    if granularity == "unit":
        _, _, ew = decompose(wq, fmt_w)
        gwb = pow2i(ew).reshape(b, n_r, n)
        den = torch.bmm(gxb, gwb)                       # (B, M, N)
        scale = 2.0 ** (fmt_x.e_max + fmt_w.e_max)
        v = num * scale / den
        z = adc_quantize(v, enob) * (den / scale)
        return z.sum(dim=0)

    raise ValueError(f"unknown granularity {granularity!r}")
