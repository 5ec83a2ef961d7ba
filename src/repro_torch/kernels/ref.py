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

With ``sanitize`` it also runs the reference's ``analysis.sanitize`` checks
at the reference's points: nonfinite values and pre-ADC overflow of ``v``,
and the exponent span of each (row, block) (row) or of ``E(x) + E(w)``
each (row, block, col) (unit). Audit markers: the values contraction runs
under ``cim_values``, unit granularity's denominator under ``cim_gains``.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FPFormat, decompose, pow2i, quantize
from repro_torch.core.mac import adc_quantize
from repro_torch.core.scopes import named_scope

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
    sanitize: bool = False,
    tag: str = "",
) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32; ``K`` a multiple of ``n_r``.

    Block terms are laid out (B, M, N) with B = K / n_r blocks.
    ``sanitize`` / ``tag``: the sanitizer's checks, named by ``tag``
    (nothing is checked without ``sanitize``).
    """
    grmac_matmul_ref.calls += 1
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
    with named_scope("cim_values"):
        num = torch.bmm(xb, wb)                         # (B, M, N)
    if sanitize:
        from repro_torch.analysis import sanitize as san

    if granularity == "conv":
        v = num / n_r
        if sanitize:
            san.check_values(tag, v)
        z = adc_quantize(v, enob) * n_r
        return z.sum(dim=0)

    _, _, ex = decompose(xq, fmt_x)
    gxb = pow2i(ex).reshape(m, b, n_r).transpose(0, 1)  # (B, M, n_r)

    if granularity == "row":
        den = gxb.sum(dim=-1, keepdim=True)             # (B, M, 1)
        v = num * 2.0**fmt_x.e_max / den
        if sanitize:
            san.check_values(tag, v)
            exb = ex.reshape(m, b, n_r)
            san.check_gain_span(tag, exb.amax(-1) - exb.amin(-1))
        z = adc_quantize(v, enob) * (den * 2.0**-fmt_x.e_max)
        return z.sum(dim=0)

    if granularity == "unit":
        _, _, ew = decompose(wq, fmt_w)
        gwb = pow2i(ew).reshape(b, n_r, n)
        with named_scope("cim_gains"):
            den = torch.bmm(gxb, gwb)                   # (B, M, N)
        scale = 2.0 ** (fmt_x.e_max + fmt_w.e_max)
        v = num * scale / den
        if sanitize:
            san.check_values(tag, v)
            # span of E(x) + E(w) over each block's n_r rows, one row at
            # a time: (M, B, N), never (M, B, n_r, N)
            exb, ewb = ex.reshape(m, b, n_r), ew.reshape(b, n_r, n)
            hi = lo = exb[:, :, 0, None] + ewb[None, :, 0, :]
            for j in range(1, n_r):
                e_j = exb[:, :, j, None] + ewb[None, :, j, :]
                hi, lo = torch.maximum(hi, e_j), torch.minimum(lo, e_j)
            san.check_gain_span(tag, hi - lo)
        z = adc_quantize(v, enob) * (den / scale)
        return z.sum(dim=0)

    raise ValueError(f"unknown granularity {granularity!r}")


grmac_matmul_ref.calls = 0   # calls, counted by the invariant harness
