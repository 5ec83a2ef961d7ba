"""Bit-faithful simulation of the conventional INT-MAC and the GR-MAC
columns (the port's counterpart of ``repro.core.mac``).

A "column" is one analog accumulation line with ``n_r`` contributing unit
cells (paper Fig. 4). The simulators take already *format-quantized*
inputs ``x_q`` and weights ``w_q`` of shape ``(..., n_r)`` and return the
analog compute-line voltage ``v`` (in [-1, 1]), the digital
renormalization ``scale`` such that the dot product is ``v * scale``, and
the ADC-quantized output ``z_hat``:

    INT-MAC (§III-B1)     v = (1/n_r) Σ x_i w_i,  z_hat = Q(v) n_r
    GR-MAC row (§III-C2)  v = Σ s_i M_i w_i 2^E_i / Σ 2^E_i,
                          z_hat = Q(v) Σ 2^E_i 2^-e_max
    GR-MAC unit (§III-C1) as row, with E = E_x + E_W and the weight's
                          mantissa too, renormalized by 2^-(e_max,x + e_max,w)

Both GR variants reconstruct Σ x_i w_i exactly with an ideal ADC; they
differ in the voltage amplitude the ADC sees. ``mismatch_gains`` models
capacitor mismatch (Pelgrom, §III-E1). The ADC's step comes from
``adc_delta`` on every path, the GR-MAC kernel's too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .formats import FPFormat, decompose, pow2i

__all__ = ["adc_delta", "adc_quantize", "MacOutput", "int_mac", "n_eff",
           "mismatch_gains", "gr_mac_row", "gr_mac_unit", "global_normalize"]


def adc_delta(enob: float, dtype: torch.dtype = torch.float32) -> float:
    """The ADC step ``2 / 2**enob``, computed once on the host in ``dtype``.

    Every path (the plain version on any device and the CUDA kernel) takes
    the step from here, so they agree on its bits even at fractional ENOB,
    where ``exp2`` differs between backends. At integer ENOB the step is an
    exact power of two.
    """
    return float(2.0 / torch.exp2(torch.tensor(float(enob), dtype=dtype)))


def adc_quantize(v: torch.Tensor, enob: float) -> torch.Tensor:
    """Mid-tread uniform ADC on [-1, 1] with step ``adc_delta(enob)``."""
    delta = adc_delta(enob, v.dtype)
    return torch.clamp(torch.round(v / delta) * delta, -1.0, 1.0)


@dataclasses.dataclass
class MacOutput:
    v: torch.Tensor       # analog compute-line voltage in [-1, 1]
    scale: torch.Tensor   # digital renormalization factor
    z: torch.Tensor       # ideal dot product (no ADC), == v * scale
    z_hat: torch.Tensor   # ADC-quantized output, == Q(v) * scale
    n_eff: Optional[torch.Tensor] = None  # effective contributors (GR only)


def int_mac(x_q: torch.Tensor, w_q: torch.Tensor, enob: float) -> MacOutput:
    """Conventional charge-domain INT-MAC column (uniform averaging)."""
    n_r = x_q.shape[-1]
    v = torch.sum(x_q * w_q, dim=-1) / n_r
    scale = torch.full_like(v, float(n_r))
    return MacOutput(v=v, scale=scale, z=v * scale,
                     z_hat=adc_quantize(v, enob) * scale)


def n_eff(gains: torch.Tensor) -> torch.Tensor:
    """Effective number of contributors of a weighted average (§III-B2):
    (Σ g_i)^2 / Σ g_i^2 with g_i = 2^E_i."""
    s1 = torch.sum(gains, dim=-1)
    s2 = torch.sum(torch.square(gains), dim=-1)
    return torch.square(s1) / torch.clamp(s2, min=1e-30)


def mismatch_gains(generator: torch.Generator, e: torch.Tensor,
                   k_c_pct_sqrt_ff: float,
                   c_unit_ff: float = 1.0) -> torch.Tensor:
    """Per-cell multiplicative coupling-gain error from capacitor mismatch:
    sigma(dC/C) = K_C / sqrt(C), C = 2^(E-1) c_unit_ff (the coupling
    ladder); ``k_c_pct_sqrt_ff`` in %·sqrt(fF) (paper range 0.45–0.85).
    Drawn by ``generator``, which must live on ``e``'s device."""
    c = torch.exp2(e.to(torch.float32) - 1.0) * c_unit_ff
    sigma = (k_c_pct_sqrt_ff / 100.0) / torch.sqrt(c)
    return 1.0 + sigma * torch.randn(e.shape, generator=generator,
                                     device=e.device)


def _gr_output(num, g, scale_exp: int, enob: float) -> MacOutput:
    den = torch.sum(g, dim=-1)
    v = num / den
    scale = den * 2.0 ** (-scale_exp)
    return MacOutput(v=v, scale=scale, z=v * scale,
                     z_hat=adc_quantize(v, enob) * scale, n_eff=n_eff(g))


def gr_mac_row(x_q: torch.Tensor, w_q: torch.Tensor, fmt_x: FPFormat,
               enob: float,
               gain_err: Optional[torch.Tensor] = None) -> MacOutput:
    """GR-MAC with row (input-only) normalization: the weights arrive
    pre-aligned (their values in [-1, 1]); only the inputs are decomposed
    and gain-ranged by 2^E_x."""
    s, m, e = decompose(x_q, fmt_x)
    g = pow2i(e).to(x_q.dtype)
    if gain_err is not None:
        g = g * gain_err
    return _gr_output(torch.sum(s * m * w_q * g, dim=-1), g, fmt_x.e_max,
                      enob)


def gr_mac_unit(x_q: torch.Tensor, w_q: torch.Tensor, fmt_x: FPFormat,
                fmt_w: FPFormat, enob: float,
                gain_err: Optional[torch.Tensor] = None) -> MacOutput:
    """GR-MAC with unit (input and weight) normalization."""
    sx, mx, ex = decompose(x_q, fmt_x)
    sw, mw, ew = decompose(w_q, fmt_w)
    g = pow2i(ex + ew).to(x_q.dtype)
    if gain_err is not None:
        g = g * gain_err
    return _gr_output(torch.sum(sx * sw * mx * mw * g, dim=-1), g,
                      fmt_x.e_max + fmt_w.e_max, enob)


def global_normalize(x_q: torch.Tensor, fmt: FPFormat, int_bits: int):
    """Block-wise FP->INT conversion (the conventional pipeline, §II-B2):
    every value of the trailing-axis block is aligned to the block's
    largest exponent on an ``int_bits``-wide integer grid. Returns (aligned
    values in [-1, 1], block scale 2^(E - e_max)) with x ≈ aligned * scale;
    the shifted-out LSBs are the fidelity the GR-MAC keeps."""
    _, _, e = decompose(x_q, fmt)
    e_blk = torch.amax(e, dim=-1, keepdim=True)
    scale = pow2i(e_blk - fmt.e_max).to(x_q.dtype)
    step = 2.0 ** (1 - int_bits)
    aligned = torch.round((x_q / scale) / step) * step
    return torch.clamp(aligned, -1.0, 1.0), scale
