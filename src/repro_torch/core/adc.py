"""Monte-Carlo ADC resolution (ENOB) requirement solver (paper §IV-A); the
port's counterpart of ``repro.core.adc``.

The ADC must keep its noise at least 6 dB below the output-referred
quantization noise of the input format:

    SNR_ADC >= SQNR_out + 6 dB  <=>  P_adc <= P_qnoise_out / 10^0.6

Only input quantization noise counts (Fig. 10): the weights are exact
signal, sampled on their format grid. Referred to the dot product, the ADC
noise is P_adc = (Δ² / 12) · E[scale²], with the architecture's digital
renormalization ``scale`` (``n_r`` for the INT-MAC, the data-dependent
Σ 2^E · 2^-e_max for the GR-MAC), and ENOB = log2(V_FS / Δ), V_FS = 2:
fractional. The arithmetic is the reference's, in f32.

Samples come from an explicit ``torch.Generator`` on an explicit device:
the CPU and the card draw different streams from one seed, so a seeded
solve is a Monte-Carlo estimate that differs between them (and from the
reference's ``jax.random`` stream) by the estimator's own spread.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from .device import resolve_device
from .distributions import Distribution, max_entropy, uniform
from .formats import FP4_E2M1, FPFormat, IntFormat, quantize_any
from .mac import gr_mac_row, gr_mac_unit, int_mac

__all__ = ["EnobResult", "required_enob", "solve_required_enob",
           "narrowest_uniform", "ARCHS"]

ARCHS = ("conv", "gr_row", "gr_unit")
_MARGIN_DB = 6.0


@dataclasses.dataclass
class EnobResult:
    enob: float             # required ADC resolution (fractional bits)
    sqnr_out_db: float      # output-referred SQNR from input quantization
    sig_power: float        # P(z_ref)
    qnoise_power: float     # P(z_q - z_ref)
    mean_scale_sq: float    # E[scale²] of the renormalization factor
    n_eff_mean: Optional[float] = None  # GR only


def required_enob(
    generator: torch.Generator,
    arch: str,
    dist_x: Distribution,
    fmt_x: Union[FPFormat, IntFormat],
    n_r: int = 32,
    fmt_w: FPFormat = FP4_E2M1,
    dist_w: Optional[Distribution] = None,
    n_cols: int = 1 << 14,
    margin_db: float = _MARGIN_DB,
) -> EnobResult:
    """The minimum ADC ENOB of one (architecture, input condition).

    ``arch``: "conv" (FP->INT direct accumulation), "gr_row" or "gr_unit".
    An IntFormat input has no exponent to range on: "conv" semantics apply
    (pass "gr_unit" for INT normalization through the weight format; the
    inputs then carry one exponent bin). ``n_cols`` columns of ``n_r``
    cells are drawn, the inputs first, then the weights (max-entropy on
    ``fmt_w`` unless ``dist_w`` says otherwise).
    """
    shape = (n_cols, n_r)
    x = dist_x(generator, shape)
    if dist_w is None:
        dist_w = max_entropy(fmt_w)
    w_q = dist_w(generator, shape)  # on the weight grid for max-entropy
    x_q = quantize_any(x, fmt_x)

    # output-referred input-quantization noise (the budget reference)
    z_ref = torch.sum(x * w_q, dim=-1)
    z_q = torch.sum(x_q * w_q, dim=-1)
    p_sig = torch.mean(torch.square(z_ref))
    p_qn = torch.mean(torch.square(z_q - z_ref))

    # renormalization-scale statistics (ENOB-independent: a dummy ENOB)
    n_eff_mean = None
    if arch == "conv" or isinstance(fmt_x, IntFormat):
        out = int_mac(x_q, w_q, 16.0)
    elif arch == "gr_row":
        out = gr_mac_row(x_q, w_q, fmt_x, 16.0)
    elif arch == "gr_unit":
        out = gr_mac_unit(x_q, w_q, fmt_x, fmt_w, 16.0)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    mean_scale_sq = torch.mean(torch.square(out.scale))
    if out.n_eff is not None:
        n_eff_mean = float(torch.mean(out.n_eff))

    # Δ² / 12 · E[scale²] <= P_qn / 10^(margin / 10)
    p_allowed = p_qn / 10.0 ** (margin_db / 10.0)
    delta = torch.sqrt(12.0 * p_allowed / torch.clamp(mean_scale_sq,
                                                      min=1e-30))
    enob = torch.log2(2.0 / delta)
    return EnobResult(
        enob=float(enob),
        sqnr_out_db=float(10.0 * torch.log10(
            p_sig / torch.clamp(p_qn, min=1e-30))),
        sig_power=float(p_sig),
        qnoise_power=float(p_qn),
        mean_scale_sq=float(mean_scale_sq),
        n_eff_mean=n_eff_mean,
    )


def narrowest_uniform(fmt: Union[FPFormat, IntFormat]) -> Distribution:
    """Uniform input at the narrowest valid bounds of the format (§IV-B):
    twice the minimum normal value for FP, full scale for INT; the
    reference input condition for dimensioning converters."""
    if isinstance(fmt, IntFormat):
        return uniform(1.0)
    return uniform(min(1.0, 2.0 * fmt.min_normal))


def solve_required_enob(
    arch: str,
    fmt_x: Union[FPFormat, IntFormat],
    n_r: int = 32,
    fmt_w: FPFormat = FP4_E2M1,
    n_cols: int = 1 << 14,
    seed: int = 0,
    margin_db: float = _MARGIN_DB,
    device=None,
) -> EnobResult:
    """``required_enob`` at the paper's reference input condition
    (``narrowest_uniform(fmt_x)``), drawn by a generator seeded with
    ``seed`` on ``device`` (None: the card).

    Memoized on the full tuple (arch, fmt_x, n_r, fmt_w, n_cols, seed,
    margin_db) and the device's type, so the per-site DSE sweep pays each
    distinct solve once per process; the device type is part of the key
    because the CPU and the card draw different streams from one seed."""
    return _solve(arch, fmt_x, n_r, fmt_w, n_cols, seed, margin_db,
                  resolve_device(device).type)


@functools.lru_cache(maxsize=8192)
def _solve(arch, fmt_x, n_r, fmt_w, n_cols, seed, margin_db, device_type):
    gen = torch.Generator(device=device_type).manual_seed(seed)
    return required_enob(gen, arch, narrowest_uniform(fmt_x), fmt_x,
                         n_r=n_r, fmt_w=fmt_w, n_cols=n_cols,
                         margin_db=margin_db)
