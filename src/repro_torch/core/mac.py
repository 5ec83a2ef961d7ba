"""The ADC of one analog CIM column.

Only the converter is here so far; the column simulators (INT-MAC and the
GR-MAC rows/units) belong to the energy model and come with it.
"""
from __future__ import annotations

import torch

__all__ = ["adc_delta", "adc_quantize"]


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
