"""Numerics core of the port: formats, the ADC, and the CIM config."""
from repro_torch.core.cim_config import SITES, CIMConfig, SiteDesign
from repro_torch.core.formats import (
    FP4_E2M1,
    FP6_E2M3,
    FP6_E3M2,
    FP8_E4M3,
    FPFormat,
    IntFormat,
)

__all__ = ["SITES", "CIMConfig", "SiteDesign", "FPFormat", "IntFormat",
           "FP4_E2M1", "FP6_E2M3", "FP6_E3M2", "FP8_E4M3"]
