"""Numerics core of the port: formats, the MAC signal chains, the CIM
config, the ADC requirement solver, the energy model, the cost ledger and
the design-space exploration. ``costs`` and ``dse`` are modules of their
own (``repro_torch.core.costs``, ``repro_torch.core.dse``)."""
from repro_torch.core.adc import EnobResult, required_enob, solve_required_enob
from repro_torch.core.cim_config import SITES, CIMConfig, SiteDesign
from repro_torch.core.distributions import (DISTRIBUTIONS, Distribution,
                                            gaussian_outliers, max_entropy,
                                            uniform)
from repro_torch.core.energy import (CimDesign, EnergyBreakdown, TechParams,
                                     energy_per_op_fj)
from repro_torch.core.formats import (
    FP4_E2M1,
    FP6_E2M3,
    FP6_E3M2,
    FP8_E4M3,
    FPFormat,
    IntFormat,
    decompose,
    int_quantize,
    max_entropy_sample,
    quantize,
    sqnr_db,
)
from repro_torch.core.mac import (MacOutput, adc_quantize, gr_mac_row,
                                  gr_mac_unit, int_mac, n_eff)

__all__ = ["SITES", "CIMConfig", "SiteDesign", "FPFormat", "IntFormat",
           "FP4_E2M1", "FP6_E2M3", "FP6_E3M2", "FP8_E4M3", "quantize",
           "decompose", "int_quantize", "sqnr_db", "max_entropy_sample",
           "adc_quantize", "MacOutput", "int_mac", "gr_mac_row",
           "gr_mac_unit", "n_eff", "Distribution", "DISTRIBUTIONS",
           "uniform", "gaussian_outliers", "max_entropy", "EnobResult",
           "required_enob", "solve_required_enob", "TechParams", "CimDesign",
           "EnergyBreakdown", "energy_per_op_fj"]
