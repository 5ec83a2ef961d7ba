"""Energy models for CIM components and full arrays (paper §IV-B, Appendix);
a copy of ``repro.core.energy`` (pure Python floats, so its numbers are
bitwise the reference's).

Component models (Table II) with 28 nm @ 0.9 V parameters (Table III), all in
femtojoules.  Array-level roll-ups follow §III-C's normalization-granularity
descriptions (which logic exists, and what it is amortized over):

  conventional  ADC + wide DAC + cell switching over the FP->INT width
  gr_row        narrow DAC, +1 gain switch, per-row exponent decoder (/N_C),
                one exponent adder tree per array (/N_R·N_C),
                output multiplier per column (/N_R)
  gr_unit       narrow DAC + narrow divider, per-cell exponent adder+decoder
                (unamortized), adder tree and multiplier per column (/N_R)
  gr_int        integer inputs, static weight exponents: decoder does not
                toggle; precomputed column sums; multiplier per column only

Each MAC is two Ops.  Energy-per-op = total MVM energy / (2 · N_R · N_C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

from .formats import FPFormat, IntFormat

__all__ = [
    "TechParams",
    "CimDesign",
    "adc_energy_fj",
    "dac_energy_fj",
    "adder_tree_fa_count",
    "energy_per_op_fj",
    "EnergyBreakdown",
    "mult_energy_fj",
    "decoder_energy_fj",
    "cell_switch_energy_fj",
    "global_norm_energy_per_op_fj",
]


@dataclasses.dataclass(frozen=True)
class TechParams:
    """Cost-model parameters @ 0.9 V, 28 nm (Table III)."""

    c_gate_ff: float = 0.7   # fF — reference NAND2/NOR2 gate capacitance
    k1_ff: float = 100.0     # fF — ADC linear term
    k2_ff: float = 1e-3      # fF — ADC 4^ENOB term (1 aF)
    k3_ff: float = 50.0      # fF — DAC switching cap per bit
    vdd: float = 0.9         # V
    # Activity factor of the one-hot exponent adder tree ("low-activity
    # one-hot inputs", §III-B2). Not specified numerically in the paper;
    # exposed as a calibration knob.
    tree_activity: float = 0.5

    @property
    def vdd_sq(self) -> float:
        return self.vdd * self.vdd

    @property
    def e_fa_fj(self) -> float:
        """Full-adder energy: 6·C_gate·VDD²."""
        return 6.0 * self.c_gate_ff * self.vdd_sq

    def n_cross(self) -> float:
        """Boundary of thermal-noise-limited ADC scaling (~10 b for Table III).

        Solves k1·N = k2·4^N for N (where the exponential term overtakes the
        linear baseline), by bisection.
        """
        lo, hi = 1.0, 20.0
        f = lambda n: self.k2_ff * 4.0**n - self.k1_ff * n
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if f(mid) > 0:
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)


def adc_energy_fj(enob: float, p: TechParams = TechParams()) -> float:
    """(k1·ENOB + k2·4^ENOB)·VDD² — per conversion."""
    return (p.k1_ff * enob + p.k2_ff * 4.0**enob) * p.vdd_sq


def dac_energy_fj(res_bits: float, p: TechParams = TechParams()) -> float:
    """k3·DAC_res·VDD² — per conversion."""
    return p.k3_ff * res_bits * p.vdd_sq


def mult_energy_fj(n_a: int, n_b: Optional[int] = None, p: TechParams = TechParams()) -> float:
    """N-bit multiplier: (1.5·C_gate·VDD² + E_FA)·N² (generalized to N_a·N_b)."""
    n_b = n_a if n_b is None else n_b
    return (1.5 * p.c_gate_ff * p.vdd_sq + p.e_fa_fj) * n_a * n_b


def decoder_energy_fj(n_in: int, n_out: int, p: TechParams = TechParams()) -> float:
    """(0.5·N_in + N_out + 1)·C_gate·VDD²."""
    return (0.5 * n_in + n_out + 1) * p.c_gate_ff * p.vdd_sq


def adder_tree_fa_count(n_inputs: int, in_width: int) -> int:
    """FA count of a binary reduction tree over ``n_inputs`` words.

    Level k merges pairs with operand width in_width + k - 1.
    """
    total = 0
    n = n_inputs
    w = in_width
    while n > 1:
        pairs = n // 2
        total += pairs * w
        n = n - pairs
        w += 1
    return total


def cell_switch_energy_fj(n_sw: int, n_r: int, n_c: int, p: TechParams = TechParams()) -> float:
    """0.5·C_gate·VDD²·N_SW·N_R·N_C — whole-array bitline switching per MVM."""
    return 0.5 * p.c_gate_ff * p.vdd_sq * n_sw * n_r * n_c


@dataclasses.dataclass(frozen=True)
class CimDesign:
    """One point in the design space."""

    arch: str                               # conv | gr_row | gr_unit | gr_int
    fmt_x: Union[FPFormat, IntFormat]
    fmt_w: FPFormat
    enob: float                             # from core.adc.required_enob
    n_r: int = 32
    n_c: int = 32

    @property
    def x_is_int(self) -> bool:
        return isinstance(self.fmt_x, IntFormat)

    def int_width(self, fmt: FPFormat) -> int:
        """FP->INT aligned width: mantissa (incl. implicit) + shift range."""
        return (fmt.n_man + 1) + (fmt.e_max - 1)

    @property
    def dac_res(self) -> int:
        if self.x_is_int:
            return self.fmt_x.bits
        if self.arch == "conv":
            return self.int_width(self.fmt_x)
        return self.fmt_x.n_man + 1  # normalized mantissa only

    @property
    def gain_range_bits(self) -> int:
        """Octaves spanned by the gain-ranging coupling ladder."""
        if self.arch in ("conv",):
            return 0
        bits = 0
        if not self.x_is_int and self.arch in ("gr_row", "gr_unit"):
            bits += self.fmt_x.e_max - 1
        if self.arch in ("gr_unit", "gr_int"):
            bits += self.fmt_w.e_max - 1
        return bits


@dataclasses.dataclass
class EnergyBreakdown:
    adc: float
    dac: float
    cells: float
    logic: float  # exponent adders/decoders/trees/output multipliers

    @property
    def total(self) -> float:
        return self.adc + self.dac + self.cells + self.logic

    def as_dict(self) -> dict:
        return {
            "adc": self.adc,
            "dac": self.dac,
            "cells": self.cells,
            "logic": self.logic,
            "total": self.total,
        }


def energy_per_op_fj(d: CimDesign, p: TechParams = TechParams()) -> EnergyBreakdown:
    """Per-Op (MAC = 2 Ops) energy of one CIM array design point."""
    n_r, n_c = d.n_r, d.n_c
    ops = 2.0 * n_r * n_c
    log2nr = max(1, math.ceil(math.log2(n_r)))

    e_adc = n_c * adc_energy_fj(d.enob, p)
    e_dac = n_r * dac_energy_fj(d.dac_res, p)
    e_logic = 0.0

    if d.arch == "conv":
        n_sw = d.int_width(d.fmt_w)
        e_cells = cell_switch_energy_fj(n_sw, n_r, n_c, p)

    elif d.arch == "gr_row":
        # Weights stored pre-shifted (storage overhead, §III-C2): divider
        # spans the aligned weight width; +1 switch for the gain stage.
        n_sw = d.int_width(d.fmt_w) + 1
        e_cells = cell_switch_energy_fj(n_sw, n_r, n_c, p)
        ne_x = d.fmt_x.n_exp
        e_maxx = d.fmt_x.e_max
        # One decoder per row, serving N_C cells.
        e_logic += n_r * decoder_energy_fj(ne_x, e_maxx, p)
        # One exponent adder tree per array over N_R one-hot words.
        fa = adder_tree_fa_count(n_r, e_maxx)
        e_logic += fa * p.e_fa_fj * p.tree_activity
        # Output normalization multiplier per column: ADC code × exp-sum.
        sum_w = e_maxx + log2nr
        e_logic += n_c * mult_energy_fj(math.ceil(d.enob), sum_w, p)

    elif d.arch == "gr_unit":
        n_sw = (d.fmt_w.n_man + 1) + 1
        e_cells = cell_switch_energy_fj(n_sw, n_r, n_c, p)
        ne_x = 0 if d.x_is_int else d.fmt_x.n_exp
        ne_w = d.fmt_w.n_exp
        e_maxx = 0 if d.x_is_int else d.fmt_x.e_max
        e_maxw = d.fmt_w.e_max
        esum_w = max(ne_x, ne_w) + 1
        onehot_w = max(1, (e_maxx - 1) + (e_maxw - 1) + 1)
        # Per-cell exponent adder (E_x + E_W) and gain decoder — unamortized.
        e_logic += n_r * n_c * (esum_w * p.e_fa_fj)
        e_logic += n_r * n_c * decoder_energy_fj(esum_w, onehot_w, p)
        # Adder tree per column.
        fa = adder_tree_fa_count(n_r, onehot_w)
        e_logic += n_c * fa * p.e_fa_fj * p.tree_activity
        sum_w = onehot_w + log2nr
        e_logic += n_c * mult_energy_fj(math.ceil(d.enob), sum_w, p)

    elif d.arch == "gr_int":
        # Integer inputs, FP weights with *static* exponents: decoders and
        # column exponent sums are compile-time constants (no toggling).
        n_sw = (d.fmt_w.n_man + 1) + 1
        e_cells = cell_switch_energy_fj(n_sw, n_r, n_c, p)
        e_maxw = d.fmt_w.e_max
        sum_w = (e_maxw - 1) + 1 + log2nr
        e_logic += n_c * mult_energy_fj(math.ceil(d.enob), sum_w, p)

    else:
        raise ValueError(f"unknown arch {d.arch!r}")

    return EnergyBreakdown(
        adc=e_adc / ops, dac=e_dac / ops, cells=e_cells / ops, logic=e_logic / ops
    )


def global_norm_energy_per_op_fj(
    width_bits: int, shift_range: int, n_r: int, n_c: int, p: TechParams = TechParams()
) -> float:
    """Overhead of a global (block-wise) normalization wrapper (§II-B2).

    Models a max-exponent comparator tree over the input block plus a
    ``width_bits``-wide barrel shifter (log2(shift_range) mux stages) per
    input. Runs once per MVM over N_R inputs; amortized per Op. This is a
    derived extension (the paper only includes CIM-array energy for FP8*).
    """
    stages = max(1, math.ceil(math.log2(max(2, shift_range))))
    shifter = width_bits * stages * 0.5 * p.c_gate_ff * p.vdd_sq
    cmp_tree = adder_tree_fa_count(n_r, stages) * p.e_fa_fj
    return (n_r * shifter + cmp_tree) / (2.0 * n_r * n_c)
