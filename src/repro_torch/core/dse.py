"""Design-space exploration: the format grid (Fig. 12) and the per-site
(format × n_r × granularity) Pareto explorer; the port's counterpart of
``repro.core.dse``. The Monte-Carlo solves take an explicit generator
(``evaluate_point``, ``explore``) or a seed and a device (the per-site
sweep; None: the card).

Two layers live here:

1. **The paper's Fig. 12 grid** (``explore`` / ``evaluate_point``): each
   design point is an input format (``n_exp``, ``n_man``). Precision (SQNR)
   is set by the mantissa; excess dynamic range beyond the minimum needed
   for that SQNR is set by the exponent range (``e_max - 1`` octaves). Per
   §IV-B, converters are dimensioned to robustly process *a uniform input
   scaled to its narrowest valid bounds* (twice the minimum normal value):
   the excess DR manifests as a 2^-(e_max-1) amplitude reduction for the
   conventional CIM, while the GR-MAC renormalizes it away. Weights are
   FP4_E2M1 max-entropy throughout.

2. **The per-site Pareto explorer** (``explore_pareto`` — the design space
   the paper implies but never sweeps). Because the GR-MAC makes ADC
   resolution invariant to input dynamic range, the interesting question
   per matmul *site* (``core.cim_config.SITES``) becomes which input
   format and row-parallelism that site actually needs at a given accuracy
   standard. The swept axes per site are:

   * ``fmt_x``   — the FP/INT ladder (``FORMAT_LADDER``; INT entries price
     through the ``gr_int`` energy arch at GR granularities);
   * ``n_r``     — array depth (``N_R_LADDER``): deeper arrays amortize the
     per-column ADC over more MACs but accumulate more rows, which raises
     the renormalization-scale statistics and with them the required ENOB
     — the sweep resolves that trade per candidate, nothing is assumed;
   * ``granularity`` — row / unit / conv normalization domain (§III-C).

   **Budget semantics** (``SiteBudget``): a candidate is admissible when
   its *format* SQNR — ``spec_of_format``'s 6.02·N_M + 10.79 dB (FP) or
   6.02·(bits-1) + 1.76 dB (INT) — meets the site's floor. The default is
   the paper's 35 dB accuracy standard (``PAPER_SQNR_STANDARD_DB``). The
   required-ENOB solve then holds ADC noise ≥ 6 dB under that format's
   quantization noise (``core.adc``), so the delivered output SQNR tracks
   the format SQNR the budget is written against. A budget may also be
   stated as a minimum ENOB (converted through the 6.02·N + 1.76 dB line);
   when both fields are set the stricter floor wins. A site with NO
   admissible candidate under an active budget falls back to ``"off"``
   (digital) with a ``UserWarning`` — an analog site that cannot meet the
   accuracy standard is not deployed.

   **GAIN_RANGE_LIMIT_BITS × the n_r sweep**: the C-2C coupling-ladder
   span limit (§III-D1) depends only on the formats' exponent ranges, not
   on ``n_r`` — so it prunes the same (format, granularity) combinations
   at every array depth (wide-exponent formats such as FP8_E4M3 can enter
   the space only through ``conv``), and the sweep skips those combos
   before paying any Monte-Carlo solve. The solves that do run are
   memoized on the full candidate tuple (``core.adc.solve_required_enob``
   via ``core.costs.design_energy_fj``), which is what keeps the
   combinatorial sweep — |formats| × |n_r| × |granularities| × sites ×
   phases — tractable: distinct solves are bounded by the candidate grid,
   not by the number of sites or phases that share it.

   Results per ledger: a per-site energy/accuracy **Pareto front**
   (``pareto_front`` — fJ/Op weighted by the site's traced op count vs
   format SQNR), the chosen (cheapest admissible) design per site emitted
   as a ready-to-apply ``{site: SiteDesign}`` mapping
   (``CIMConfig.with_site_overrides``), and a deployment-level front
   (``deployment_front``: total pJ vs the weakest-site SQNR floor).

``explore_sites`` (granularity-only at the base formats) is the degenerate
sweep: ``explore_pareto(formats=(base.fmt_x,), n_r_set=(base.n_r,),
budget=None)`` reproduces it (regression-tested).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from .adc import narrowest_uniform, required_enob
from .cim_config import SiteDesign
from .costs import design_arch, design_energy_fj
from .energy import CimDesign, EnergyBreakdown, TechParams, energy_per_op_fj
from .formats import (FP4_E2M1, FP6_E2M3, FP6_E3M2, FP8_E4M3, FPFormat,
                      IntFormat)

__all__ = ["DsePoint", "explore", "explore_sites", "spec_of_format",
           "GAIN_RANGE_LIMIT_BITS", "FORMAT_LADDER", "N_R_LADDER",
           "GRANULARITIES", "PAPER_SQNR_STANDARD_DB", "SiteBudget",
           "SiteCandidate", "pareto_front", "sweep_site",
           "deployment_front", "explore_pareto"]

# Conservative C-2C linearity limit on the coupling-ladder span (§III-D1).
GAIN_RANGE_LIMIT_BITS = 6

# The FP/INT candidate ladder for the per-site sweep: the named formats
# plus the wider-mantissa points needed to clear the 35 dB standard
# (6.02·N_M + 10.79 dB ≥ 35 needs N_M ≥ 5 for FP; 6.02·(bits-1) + 1.76 ≥ 35
# needs INT7+), and the INT column of the Fig. 12 grid.
FORMAT_LADDER: Tuple[Union[FPFormat, IntFormat], ...] = (
    IntFormat(4), IntFormat(6), IntFormat(8),
    FP4_E2M1, FP6_E2M3, FP6_E3M2, FP8_E4M3,
    FPFormat(2, 4), FPFormat(3, 4), FPFormat(2, 5), FPFormat(3, 5),
)

# Small power-of-two array depths around the paper's N_R = 32 reference.
N_R_LADDER: Tuple[int, ...] = (16, 32, 64, 128)

GRANULARITIES: Tuple[str, ...] = ("row", "unit", "conv")

# The paper's accuracy standard (§IV): the iso-accuracy column Fig. 12's
# energy comparison is read at.
PAPER_SQNR_STANDARD_DB = 35.0


@dataclasses.dataclass
class DsePoint:
    fmt_x: FPFormat | IntFormat
    dr_db: float
    sqnr_db: float
    conv: Optional[EnergyBreakdown]      # None when outside conventional reach
    gr: Optional[EnergyBreakdown]        # best GR granularity (None if infeasible)
    gr_arch: Optional[str]
    enob_conv: float
    enob_gr: float


def spec_of_format(fmt: FPFormat | IntFormat) -> tuple[float, float]:
    """(DR_dB, SQNR_dB) coordinates of a format in the design space.

    DR counts total resolvable bits: information bits (mantissa incl. the
    implicit leading one) plus excess-range octaves.  SQNR follows the
    6.02·N_M + 10.79 dB floating-point formula (stored mantissa bits).
    """
    if isinstance(fmt, IntFormat):
        bits = fmt.bits
        return 6.02 * bits, 6.02 * (bits - 1) + 1.76
    dr_bits = (fmt.n_man + 2) + (fmt.e_max - 1)  # sign+implicit+stored + range
    return 6.02 * dr_bits, 6.02 * fmt.n_man + 10.79


def evaluate_point(
    generator: torch.Generator,
    fmt_x: FPFormat | IntFormat,
    fmt_w: FPFormat = FP4_E2M1,
    n_r: int = 32,
    n_c: int = 32,
    p: TechParams = TechParams(),
    n_cols: int = 1 << 13,
) -> DsePoint:
    """One Fig. 12 point: the conventional CIM and the cheapest GR
    granularity inside the coupling ladder's span, each at the ENOB its
    solve requires. Every solve draws from ``generator`` in turn."""
    dist = narrowest_uniform(fmt_x)
    dr_db, sqnr_db = spec_of_format(fmt_x)
    # every solve of the point sees the same samples (the reference reuses
    # one key); the generator ends one solve's draws further on
    state = generator.get_state()

    def solve(arch):
        generator.set_state(state)
        return required_enob(generator, arch, dist, fmt_x, n_r=n_r,
                             fmt_w=fmt_w, n_cols=n_cols)

    res_conv = solve("conv")
    conv = energy_per_op_fj(
        CimDesign("conv", fmt_x, fmt_w, res_conv.enob, n_r, n_c), p
    )

    best = None
    best_arch = None
    best_enob = float("nan")
    if isinstance(fmt_x, IntFormat):
        cand = ["gr_int"]
    else:
        cand = ["gr_row", "gr_unit"]
    for arch in cand:
        solver_arch = "gr_unit" if arch == "gr_int" else arch
        res = solve(solver_arch)
        d = CimDesign(arch, fmt_x, fmt_w, res.enob, n_r, n_c)
        if d.gain_range_bits > GAIN_RANGE_LIMIT_BITS:
            continue  # outside the coupling ladder's linear span
        e = energy_per_op_fj(d, p)
        if best is None or e.total < best.total:
            best, best_arch, best_enob = e, arch, res.enob

    return DsePoint(
        fmt_x=fmt_x,
        dr_db=dr_db,
        sqnr_db=sqnr_db,
        conv=conv,
        gr=best,
        gr_arch=best_arch,
        enob_conv=res_conv.enob,
        enob_gr=best_enob,
    )


# ------------------------------------------------------- per-site sweep
@dataclasses.dataclass(frozen=True)
class SiteBudget:
    """Per-site accuracy floor. ``min_sqnr_db`` is written against the
    candidate *format's* SQNR (``spec_of_format``); ``min_enob`` states the
    same floor in effective bits (6.02·N + 1.76 dB). When both are set the
    stricter one applies; a budget with neither admits every candidate."""

    min_sqnr_db: Optional[float] = PAPER_SQNR_STANDARD_DB
    min_enob: Optional[float] = None

    def floor_db(self) -> Optional[float]:
        floors = []
        if self.min_sqnr_db is not None:
            floors.append(self.min_sqnr_db)
        if self.min_enob is not None:
            floors.append(6.02 * self.min_enob + 1.76)
        return max(floors) if floors else None

    def admits(self, sqnr_db: float) -> bool:
        floor = self.floor_db()
        return floor is None or sqnr_db >= floor


@dataclasses.dataclass(frozen=True)
class SiteCandidate:
    """One admissible point of a site's sweep: a (format, n_r, granularity)
    design with its solved ADC requirement and op-count-weighted energy."""

    fmt_x: Union[FPFormat, IntFormat]
    n_r: int
    granularity: str
    arch: str                 # energy-model arch (gr_row/gr_unit/gr_int/conv)
    fj_per_op: float
    enob: float
    sqnr_db: float            # format SQNR: the accuracy axis
    dr_db: float
    ops: int                  # ledger Ops at this site (weights pj)

    @property
    def key(self) -> str:
        """Stable candidate id used in records and rendered tables."""
        return f"{self.fmt_x.name}/n{self.n_r}/{self.granularity}"

    @property
    def pj(self) -> float:
        return self.ops * self.fj_per_op * 1e-3

    def design(self) -> SiteDesign:
        """The ready-to-apply override for this candidate."""
        return SiteDesign(granularity=self.granularity, fmt_x=self.fmt_x,
                          n_r=self.n_r)

    def as_dict(self) -> dict:
        return {
            "fmt_x": self.fmt_x.name, "n_r": self.n_r,
            "granularity": self.granularity, "arch": self.arch,
            "fj_per_op": self.fj_per_op, "enob": self.enob,
            "sqnr_db": self.sqnr_db, "dr_db": self.dr_db,
            "pj": self.pj,
        }


def pareto_front(points: Iterable, *, energy=lambda c: c.fj_per_op,
                 accuracy=lambda c: c.sqnr_db) -> list:
    """Non-dominated subset under (minimize ``energy``, maximize
    ``accuracy``), sorted by energy ascending. ``a`` dominates ``b`` when
    ``energy(a) <= energy(b)`` and ``accuracy(a) >= accuracy(b)`` with at
    least one strict; ties on both axes keep the first point seen (the
    sweep order is deterministic, so records are stable)."""
    front: list = []
    for p in sorted(points, key=lambda c: (energy(c), -accuracy(c))):
        if not front or accuracy(p) > accuracy(front[-1]):
            front.append(p)
    return front


def sweep_site(
    base,
    ops: int,
    *,
    formats: Sequence = FORMAT_LADDER,
    n_r_set: Sequence[int] = N_R_LADDER,
    granularities: Sequence[str] = GRANULARITIES,
    budget: Optional[SiteBudget] = SiteBudget(),
    seed: int = 0,
    n_cols: int = 1 << 11,
    device=None,
) -> dict:
    """Sweep one site's candidate grid against its accuracy budget.

    ``base`` is the site's resolved ``CIMConfig`` (supplies ``fmt_w``);
    ``ops`` the ledger op count weighting the energy axis. Returns
    ``{"candidates", "front", "chosen", "n_pruned"}`` where ``chosen`` is
    the cheapest front point (None when nothing is admissible) and
    ``n_pruned`` counts budget- or gain-range-rejected combos."""
    candidates: List[SiteCandidate] = []
    n_pruned = 0
    seen_archs = set()
    for fmt in formats:
        dr_db, sqnr_db = spec_of_format(fmt)
        if budget is not None and not budget.admits(sqnr_db):
            n_pruned += len(n_r_set) * len(granularities)
            continue
        for g in granularities:
            arch = design_arch(g, fmt)
            # gain-range feasibility is n_r-invariant: check once per
            # (format, granularity) with a dummy depth
            probe = CimDesign(arch, fmt, base.fmt_w, 0.0, n_r_set[0])
            if probe.gain_range_bits > GAIN_RANGE_LIMIT_BITS:
                n_pruned += len(n_r_set)
                continue
            if (fmt, arch) in seen_archs:
                continue  # e.g. INT row/unit both price as gr_int
            seen_archs.add((fmt, arch))
            for n_r in n_r_set:
                pt = design_energy_fj(g, fmt, base.fmt_w, int(n_r),
                                      n_cols=n_cols, seed=seed,
                                      device=device)
                candidates.append(SiteCandidate(
                    fmt_x=fmt, n_r=int(n_r), granularity=g, arch=pt["arch"],
                    fj_per_op=pt["fj_per_op"], enob=pt["enob"],
                    sqnr_db=sqnr_db, dr_db=dr_db, ops=ops))
    front = pareto_front(candidates)
    return {
        "candidates": candidates,
        "front": front,
        "chosen": front[0] if front else None,
        "n_pruned": n_pruned,
    }


def deployment_front(site_results: Dict[str, dict]) -> List[dict]:
    """Arch×phase-level energy/accuracy front over the swept sites.

    The deployment's accuracy is its weakest site (the minimum per-site
    format SQNR); its energy is the ledger-weighted total. For every
    accuracy floor available in the candidate sets, each site takes its
    cheapest candidate meeting that floor; levels where some site has no
    such candidate are infeasible and dropped. The front is the Pareto
    filter over the resulting (total pJ, floor) points."""
    swept = {s: r for s, r in site_results.items() if r["candidates"]}
    if not swept:
        return []
    levels = sorted({c.sqnr_db for r in swept.values()
                     for c in r["candidates"]})
    points = []
    for level in levels:
        total_pj = 0.0
        choices = {}
        for site, r in swept.items():
            ok = [c for c in r["candidates"] if c.sqnr_db >= level]
            if not ok:
                choices = None
                break
            pick = min(ok, key=lambda c: (c.fj_per_op, -c.sqnr_db))
            total_pj += pick.pj
            choices[site] = pick.key
        if choices is None:
            continue
        points.append({"sqnr_db": level, "pj": total_pj,
                       "choices": choices})
    return pareto_front(points, energy=lambda p: p["pj"],
                        accuracy=lambda p: p["sqnr_db"])


def explore_pareto(
    cim,
    ledger,
    *,
    formats: Sequence = FORMAT_LADDER,
    n_r_set: Sequence[int] = N_R_LADDER,
    granularities: Sequence[str] = GRANULARITIES,
    budget: Union[SiteBudget, Dict[str, Optional[SiteBudget]], None]
        = SiteBudget(),
    seed: int = 0,
    n_cols: int = 1 << 11,
    device=None,
) -> dict:
    """Per-site (format × n_r × granularity) Pareto DSE over a traced
    ``core.costs.CostLedger`` under per-site accuracy budgets.

    For every analog site in ``ledger`` the full candidate grid is priced
    (budget- and gain-range-pruned, Monte-Carlo solves memoized — see the
    module docstring), the energy/accuracy Pareto front is kept, and the
    cheapest admissible point is *chosen*. ``budget`` is one
    ``SiteBudget`` for all sites, a ``{site: SiteBudget | None}`` mapping
    (missing sites get the default), or None (no accuracy constraint —
    the degenerate sweep).

    Fallbacks: a site with no admissible candidate under an **active**
    budget resolves to ``"off"`` with a ``UserWarning``; with no active
    budget (the explore_sites-compatible mode) it keeps its base design.

    Returns ``{"sites", "front", "site_overrides", "config", "pj",
    "base_pj"}``: ``site_overrides`` is the ready-to-apply ``{site: "off"
    | SiteDesign}`` chosen frontier, ``config`` is ``cim`` with it applied
    (``CIMConfig.with_site_overrides``), ``front`` the deployment-level
    front (``deployment_front``), and the pj figures price the whole
    ledger under the chosen vs the base designs."""
    default_budget = budget if isinstance(budget, (SiteBudget, type(None))) \
        else SiteBudget()
    budget_map = budget if isinstance(budget, dict) else {}

    sites: Dict[str, dict] = {}
    overrides: Dict[str, Union[str, SiteDesign]] = {}
    swept: Dict[str, dict] = {}
    pj_chosen = 0.0
    pj_base = 0.0
    for site in ledger.sites():
        ops = 2 * ledger.macs(site=site, analog_only=True)
        base = cim.for_site(site)
        if ops == 0 or not base.enabled:
            sites[site] = {"mode": "off", "ops": 2 * ledger.macs(site=site)}
            continue
        site_budget = budget_map.get(site, default_budget)
        base_pt = design_energy_fj(base.granularity, base.fmt_x, base.fmt_w,
                                   base.n_r, n_cols=n_cols, seed=seed,
                                   device=device)
        pj_base += ops * base_pt["fj_per_op"] * 1e-3
        res = sweep_site(base, ops, formats=formats, n_r_set=n_r_set,
                         granularities=granularities, budget=site_budget,
                         seed=seed, n_cols=n_cols, device=device)
        info = {
            "ops": ops,
            "budget_sqnr_db": site_budget.floor_db()
            if site_budget is not None else None,
            "base": {"granularity": base.granularity,
                     "fmt_x": base.fmt_x.name, "n_r": base.n_r,
                     "fj_per_op": base_pt["fj_per_op"]},
            "front": [c.as_dict() for c in res["front"]],
            "n_candidates": len(res["candidates"]),
            "n_pruned": res["n_pruned"],
        }
        chosen = res["chosen"]
        if chosen is None:
            if site_budget is not None and site_budget.floor_db() is not None:
                warnings.warn(
                    f"site {site!r}: no (format, n_r, granularity) candidate "
                    f"meets the {site_budget.floor_db():.1f} dB accuracy "
                    "budget within the coupling-ladder span — deploying the "
                    "site digital (\"off\")")
                overrides[site] = "off"
                info["chosen"] = "off"
            else:
                # no active budget: keep the base design (the
                # explore_sites-compatible degenerate fallback)
                pj_chosen += ops * base_pt["fj_per_op"] * 1e-3
                info["chosen"] = "base"
            sites[site] = info
            continue
        swept[site] = res
        pj_chosen += chosen.pj
        overrides[site] = chosen.design()
        info["chosen"] = chosen.as_dict()
        sites[site] = info
    return {
        "sites": sites,
        "front": deployment_front(swept),
        "site_overrides": overrides,
        "config": cim.with_site_overrides(overrides),
        "pj": pj_chosen,
        "base_pj": pj_base,
    }


def explore_sites(
    cim,
    ledger,
    *,
    granularities=("row", "unit", "conv"),
    seed: int = 0,
    n_cols: int = 1 << 11,
    device=None,
) -> dict:
    """Granularity-only per-site sweep at the base formats — the degenerate
    case of ``explore_pareto`` (kept as the cheap entry point and the
    regression anchor: ``explore_pareto(formats=(base.fmt_x,),
    n_r_set=(base.n_r,), budget=None)`` reproduces these results).

    Returns ``{"sites": {site: {...}}, "config": CIMConfig, "pj": float,
    "base_pj": float}`` where ``config`` is ``cim`` with
    ``site_overrides`` set to the winning mixed deployment and the pj
    figures price the whole ledger under the swept vs the base designs.
    """
    sites: dict = {}
    best_cfg = cim
    pj_best = 0.0
    pj_base = 0.0
    for site in ledger.sites():
        ops = 2 * ledger.macs(site=site, analog_only=True)
        base = cim.for_site(site)
        if ops == 0 or not base.enabled:
            sites[site] = {"mode": "off", "ops": 2 * ledger.macs(site=site)}
            continue
        base_pt = design_energy_fj(base.granularity, base.fmt_x, base.fmt_w,
                                   base.n_r, n_cols=n_cols, seed=seed,
                                   device=device)
        pj_base += ops * base_pt["fj_per_op"] * 1e-3
        best = None
        for g in granularities:
            d = CimDesign(design_arch(g, base.fmt_x), base.fmt_x,
                          base.fmt_w, 0.0, base.n_r)
            if d.gain_range_bits > GAIN_RANGE_LIMIT_BITS:
                continue  # outside the coupling ladder's linear span
            pt = design_energy_fj(g, base.fmt_x, base.fmt_w, base.n_r,
                                  n_cols=n_cols, seed=seed, device=device)
            if best is None or pt["fj_per_op"] < best[1]["fj_per_op"]:
                best = (g, pt)
        if best is None:
            # every candidate outside the coupling ladder (possible when
            # the caller restricts granularities and the formats are wide)
            # -> the site keeps its base design
            pj_best += ops * base_pt["fj_per_op"] * 1e-3
            sites[site] = {
                "granularity": base.granularity,
                "fj_per_op": base_pt["fj_per_op"],
                "enob": base_pt["enob"], "ops": ops,
                "pj": ops * base_pt["fj_per_op"] * 1e-3,
                "base_granularity": base.granularity,
                "base_fj_per_op": base_pt["fj_per_op"],
                "infeasible_candidates": True,
            }
            continue
        g, pt = best
        pj_best += ops * pt["fj_per_op"] * 1e-3
        sites[site] = {
            "granularity": g, "fj_per_op": pt["fj_per_op"],
            "enob": pt["enob"], "ops": ops,
            "pj": ops * pt["fj_per_op"] * 1e-3,
            "base_granularity": base.granularity,
            "base_fj_per_op": base_pt["fj_per_op"],
        }
        if g != base.granularity:
            best_cfg = best_cfg.override_site(site, SiteDesign(granularity=g))
    return {"sites": sites, "config": best_cfg, "pj": pj_best,
            "base_pj": pj_base}


def explore(
    generator: torch.Generator,
    n_exps=(0, 1, 2, 3, 4),
    n_mans=(1, 2, 3, 4, 5, 6),
    fmt_w: FPFormat = FP4_E2M1,
    n_r: int = 32,
    n_c: int = 32,
    p: TechParams = TechParams(),
    n_cols: int = 1 << 13,
) -> list[DsePoint]:
    """Sweep the (n_exp × n_man) grid; n_exp == 0 denotes an INT format of
    equivalent precision (sign + implicit + stored mantissa bits). The
    points draw from ``generator`` one after another."""
    pts = []
    for ne in n_exps:
        for nm in n_mans:
            fmt = IntFormat(nm + 2) if ne == 0 else FPFormat(ne, nm)
            pts.append(evaluate_point(generator, fmt, fmt_w, n_r, n_c, p,
                                      n_cols))
    return pts
