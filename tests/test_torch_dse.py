"""The port's design-space exploration against the JAX package on the CPU:
the Pareto filters on fixed candidates (identical), the format grid's
coordinates and budgets (identical), the per-site sweep on a reduced
config (the same candidates and prunes; the same chosen design wherever
the two choices' energies differ by more than the Monte-Carlo tolerance),
the budget fallback, the gain-range prune at every n_r, the emitted
overrides, and a Fig. 12 point within the stated tolerance.

Monte-Carlo tolerance of a design's fJ/Op: twice the spread the JAX
package shows over seeds 0-7 at the same n_cols (``_fj_tolerance``).
"""
import importlib.util
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import costs as JC  # noqa: E402
from repro.core import dse as JS  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import costs as TC  # noqa: E402
from repro_torch.core import dse as TS  # noqa: E402
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core.cim_config import SiteDesign  # noqa: E402
from repro_torch.core.energy import CimDesign  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
MC_TOL = _smoke.MC_TOL

_NC = 1 << 7
T_FMTS = (TF.FP6_E3M2, TF.FPFormat(2, 5), TF.IntFormat(8))
J_FMTS = (JF.FP6_E3M2, JF.FPFormat(2, 5), JF.IntFormat(8))
_NRS = (16, 32)


def _tiny(get_config):
    arch = get_config("paper-cim-120m").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256, vocab_size=512)
    return arch.replace(cim=arch.cim.with_mode("grmac"))


@pytest.fixture(scope="module")
def ledgers():
    tarch, jarch = _tiny(torch_get_config), _tiny(jax_get_config)
    return tarch, TC.trace_decode(tarch), jarch, JC.trace_decode(jarch)


# ------------------------------------------------------- fixed candidates
class _P:
    def __init__(self, fj, db):
        self.fj_per_op = fj
        self.sqnr_db = db


def test_pareto_front_identical_on_fixed_points():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(1, 30))
        fj = rng.choice([1.0, 2.0, 3.0, 5.0, 8.0], n) + (
            rng.uniform(0, 1, n) if trial % 2 else 0)
        db = rng.choice([10.0, 20.0, 35.0, 41.0], n)
        pts = [_P(float(a), float(b)) for a, b in zip(fj, db)]
        assert TS.pareto_front(pts) == JS.pareto_front(pts)
    a, b, c = _P(1.0, 10.0), _P(2.0, 20.0), _P(3.0, 15.0)
    assert TS.pareto_front([c, b, a]) == [a, b]


def _candidates(pkg, fmts, site_seed):
    """The same (format, n_r, granularity) candidates with the same
    numbers in either package."""
    rng = np.random.default_rng(site_seed)
    out = []
    for fmt in fmts:
        for g in ("row", "conv"):
            for n_r in _NRS:
                dr, sq = pkg.spec_of_format(fmt)
                out.append(pkg.SiteCandidate(
                    fmt_x=fmt, n_r=n_r, granularity=g, arch=g,
                    fj_per_op=float(rng.uniform(10, 50)), enob=8.0,
                    sqnr_db=sq, dr_db=dr, ops=int(rng.integers(1, 1000))))
    return out


def test_deployment_front_identical_on_fixed_candidates():
    sites = ("attn_qkv", "mlp", "head")
    t = {s: {"candidates": _candidates(TS, T_FMTS, i)}
         for i, s in enumerate(sites)}
    j = {s: {"candidates": _candidates(JS, J_FMTS, i)}
         for i, s in enumerate(sites)}
    assert TS.deployment_front(t) == JS.deployment_front(j)
    assert [[c.key for c in TS.pareto_front(t[s]["candidates"])]
            for s in sites] == [[c.key for c in JS.pareto_front(
                j[s]["candidates"])] for s in sites]


def test_format_coordinates_and_budgets_match_jax():
    for tf, jf in zip(TS.FORMAT_LADDER, JS.FORMAT_LADDER):
        assert tf.name == jf.name
        assert TS.spec_of_format(tf) == JS.spec_of_format(jf)
    assert (TS.N_R_LADDER, TS.GRANULARITIES, TS.GAIN_RANGE_LIMIT_BITS,
            TS.PAPER_SQNR_STANDARD_DB) == (
        JS.N_R_LADDER, JS.GRANULARITIES, JS.GAIN_RANGE_LIMIT_BITS,
        JS.PAPER_SQNR_STANDARD_DB)
    for args in ((35.0, None), (20.0, 6.0), (None, None), (None, 7.5)):
        tb, jb = TS.SiteBudget(*args), JS.SiteBudget(*args)
        assert tb.floor_db() == jb.floor_db()
        assert [tb.admits(TS.spec_of_format(f)[1]) for f in
                TS.FORMAT_LADDER] == [jb.admits(JS.spec_of_format(f)[1])
                                      for f in JS.FORMAT_LADDER]


# --------------------------------------------------------- the site sweep
def _jax_fj(key, seed=0):
    """The reference's fJ/Op of one candidate (``SiteCandidate.key``,
    "FMT/nN/gran") at ``_NC`` columns."""
    fmt_name, n_r, g = key.split("/")
    return JC.design_energy_fj(g, JF.parse_format(fmt_name), JF.FP4_E2M1,
                               int(n_r[1:]), n_cols=_NC,
                               seed=seed)["fj_per_op"]


def _fj_tolerance(key):
    """Twice the JAX package's spread of ``_jax_fj(key)`` over seeds 0-7."""
    vals = [_jax_fj(key, s) for s in range(8)]
    return 2 * (max(vals) - min(vals))


@pytest.mark.parametrize("budget", ["paper", "none"])
def test_explore_pareto_matches_jax(ledgers, budget):
    tarch, tled, jarch, jled = ledgers
    kw = dict(n_r_set=_NRS, n_cols=_NC)
    tb = TS.SiteBudget() if budget == "paper" else None
    jb = JS.SiteBudget() if budget == "paper" else None
    got = TS.explore_pareto(tarch.cim, tled, formats=T_FMTS, budget=tb,
                            device="cpu", **kw)
    want = JS.explore_pareto(jarch.cim, jled, formats=J_FMTS, budget=jb,
                             **kw)
    assert got["sites"].keys() == want["sites"].keys()
    for site, w in want["sites"].items():
        g = got["sites"][site]
        for key in ("ops", "budget_sqnr_db", "n_candidates", "n_pruned"):
            assert g.get(key) == w.get(key), (site, key)
        if not isinstance(w.get("chosen"), dict):
            assert g.get("chosen") == w.get("chosen"), site
            continue
        g_key = "{fmt_x}/n{n_r}/{granularity}".format(**g["chosen"])
        w_key = "{fmt_x}/n{n_r}/{granularity}".format(**w["chosen"])
        if g_key != w_key:
            # two choices may differ only where the reference prices them
            # within the sum of their estimators' tolerances
            gap = _jax_fj(g_key) - _jax_fj(w_key)
            assert gap <= _fj_tolerance(g_key) + _fj_tolerance(w_key), site
        # every chosen design is the config the overrides resolve to
        eff = got["config"].for_site(site)
        assert (eff.fmt_x.name, eff.n_r, eff.granularity) == (
            g["chosen"]["fmt_x"], g["chosen"]["n_r"],
            g["chosen"]["granularity"])
    assert got["config"] == tarch.cim.with_site_overrides(
        got["site_overrides"])


def test_budget_infeasible_sites_fall_back_off_with_warning(ledgers):
    tarch, tled, _, _ = ledgers
    with pytest.warns(UserWarning, match="accuracy budget"):
        res = TS.explore_pareto(tarch.cim, tled, formats=T_FMTS,
                                n_r_set=_NRS,
                                budget=TS.SiteBudget(min_sqnr_db=1000.0),
                                n_cols=_NC, device="cpu")
    assert res["site_overrides"]
    assert all(ov == "off" for ov in res["site_overrides"].values())
    assert res["pj"] == 0.0 and res["base_pj"] > 0.0 and res["front"] == []
    for site in res["site_overrides"]:
        assert not res["config"].for_site(site).enabled


def test_gain_range_prunes_wide_exponents_at_every_n_r(ledgers):
    tarch, tled, _, _ = ledgers
    for n_r in TS.N_R_LADDER:
        d = CimDesign("gr_row", TF.FP8_E4M3, TF.FP4_E2M1, 0.0, n_r)
        assert d.gain_range_bits > TS.GAIN_RANGE_LIMIT_BITS
        assert CimDesign("conv", TF.FP8_E4M3, TF.FP4_E2M1, 0.0,
                         n_r).gain_range_bits == 0
    res = TS.explore_pareto(tarch.cim, tled, formats=(TF.FP8_E4M3,),
                            n_r_set=TS.N_R_LADDER, budget=None, n_cols=_NC,
                            device="cpu")
    for info in res["sites"].values():
        if "front" in info:
            assert info["n_pruned"] == 2 * len(TS.N_R_LADDER)
            assert {c["granularity"] for c in info["front"]} == {"conv"}


def test_degenerate_sweep_reproduces_explore_sites(ledgers):
    tarch, tled, _, _ = ledgers
    base = tarch.cim
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        deg = TS.explore_pareto(base, tled, formats=(base.fmt_x,),
                                n_r_set=(base.n_r,), budget=None,
                                n_cols=_NC, device="cpu")
    es = TS.explore_sites(base, tled, n_cols=_NC, device="cpu")
    assert deg["pj"] == es["pj"] and deg["base_pj"] == es["base_pj"]
    for site, s in es["sites"].items():
        chosen = deg["sites"][site]["chosen"]
        assert chosen["granularity"] == s["granularity"]
        assert chosen["fj_per_op"] == s["fj_per_op"]


def test_emitted_overrides_roundtrip_and_memo(ledgers):
    tarch, tled, _, _ = ledgers
    res = TS.explore_pareto(tarch.cim, tled, formats=T_FMTS, n_r_set=_NRS,
                            n_cols=_NC, device="cpu")
    for site, info in res["sites"].items():
        if not isinstance(info.get("chosen"), dict):
            continue
        eff = res["config"].for_site(site)
        pt = TC.design_energy_fj(eff.granularity, eff.fmt_x, eff.fmt_w,
                                 eff.n_r, n_cols=_NC, seed=0, device="cpu")
        assert pt is TC.design_energy_fj(eff.granularity, eff.fmt_x,
                                         eff.fmt_w, eff.n_r, n_cols=_NC,
                                         device="cpu")
        assert (pt["fj_per_op"], pt["enob"]) == (
            info["chosen"]["fj_per_op"], info["chosen"]["enob"])
        ov = res["site_overrides"][site]
        assert SiteDesign.from_dict(ov.as_dict()) == ov


# ------------------------------------------------------- Fig. 12 grid point
def test_evaluate_point_within_tolerance_of_jax():
    got = TS.evaluate_point(torch.Generator().manual_seed(2), TF.FP6_E3M2,
                            n_cols=1 << 12)
    want = JS.evaluate_point(jax.random.PRNGKey(2), JF.FP6_E3M2,
                             n_cols=1 << 12)
    assert (got.dr_db, got.sqnr_db) == (want.dr_db, want.sqnr_db)
    tol = MC_TOL["enob_narrowest_4096"]
    assert abs(got.enob_conv - want.enob_conv) <= tol
    assert abs(got.enob_gr - want.enob_gr) <= tol
    assert got.gr_arch == want.gr_arch


def test_explore_grid_draws_one_point_after_another():
    gen = torch.Generator().manual_seed(0)
    pts = TS.explore(gen, n_exps=(0, 2), n_mans=(2,), n_cols=1 << 8)
    assert [p.fmt_x.name for p in pts] == ["INT4", "FP5_E2M2"]
    assert pts[0].gr_arch == "gr_int" and pts[1].gr_arch in ("gr_row",
                                                             "gr_unit")
