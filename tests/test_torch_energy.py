"""The port's energy model against the JAX package on the CPU: the
component and array energy models (bitwise: both are Python floats), the
column simulators on equal inputs, the required-ENOB solve on equal
injected samples, the max-entropy sampler's grid and code frequencies, the
paper's ADC and energy claims, and the Monte-Carlo tolerances.

Tolerances:
- the column simulators: bitwise on format-grid inputs (every partial sum
  is exact in f32 in any order); with mismatch gains, whose products are
  off the grid and sum in each library's order, rtol 1e-6 plus 1e-6 of the
  largest value (v and z cancel), and ``z_hat`` bitwise where v and scale
  are, else within one ADC step;
- ``required_enob`` on equal samples: 1e-5 bits (f32 reductions over 2**14
  columns sum in different orders in XLA and torch);
- seeded solves (the port's generator against ``jax.random``): the
  ``MC_TOL`` of ``chip_smoke.py``, twice the spread the JAX package shows
  over seeds 0-7 at the same n_cols; ``test_mc_tolerance`` recomputes each
  spread and holds the constant to it.
"""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import adc as JA  # noqa: E402
from repro.core import costs as JC  # noqa: E402
from repro.core import distributions as JD  # noqa: E402
from repro.core import energy as JE  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import mac as JM  # noqa: E402
from repro_torch.core import adc as TA  # noqa: E402
from repro_torch.core import distributions as TD  # noqa: E402
from repro_torch.core import dse as TS  # noqa: E402
from repro_torch.core import energy as TE  # noqa: E402
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core import mac as TM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MC_TOL = _chip_smoke().MC_TOL


def _fmt(pkg, fmt):
    """The same format in the other package."""
    return (pkg.IntFormat(fmt.bits) if fmt.name.startswith("INT")
            else pkg.FPFormat(fmt.n_exp, fmt.n_man))


def _cpu_gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


# ------------------------------------------------------------ energy model
FMTS = [TF.FP6_E3M2, TF.FP6_E2M3, TF.FP8_E4M3, TF.IntFormat(8)]


@pytest.mark.parametrize("fmt", FMTS, ids=lambda f: f.name)
@pytest.mark.parametrize("arch", ["conv", "gr_row", "gr_unit", "gr_int"])
def test_energy_per_op_bitwise(arch, fmt):
    """Every (ENOB, n_r) of one (arch, fmt_x): the breakdowns are equal
    floats, or both models refuse the design with the same error (gr_row
    has no input exponent to decode on an INT input)."""
    for enob in (4.0, 6.5, 8.0, 10.0):
        for n_r in (16, 32, 128):
            t = TE.CimDesign(arch, fmt, TF.FP4_E2M1, enob, n_r)
            j = JE.CimDesign(arch, _fmt(JF, fmt), JF.FP4_E2M1, enob, n_r)
            try:
                want = JE.energy_per_op_fj(j).as_dict()
            except AttributeError as e:
                with pytest.raises(type(e)):
                    TE.energy_per_op_fj(t)
                continue
            assert TE.energy_per_op_fj(t).as_dict() == want
            assert (t.dac_res, t.gain_range_bits) == (j.dac_res,
                                                      j.gain_range_bits)


def test_component_models_bitwise():
    tp, jp = TE.TechParams(), JE.TechParams()
    assert tp.n_cross() == jp.n_cross()
    assert 9.5 < tp.n_cross() < 10.5
    for n in range(1, 140):
        for w in (1, 3, 7):
            assert TE.adder_tree_fa_count(n, w) == JE.adder_tree_fa_count(n,
                                                                          w)
    for x in (1.0, 4.5, 9.0, 14.0):
        assert TE.adc_energy_fj(x) == JE.adc_energy_fj(x)
        assert TE.dac_energy_fj(x) == JE.dac_energy_fj(x)
    for a, b in ((3, None), (8, 6), (9, 12)):
        assert TE.mult_energy_fj(a, b) == JE.mult_energy_fj(a, b)
        assert TE.decoder_energy_fj(a, a + 4) == JE.decoder_energy_fj(a,
                                                                      a + 4)
    assert TE.cell_switch_energy_fj(5, 32, 32) == \
        JE.cell_switch_energy_fj(5, 32, 32)
    for args in ((8, 16, 32, 32), (12, 2, 16, 64), (6, 100, 128, 32)):
        assert TE.global_norm_energy_per_op_fj(*args) == \
            JE.global_norm_energy_per_op_fj(*args)


# ------------------------------------------------------- column simulators
def _grid_operands(fmt_x, seed=0, shape=(512, 32)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(-1, 1, shape).astype(np.float32)
    xq = np.asarray(JF.quantize(jnp.asarray(x), _fmt(JF, fmt_x)))
    wq = np.asarray(JF.quantize(jnp.asarray(w), JF.FP4_E2M1))
    gains = (1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return xq, wq, gains


def _sims(fmt_x, xq, wq, gains):
    """(name, JAX output, port output) of every simulator on equal
    inputs."""
    jx, jw, tx, tw = jnp.asarray(xq), jnp.asarray(wq), torch.tensor(xq), \
        torch.tensor(wq)
    jf, jg, tg = _fmt(JF, fmt_x), jnp.asarray(gains), torch.tensor(gains)
    return [
        ("int_mac", JM.int_mac(jx, jw, 6.0), TM.int_mac(tx, tw, 6.0)),
        ("gr_row", JM.gr_mac_row(jx, jw, jf, 6.0),
         TM.gr_mac_row(tx, tw, fmt_x, 6.0)),
        ("gr_unit", JM.gr_mac_unit(jx, jw, jf, JF.FP4_E2M1, 6.0),
         TM.gr_mac_unit(tx, tw, fmt_x, TF.FP4_E2M1, 6.0)),
        ("gr_row_mismatch", JM.gr_mac_row(jx, jw, jf, 6.0, jg),
         TM.gr_mac_row(tx, tw, fmt_x, 6.0, tg)),
        ("gr_unit_mismatch", JM.gr_mac_unit(jx, jw, jf, JF.FP4_E2M1, 6.0, jg),
         TM.gr_mac_unit(tx, tw, fmt_x, TF.FP4_E2M1, 6.0, tg)),
    ]


@pytest.mark.parametrize("fmt_x", [TF.FP6_E3M2, TF.FP8_E4M3, TF.FP6_E2M3],
                         ids=lambda f: f.name)
def test_column_simulators_match_jax(fmt_x):
    xq, wq, gains = _grid_operands(fmt_x)
    for name, j, t in _sims(fmt_x, xq, wq, gains):
        out = {}
        for field in ("v", "scale", "z", "z_hat", "n_eff"):
            a, b = getattr(j, field), getattr(t, field)
            if a is None:
                assert b is None, (name, field)
                continue
            out[field] = a, b = np.asarray(a), b.numpy()
            if not name.endswith("mismatch"):
                np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")
            elif field != "z_hat":
                # v and z cancel: their error is relative to the terms
                np.testing.assert_allclose(
                    b, a, rtol=1e-6, atol=1e-6 * np.abs(a).max(),
                    err_msg=f"{name}.{field}")
        if name.endswith("mismatch"):
            # z_hat = Q(v) * scale: bitwise where v and scale are; an ADC
            # code may flip only where v differs in its last bits
            (va, vb), (sa, sb), (za, zb) = (out[f] for f in
                                            ("v", "scale", "z_hat"))
            same = (va == vb) & (sa == sb)
            np.testing.assert_array_equal(zb[same], za[same])
            step = 2.0 / 2 ** 6 * sa
            assert np.all(np.abs(zb - za) <= step + 1e-6 * np.abs(za))
    # the ideal dot products reconstruct sum(x w) in every architecture
    for name, _, t in _sims(fmt_x, xq, wq, gains)[:3]:
        np.testing.assert_allclose(t.z.numpy(), (xq * wq).sum(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_global_normalize_and_adc_match_jax():
    xq, _, _ = _grid_operands(TF.FP6_E3M2, seed=1)
    for bits in (4, 6, 10):
        ja, js = JM.global_normalize(jnp.asarray(xq), JF.FP6_E3M2, bits)
        ta, ts = TM.global_normalize(torch.tensor(xq), TF.FP6_E3M2, bits)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    v = np.linspace(-1, 1, 999, dtype=np.float32)
    for enob in (4.0, 6.0, 8.0):
        np.testing.assert_array_equal(
            TM.adc_quantize(torch.tensor(v), enob).numpy(),
            np.asarray(JM.adc_quantize(jnp.asarray(v), enob)))


def test_mismatch_gains_statistics():
    e = torch.randint(1, 8, (4096, 32), generator=_cpu_gen())
    g = TM.mismatch_gains(_cpu_gen(1), e, 0.85)
    sigma = (0.85 / 100.0) / torch.sqrt(torch.exp2(e.float() - 1.0))
    z = (g - 1.0) / sigma
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02


# --------------------------------------------------------- required ENOB
def _fixed(pkg, arr, name):
    """A distribution of either package that ignores its key or generator
    and returns ``arr``: equal samples in both."""
    if pkg is JD:
        return JD.Distribution(name, lambda key, shape: jnp.asarray(arr))
    return TD.Distribution(name, lambda gen, shape: torch.tensor(arr))


@pytest.mark.parametrize("fmt_x", [TF.FP6_E3M2, TF.FPFormat(2, 2),
                                   TF.IntFormat(8)], ids=lambda f: f.name)
@pytest.mark.parametrize("dist", ["uniform", "outliers", "narrow"])
def test_required_enob_on_equal_samples(dist, fmt_x):
    n_cols, n_r = 1 << 14, 32
    rng = np.random.default_rng(3)
    shape = (n_cols, n_r)
    if dist == "uniform":
        x = rng.uniform(-1, 1, shape)
    elif dist == "narrow":
        x = rng.uniform(-1, 1, shape) * (2.0 * 2.0 ** -7)
    else:
        core = np.clip(rng.standard_normal(shape) / 150.0, -1, 1)
        x = np.where(rng.uniform(size=shape) < 0.01,
                     rng.uniform(-1, 1, shape), core)
    codes = rng.uniform(-1, 1, shape).astype(np.float32)
    w = np.asarray(JF.quantize(jnp.asarray(codes), JF.FP4_E2M1))
    x = x.astype(np.float32)
    for arch in ("conv", "gr_row", "gr_unit"):
        if arch == "gr_row" and isinstance(fmt_x, TF.IntFormat):
            continue
        want = JA.required_enob(
            jax.random.PRNGKey(0), arch, _fixed(JD, x, "x"), _fmt(JF, fmt_x),
            n_r=n_r, dist_w=_fixed(JD, w, "w"), n_cols=n_cols)
        got = TA.required_enob(
            _cpu_gen(), arch, _fixed(TD, x, "x"), fmt_x, n_r=n_r,
            dist_w=_fixed(TD, w, "w"), n_cols=n_cols)
        assert abs(got.enob - want.enob) <= 1e-5, (arch, got, want)
        for f in ("sig_power", "qnoise_power", "mean_scale_sq"):
            assert math.isclose(getattr(got, f), getattr(want, f),
                                rel_tol=1e-5), (arch, f)
        assert abs(got.sqnr_out_db - want.sqnr_out_db) <= 1e-4
        assert (got.n_eff_mean is None) == (want.n_eff_mean is None)
        if got.n_eff_mean is not None:
            assert math.isclose(got.n_eff_mean, want.n_eff_mean,
                                rel_tol=1e-5)


# ------------------------------------------------------- max-entropy sampler
@pytest.mark.parametrize("fmt", [TF.FP6_E3M2, TF.FP4_E2M1, TF.FP8_E4M3],
                         ids=lambda f: f.name)
def test_max_entropy_sample_grid_and_code_frequencies(fmt):
    n = 1 << 17
    x = TF.max_entropy_sample(_cpu_gen(5), (n,), fmt)
    assert x.dtype == torch.float32 and x.shape == (n,)
    assert torch.equal(TF.quantize(x, fmt), x)          # on the grid
    # every code (sign, stored exponent, mantissa bits) and its value
    codes = {}
    for sign in (0, 1):
        for e in range(2 ** fmt.n_exp):
            for mb in range(2 ** fmt.n_man):
                m = ((e > 0) + mb / 2 ** fmt.n_man) / 2.0
                mag = m * 2.0 ** (max(e, 1) - fmt.e_max)
                codes[(sign, mag)] = 0
    signs = torch.signbit(x).numpy().astype(int)
    mags = x.abs().numpy().astype(np.float64)
    for s, mag in zip(signs, mags):
        codes[(int(s), float(mag))] += 1
    assert len(codes) == 2 ** fmt.bits
    p = 1.0 / len(codes)
    sigma = math.sqrt(n * p * (1 - p))
    worst = max(abs(c - n * p) for c in codes.values())
    assert worst <= 5 * sigma, (worst, sigma)
    # the same sampler through the Distribution, on the generator's device
    d = TD.max_entropy(fmt, scale=0.5)(_cpu_gen(5), (n,))
    assert torch.equal(d, 0.5 * x)


def test_sqnr_db_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    for fmt in (TF.FP6_E3M2, TF.FP8_E4M3, TF.FPFormat(2, 5)):
        assert TF.sqnr_db(fmt) == JF.sqnr_db(_fmt(JF, fmt))
        xq = TF.quantize(torch.tensor(x), fmt)
        want = float(JF.measured_sqnr_db(jnp.asarray(x), jnp.asarray(
            xq.numpy())))
        assert abs(float(TF.measured_sqnr_db(torch.tensor(x), xq))
                   - want) < 1e-4


# ------------------------------------------------------------ paper claims
def test_paper_claim_C2_upper_bound_1p5_bits():
    gen = _cpu_gen()
    deltas = []
    for ne in (2, 3, 4):
        fmt = TF.FPFormat(ne, 2)
        rc = TA.required_enob(gen, "conv", TD.uniform(), fmt)
        ru = TA.required_enob(gen, "gr_unit", TD.uniform(), fmt)
        deltas.append(rc.enob - ru.enob)
    assert min(deltas) >= 1.3, deltas  # paper: 1.5 b


def test_paper_claim_C3_outliers_6_bits():
    gen = _cpu_gen()
    fmt = TF.FPFormat(3, 2)
    rc = TA.required_enob(gen, "conv", TD.gaussian_outliers(), fmt)
    ru = TA.required_enob(gen, "gr_unit", TD.gaussian_outliers(), fmt)
    assert rc.enob - ru.enob > 6.0, (rc.enob, ru.enob)


def test_paper_claim_C8_below_thermal_crossover():
    ncross = TE.TechParams().n_cross()
    gen = _cpu_gen()
    for ne in (2, 3, 4):
        ru = TA.required_enob(gen, "gr_unit", TD.uniform(), TF.FPFormat(ne, 2))
        assert ru.enob < ncross


def test_paper_claim_C6_fp6_native():
    pt = TS.evaluate_point(_cpu_gen(2), TF.FP6_E3M2, n_cols=1 << 12)
    assert pt.gr is not None and pt.gr.total < 40.0, pt.gr
    assert pt.conv.total > 100.0


# ------------------------------------------- Monte-Carlo tolerances, seeded
def _spread(values):
    return max(values) - min(values)


def _jax_spread(name):
    """The JAX package's own spread over seeds 0-7 behind one MC_TOL."""
    seeds = range(8)
    key = jax.random.PRNGKey
    if name == "enob_uniform_16384":
        return max(_spread([JA.required_enob(
            key(s), arch, JD.uniform(), JF.FPFormat(ne, 2)).enob
            for s in seeds]) for ne in (2, 3, 4)
            for arch in ("conv", "gr_unit"))
    if name == "enob_outliers_16384":
        return max(_spread([JA.required_enob(
            key(s), arch, JD.gaussian_outliers(), JF.FPFormat(3, 2)).enob
            for s in seeds]) for arch in ("conv", "gr_unit"))
    if name == "enob_narrowest_4096":
        return max(_spread([JA.solve_required_enob(
            arch, JF.FP6_E3M2, 32, JF.FP4_E2M1, 1 << 12, s).enob
            for s in seeds]) for arch in ("conv", "gr_row", "gr_unit"))
    ledger = JC.trace_decode(jax_get_config("paper-cim-120m"))
    field = {"pj_per_token_2048": "pj_per_token",
             "fj_per_op_2048": "fj_per_op"}[name]
    return _spread([JC.price_ledger(ledger, 1, seed=s)[field]
                    for s in seeds])


@pytest.mark.parametrize("name", sorted(MC_TOL))
def test_mc_tolerance(name):
    """Each stated tolerance is twice the reference's spread, rounded up
    (by at most 2%)."""
    twice = 2 * _jax_spread(name)
    assert twice <= MC_TOL[name] <= 1.02 * twice, (name, twice)


@pytest.mark.parametrize("arch", ["conv", "gr_row", "gr_unit"])
def test_seeded_solve_within_tolerance_of_jax(arch):
    """The port's seeded solve (its own stream) lies within the stated
    tolerance of the reference's; memoized per device type."""
    got = TA.solve_required_enob(arch, TF.FP6_E3M2, 32, TF.FP4_E2M1,
                                 1 << 12, 0, device="cpu")
    want = JA.solve_required_enob(arch, JF.FP6_E3M2, 32, JF.FP4_E2M1,
                                  1 << 12, 0)
    assert abs(got.enob - want.enob) <= MC_TOL["enob_narrowest_4096"]
    assert TA.solve_required_enob(arch, TF.FP6_E3M2, 32, TF.FP4_E2M1,
                                  1 << 12, 0, device="cpu") is got


def test_seeded_solve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.solve_required_enob("gr_row", TF.FP6_E3M2, n_cols=1 << 7)


def test_claims_within_tolerance_of_jax():
    """The claims' ENOBs, the port's stream against the reference's key 0
    at 2**14 columns."""
    gen = _cpu_gen()
    for ne in (2, 3, 4):
        for arch in ("conv", "gr_unit"):
            got = TA.required_enob(gen, arch, TD.uniform(),
                                   TF.FPFormat(ne, 2)).enob
            want = JA.required_enob(jax.random.PRNGKey(0), arch, JD.uniform(),
                                    JF.FPFormat(ne, 2)).enob
            assert abs(got - want) <= MC_TOL["enob_uniform_16384"]
    for arch in ("conv", "gr_unit"):
        got = TA.required_enob(gen, arch, TD.gaussian_outliers(),
                               TF.FPFormat(3, 2)).enob
        want = JA.required_enob(jax.random.PRNGKey(0), arch,
                                JD.gaussian_outliers(),
                                JF.FPFormat(3, 2)).enob
        assert abs(got - want) <= MC_TOL["enob_outliers_16384"]
