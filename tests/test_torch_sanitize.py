"""The port's numerics sanitizer (``repro_torch.analysis.sanitize``) against
the JAX package's: the counterparts of ``tests/test_sanitize.py`` (nothing
checked when the flag is unset, clean on single-binade operands, a NaN
caught, a gain-range violation caught, the flag read on every call), and
the records of the port's plain version equal to those of JAX's ``ref``
and ``xla`` backends on the same inputs.

Tolerances: records equal exactly (kind, tag, count); ``worst`` bitwise
at FP6_E3M2 x FP4_E2M1, where every partial sum of v is exact in f32; the
gain spans are integers. The kernel's sanitizing instantiation is held to
the plain version on the card (``tests/test_torch_gpu.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import sanitize as jsan  # noqa: E402
from repro.core import formats as jf  # noqa: E402
from repro.kernels.dispatch import grmac_matmul as jax_grmac  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.dispatch import grmac_matmul  # noqa: E402
from repro_torch.kernels.ops import cim_matmul  # noqa: E402

GRANULARITIES = ["conv", "row", "unit"]


def _kw(mod, **over):
    kw = dict(fmt_x=mod.FP6_E3M2, fmt_w=mod.FP4_E2M1, n_r=32, enob=8.0,
              granularity="row")
    kw.update(over)
    return kw


def _data(seed, m, k, n, *, narrow=False, fmt_w=jf.FP4_E2M1):
    """Uniform operands (numpy, from a seed); ``narrow`` confines |x| and
    |w| to [0.5, 1), one binade, so every span stays inside the limit and
    the compute line inside full scale."""
    rng = np.random.default_rng(seed)
    lo = 0.5 if narrow else -1.0
    x = rng.uniform(lo, 1.0, (m, k)).astype(np.float32)
    w = rng.uniform(lo, 1.0, (k, n)).astype(np.float32)
    if narrow:
        x *= np.where(rng.uniform(size=(m, k)) < 0.5, -1.0, 1.0).astype(
            np.float32)
    wq = np.asarray(jf.quantize(jnp.asarray(w), fmt_w))
    return x, wq


@pytest.fixture
def _clean(monkeypatch):
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    sanitize.clear()
    jsan.clear()
    yield
    sanitize.clear()
    jsan.clear()


_KINDS = ["nonfinite", "adc_overflow", "gain_range"]


def _records(recs):
    return [dict(r) for r in recs]


def _by_kind(recs):
    return sorted(recs, key=lambda r: (r["tag"], _KINDS.index(r["kind"])))


def test_zero_cost_when_unset(_clean, monkeypatch):
    """No REPRO_SANITIZE: no check runs (no pending record, no extra
    operation), and the output is bitwise that of an explicit '0'."""
    x, w = _data(0, 64, 64, 16)
    calls = []
    monkeypatch.setattr(sanitize, "_defer", lambda *a, **k: calls.append(a))
    out_unset = grmac_matmul(torch.tensor(x), torch.tensor(w), **_kw(tf))
    monkeypatch.setenv(sanitize.ENV_VAR, "0")
    out_zero = grmac_matmul(torch.tensor(x), torch.tensor(w), **_kw(tf))
    assert torch.equal(out_unset, out_zero)
    assert calls == [] and sanitize._PENDING == []
    assert sanitize.VIOLATIONS == []


def test_sanitize_on_is_bit_identical_and_clean(_clean, monkeypatch):
    """Instrumentation never changes numerics, and single-binade operands
    report nothing, through the plain version and ``cim_matmul``."""
    x, w = _data(1, 64, 64, 16, narrow=True)
    xt, wt = torch.tensor(x), torch.tensor(w)
    base = {g: grmac_matmul(xt, wt, **_kw(tf, granularity=g))
            for g in GRANULARITIES}
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    for g in GRANULARITIES:
        out = grmac_matmul(xt, wt, tag=f"ref/{g}", **_kw(tf, granularity=g))
        assert torch.equal(out, base[g])
    assert len(sanitize._PENDING) == 5       # the checks really ran
    assert sanitize.VIOLATIONS == [], sanitize.VIOLATIONS


def test_nan_input_is_caught(_clean, monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    x, w = _data(2, 16, 64, 8)
    x[0, 0] = np.nan
    grmac_matmul(torch.tensor(x), torch.tensor(w), tag="nan/ref", **_kw(tf))
    recs = [v for v in sanitize.VIOLATIONS if v["kind"] == "nonfinite"]
    assert recs, sanitize.VIOLATIONS
    assert recs[0]["tag"] == "nan/ref"
    assert recs[0]["count"] >= 1


def test_gain_range_violation_is_caught(_clean, monkeypatch):
    """FP8_E4M3 activations over full-range uniform data span more
    exponent bits than GAIN_RANGE_LIMIT_BITS per row block."""
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    x, w = _data(0, 64, 64, 16)
    grmac_matmul(torch.tensor(x), torch.tensor(w), tag="gain/e4m3",
                 **_kw(tf, fmt_x=tf.FP8_E4M3))
    recs = [v for v in sanitize.VIOLATIONS if v["kind"] == "gain_range"]
    assert recs, sanitize.VIOLATIONS
    assert recs[0]["tag"] == "gain/e4m3"
    assert recs[0]["worst"] > 6          # beyond the C-2C ladder depth


def test_env_is_read_per_call(_clean, monkeypatch):
    """Flipping the env var mid-process takes effect on the next call."""
    x, w = _data(3, 16, 64, 8)
    x[0, 0] = np.nan
    xt, wt = torch.tensor(x), torch.tensor(w)
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    grmac_matmul(xt, wt, tag="flip", **_kw(tf))
    assert sanitize.VIOLATIONS
    sanitize.clear()
    monkeypatch.setenv(sanitize.ENV_VAR, "0")
    grmac_matmul(xt, wt, tag="flip", **_kw(tf))
    assert sanitize.VIOLATIONS == []


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("case", ["main", "e4m3", "nan", "ragged"])
def test_plain_records_equal_jax_ref_and_xla(_clean, monkeypatch,
                                             granularity, case):
    """The same inputs through JAX's ``ref`` and ``xla`` backends and the
    port's plain version give equal records, worst values bitwise: the
    main formats, FP8_E4M3 activations (gain-range violations), a NaN, and
    a K that pads to the analog columns (padding rows count in the
    spans, as zeros of gain 2)."""
    fmt_x = "FP8_E4M3" if case == "e4m3" else "FP6_E3M2"
    m, k, n = (37, 200, 24) if case == "ragged" else (24, 128, 16)
    x, w = _data(7, m, k, n)
    if case == "nan":
        x[5, 40] = np.nan
    if case == "ragged":
        x[:, :17] *= 1e-3               # small inputs beside full-range ones
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    monkeypatch.setenv(jsan.ENV_VAR, "1")
    kw = dict(n_r=32, enob=8.0, granularity=granularity)
    want = {}
    for backend in ("ref", "xla"):
        jsan.clear()
        jax.block_until_ready(jax_grmac(
            jnp.asarray(x), jnp.asarray(w), fmt_x=getattr(jf, fmt_x),
            fmt_w=jf.FP4_E2M1, backend=backend, tag=f"site/{granularity}",
            **kw))
        jax.effects_barrier()
        want[backend] = _records(jsan.VIOLATIONS)
    grmac_matmul(torch.tensor(x), torch.tensor(w), fmt_x=getattr(tf, fmt_x),
                 fmt_w=tf.FP4_E2M1, tag=f"site/{granularity}", **kw)
    got = _records(sanitize.VIOLATIONS)
    # jax.debug.callback effects are unordered: JAX's records of one call
    # compare as a set; the port's come in the checks' program order
    assert _by_kind(got) == _by_kind(want["ref"]) == _by_kind(want["xla"])
    assert [r["kind"] for r in got] == sorted(
        (r["kind"] for r in got), key=_KINDS.index)
    if case in ("e4m3", "nan") and granularity != "conv":
        assert got, "the case should report"


def test_cim_matmul_tags_its_site_and_nan_scale_is_caught(_clean,
                                                          monkeypatch):
    """``cim_matmul`` threads its site down as the tag; a NaN anywhere in
    x makes the pre-scale NaN, so every v of the call is nonfinite, in
    the port as in the reference."""
    from repro.core.cim_config import CIMConfig as JCfg
    from repro.kernels.ops import cim_matmul as jax_cim
    from repro_torch.core.cim_config import CIMConfig as TCfg

    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    x[2, 7] = np.nan
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    monkeypatch.setenv(jsan.ENV_VAR, "1")
    monkeypatch.setenv("REPRO_GRMAC_BACKEND", "ref")
    jax.block_until_ready(jax_cim(jnp.asarray(x), jnp.asarray(w),
                                  JCfg(mode="grmac"), site="mlp"))
    jax.effects_barrier()
    cim_matmul(torch.tensor(x), torch.tensor(w), TCfg(mode="grmac"),
               site="mlp")
    got = _records(sanitize.VIOLATIONS)
    assert got == _by_kind(jsan.VIOLATIONS)
    assert got[0] == {"kind": "nonfinite", "tag": "mlp",
                      "count": 6 * 3 * 40, "worst": float("inf")}


def test_records_materialize_in_call_order_with_one_transfer(_clean,
                                                             monkeypatch):
    """Pending records hold tensors until read; reading materializes them
    in call order (kernel-style and plain entries interleaved), and
    ``clear`` drops both."""
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    v = torch.tensor([[0.5, float("nan")], [2.0, -3.0]])
    sanitize.check_values("a", v)
    bits = int(np.array([3.0], np.float32).view(np.uint32)[0])
    sanitize.defer_kernel("k", torch.tensor([1, 2, bits, 4, 9]), spans=True)
    sanitize.check_gain_span("b", torch.tensor([[3, 8], [7, 1]]))
    assert len(sanitize._PENDING) == 3
    assert _records(sanitize.VIOLATIONS) == [
        {"kind": "nonfinite", "tag": "a", "count": 1, "worst": float("inf")},
        {"kind": "adc_overflow", "tag": "a", "count": 2, "worst": 3.0},
        {"kind": "nonfinite", "tag": "k", "count": 1, "worst": float("inf")},
        {"kind": "adc_overflow", "tag": "k", "count": 2, "worst": 3.0},
        {"kind": "gain_range", "tag": "k", "count": 4, "worst": 9.0},
        {"kind": "gain_range", "tag": "b", "count": 2, "worst": 8.0}]
    assert sanitize._PENDING == []
    sanitize.check_values("c", v)
    sanitize.clear()
    assert sanitize.VIOLATIONS == [] and sanitize._PENDING == []


def test_plain_version_counts_its_calls():
    x, w = _data(4, 8, 64, 8)
    before = tref.grmac_matmul_ref.calls
    grmac_matmul(torch.tensor(x), torch.tensor(w), **_kw(tf))
    assert tref.grmac_matmul_ref.calls == before + 1
