"""The port's numerics core and config dataclasses against the JAX package.

Format codecs and the ADC must agree with ``repro.core`` bit for bit (0
mismatches) on every FP format, including zeros, f32 subnormals,
saturation and values just under binade edges. The copied config
dataclasses must equal the reference's field by field.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import cim_config as jcc  # noqa: E402
from repro.core import formats as jf  # noqa: E402
from repro.core.mac import adc_quantize as jax_adc  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import cim_config as tcc  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.core.mac import adc_quantize as torch_adc  # noqa: E402

FORMATS = ["FP4_E2M1", "FP6_E2M3", "FP6_E3M2", "FP8_E4M3"]


def _probe_values(fmt, seed=0):
    """Random values plus every edge the codec must get right."""
    rng = np.random.default_rng(seed)
    edges = [0.0, -0.0, 1e-40, -1e-40, 1e-30, 2.0 ** -149, 1.0, -1.0, 1.5,
             -7.0, fmt.max_value, np.nextafter(np.float32(fmt.max_value), 2)]
    for e in range(-fmt.e_max - fmt.n_man - 2, 1):
        p = np.float32(2.0 ** e)
        edges += [p, -p, np.nextafter(p, np.float32(0)),
                  np.nextafter(p, np.float32(2))]
        # midpoints between grid steps exercise round-half-to-even
        edges += [p * (1 + 2.0 ** -(fmt.n_man + 1)), p * 1.5]
    mags = np.exp2(rng.uniform(-fmt.e_max - fmt.n_man - 3, 0.5, 20000))
    vals = np.concatenate([np.asarray(edges, np.float64),
                           rng.uniform(-1, 1, 20000),
                           mags * rng.choice([-1, 1], mags.shape)])
    return vals.astype(np.float32)


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_and_decompose_match_jax(name):
    jfmt, tfmt = getattr(jf, name), getattr(tf, name)
    v = _probe_values(jfmt)
    jq = np.asarray(jf.quantize(jnp.asarray(v), jfmt))
    tq = tf.quantize(torch.tensor(v), tfmt).numpy()
    # equal values, and equal bits wherever the value is not zero: XLA-CPU
    # flushes f32 subnormals, so -1e-40 quantizes to +0 there and to -0 in
    # torch, a zero of either sign that the GR-MAC sums cannot tell apart
    np.testing.assert_array_equal(tq, jq)
    nz = jq != 0
    np.testing.assert_array_equal(tq[nz].view(np.int32), jq[nz].view(np.int32))
    js, jm, je = (np.asarray(a) for a in jf.decompose(jnp.asarray(jq), jfmt))
    ts, tm, te = (a.numpy() for a in tf.decompose(torch.tensor(jq), tfmt))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm.view(np.int32), jm.view(np.int32))
    np.testing.assert_array_equal(te, je)
    comp = tf.compose(torch.tensor(ts), torch.tensor(tm), torch.tensor(te),
                      tfmt).numpy()
    np.testing.assert_array_equal(comp, np.asarray(
        jf.compose(jnp.asarray(js), jnp.asarray(jm), jnp.asarray(je), jfmt)))


def test_pow2i_is_exact_over_the_normal_range():
    e = np.arange(-126, 128, dtype=np.int32)
    got = tf.pow2i(torch.tensor(e)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.pow2i(jnp.asarray(e))))
    np.testing.assert_array_equal(got.astype(np.float64), np.exp2(e))


@pytest.mark.parametrize("enob", [4.0, 6.0, 8.0, 10.0])
def test_adc_quantize_matches_jax(enob):
    rng = np.random.default_rng(int(enob))
    v = np.concatenate([rng.uniform(-1.2, 1.2, 20000),
                        (np.arange(-300, 301) + 0.5) * 2.0 / 2**enob,
                        [0.0, -0.0, 1.0, -1.0, 5.0]]).astype(np.float32)
    got = torch_adc(torch.tensor(v), enob).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_adc(jnp.asarray(v), enob)))


def test_int_quantize_and_parse_format_match_jax():
    v = np.random.default_rng(3).uniform(-1.5, 1.5, 5000).astype(np.float32)
    for bits in (4, 8):
        got = tf.quantize_any(torch.tensor(v), tf.IntFormat(bits)).numpy()
        want = np.asarray(jf.quantize_any(jnp.asarray(v), jf.IntFormat(bits)))
        np.testing.assert_array_equal(got, want)
    for name in FORMATS + ["INT8"]:
        assert tf.parse_format(name).name == jf.parse_format(name).name
    with pytest.raises(ValueError):
        tf.parse_format("FP6_E9")


def _plain(obj):
    """A dataclass tree as plain values; formats by name."""
    if isinstance(obj, (jf.FPFormat, jf.IntFormat, tf.FPFormat, tf.IntFormat)):
        return obj.name
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_plain(o) for o in obj)
    return obj


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = _plain(f.default)
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = _plain(f.default_factory())
        else:
            out[f.name] = "<required>"
    return out


@pytest.mark.parametrize("jcls,tcls", [
    (jf.FPFormat, tf.FPFormat), (jf.IntFormat, tf.IntFormat),
    (jcc.SiteDesign, tcc.SiteDesign), (jcc.CIMConfig, tcc.CIMConfig),
    (jax_get_config("paper-cim-120m").__class__, tbase.ArchConfig)])
def test_config_dataclasses_match_jax(jcls, tcls):
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert _defaults(tcls) == _defaults(jcls)


def test_paper_cim_config_matches_jax_field_by_field():
    ja, ta = jax_get_config("paper-cim-120m"), torch_get_config("paper-cim-120m")
    assert _plain(ta) == _plain(ja)
    assert _plain(ta.reduced()) == _plain(ja.reduced())
    for attr in ("padded_vocab", "param_count", "blocks", "pattern_period"):
        got, want = getattr(ta, attr), getattr(ja, attr)
        assert (got() if callable(got) else got) == \
            (want() if callable(want) else want)
    assert torch_get_config("paper-cim-120m").cim.resolved_enob() == 8.0


def test_every_reference_config_is_registered():
    from repro.configs import list_configs as jax_list
    from repro_torch.configs import list_configs as torch_list

    assert torch_list() == jax_list()
    assert len(torch_list()) == 11


@pytest.mark.parametrize("name", [
    "arctic-480b", "chameleon-34b", "gemma3-1b", "granite-8b", "grok-1-314b",
    "mamba2-1.3b", "musicgen-medium", "qwen2-1.5b", "recurrentgemma-9b",
    "stablelm-3b"])
def test_config_matches_jax_field_by_field(name):
    """Each copied config module (``source`` included), its reduced form
    and its derived sizes."""
    ja, ta = jax_get_config(name), torch_get_config(name)
    assert _plain(ta) == _plain(ja)
    assert _plain(ta.reduced()) == _plain(ja.reduced())
    for attr in ("padded_vocab", "param_count", "blocks", "expert_d_ff"):
        got, want = getattr(ta, attr), getattr(ja, attr)
        assert (got() if callable(got) else got) == \
            (want() if callable(want) else want)


def test_site_resolution_matches_jax():
    jcfg = jcc.CIMConfig(mode="grmac", apply_to=("ffn", "head")) \
        .override_site("head", jcc.SiteDesign(granularity="conv", n_r=64)) \
        .override_site("mlp", "off")
    tcfg = tcc.CIMConfig(mode="grmac", apply_to=("ffn", "head")) \
        .override_site("head", tcc.SiteDesign(granularity="conv", n_r=64)) \
        .override_site("mlp", "off")
    for site in jcc.SITES + ("qkvo", "ffn", "expert"):
        assert _plain(tcfg.for_site(site)) == _plain(jcfg.for_site(site))
    assert tcfg.enabled == jcfg.enabled
    with pytest.raises(ValueError):
        tcfg.override_site("heads", "off")
    d = tcc.SiteDesign(fmt_x=tf.FP8_E4M3, enob=7.0)
    assert tcc.SiteDesign.from_dict(d.as_dict()) == d
    assert d.as_dict() == jcc.SiteDesign(fmt_x=jf.FP8_E4M3, enob=7.0).as_dict()


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
