"""The port's GR-MAC plain version, dispatch and ``cim_matmul`` against the
JAX package.

Tolerances and why:
- the plain version and grmac ``cim_matmul`` against ``repro``'s ``ref`` and
  ``xla`` backends: 0 ulp (integer ENOB; every partial sum is exact for
  these formats, so the order of sums cannot matter);
- against the Pallas kernel in interpret mode: rtol = atol = 1e-5, the
  bound the JAX suite gives its own kernel (``tests/test_kernels.py``);
- off / fakequant modes: rtol 1e-6, because XLA-CPU and torch-CPU sum the
  plain matmul in different orders;
- STE gradients: rtol 1e-5, for the same reason.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cim_config as jcc  # noqa: E402
from repro.core import formats as jf  # noqa: E402
from repro.kernels.dispatch import grmac_matmul as jax_grmac  # noqa: E402
from repro.kernels.grmac_matmul import grmac_matmul_pallas  # noqa: E402
from repro.kernels.ops import cim_matmul as jax_cim_matmul  # noqa: E402
from repro_torch.core import cim_config as tcc  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    grmac_matmul as torch_grmac,
    pad_to_multiple,
    resolve_backend,
)
from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda  # noqa: E402
from repro_torch.kernels.ops import cim_matmul as torch_cim_matmul  # noqa: E402

GRANULARITIES = ["row", "conv", "unit"]


def _operands(seed, m, k, n, fmt_w=jf.FP4_E2M1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    wq = np.asarray(jf.quantize(jnp.asarray(w), fmt_w))
    return x, wq


def _kw(mod, granularity, n_r, fmt_x="FP6_E3M2", fmt_w="FP4_E2M1", enob=8.0):
    return dict(fmt_x=getattr(mod, fmt_x), fmt_w=getattr(mod, fmt_w),
                n_r=n_r, enob=enob, granularity=granularity)


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("n_r", [16, 32])
@pytest.mark.parametrize("m,k,n", [(7, 100, 13), (33, 200, 65), (64, 96, 128)])
def test_plain_grmac_matches_jax_ref_and_xla(granularity, n_r, m, k, n):
    x, wq = _operands(m * 1000 + k, m, k, n)
    got = torch_grmac(torch.tensor(x), torch.tensor(wq),
                      **_kw(tf, granularity, n_r)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    for backend in ("ref", "xla"):
        want = np.asarray(jax_grmac(jnp.asarray(x), jnp.asarray(wq),
                                    backend=backend,
                                    **_kw(jf, granularity, n_r)))
        np.testing.assert_array_equal(got, want, err_msg=backend)


@pytest.mark.parametrize("enob", [5.0, 9.0])
@pytest.mark.parametrize("fmts", [("FP8_E4M3", "FP4_E2M1"),
                                  ("FP6_E2M3", "FP6_E2M3")])
def test_plain_grmac_other_formats_match_jax_ref(fmts, enob):
    x, wq = _operands(5, 16, 96, 24, getattr(jf, fmts[1]))
    for g in GRANULARITIES:
        got = torch_grmac(torch.tensor(x), torch.tensor(wq),
                          **_kw(tf, g, 32, *fmts, enob=enob)).numpy()
        want = np.asarray(jax_grmac(jnp.asarray(x), jnp.asarray(wq),
                                    backend="ref",
                                    **_kw(jf, g, 32, *fmts, enob=enob)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_plain_grmac_matches_pallas_interpret(granularity):
    x, wq = _operands(0, 128, 128, 128)
    got = torch_grmac(torch.tensor(x), torch.tensor(wq),
                      **_kw(tf, granularity, 32)).numpy()
    want = np.asarray(grmac_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wq), block_m=128, block_n=128,
        block_k=128, interpret=True, **_kw(jf, granularity, 32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dispatch_pads_k_with_gain_two_zeros():
    """A padded zero quantizes to 0 and adds 2^1 to the row denominator:
    K = 40 at n_r = 32 equals the explicitly zero-padded K = 64 call."""
    x, wq = _operands(9, 3, 40, 5)
    kw = _kw(tf, "row", 32)
    got = torch_grmac(torch.tensor(x), torch.tensor(wq), **kw)
    xp = pad_to_multiple(torch.tensor(x), 1, 32)
    wp = pad_to_multiple(torch.tensor(wq), 0, 32)
    assert xp.shape == (3, 64) and wp.shape == (64, 5)
    assert torch.equal(got, torch_grmac(xp, wp, **kw))
    _, _, e = tf.decompose(torch.zeros(3), tf.FP6_E3M2)
    assert torch.equal(tf.pow2i(e), torch.full((3,), 2.0))


def test_dispatch_backends_and_device_contract():
    assert resolve_backend(None) == "auto"
    assert resolve_backend("ref") == "ref"
    with pytest.raises(ValueError):
        resolve_backend("xla")
    x, wq = _operands(1, 4, 32, 8)
    kw = _kw(tf, "row", 32)
    a = torch_grmac(torch.tensor(x), torch.tensor(wq), **kw)
    b = torch_grmac(torch.tensor(x), torch.tensor(wq), backend="ref", **kw)
    assert torch.equal(a, b)
    # the kernel's wrapper never falls back: a CPU tensor is refused
    before = grmac_matmul_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        grmac_matmul_cuda(torch.tensor(x), torch.tensor(wq), **kw)
    assert grmac_matmul_cuda.launches == before


def _jax_cfg(**kw):
    return jcc.CIMConfig(**{k: getattr(jf, v) if k.startswith("fmt") else v
                            for k, v in kw.items()})


def _torch_cfg(**kw):
    return tcc.CIMConfig(**{k: getattr(tf, v) if k.startswith("fmt") else v
                            for k, v in kw.items()})


def _activations(seed, shape=(2, 5, 96), n=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, shape).astype(np.float32),
            rng.normal(0, 0.05, (shape[-1], n)).astype(np.float32))


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_cim_matmul_grmac_matches_jax(granularity):
    x, w = _activations(2)
    kw = dict(mode="grmac", granularity=granularity)
    got = torch_cim_matmul(torch.tensor(x), torch.tensor(w),
                           _torch_cfg(**kw)).numpy()
    want = np.asarray(jax_cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                     _jax_cfg(**kw)))
    assert got.shape == (2, 5, 40)
    np.testing.assert_array_equal(got, want)
    # logical_n is ledger metadata: the numbers do not move
    again = torch_cim_matmul(torch.tensor(x), torch.tensor(w),
                             _torch_cfg(**kw), logical_n=7).numpy()
    np.testing.assert_array_equal(again, got)


def test_cim_matmul_per_site_designs_match_jax():
    x, w = _activations(4)
    jcfg = jcc.CIMConfig(mode="grmac").override_site(
        "head", jcc.SiteDesign(granularity="conv", n_r=16)).override_site(
        "mlp", "off")
    tcfg = tcc.CIMConfig(mode="grmac").override_site(
        "head", tcc.SiteDesign(granularity="conv", n_r=16)).override_site(
        "mlp", "off")
    for site in ("head", "attn_qkv", "mlp"):
        got = torch_cim_matmul(torch.tensor(x), torch.tensor(w), tcfg,
                               site=site).numpy()
        want = np.asarray(jax_cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jcfg, site=site))
        if site == "mlp":      # resolves to off: a plain matmul
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=site)


@pytest.mark.parametrize("mode", ["off", "fakequant"])
def test_cim_matmul_off_and_fakequant_match_jax(mode):
    x, w = _activations(3)
    got = torch_cim_matmul(torch.tensor(x), torch.tensor(w),
                           _torch_cfg(mode=mode)).numpy()
    want = np.asarray(jax_cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                     _jax_cfg(mode=mode)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got_int = torch_cim_matmul(
        torch.tensor(x), torch.tensor(w),
        tcc.CIMConfig(mode="fakequant", fmt_x=tf.IntFormat(8))).numpy()
    want_int = np.asarray(jax_cim_matmul(
        jnp.asarray(x), jnp.asarray(w),
        jcc.CIMConfig(mode="fakequant", fmt_x=jf.IntFormat(8))))
    np.testing.assert_allclose(got_int, want_int, rtol=1e-6, atol=1e-6)


def test_cim_matmul_grmac_int_format_raises():
    x, w = _activations(0)
    cfg = tcc.CIMConfig(mode="grmac", fmt_x=tf.IntFormat(8))
    with pytest.raises(NotImplementedError, match="IntFormat"):
        torch_cim_matmul(torch.tensor(x), torch.tensor(w), cfg)


@pytest.mark.parametrize("mode", ["grmac", "fakequant"])
def test_ste_gradients_match_jax(mode):
    x, w = _activations(6, shape=(3, 64), n=24)
    r = np.random.default_rng(7).normal(size=(3, 24)).astype(np.float32)

    def jloss(xx, ww):
        return jnp.sum(jax_cim_matmul(xx, ww, _jax_cfg(mode=mode))
                       * jnp.asarray(r))

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (torch_cim_matmul(tx, tw, _torch_cfg(mode=mode))
     * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)
