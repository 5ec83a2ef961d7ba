"""Weights prepared once (``kernels/packed.py``) against the per-call path
and against the JAX package, on the CPU.

Tolerances and why:
- pack -> unpack is bitwise (the bits of every value, -0 included): the
  codes store exactly the per-call path's ``quantize(w / sw)``;
- ``cim_matmul`` with a packed weight against the raw-weight path: bitwise
  (the same operations in the same order);
- against JAX's ``cim_matmul`` with ``backend="ref"``: 0 ulp at integer
  ENOB (every partial sum is exact for these formats), 1e-5 at fractional
  ENOB, where the reference disagrees with itself (ROADMAP section C);
- engine streams: identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import cim_config as jcc  # noqa: E402
from repro.core import formats as jf  # noqa: E402
from repro.kernels.ops import cim_matmul as jax_cim_matmul  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cim_config as tcc  # noqa: E402
from repro_torch.core import formats as tf  # noqa: E402
from repro_torch.kernels.ops import cim_matmul  # noqa: E402
from repro_torch.kernels.packed import (  # noqa: E402
    PackedWeight,
    code_values,
    pack_quantized,
    pack_weight,
    unpack_weight,
)
from repro_torch.models import forward, pack_params  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

FORMATS = ["FP4_E2M1", "FP6_E2M3", "FP6_E3M2", "FP8_E4M3"]
GRANULARITIES = ["row", "conv", "unit"]


def _weight(seed, k, n):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    w[0, :4] = [0.0, -0.0, -1e-9, 1e-9]      # +-0 and values that round to 0
    return w


@pytest.mark.parametrize("n_r", [16, 32, 128])
@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_unpack_round_trip_is_bitwise(fmt, n_r):
    f = getattr(tf, fmt)
    w = torch.tensor(_weight(1, 100, 37))       # K not a multiple of n_r
    w[1, 0] = w.abs().max() * 1.5               # the max value, after scaling
    w[1, 1] = -w[1, 0]
    p = pack_weight(w, f, n_r)
    sw = torch.clamp(torch.amax(torch.abs(w)), min=1e-12)
    want = tf.quantize(w / sw, f)
    got = unpack_weight(p)
    assert p.codes.dtype == torch.uint8 and p.codes.is_contiguous()
    assert p.codes.shape == (p.k_store // p.group, 37, 16)
    assert p.code_bits == (4 if f.bits <= 4 else 8)
    assert got.shape == (p.k_pad, 37) and p.k_pad % n_r == 0
    assert torch.equal(got[:100].view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[100:].view(torch.int32),
                       torch.zeros((p.k_pad - 100, 37), dtype=torch.int32))
    assert bool(torch.signbit(got[0, 2])) and got[1, 0] == f.max_value
    assert torch.equal(p.sw, sw)


@pytest.mark.parametrize("fmt", FORMATS)
def test_code_values_match_the_jax_grid(fmt):
    """Every code's value is a grid point of the reference's quantizer and
    the codes cover the grid: quantizing the table returns it."""
    vals = code_values(getattr(tf, fmt)).numpy()
    assert len(vals) == 2 ** getattr(tf, fmt).bits
    back = np.asarray(jf.quantize(jnp.asarray(vals), getattr(jf, fmt)))
    np.testing.assert_array_equal(back, vals)
    assert np.all(np.diff(vals[:len(vals) // 2]) > 0)


def test_pack_refuses_what_it_cannot_hold():
    w = torch.zeros((32, 4))
    with pytest.raises(ValueError, match="8 bits"):
        pack_weight(w, tf.FPFormat(3, 5), 32)
    with pytest.raises(ValueError, match="n_r"):
        pack_weight(w, tf.FP4_E2M1, 24)


def _cfgs(granularity, enob=None):
    kw = dict(mode="grmac", granularity=granularity, enob=enob)
    return jcc.CIMConfig(**kw), tcc.CIMConfig(**kw)


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("enob", [None, 6.5])
def test_cim_matmul_packed_equals_raw_and_jax(granularity, enob):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (2, 5, 100)).astype(np.float32)   # ragged K
    w = _weight(4, 100, 40)
    jcfg, tcfg = _cfgs(granularity, enob)
    raw = cim_matmul(torch.tensor(x), torch.tensor(w), tcfg)
    packed = cim_matmul(torch.tensor(x),
                        pack_weight(torch.tensor(w), tcfg.fmt_w, tcfg.n_r),
                        tcfg)
    assert packed.shape == (2, 5, 40)
    assert torch.equal(packed, raw)
    want = np.asarray(jax_cim_matmul(jnp.asarray(x), jnp.asarray(w), jcfg,
                                     backend="ref"))
    if enob is None:
        np.testing.assert_array_equal(packed.numpy(), want)
    else:
        np.testing.assert_allclose(packed.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_cim_matmul_packed_serves_only_its_grmac_design():
    x = torch.randn(3, 64, requires_grad=True)
    _, cfg = _cfgs("row")
    p = pack_weight(torch.randn(64, 8), cfg.fmt_w, cfg.n_r)
    with pytest.raises(RuntimeError, match="gradient"):
        cim_matmul(x, p, cfg)
    with torch.no_grad():
        assert cim_matmul(x, p, cfg).shape == (3, 8)
        with pytest.raises(ValueError, match="grmac"):
            cim_matmul(x, p, tcc.CIMConfig(mode="fakequant"))
        with pytest.raises(ValueError, match="n_r"):
            cim_matmul(x, p, tcc.CIMConfig(mode="grmac", n_r=16))


def test_tied_head_packs_contiguous_and_matches_the_raw_path():
    """A tied LM head is ``embed.T``, whose strides are transposed: the
    packed codes are contiguous whatever the input layout, and the packed
    model gives the raw model's logits bit for bit."""
    arch = torch_get_config("paper-cim-120m").reduced().replace(
        tie_embeddings=True)
    jarch = jax_get_config("paper-cim-120m").reduced().replace(
        tie_embeddings=True)
    jp = jax_init_params(jax.random.PRNGKey(2), jarch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), arch, "cpu")
    embed_t = tp["embed"].T
    assert not (embed_t / 2).is_contiguous()
    served = pack_params(tp, arch)
    head = served["lm_head"]["w"]
    assert isinstance(head, PackedWeight) and head.codes.is_contiguous()
    assert "lm_head" not in tp                  # the input is not changed
    toks = torch.tensor(np.random.default_rng(5).integers(0, 512, (2, 16)))
    want = forward(tp, toks, arch)[0]
    got = forward(served, toks, arch)[0]
    assert torch.equal(got, want)


def test_pack_params_follows_the_site_designs():
    arch = torch_get_config("paper-cim-120m").reduced()
    cim = arch.cim.override_site("head", tcc.SiteDesign(n_r=16)) \
        .override_site("attn_o", "off")
    arch = arch.replace(cim=cim)
    params = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jax_get_config("paper-cim-120m").reduced())),
        arch, "cpu")
    served = pack_params(params, arch)
    layer = served["layers"][0]
    assert layer["attn"]["wq"]["w"].n_r == 32
    assert torch.is_tensor(layer["attn"]["wo"]["w"])      # off: kept raw
    assert served["lm_head"]["w"].n_r == 16
    toks = torch.tensor(np.random.default_rng(6).integers(0, 512, (2, 8)))
    assert torch.equal(forward(served, toks, arch)[0],
                       forward(params, toks, arch)[0])


def test_packed_engine_streams_equal_jax_engine():
    jarch = jax_get_config("paper-cim-120m").reduced()
    tarch = torch_get_config("paper-cim-120m").reduced()
    jp = jax_init_params(jax.random.PRNGKey(0), jarch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 512, n)] for n in (5, 12, 9)]
    streams = []
    for eng in (jeng.Engine(jarch, jp, jeng.ServeConfig(batch_slots=4,
                                                        max_ctx=64)),
                teng.Engine(tarch, tp, teng.ServeConfig(batch_slots=4,
                                                        max_ctx=64),
                            device="cpu")):
        for p in prompts:
            eng.add_request(p)
        for _ in range(5):
            eng.step()
        streams.append([[int(t) for t in s] for s in eng.tokens])
    t_eng = eng
    assert isinstance(t_eng.params["layers"][0]["ffn"]["wi"]["w"],
                      PackedWeight)
    assert streams[0] == streams[1]


def test_dispatch_encodes_with_unit_scales():
    """The kernel's entry for pre-scaled operands encodes ``wq`` with sw =
    1; the codes decode back to ``wq``."""
    w = tf.quantize(torch.tensor(_weight(8, 64, 8)) * 10, tf.FP4_E2M1)
    p = pack_quantized(w, torch.ones(()), tf.FP4_E2M1, 32)
    assert torch.equal(unpack_weight(p), w) and float(p.sw) == 1.0


def _zero_packed(k, n):
    return pack_quantized(torch.zeros((k, n)), torch.ones(()), tf.FP4_E2M1,
                          32)


def test_design_switch():
    """Decode up to 32 rows (and K codes it can stage); then the tensor
    cores. Formats bf16 cannot hold take the decode design (f32 FMA) at
    every M."""
    from repro_torch.kernels.grmac_matmul import choose_design

    fx = tf.FP6_E3M2
    head, narrow = _zero_packed(768, 32000), _zero_packed(768, 768)
    wide = tf.FPFormat(3, 10)           # bf16 would round its values
    assert choose_design(8, head, fx) == "decode"
    assert choose_design(32, narrow, wide) == "decode"
    assert choose_design(33, narrow, fx) == "prefill"
    assert choose_design(512, head, fx) == "prefill"
    assert choose_design(64, head, wide) == "decode"
    assert choose_design(512, head, wide) == "decode"
    assert choose_design(8, _zero_packed(20000, 8), fx) == "prefill"  # deep K


def test_wide_formats_beyond_the_decode_stage_are_refused():
    """A format bf16 cannot hold has no tensor-core route, so K beyond what
    the decode design stages is refused by name, not sent elsewhere."""
    from repro_torch.kernels.grmac_matmul import DECODE_MAX_K, choose_design

    wide = tf.FPFormat(3, 10)
    deep = _zero_packed(DECODE_MAX_K + 32, 8)
    assert choose_design(8, _zero_packed(DECODE_MAX_K, 8), wide) == "decode"
    with pytest.raises(ValueError, match="bf16"):
        choose_design(8, deep, wide)
    with pytest.raises(ValueError, match="bf16"):
        choose_design(512, deep, wide)
