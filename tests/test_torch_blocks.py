"""The port's sliding-window attention, RG-LRU and Mamba2 SSD blocks
against the JAX package's, block by block, on the reduced configs
(d_model 128, window 64, f32) with every projection through GR-MAC row.

Weights come from the reference's ``init_params`` through
``params_from_jax``; inputs, caches and states from a numpy seed. Both
packages see the same full batch (the CIM pre-scale couples the lanes).

Tolerance: 1e-5 absolute on outputs, caches and states (measured: at
most 7.2e-7, on values of magnitude 1-4). The projections agree bitwise
on equal inputs; what remains are last-ulp differences of exp, sigmoid,
softplus, sqrt, softmax, RoPE and the SSM's C . H contraction between
XLA-CPU and torch-CPU. Lanes that must not move (``length == 0``) are
held bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = 1e-5


def _archs(name):
    j = jax_get_config(name).reduced()
    t = torch_get_config(name).reduced()
    return (j.replace(cim=j.cim.with_mode("grmac")),
            t.replace(cim=t.cim.with_mode("grmac")))


def _layer_params(name, kind):
    """The first ``kind`` layer's params in both packages' layouts."""
    jarch, tarch = _archs(name)
    jp = jax_init_params(jax.random.PRNGKey(0), jarch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
    j = tarch.blocks().index(kind)
    jl = jax.tree.map(lambda a: a[0],
                      jp["superblocks"][f"b{j}_{kind}"])
    return jarch, tarch, jl, tp["layers"][j]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def _t(a):
    a = np.asarray(a)
    return torch.tensor(a, dtype=torch.int64 if a.dtype.kind == "i"
                        else None)


# ------------------------------------------------------------ local attention
@pytest.fixture(scope="module")
def local_attn():
    return _layer_params("gemma3-1b", "local")


def test_local_attention_train_mask_matches_jax(local_attn):
    """96 positions against a 64-wide window: the band drops the oldest
    keys of the later queries."""
    jarch, tarch, jp, tp = local_attn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 96, tarch.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(96), (2, 96))
    want, _ = JL.attention(jp["attn"], jnp.asarray(x), jarch, local=True,
                           positions=jnp.asarray(pos))
    got, _ = TL.attention(tp["attn"], _t(x), tarch, local=True,
                          positions=_t(pos))
    _close(got, want)
    full, _ = TL.attention(tp["attn"], _t(x), tarch, local=False,
                           positions=_t(pos))
    assert torch.equal(full[:, :64], got[:, :64])      # inside the window
    assert not torch.equal(full[:, 64:], got[:, 64:])  # past it


def _ring(rng, b, s_ctx, tarch):
    shape = (b, s_ctx, tarch.n_kv_heads, tarch.d_head)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("ctx", [64, 48])
def test_ring_decode_matches_jax(local_attn, ctx):
    """Decode into a ring of min(window, ctx) slots at indices before,
    at and far past the first wrap; ctx 48 keeps a ring shorter than the
    window."""
    jarch, tarch, jp, tp = local_attn
    rng = np.random.default_rng(1)
    b = 4
    ring = _ring(rng, b, min(tarch.window, ctx), tarch)
    x = rng.standard_normal((b, 1, tarch.d_model)).astype(np.float32)
    idx = np.array([5, 63, 64, 201])
    pos = idx[:, None]
    want, wc = JL.attention(jp["attn"], jnp.asarray(x), jarch, local=True,
                            positions=jnp.asarray(pos),
                            cache=jax.tree.map(jnp.asarray, ring),
                            cache_index=jnp.asarray(idx))
    tc = {n: _t(a) for n, a in ring.items()}
    got, tc = TL.attention(tp["attn"], _t(x), tarch, local=True,
                           positions=_t(pos), cache=tc, cache_index=_t(idx))
    _close(got, want)
    for n in ("k", "v"):
        _close(tc[n], wc[n])


def test_ring_chunked_prefill_longer_than_window_matches_jax(local_attn):
    """An 80-step chunk into a 64-slot ring: lanes from an empty ring, at
    an offset, frozen (length 0) past a wrap, and a 70-token chunk that
    wraps the ring mid-chunk on top of older contents. Only the last
    min(len, 64) valid steps write; queries see the pre-write ring."""
    jarch, tarch, jp, tp = local_attn
    rng = np.random.default_rng(2)
    b, s = 4, 80
    ring = _ring(rng, b, tarch.window, tarch)
    x = rng.standard_normal((b, s, tarch.d_model)).astype(np.float32)
    idx = np.array([0, 3, 100, 50])
    lens = np.array([80, 7, 0, 70])
    pos = idx[:, None] + np.arange(s)[None, :]
    want, wc = JL.attention(jp["attn"], jnp.asarray(x), jarch, local=True,
                            positions=jnp.asarray(pos),
                            cache=jax.tree.map(jnp.asarray, ring),
                            cache_index=jnp.asarray(idx),
                            chunk_lengths=jnp.asarray(lens))
    tc = {n: _t(a) for n, a in ring.items()}
    got, tc = TL.attention(tp["attn"], _t(x), tarch, local=True,
                           positions=_t(pos), cache=tc, cache_index=_t(idx),
                           chunk_lengths=_t(lens))
    _close(got, want)
    for n in ("k", "v"):
        _close(tc[n], wc[n])
        assert torch.equal(tc[n][2], _t(ring[n][2]))     # the frozen lane
    # lane 0 wrote steps 16..79, step t at slot t mod 64
    assert not torch.equal(tc["k"][0], _t(ring["k"][0]))


def test_ring_slot_takes_the_latest_writer(local_attn):
    """The slot -> step map of a ring prefill, for every offset and length
    of a 20-step chunk into an 8-slot ring: each slot holds the last valid
    step landing on it, only the last min(len, 8) steps write (the
    reference's scatter), and the other slots keep their contents."""
    _, tarch, _, _ = local_attn
    cfg = tarch.replace(window=8)
    s_ctx, s = 8, 20
    idx = torch.arange(19).repeat_interleave(s + 1)
    lens = torch.arange(s + 1).repeat(19)
    b = idx.shape[0]
    step = torch.arange(1, s + 1, dtype=torch.float32)
    kv = step[None, :, None, None].expand(b, s, 1, 1)
    cache = {n: torch.full((b, s_ctx, 1, 1), -1.0) for n in ("k", "v")}
    TL._chunk_prefill_attention(kv, kv, kv, kv[..., 0], cache, idx, lens,
                                cfg, local=True)
    for lane in range(b):
        i, n = int(idx[lane]), int(lens[lane])
        want = [-1.0] * s_ctx
        for t in range(max(0, n - s_ctx), n):
            want[(i + t) % s_ctx] = t + 1.0
        assert cache["k"][lane, :, 0, 0].tolist() == want, (i, n)


# ------------------------------------------------------------ RG-LRU
@pytest.fixture(scope="module")
def rglru_layer():
    return _layer_params("recurrentgemma-9b", "rglru")


def _rnn_state(rng, b, h_shape, conv_shape):
    return {"h": (0.5 * rng.standard_normal((b, *h_shape))).astype(np.float32),
            "conv": rng.standard_normal((b, *conv_shape)).astype(np.float32)}


def test_rglru_decode_matches_jax(rglru_layer):
    jarch, tarch, jp, tp = rglru_layer
    rng = np.random.default_rng(3)
    b, w = 4, tarch.rnn_width
    st = _rnn_state(rng, b, (w,), (tarch.conv_width - 1, w))
    u = rng.standard_normal((b, 1, tarch.d_model)).astype(np.float32)
    want, ws = JR.rglru_decode(jp["rglru"], jnp.asarray(u), jarch,
                               jax.tree.map(jnp.asarray, st))
    got, ts = TR.rglru_decode(tp["rglru"], _t(u), tarch,
                              {n: _t(a) for n, a in st.items()})
    _close(got, want)
    for n in ("h", "conv"):
        _close(ts[n], ws[n])


def test_rglru_prefill_matches_jax_and_freezes_empty_lanes(rglru_layer):
    jarch, tarch, jp, tp = rglru_layer
    rng = np.random.default_rng(4)
    b, s, w = 4, 24, tarch.rnn_width
    st = _rnn_state(rng, b, (w,), (tarch.conv_width - 1, w))
    u = rng.standard_normal((b, s, tarch.d_model)).astype(np.float32)
    lens = np.array([24, 5, 0, 17])
    want, ws = JR.rglru_prefill(jp["rglru"], jnp.asarray(u), jarch,
                                jax.tree.map(jnp.asarray, st),
                                jnp.asarray(lens))
    got, ts = TR.rglru_prefill(tp["rglru"], _t(u), tarch,
                               {n: _t(a) for n, a in st.items()}, _t(lens))
    _close(got, want)
    for n in ("h", "conv"):
        _close(ts[n], ws[n])
        assert torch.equal(ts[n][2], _t(st[n][2]))


# ------------------------------------------------------------ SSM
@pytest.fixture(scope="module")
def ssm_layer():
    return _layer_params("mamba2-1.3b", "ssm")


def _ssm_state(rng, b, tarch):
    return _rnn_state(rng, b, (tarch.ssm_heads, tarch.ssm_state,
                               tarch.ssm_headdim),
                      (tarch.conv_width - 1, tarch.d_inner))


def test_ssm_decode_matches_jax(ssm_layer):
    jarch, tarch, jp, tp = ssm_layer
    rng = np.random.default_rng(5)
    b = 4
    st = _ssm_state(rng, b, tarch)
    u = rng.standard_normal((b, 1, tarch.d_model)).astype(np.float32)
    want, ws = JS.ssm_decode(jp["ssm"], jnp.asarray(u), jarch,
                             jax.tree.map(jnp.asarray, st))
    got, ts = TS.ssm_decode(tp["ssm"], _t(u), tarch,
                            {n: _t(a) for n, a in st.items()})
    _close(got, want)
    for n in ("h", "conv"):
        _close(ts[n], ws[n])


def test_ssm_prefill_matches_jax_and_freezes_empty_lanes(ssm_layer):
    jarch, tarch, jp, tp = ssm_layer
    rng = np.random.default_rng(6)
    b, s = 4, 24
    st = _ssm_state(rng, b, tarch)
    u = rng.standard_normal((b, s, tarch.d_model)).astype(np.float32)
    lens = np.array([24, 5, 0, 17])
    want, ws = JS.ssm_prefill(jp["ssm"], jnp.asarray(u), jarch,
                              jax.tree.map(jnp.asarray, st),
                              jnp.asarray(lens))
    got, ts = TS.ssm_prefill(tp["ssm"], _t(u), tarch,
                             {n: _t(a) for n, a in st.items()}, _t(lens))
    _close(got, want)
    for n in ("h", "conv"):
        _close(ts[n], ws[n])
        assert torch.equal(ts[n][2], _t(st[n][2]))
