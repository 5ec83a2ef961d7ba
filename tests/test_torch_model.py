"""The port's model against the JAX package on ``paper-cim-120m.reduced()``
(2 layers, d_model 128, vocab 512, f32, every projection through GR-MAC
row), with the reference's weights carried over by ``params_from_jax``.

Tolerances and why: greedy ids must be equal. Logits agree to 1e-5
absolute (measured: 0 on the train path, at most 7.2e-7 on the cached
paths, against logits of magnitude ~4): RMSNorm's mean, RoPE's
exp/cos/sin, softmax and silu differ in the last ulp between XLA-CPU and
torch-CPU, and the pre-scale + quantizer can turn such an ulp into a grid
step on a rare element, so the bound leaves room for one such step.
Caches are compared at the same bound.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill_step as jax_prefill  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step as torch_decode  # noqa: E402
from repro_torch.models import forward as torch_forward  # noqa: E402
from repro_torch.models import init_cache as torch_init_cache  # noqa: E402
from repro_torch.models import init_params as torch_init_params  # noqa: E402
from repro_torch.models import prefill_step as torch_prefill  # noqa: E402

ATOL = 1e-5
JARCH = jax_get_config("paper-cim-120m").reduced()
TARCH = torch_get_config("paper-cim-120m").reduced()


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax.random.PRNGKey(0), JARCH)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), TARCH, "cpu")


def _long(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


def _jax_layer_cache(cache, layer, name):
    return np.asarray(cache["superblocks"]["b0_attn"][name][layer])


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


def test_params_from_jax_layout(params):
    jp, tp = params
    assert len(tp["layers"]) == TARCH.n_layers
    for layer in range(TARCH.n_layers):
        for path in (("attn", "wq"), ("attn", "wo"), ("ffn", "wg")):
            want = np.asarray(jp["superblocks"]["b0_attn"][path[0]][path[1]]
                              ["w"][layer])
            np.testing.assert_array_equal(
                tp["layers"][layer][path[0]][path[1]]["w"].numpy(), want)
    own = torch_init_params(TARCH, seed=0, device="cpu")
    assert _shapes(own) == _shapes(tp)


def test_train_forward_matches_jax(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)
    jl = np.asarray(jax_forward(jp, jnp.asarray(toks), JARCH)[0])
    tl = torch_forward(tp, _long(toks), TARCH)[0].numpy()
    assert tl.shape == (2, 24, TARCH.padded_vocab)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def test_prefill_and_decode_match_jax(params):
    """Bucketed prefill with lanes at different offsets and lengths (one
    frozen at length 0), then a decode step whose indices include the last
    slot and one past it (the clamped write)."""
    jp, tp = params
    rng = np.random.default_rng(1)
    b, s, ctx = 4, 16, 64
    idx = np.array([0, 3, 0, 5], np.int32)
    lens = np.array([16, 7, 0, 12], np.int32)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    jc = jax_init_cache(JARCH, b, ctx, jnp.float32)
    tc = torch_init_cache(TARCH, b, ctx, torch.float32, "cpu")
    jl, jids, jc = jax_prefill(jp, jnp.asarray(toks), JARCH, jc,
                               jnp.asarray(idx), jnp.asarray(lens))
    tl, tids, tc = torch_prefill(tp, _long(toks), TARCH, tc, _long(idx),
                                 _long(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    for layer in range(TARCH.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tc["layers"][layer][name].numpy(),
                _jax_layer_cache(jc, layer, name), rtol=0, atol=ATOL)
    # the frozen lane's cache is untouched
    assert not tc["layers"][0]["k"][2].any()

    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    at = np.array([16, 10, ctx - 1, ctx], np.int32)
    jd, jc = jax_decode(jp, jnp.asarray(tok), JARCH, jc, jnp.asarray(at))
    td, tc = torch_decode(tp, _long(tok), TARCH, tc, _long(at))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(td.numpy().argmax(-1),
                                  np.asarray(jd).argmax(-1))
    for layer in range(TARCH.n_layers):
        np.testing.assert_allclose(tc["layers"][layer]["k"].numpy(),
                                   _jax_layer_cache(jc, layer, "k"),
                                   rtol=0, atol=ATOL)


def test_decode_active_mask_freezes_lanes(params):
    """Lanes outside ``active`` compute like the others but keep their
    caches, which is what the reference engine's per-lane merge leaves."""
    _, tp = params
    b, ctx = 3, 32
    tc = torch_init_cache(TARCH, b, ctx, torch.float32, "cpu")
    toks = torch.randint(0, 512, (b, 8), generator=torch.Generator()
                         .manual_seed(0))
    torch_prefill(tp, toks, TARCH, tc, torch.zeros(b, dtype=torch.int64),
                  torch.full((b,), 8))
    before = [{n: t.clone() for n, t in c.items()} for c in tc["layers"]]
    tok = torch.tensor([[5], [6], [7]])
    at = torch.tensor([8, 8, ctx])
    full, _ = torch_decode(tp, tok, TARCH,
                           {"layers": [{n: t.clone() for n, t in c.items()}
                                       for c in before]}, at)
    part, tc = torch_decode(tp, tok, TARCH, tc, at,
                            active=torch.tensor([True, False, False]))
    assert torch.equal(part, full)
    for c, old in zip(tc["layers"], before):
        assert not torch.equal(c["k"][0], old["k"][0])
        assert torch.equal(c["k"][1:], old["k"][1:])
        assert torch.equal(c["v"][1:], old["v"][1:])


def test_unported_block_kinds_raise():
    with pytest.raises(NotImplementedError, match="local"):
        torch_init_params(TARCH.replace(block_pattern=("attn", "local")), 0,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        torch_init_cache(TARCH.replace(n_experts=4), 1, 8, device="cpu")


@pytest.mark.parametrize("variant", [dict(gated_mlp=False),
                                     dict(tie_embeddings=True),
                                     dict(qkv_bias=True, n_layers=3)])
def test_model_variants_match_jax(variant):
    """The GELU MLP, the tied LM head (a CIM site too) and QKV biases."""
    jarch, tarch = JARCH.replace(**variant), TARCH.replace(**variant)
    jp = jax_init_params(jax.random.PRNGKey(1), jarch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
    toks = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(np.int32)
    jl = np.asarray(jax_forward(jp, jnp.asarray(toks), jarch)[0])
    tl = torch_forward(tp, _long(toks), tarch)[0].numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
