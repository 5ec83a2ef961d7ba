"""The port's model against the JAX package on ``paper-cim-120m.reduced()``
(2 layers, d_model 128, vocab 512, f32, every projection through GR-MAC
row), on the reduced ``gemma3-1b``, ``recurrentgemma-9b`` and
``mamba2-1.3b`` (sliding-window attention, RG-LRU and SSM blocks, GR-MAC
row) and on the seven other reduced configs (the MoE ``grok-1-314b`` and
``arctic-480b``, the dense ``granite-8b``, ``qwen2-1.5b``, ``stablelm-3b``
and ``chameleon-34b``, and ``musicgen-medium`` on embedding inputs), with
the reference's weights carried over by ``params_from_jax``.

Tolerances and why: greedy ids must be equal. Logits, caches and states
agree to 1e-5 absolute (measured: 0 on the train path, at most 9.5e-7 on
the cached paths): RMSNorm's mean, RoPE's exp/cos/sin, softmax and silu
differ in the last ulp between XLA-CPU and torch-CPU. The quantizer
absorbs such differences unless one straddles a rounding boundary; then a
whole output row moves by a grid step, which no tolerance covers (ROADMAP
section C). The ring-wrapping scenario, where the reference itself flips
between two compilations, runs with the CIM path off at 2e-5.
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
from repro_torch.models import pack_params as torch_pack_params  # noqa: E402
from repro_torch.models import train_loss as torch_train_loss  # noqa: E402
from repro_torch.kernels.packed import PackedWeight  # noqa: E402

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
    """Once the refusals of the unported train path, now its agreement with
    JAX: the forward without a cache of RG-LRU and SSM blocks (reduced
    recurrentgemma / mamba2, GR-MAC row) and ``train_loss``, within ATOL
    (``tests/test_torch_train_model.py`` holds the gradients); the engine
    still refuses embedding-input models, as the reference's does (they
    run through ``prefill_step`` / ``decode_step``)."""
    from repro.models import train_loss as jax_train_loss

    rng = np.random.default_rng(7)
    for name in ("recurrentgemma-9b", "mamba2-1.3b"):
        jarch, tarch, jp, tp = _family(name)
        jt, tt = _inputs(rng, tarch, (2, 32))
        jl, _, _ = jax_forward(jp, jt, jarch)
        tl, _, _ = torch_forward(tp, tt, tarch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        assert torch.equal(tl.argmax(-1), _long(jnp.argmax(jl, -1)))
        labels = np.roll(np.asarray(jt), -1, axis=1)
        jtot, jm = jax_train_loss(jp, {"inputs": jt, "labels": labels},
                                  jarch)
        ttot, tm = torch_train_loss(tp, {"inputs": tt, "labels":
                                         _long(labels)}, tarch)
        assert abs(float(ttot) - float(jtot)) <= ATOL
        assert set(tm) == set(jm) == {"loss", "aux_loss", "total"}
    from repro_torch.serving import Engine, ServeConfig

    arch = torch_get_config("musicgen-medium").reduced()
    with pytest.raises(ValueError, match="token models"):
        Engine(arch, torch_init_params(arch, 0, device="cpu"),
               ServeConfig(batch_slots=1, max_ctx=8), device="cpu")


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


# ------------------------------------------------------------ other blocks
FAMILIES = ["gemma3-1b", "recurrentgemma-9b", "mamba2-1.3b"]
OFF_ATOL = 2e-5
_FAMILY_PARAMS = {}


def _family(name):
    """A reduced family config in grmac mode, in both packages, with the
    reference's weights carried over."""
    if name not in _FAMILY_PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        jarch = jarch.replace(cim=jarch.cim.with_mode("grmac"))
        tarch = tarch.replace(cim=tarch.cim.with_mode("grmac"))
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _FAMILY_PARAMS[name] = (jarch, tarch, jp, tp)
    return _FAMILY_PARAMS[name]


def _jax_layers(tree, arch):
    """The reference's stacked cache (or params) tree as one tree of numpy
    arrays per layer."""
    pat = arch.block_pattern
    n_super, n_tail = divmod(arch.n_layers, len(pat))
    out = [jax.tree.map(lambda a: np.asarray(a[i]),
                        tree["superblocks"][f"b{j}_{kind}"])
           for i in range(n_super) for j, kind in enumerate(pat)]
    out += [jax.tree.map(np.asarray, tree["tail"][f"t{i}_{pat[i]}"])
            for i in range(n_tail)]
    return out


def _caches_close(tc, jc, arch, atol=ATOL):
    layers = _jax_layers(jc, arch)
    assert len(layers) == len(tc["layers"])
    for want, got in zip(layers, tc["layers"]):
        assert sorted(want) == sorted(got)
        for name in want:
            assert got[name].dtype == torch.float32
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("name", FAMILIES + ["gemma3-1b:tail"])
def test_family_params_from_jax_layout(name):
    """Mixed patterns: super-blocks of len(block_pattern) layers, then the
    tail (gemma3 with 8 layers: one super-block of 6 and 2 tail layers).
    Every leaf lands in its layer; the port's own init has the converted
    tree's shapes and dtypes."""
    name, _, tail = name.partition(":")
    jarch = jax_get_config(name).reduced()
    tarch = torch_get_config(name).reduced()
    if tail:
        jarch, tarch = jarch.replace(n_layers=8), tarch.replace(n_layers=8)
    jp = jax_init_params(jax.random.PRNGKey(0), jarch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
    want = _jax_layers(jp, tarch)        # the same stacking as caches
    assert len(tp["layers"]) == len(want) == tarch.n_layers
    for kind, got, ref in zip(tarch.blocks(), tp["layers"], want):
        assert set(got) == set(ref)
        assert set(got) == ({"norm1", "ssm"} if kind == "ssm" else
                            {"norm1", "norm2", "ffn",
                             "rglru" if kind == "rglru" else "attn"})
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(ref)[0],
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(lambda t: t.numpy(), got))[0]):
            np.testing.assert_array_equal(b, a, err_msg=str(path))
    own = torch_init_params(tarch, seed=0, device="cpu")
    assert _shapes(own) == _shapes(tp)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_prefill_and_decode_match_jax(name):
    """As ``test_prefill_and_decode_match_jax``, with every projection
    through GR-MAC: bucketed prefill with lanes at different offsets and
    lengths (one frozen at length 0), then a decode step whose indices
    include the last slot and one past it (the clamped write of a global
    layer, the ring's wrap to slot 0 of a local one). Logits, greedy ids
    and every cache (KV, ring, RG-LRU and SSM states, conv windows)."""
    jarch, tarch, jp, tp = _family(name)
    rng = np.random.default_rng(1)
    b, s, ctx = 4, 16, 64
    idx = np.array([0, 3, 0, 5], np.int32)
    lens = np.array([16, 7, 0, 12], np.int32)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    jc = jax_init_cache(jarch, b, ctx, jnp.float32)
    tc = torch_init_cache(tarch, b, ctx, torch.float32, "cpu")
    jl, jids, jc = jax_prefill(jp, jnp.asarray(toks), jarch, jc,
                               jnp.asarray(idx), jnp.asarray(lens))
    tl, tids, tc = torch_prefill(tp, _long(toks), tarch, tc, _long(idx),
                                 _long(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _caches_close(tc, jc, jarch)
    for layer in tc["layers"]:            # the frozen lane is untouched
        assert not any(t[2].any() for t in layer.values())
    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    at = np.array([16, 10, ctx - 1, ctx], np.int32)
    jd, jc = jax_decode(jp, jnp.asarray(tok), jarch, jc, jnp.asarray(at))
    td, tc = torch_decode(tp, _long(tok), tarch, tc, _long(at))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(td.numpy().argmax(-1),
                                  np.asarray(jd).argmax(-1))
    _caches_close(tc, jc, jarch)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_ring_wrapping_prefill_and_decode_match_jax(name):
    """An 80-token chunk into 64-slot rings (ctx 128), lanes at offsets,
    one frozen, then three decode steps: logits, ids and every cache.

    With the CIM path off, within 2e-5 absolute (measured: 1.3e-5 on ring
    values of magnitude 4.2, 1.0e-5 on logits, in recurrentgemma; the
    last-ulp differences of RMSNorm's sum, RoPE, softmax and the
    recurrences compound over the layers, and no quantizer rounds them
    away). With GR-MAC this scenario
    does not give the reference's numbers, and it does not give them in
    the reference either: compiled as one layer, XLA fuses RMSNorm and
    attention differently from the same operations compiled one by one,
    the last-ulp difference straddles a rounding boundary of the input
    quantizer, and the row normalization carries the flipped code over a
    whole output row (layer 0 of gemma3: one token's row differs between
    the two compilations of the reference; the port matches the op-by-op
    one). ROADMAP section C has the finding.
    """
    jarch, tarch, jp, tp = _family(name)
    jarch, tarch = jarch.replace(cim=JARCH.cim.with_mode("off")), \
        tarch.replace(cim=TARCH.cim.with_mode("off"))
    rng = np.random.default_rng(1)
    b, s, ctx = 4, 80, 128
    idx = np.array([0, 3, 0, 40], np.int32)
    lens = np.array([80, 9, 0, 30], np.int32)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    jc = jax_init_cache(jarch, b, ctx, jnp.float32)
    tc = torch_init_cache(tarch, b, ctx, torch.float32, "cpu")
    jl, jids, jc = jax_prefill(jp, jnp.asarray(toks), jarch, jc,
                               jnp.asarray(idx), jnp.asarray(lens))
    tl, tids, tc = torch_prefill(tp, _long(toks), tarch, tc, _long(idx),
                                 _long(lens))
    valid = np.arange(s)[None, :] < lens[:, None]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=OFF_ATOL)
    np.testing.assert_array_equal(tids.numpy()[valid],
                                  np.asarray(jids)[valid])
    _caches_close(tc, jc, jarch, atol=OFF_ATOL)
    at = idx + lens
    for step in range(3):
        tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
        jd, jc = jax_decode(jp, jnp.asarray(tok), jarch, jc,
                            jnp.asarray(at + step))
        td, tc = torch_decode(tp, _long(tok), tarch, tc, _long(at + step))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=OFF_ATOL)
        np.testing.assert_array_equal(td.numpy().argmax(-1),
                                      np.asarray(jd).argmax(-1))
        _caches_close(tc, jc, jarch, atol=OFF_ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_decode_active_mask_freezes_lanes(name):
    """Lanes outside ``active`` compute like the others and come back
    bitwise unchanged in every cache kind: KV rows, rings, RG-LRU and SSM
    states, conv windows."""
    _, tarch, _, tp = _family(name)
    b, ctx = 3, 32
    tc = torch_init_cache(tarch, b, ctx, torch.float32, "cpu")
    toks = torch.randint(0, 512, (b, 8), generator=torch.Generator()
                         .manual_seed(0))
    torch_prefill(tp, toks, tarch, tc, torch.zeros(b, dtype=torch.int64),
                  torch.full((b,), 8))

    def copy(cache):
        return {"layers": [{n: t.clone() for n, t in c.items()}
                           for c in cache["layers"]]}

    before = copy(tc)
    tok = torch.tensor([[5], [6], [7]])
    at = torch.tensor([8, 8, ctx])
    full, _ = torch_decode(tp, tok, tarch, copy(before), at)
    part, tc = torch_decode(tp, tok, tarch, tc, at,
                            active=torch.tensor([True, False, False]))
    assert torch.equal(part, full)
    for c, old in zip(tc["layers"], before["layers"]):
        for n in c:
            assert not torch.equal(c[n][0], old[n][0])
            assert torch.equal(c[n][1:], old[n][1:])


# ------------------------------------------------- the other architectures
# MoE (grok: 4 experts top-2 reduced; arctic: 4 experts and the dense
# residual MLP), the dense configs that need nothing but their config
# (qwen2's QKV bias, stablelm's MHA), and musicgen on embedding inputs
# with the GELU MLP
NEW_CONFIGS = ["arctic-480b", "chameleon-34b", "granite-8b", "grok-1-314b",
               "musicgen-medium", "qwen2-1.5b", "stablelm-3b"]
MOE_CONFIGS = ["arctic-480b", "grok-1-314b"]
_NEW_PARAMS = {}


def _new(name, mode):
    """A reduced config with the CIM path ``mode`` in both packages, with the
    reference's weights carried over."""
    if (name, mode) not in _NEW_PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        jarch = jarch.replace(cim=jarch.cim.with_mode(mode))
        tarch = tarch.replace(cim=tarch.cim.with_mode(mode))
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _NEW_PARAMS[name, mode] = (jarch, tarch, jp, tp)
    return _NEW_PARAMS[name, mode]


def _inputs(rng, arch, shape):
    """Token ids, or seeded f32 embeddings (B, S, D) for an embedding-input
    model; returned for both packages."""
    if arch.input_mode == "tokens":
        a = rng.integers(0, arch.vocab_size, shape).astype(np.int32)
        return jnp.asarray(a), _long(a)
    a = rng.standard_normal((*shape, arch.d_model)).astype(np.float32)
    return jnp.asarray(a), torch.tensor(a)


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_new_config_params_from_jax_layout(name):
    """Every leaf of the reference's tree lands in its layer (an MoE layer's
    f32 router, stacked experts and arctic's dense residual under
    ``moe``; no embedding table for musicgen), and the port's own init
    has the converted tree's shapes and dtypes."""
    jarch, tarch, jp, tp = _new(name, "off")
    want = _jax_layers(jp, tarch)
    assert ("embed" in tp) == (tarch.input_mode == "tokens")
    assert len(tp["layers"]) == len(want) == tarch.n_layers
    for got, ref in zip(tp["layers"], want):
        assert set(got) == set(ref) == {
            "norm1", "norm2", "attn", "moe" if tarch.is_moe else "ffn"}
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(ref)[0],
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(lambda t: t.numpy(), got))[0]):
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        if tarch.is_moe:
            assert got["moe"]["router"]["w"].dtype == torch.float32
            assert got["moe"]["experts"]["wi"].shape == (
                tarch.n_experts, tarch.d_model, tarch.expert_d_ff)
            assert ("dense_mlp" in got["moe"]) == tarch.moe_dense_residual
    own = torch_init_params(tarch, seed=0, device="cpu")
    assert _shapes(own) == _shapes(tp)
    own_bf16 = torch_init_params(tarch.replace(dtype="bfloat16"), seed=0,
                                 device="cpu")
    if tarch.is_moe:
        assert own_bf16["layers"][0]["moe"]["router"]["w"].dtype \
            == torch.float32
    # served params: every CIM site packed, the digital experts not
    grmac = tarch.replace(cim=tarch.cim.with_mode("grmac"))
    served = torch_pack_params(tp, grmac)
    layer = served["layers"][0]
    packed = [layer["attn"]["wq"]["w"], served["lm_head"]["w"]]
    if tarch.is_moe:
        packed.append(layer["moe"]["router"]["w"])
        assert isinstance(layer["moe"]["experts"]["wi"], torch.Tensor)
    else:
        packed.append(layer["ffn"]["wi"]["w"])
    assert all(isinstance(w, PackedWeight) for w in packed)


@pytest.mark.parametrize("mode", ["off", "grmac"])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_train_forward_matches_jax(name, mode):
    """Train-path logits and the summed aux loss. With GR-MAC every
    projection's output is quantized and the logits come out bitwise
    (measured); with the CIM path off the exact matmuls round in XLA's
    order or torch's, within 1e-5 (measured: at most 3.8e-6)."""
    jarch, tarch, jp, tp = _new(name, mode)
    jin, tin = _inputs(np.random.default_rng(0), tarch, (2, 24))
    jl, jaux, _ = jax_forward(jp, jin, jarch)
    tl, taux, _ = torch_forward(tp, tin, tarch)
    atol = 0.0 if mode == "grmac" else ATOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_new_config_prefill_and_decode_match_jax(name):
    """As ``test_family_prefill_and_decode_match_jax``, every projection (the
    MoE router and arctic's dense residual included) through GR-MAC:
    bucketed prefill with lanes at different offsets and lengths (one
    frozen at length 0, whose padded steps take no expert capacity),
    then a decode step whose indices include the last slot and one past
    it. musicgen takes seeded (B, S, D) embeddings. Logits, greedy ids and
    every KV cache within 1e-5 (measured: at most 4.8e-7)."""
    jarch, tarch, jp, tp = _new(name, "grmac")
    rng = np.random.default_rng(1)
    b, s, ctx = 4, 16, 64
    idx = np.array([0, 3, 0, 5], np.int32)
    lens = np.array([16, 7, 0, 12], np.int32)
    jin, tin = _inputs(rng, tarch, (b, s))
    jc = jax_init_cache(jarch, b, ctx, jnp.float32)
    tc = torch_init_cache(tarch, b, ctx, torch.float32, "cpu")
    jl, jids, jc = jax_prefill(jp, jin, jarch, jc, jnp.asarray(idx),
                               jnp.asarray(lens))
    tl, tids, tc = torch_prefill(tp, tin, tarch, tc, _long(idx), _long(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _caches_close(tc, jc, jarch)
    for layer in tc["layers"]:            # the frozen lane is untouched
        assert not any(t[2].any() for t in layer.values())
    jtok, ttok = _inputs(rng, tarch, (b, 1))
    at = np.array([16, 10, ctx - 1, ctx], np.int32)
    jd, jc = jax_decode(jp, jtok, jarch, jc, jnp.asarray(at))
    td, tc = torch_decode(tp, ttok, tarch, tc, _long(at))
    assert td.shape == (b, tarch.padded_vocab)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(td.numpy().argmax(-1),
                                  np.asarray(jd).argmax(-1))
    _caches_close(tc, jc, jarch)
