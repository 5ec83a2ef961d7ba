"""The port's MoE block against ``repro.models.moe`` on equal inputs, on the
reduced ``grok-1-314b`` (4 experts top-2) and ``arctic-480b`` (4 experts
top-2 and the dense residual MLP), f32, with the CIM path off and with
GR-MAC row (the router is a CIM site, ``moe_router``; so is arctic's dense
residual, ``mlp``).

Tolerances: the routing decisions (expert ids, kept assignments, slots)
must be equal; outputs and the aux loss within 1e-5 absolute (measured:
at most 2.4e-7 on outputs of magnitude up to 1.9, 1.2e-7 on the aux
loss). XLA's and torch's batched matmuls and softmax round differently
in the last ulp. A routing decision that rests on such an ulp
(two router probabilities an ulp apart) could go either way; on equal
inputs no test scenario has one, and exact ties (a collapsed router) are
broken alike, to the lower expert index. In GR-MAC mode a last-ulp
difference upstream can also flip an input code of the router's quantizer
(ROADMAP section C), and a flipped router row can send a token to another
expert, a larger effect than a code flip: a whole-model scenario that
parts only in GR-MAC mode and agrees with the CIM path off is that, not a
port fault.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.models import moe as torch_moe  # noqa: E402

ATOL = 1e-5
ARCHS = ["grok-1-314b", "arctic-480b"]


def _archs(name, mode):
    jarch = jax_get_config(name).reduced()
    tarch = torch_get_config(name).reduced()
    return (jarch.replace(cim=jarch.cim.with_mode(mode)),
            tarch.replace(cim=tarch.cim.with_mode(mode)))


def _params(jarch, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jarch, jnp.float32)
    return jp, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)


def _jax_routing(jp, x, valid, jarch):
    """The reference's routing decisions for ``x`` (T, D): top-k ids and
    its dispatch's slots and kept assignments."""
    e, k = jarch.n_experts, jarch.top_k
    t = x.shape[0]
    logits = jax_layers.dense(jp["router"], jnp.asarray(x), jarch.cim,
                              "moe_router")
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(4, int(np.ceil(t * k / e * jarch.capacity_factor)))
    _, slot, keep = jax_moe._dispatch_local(
        jnp.asarray(x), idx, jnp.asarray(valid), e, cap)
    return np.asarray(idx), np.asarray(slot), np.asarray(keep), cap


def _torch_routing(tp, x, valid, tarch):
    t = x.shape[0]
    _, _, idx = torch_moe.route(tp, torch.tensor(x), tarch)
    cap = torch_moe.capacity(t, tarch)
    _, slot, keep = torch_moe.dispatch(torch.tensor(x), idx,
                                       torch.tensor(valid),
                                       tarch.n_experts, cap)
    return idx.numpy(), slot.numpy(), keep.numpy(), cap


@pytest.mark.parametrize("mode", ["off", "grmac"])
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_moe_block_matches_jax(name, mode, masked):
    """Outputs, aux loss and every routing decision on equal inputs; with
    ``masked``, a chunked prefill's ``valid`` mask (lanes of lengths 12, 5,
    0 and 16 in a 16-step bucket), whose padded rows take no capacity and
    combine to zero."""
    jarch, tarch = _archs(name, mode)
    jp, tp = _params(jarch)
    rng = np.random.default_rng(0)
    b, s, d = 4, 16, jarch.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    valid = None
    if masked:
        valid = np.arange(s)[None, :] < np.array([12, 5, 0, 16])[:, None]
    jout, jaux = jax_moe.moe(jp, jnp.asarray(x), jarch,
                             valid=None if valid is None
                             else jnp.asarray(valid))
    tout, taux = torch_moe.moe(tp, torch.tensor(x), tarch,
                               valid=None if valid is None
                               else torch.tensor(valid))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL)
    vf = (np.ones(b * s, bool) if valid is None else valid.reshape(-1))
    want = _jax_routing(jp, x.reshape(b * s, d), vf, jarch)
    got = _torch_routing(tp, x.reshape(b * s, d), vf, tarch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if masked:
        # padded rows route nowhere; without a dense residual they come
        # back zero
        assert not got[2][~np.repeat(vf, tarch.top_k)].any()
        if not tarch.moe_dense_residual:
            assert not tout.numpy()[~valid].any()


@pytest.mark.parametrize("mode", ["off", "grmac"])
def test_collapsed_router_ties_and_drops_match_jax(mode):
    """Zero router weights: every probability is 1/E, so every choice is a
    tie, and both packages send every token to experts 0 and 1 (the lower
    indices first), with gates 1/2. 64 tokens give 128 assignments for a
    capacity of 40 an expert: each package keeps exactly the first 40
    tokens' assignments to experts 0 and 1 and drops the rest; with a
    ``valid`` mask over half the tokens, the invalid ones take no
    capacity."""
    jarch, tarch = _archs("grok-1-314b", mode)
    jp, tp = _params(jarch)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    rng = np.random.default_rng(1)
    t, d = 64, jarch.d_model
    x = rng.standard_normal((t, d)).astype(np.float32)
    for vf in (np.ones(t, bool), np.arange(t) % 2 == 0):
        want = _jax_routing(jp, x, vf, jarch)
        got = _torch_routing(tp, x, vf, tarch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        idx, _, keep, cap = got
        assert cap == 40
        assert (idx == [0, 1]).all()
        n_valid = int(vf.sum())
        assert int(keep.sum()) == 2 * min(cap, n_valid)
        kept_tokens = np.where(vf)[0][:cap]
        np.testing.assert_array_equal(keep.reshape(t, 2).all(-1),
                                      np.isin(np.arange(t), kept_tokens))
    _, gates, _ = torch_moe.route(tp, torch.tensor(x), tarch)
    assert torch.equal(gates, torch.full_like(gates, 0.5))
    jout, jaux = jax_moe.moe(jp, jnp.asarray(x)[None], jarch)
    tout, taux = torch_moe.moe(tp, torch.tensor(x)[None], tarch)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), abs=ATOL)
    # the dropped tokens (past the first 40) get no expert output
    assert not tout[0, 40:].any()


def test_served_router_is_packed_at_f32():
    """In a bf16 model the router still computes in f32 (the reference casts
    its weight to the f32 input), so the engine's prepared router codes and
    scale come from the f32 weight: rounding it to bf16 first would move
    ``sw = max |w|`` and every code. Packed and per-call routing agree
    bitwise; the dense residual's weights pack at the model dtype."""
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.kernels.packed import PackedWeight, pack_weight
    from repro_torch.models import init_params, pack_params

    _, tarch = _archs("arctic-480b", "grmac")
    tarch = tarch.replace(dtype="bfloat16")
    params = init_params(tarch, seed=0, device="cpu")
    served = pack_params(params, tarch)
    w = params["layers"][0]["moe"]["router"]["w"]
    pw = served["layers"][0]["moe"]["router"]["w"]
    assert w.dtype == torch.float32 and isinstance(pw, PackedWeight)
    f32 = pack_weight(w, tarch.cim.fmt_w, tarch.cim.n_r)
    assert torch.equal(pw.sw, f32.sw) and torch.equal(pw.codes, f32.codes)
    assert not torch.equal(pack_weight(w.to(torch.bfloat16),
                                       tarch.cim.fmt_w, tarch.cim.n_r).sw,
                           f32.sw)
    x = torch.randn((8, tarch.d_model), generator=torch.Generator()
                    .manual_seed(0))
    assert torch.equal(cim_matmul(x, pw, tarch.cim, site="moe_router"),
                       cim_matmul(x, w, tarch.cim, site="moe_router"))
    dense_wi = served["layers"][0]["moe"]["dense_mlp"]["wi"]["w"]
    assert isinstance(dense_wi, PackedWeight)
    assert not isinstance(served["layers"][0]["moe"]["experts"]["wi"],
                          PackedWeight)
