"""The port's training path through the model against the JAX package's:
``train_loss`` and its STE gradients against ``jax.value_and_grad`` (CIM
off and GR-MAC row, on the reduced paper, recurrentgemma, mamba2 and grok
configs, the reference's weights carried over by ``params_from_jax``),
the RG-LRU and SSM train forms block by block on equal inputs, remat on
against remat off, and ``make_train_step`` (microbatches, compression)
against the reference's.

Tolerances and why. Losses agree within 2e-6 relative and each gradient
tensor within 2e-5 of its largest entry (measured at most 6e-6): XLA and
torch round exp, log-softmax and the reductions in their last ulp, and
the STE backward's exact matmuls sum in other orders; GR-MAC's quantizer
absorbs the forward's differences here (a flipped input code would move
a whole row: ROADMAP section C). ``rglru_train`` sums in the order of
``jax.lax.associative_scan`` and agrees within 1e-6; ``ssm_train``'s
einsums contract in other orders, within 5e-6 of the output's scale
(measured 2.3e-6).
Remat recomputes the same operations, so on against off is bitwise.

``make_train_step`` is compared at AdamW eps = 1: the first AdamW step is
lr * g / (|g| + eps), which at the default eps = 1e-8 is lr * sign(g), so
an ulp of a near-zero gradient entry would move a parameter by a whole lr;
at eps = 1 the step is smooth in g. Weight decay is 0 there: the
reference stacks its layers, so it decays (and Adafactor factors) stacked
per-layer vectors as matrices, where the port keeps vectors (the
optimizer's own parity is in ``test_torch_training.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import train_loss as jax_train_loss  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import train_loss as torch_train_loss  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 2e-6, 2e-5
_PARAMS = {}


def _setup(name, mode, **replace):
    """A reduced config (CIM ``mode``) in both packages, the reference's
    weights carried over; module-wide."""
    key = (name, mode, tuple(sorted(replace.items())))
    if key not in _PARAMS:
        jarch = jax_get_config(name).reduced().replace(**replace)
        tarch = torch_get_config(name).reduced().replace(**replace)
        jarch = jarch.replace(cim=jarch.cim.with_mode(mode))
        tarch = tarch.replace(cim=tarch.cim.with_mode(mode))
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _PARAMS[key] = (jarch, tarch, jp, tp)
    return _PARAMS[key]


def _batch(arch, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (b, s + 1))
    return ({"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32),
             "mask": jnp.ones((b, s), jnp.float32)},
            {"inputs": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:]),
             "mask": torch.ones((b, s))})


def _torch_grads(params, batch, arch):
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, metrics = torch_train_loss(leaves, batch, arch)
    grads = torch.autograd.grad(total, tree_leaves(leaves),
                                materialize_grads=True)
    it = iter(grads)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _assert_trees_close(got, want_np_tree, arch, rtol):
    """``got`` (the port's layout) against the reference's tree of numpy
    arrays, mapped by ``params_from_jax``: each tensor within ``rtol`` of
    its largest entry."""
    want = params_from_jax(want_np_tree, arch, "cpu")
    pairs = list(zip(tree_paths(got), tree_paths(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    for (path, a), (_, b) in pairs:
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rtol * scale + 1e-30, path


# recurrentgemma with the CIM path off: RG-LRU's sqrt(1 - a^2) amplifies an
# ulp of exp, and on this batch that flips a GR-MAC input code downstream
# (5 of 64 logit rows move by up to 0.76; with the path off every row
# agrees within 1.2e-5), as the reference flips against itself between
# compilations (ROADMAP section C); its GR-MAC train form is held block by
# block on equal inputs (test_rglru_train_matches_jax)
CASES = [("paper-cim-120m", "grmac"), ("paper-cim-120m", "off"),
         ("recurrentgemma-9b", "off"), ("mamba2-1.3b", "grmac"),
         ("grok-1-314b", "grmac"), ("grok-1-314b", "off")]


@pytest.mark.parametrize("name,mode", CASES)
def test_loss_and_ste_gradients_match_jax(name, mode):
    jarch, tarch, jp, tp = _setup(name, mode)
    jb, tb = _batch(tarch)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_train_loss(p, jb, jarch), has_aux=True))(jp)
    tm, tg = _torch_grads(tp, tb, tarch)
    for k in ("loss", "aux_loss", "total"):
        assert tm[k] == pytest.approx(float(jm[k]), rel=LOSS_RTOL,
                                      abs=1e-7), k
    if tarch.is_moe:
        assert tm["aux_loss"] > 0
    _assert_trees_close(tg, jax.tree.map(np.asarray, jg), tarch, GRAD_RTOL)


@pytest.mark.parametrize("name", ["paper-cim-120m", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_equals_no_remat(name, policy):
    """Remat recomputes each super-block's forward (the GR-MAC projections
    included) in the backward: loss and gradients bitwise equal to the run
    that keeps every activation."""
    _, tarch, _, tp = _setup(name, "grmac")
    _, tb = _batch(tarch)
    runs = [_torch_grads(tp, tb, tarch.replace(remat=r, remat_policy=policy))
            for r in (False, True)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def _block_inputs(arch, seed, s=48):
    u = np.random.default_rng(seed).normal(
        size=(2, s, arch.d_model)).astype(np.float32)
    return jnp.asarray(u), torch.tensor(u)


@pytest.mark.parametrize("mode", ["off", "grmac"])
def test_rglru_train_matches_jax(mode):
    """The associative scan on equal inputs and weights; and the port's
    scan against its own step-by-step recurrence (``rglru_prefill`` from a
    zero state)."""
    jarch, tarch, jp, tp = _setup("recurrentgemma-9b", mode)
    jl = jax.tree.map(lambda a: a[0], jp["superblocks"]["b0_rglru"]["rglru"])
    tl = tp["layers"][0]["rglru"]
    ju, tu = _block_inputs(tarch, 1)
    want = np.asarray(jrglru.rglru_train(jl, ju, jarch))
    got = trglru.rglru_train(tl, tu, tarch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if mode == "off":
        state = trglru.init_rglru_state(tarch, 2, "cpu")
        seq, _ = trglru.rglru_prefill(tl, tu, tarch, state,
                                      torch.full((2,), tu.shape[1]))
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_associative_scan_matches_jax_order():
    """The scan's combine order is JAX's: on random (a, b) pairs of odd,
    even and power-of-two lengths the port's result is
    ``lax.associative_scan``'s within 2e-7 relative (the same products and
    sums, which XLA may fuse)."""
    rng = np.random.default_rng(3)

    def jcomb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    for n in (1, 2, 3, 4, 5, 7, 8, 16, 17, 33):
        a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
        b = rng.normal(size=(2, n, 5)).astype(np.float32)
        want = jax.lax.associative_scan(jcomb, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
        got = trglru.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
            (torch.tensor(a), torch.tensor(b)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                       atol=0)


@pytest.mark.parametrize("mode", ["off", "grmac"])
def test_ssm_train_matches_jax(mode):
    """The chunked SSD form on equal inputs and weights (3 chunks), and,
    with the CIM path off, against the port's recurrence from a zero
    state (within 2e-5 of the scale: the two forms sum in other orders;
    measured 5.0e-6)."""
    jarch, tarch, jp, tp = _setup("mamba2-1.3b", mode)
    jl = jax.tree.map(lambda a: a[0], jp["superblocks"]["b0_ssm"]["ssm"])
    tl = tp["layers"][0]["ssm"]
    ju, tu = _block_inputs(tarch, 2, s=3 * tarch.ssm_chunk)
    want = np.asarray(jax.jit(lambda l, u: jssm.ssm_train(
        l, u, jarch))(jl, ju))
    got = tssm.ssm_train(tl, tu, tarch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="ssm_chunk"):
        tssm.ssm_train(tl, tu[:, :5], tarch)
    if mode == "off":
        state = tssm.init_ssm_state(tarch, 2, "cpu")
        seq, _ = tssm.ssm_prefill(tl, tu, tarch, state,
                                  torch.full((2,), tu.shape[1]))
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def _step_both(name, mode, nmb=1, compression=False, algorithm="adamw"):
    jarch, tarch, jp, tp = _setup(name, mode, n_layers=2)
    jb, tb = _batch(tarch, b=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0,
              weight_decay=0.0, grad_compression=compression,
              algorithm=algorithm)
    jo, to = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jout = jax.jit(jtrainer.make_train_step(jarch, jtrainer.TrainConfig(
        microbatches=nmb, opt=jo)))(jp, jopt.init_opt_state(jp, jo), jb)
    tout = ttrainer.make_train_step(tarch, ttrainer.TrainConfig(
        microbatches=nmb, opt=to))(tp, topt.init_opt_state(tp, to), tb)
    return jarch, tarch, jout, tout


@pytest.mark.parametrize("name,mode,nmb,compression", [
    ("stablelm-3b", "off", 1, False), ("stablelm-3b", "off", 2, False),
    ("paper-cim-120m", "grmac", 2, False), ("stablelm-3b", "off", 1, True),
    ("grok-1-314b", "off", 2, False)])
def test_make_train_step_matches_jax(name, mode, nmb, compression):
    """One step (microbatched, compressed): the metrics, the new
    parameters (within 1e-6 of each tensor's scale) and the first moment
    as JAX's; an MoE aux loss survives microbatching. Compressed, the
    int8 codes of the two packages' layouts may differ by one (see
    below), which bounds the residuals, the moment and the parameters."""
    jarch, tarch, (jp, js, jm), (tp, ts, tm) = _step_both(
        name, mode, nmb, compression)
    for k in ("loss", "aux_loss", "total", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=GRAD_RTOL,
                                             abs=1e-7), k
    if tarch.is_moe:
        assert float(tm["aux_loss"]) > 0
    if not compression:
        _assert_trees_close(tp, jax.tree.map(np.asarray, jp), tarch, 1e-6)
        _assert_trees_close(ts["m"], jax.tree.map(np.asarray, js["m"]),
                            tarch, GRAD_RTOL)
        return
    # compressed: the reference quantizes a stacked super-block tensor
    # with one scale, the port each layer's tensor with its own, and a
    # code on a rounding boundary may land one code apart; so residuals
    # agree within one code step (twice the larger residual), the first
    # moment within a tenth of it, the parameters within lr times one
    conv = [params_from_jax(jax.tree.map(np.asarray, t), tarch, "cpu")
            for t in (js["err"], js["m"], jp)]
    for err, m, p, (w_err, w_m, w_p) in zip(
            tree_leaves(ts["err"]), tree_leaves(ts["m"]), tree_leaves(tp),
            zip(*(tree_leaves(c) for c in conv))):
        step = 2 * max(float(err.abs().max()), float(w_err.abs().max()))
        assert float((err - w_err).abs().max()) <= 1.01 * step
        assert float((m - w_m).abs().max()) <= 0.101 * step
        assert float((p - w_p).abs().max()) <= 1e-3 * step


def test_microbatched_equals_full():
    """Two microbatches accumulate the same gradients and metrics as the
    whole batch (f32 accumulation; equal up to the summation order)."""
    _, tarch, _, tp = _setup("stablelm-3b", "off", n_layers=2)
    _, tb = _batch(tarch, b=4)
    opt = topt.OptimizerConfig(eps=1.0, weight_decay=0.0)
    outs = [ttrainer.make_train_step(tarch, ttrainer.TrainConfig(
        microbatches=n, opt=opt))(tp, topt.init_opt_state(tp, opt), tb)
        for n in (1, 2)]
    (p1, _, m1), (p2, _, m2) = outs
    for k in m1:
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5), k
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert float((a - b).abs().max()) <= 1e-7
