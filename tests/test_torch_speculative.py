"""The port's speculative decode (``serving.speculative`` and the engine's
seams) against the JAX package's: every scenario of the reference's
tests/test_speculative.py runs through both packages on the same reduced
configs and weights (CIM off, as there), and the port's streams must
equal JAX's speculative streams and the port's own sequential decode,
bit for bit, with equal dispatch counters. Then GR-MAC mode (the reduced
paper config): the port's speculative stream equals JAX's (it need not
equal sequential decode: the pre-scale sees a whole verify chunk, in
the reference too). ``price_speculation`` equals JAX's on equal counters
once both packages price with the same fJ/Op (their Monte-Carlo ENOB
solves draw different samples), and gives the same verdict with their
own. The sampled verify: on fixed logits, the joint law of (accepted
count, final token) of both packages passes a chi-square test against
the rejection rule's exact law; seeded lanes reproduce, temperature-0
lanes accept exactly as greedy.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.params import SamplingParams as JaxSP  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.serving.params import SamplingParams as TorchSP  # noqa: E402

ARCHS = [("attn", "qwen2-1.5b"), ("rglru", "recurrentgemma-9b"),
         ("ssm", "mamba2-1.3b"), ("moe", "grok-1-314b")]
_PARAMS = {}


def _setup(name, mode=None, window=None):
    """A reduced config in both packages (its own CIM mode unless ``mode``;
    its window unless ``window``), the reference's weights carried over;
    module-wide."""
    if (name, mode, window) not in _PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        if mode is not None:
            jarch = jarch.replace(cim=jarch.cim.with_mode(mode))
            tarch = tarch.replace(cim=tarch.cim.with_mode(mode))
        if window is not None:
            jarch, tarch = (a.replace(window=window) for a in (jarch, tarch))
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _PARAMS[name, mode, window] = (jarch, tarch, jp, tp)
    return _PARAMS[name, mode, window]


class Pkg:
    """One package's serving modules, so a scenario is written once."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.spec = jspec if jax_side else tspec
        self.sched = jsched if jax_side else tsched
        self.SP = JaxSP if jax_side else TorchSP

    def engine(self, name, slots=2, ctx=64, mode=None, window=None,
               **cfg_kw):
        jarch, tarch, jp, tp = _setup(name, mode, window)
        cfg = dict(batch_slots=slots, max_ctx=ctx, **cfg_kw)
        if self.name == "jax":
            return jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg))
        return teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu")

    def key(self, i):
        return jax.random.PRNGKey(i) if self.name == "jax" \
            else sampling.key(i)


PKGS = (Pkg("jax"), Pkg("torch"))
TORCH = PKGS[1]


def _counters(eng):
    return {k: v for k, v in eng.stats.items() if k != "pj_per_token"}


def _seq(pkg, name, prompt, n, mode=None, window=None, **req):
    eng = pkg.engine(name, mode=mode, window=window)
    slot = eng.add_request(prompt, params=pkg.SP(**req))
    while eng.active[slot] and len(eng.tokens[slot]) - len(prompt) < n:
        eng.step()
    return eng.tokens[slot][len(prompt):][:n], eng.finish_reason(slot)


def _spec(pkg, name, prompt, n, k=4, draft="digital", draft_fn=None,
          mode=None, window=None, **req):
    eng = pkg.engine(name, mode=mode, window=window)
    dec = pkg.spec.SpecDecoder(eng, pkg.spec.SpecConfig(k=k, draft=draft),
                               draft_fn=draft_fn)
    slot = eng.add_request(prompt, params=pkg.SP(**req))
    toks = list(eng.tokens[slot][len(prompt):])
    for _ in range(64):
        if len(toks) >= n or not eng.active[slot]:
            break
        for o in dec.step().outputs:
            if o.slot == slot:
                toks.extend(o.tokens)
    return toks[:n], eng.finish_reason(slot), _counters(eng)


def _prompt(arch, seed, n):
    return [int(t) for t in
            np.random.RandomState(seed).randint(1, arch.vocab_size, n)]


@pytest.mark.parametrize("label,name", ARCHS)
def test_greedy_spec_bitwise_digital_draft(label, name):
    """The digital drafter on every cache family: the port's speculative
    stream equals its sequential decode and JAX's speculative stream, with
    JAX's counters."""
    prompt = _prompt(_setup(name)[0], 0, 7)
    ref, _ = _seq(TORCH, name, prompt, 12)
    (jt, _, jc), (tt, _, tc) = (_spec(p, name, prompt, 12) for p in PKGS)
    assert tt == ref == jt, label
    assert tc == jc
    assert tc["spec_steps"] > 0 and tc["verify_dispatches"] == \
        tc["spec_steps"]


@pytest.mark.parametrize("label,name,window", [
    ("rglru", "recurrentgemma-9b", None), ("ssm", "mamba2-1.3b", None),
    ("ring", "recurrentgemma-9b", 8)])
def test_forced_rejection_rollback(label, name, window):
    """A drafter that is always wrong: a rollback and a repair every step;
    the stream still equals sequential decode, in both packages. With an
    8-slot window the local rings wrap, so a verify overwrites valid older
    rows in place: the snapshot must be a copy."""
    arch = _setup(name, window=window)[1]
    prompt = _prompt(arch, 1, 6)
    ref, _ = _seq(TORCH, name, prompt, 10 if window is None else 20,
                  window=window)

    def bad_draft(cur, t):
        return ((cur + 1) % arch.vocab_size).astype(np.int32)

    (jt, _, jc), (tt, _, tc) = (
        _spec(p, name, prompt, len(ref), draft="self", draft_fn=bad_draft,
              window=window) for p in PKGS)
    assert tt == ref == jt, label
    assert tc == jc
    assert tc["spec_tokens"] == tc["spec_steps"]
    assert tc["repair_dispatches"] > 0 and tc["draft_dispatches"] == 0


def test_self_draft_full_acceptance():
    prompt = [3, 1, 4, 1, 5]
    ref, _ = _seq(TORCH, "qwen2-1.5b", prompt, 12)
    (jt, _, jc), (tt, _, tc) = (
        _spec(p, "qwen2-1.5b", prompt, 12, draft="self") for p in PKGS)
    assert tt == ref == jt and tc == jc
    assert tc["spec_tokens"] == 4 * tc["spec_steps"]
    assert tc["repair_dispatches"] == 0
    assert tc["draft_dispatches"] == 3 * tc["spec_steps"]


def test_spec_eos_mid_chunk():
    prompt = [5, 6, 7, 8]
    ref, _ = _seq(TORCH, "qwen2-1.5b", prompt, 8)
    eos = ref[5]
    ref_eos, reason = _seq(TORCH, "qwen2-1.5b", prompt, 8, eos_id=eos)
    assert reason == "eos"
    (jt, jr, jc), (tt, tr, tc) = (
        _spec(p, "qwen2-1.5b", prompt, 8, draft="self", eos_id=eos)
        for p in PKGS)
    assert tt == ref_eos == jt and tr == jr == "eos" and tt[-1] == eos
    assert tc == jc


def test_spec_max_tokens_cap_frees_slot():
    prompt = [2, 7, 1, 8]
    ref, _ = _seq(TORCH, "mamba2-1.3b", prompt, 10)
    out = []
    for pkg in PKGS:
        eng = pkg.engine("mamba2-1.3b")
        dec = pkg.spec.SpecDecoder(eng, pkg.spec.SpecConfig(k=4,
                                                            draft="self"))
        slot = eng.add_request(prompt, params=pkg.SP(max_tokens=5))
        toks = list(eng.tokens[slot][len(prompt):])
        while eng.active[slot]:
            for o in dec.step().outputs:
                if o.slot == slot:
                    toks.extend(o.tokens)
        reason, free = eng.finish_reason(slot), eng.free_slots()
        s2 = eng.add_request([9, 9, 2])            # the slot is reused
        r = pkg.spec.SpecDecoder(eng, pkg.spec.SpecConfig(
            k=3, draft="self")).step()
        out.append((toks, reason, free,
                    [(o.slot, o.tokens) for o in r.outputs if o.slot == s2],
                    _counters(eng)))
    assert out[1] == out[0]
    assert out[1][0] == ref[:5] and out[1][1] == "length"
    assert out[1][2] == 2 and out[1][3][0][1]


def test_spec_k_per_request_override():
    out = []
    for pkg in PKGS:
        eng = pkg.engine("qwen2-1.5b")
        dec = pkg.spec.SpecDecoder(eng, pkg.spec.SpecConfig(k=4,
                                                            draft="self"))
        s0 = eng.add_request([1, 2, 3], params=pkg.SP(spec_k=1))
        s1 = eng.add_request([4, 5, 6], params=pkg.SP(spec_k=3))
        r = dec.step()
        per_slot = {o.slot: o.tokens for o in r.outputs}
        out.append((len(per_slot[s0]), len(per_slot[s1]), per_slot))
    assert out[1] == out[0]
    assert out[1][:2] == (1, 3)


def _sched_run(pkg, name, spec, slots, traffic, mode=None, **cfg_kw):
    """``run_open_loop`` on a StepClock; streams by request id, the
    scheduler's counters and its policy-clock metrics."""
    eng = pkg.engine(name, slots=slots, mode=mode,
                     **{k: v for k, v in cfg_kw.items()
                        if k == "prefix_cache_bytes"})
    clock = pkg.sched.StepClock()
    sched = pkg.sched.Scheduler(
        eng, pkg.sched.SchedulerConfig(**{k: v for k, v in cfg_kw.items()
                                          if k != "prefix_cache_bytes"}),
        clock=clock.now, spec=spec and pkg.spec.SpecConfig(**spec))
    pkg.sched.run_open_loop(sched, traffic, tick=clock.tick)
    m = sched.metrics()
    # wall-clock metrics are not compared, nor (in GR-MAC mode) the pJ:
    # Monte-Carlo estimates whose samples differ between the packages
    return ({r.rid: list(r.generated) for r in sched.finished},
            dict(sched.stats), _counters(eng),
            {k: v for k, v in m.items() if not k.endswith(("_ms", "_s"))
             and k not in ("pj_per_token", "energy_pj")})


def test_spec_preemption_resume():
    """Spec decode under recompute preemption: an overloaded one-slot spec
    run emits the uncontended sequential run's streams; the port's
    counters and policy metrics equal JAX's."""
    arch = _setup("recurrentgemma-9b")[1]
    traffic = tsched.synth_traffic(6, 2.0, seed=5, vocab_size=arch.vocab_size,
                                   prompt_len=(4, 10), out_len=(6, 10))
    ref = _sched_run(TORCH, "recurrentgemma-9b", None, 4, traffic)[0]
    want, got = (_sched_run(p, "recurrentgemma-9b",
                            dict(k=4, draft="self"), 1, traffic,
                            preempt_age=1.0) for p in PKGS)
    assert got == want
    assert got[1]["preempted"] > 0
    assert got[0] == ref


def test_spec_prefix_cache_adoption():
    arch = _setup("qwen2-1.5b")[1]
    traffic = tsched.synth_shared_prefix_traffic(
        6, 1.0, seed=2, vocab_size=arch.vocab_size, n_prefixes=2,
        prefix_len=16, user_len=(2, 6), out_len=(4, 8))
    ref = _sched_run(TORCH, "qwen2-1.5b", None, 2, traffic,
                     prefill_token_budget=8)[0]
    want, got = (_sched_run(p, "qwen2-1.5b", dict(k=4, draft="self"), 2,
                            traffic, prefill_token_budget=8,
                            prefix_cache_bytes=64 << 20) for p in PKGS)
    assert got == want
    assert got[2]["prefix_hit_tokens"] > 0
    assert got[0] == ref


def test_scheduler_spec_counters_in_grmac_mode():
    """GR-MAC mode (the reduced paper config), the scheduler with the
    digital drafter: the port's streams, counters and policy metrics equal
    JAX's (speculation's own stream; the pre-scale couples a verify
    chunk's rows, so it need not equal sequential decode)."""
    arch = _setup("paper-cim-120m")[1]
    traffic = tsched.synth_traffic(5, 1.0, seed=3, vocab_size=arch.vocab_size,
                                   prompt_len=(4, 12), out_len=(5, 9))
    want, got = (_sched_run(p, "paper-cim-120m", dict(k=3), 2, traffic)
                 for p in PKGS)
    assert got == want
    m = got[3]
    assert m["spec_steps"] > 0 and m["draft_dispatches"] > 0
    assert m["accepted_tokens_per_step"] == m["spec_tokens"] / m[
        "spec_steps"]


def test_sampled_spec_seeded_and_mixed():
    """A seeded sampled lane reproduces across runs and differs across
    seeds; the greedy lane beside it in the same (sampled) verify equals
    sequential decode, in both packages."""
    ref, _ = _seq(TORCH, "recurrentgemma-9b", [2, 7, 1], 8)

    def run(pkg, seed):
        eng = pkg.engine("recurrentgemma-9b")
        dec = pkg.spec.SpecDecoder(eng, pkg.spec.SpecConfig(k=4,
                                                            draft="self"))
        s0 = eng.add_request([3, 1, 4], params=pkg.SP(temperature=0.9,
                                                      seed=seed))
        s1 = eng.add_request([2, 7, 1], params=pkg.SP(temperature=0.0))
        t0, t1 = list(eng.tokens[s0][3:]), list(eng.tokens[s1][3:])
        for i in range(6):
            for o in dec.step(pkg.key(i)).outputs:
                (t0 if o.slot == s0 else t1).extend(o.tokens)
        return t0[:6], t1[:8]

    for pkg in PKGS:
        a0, a1 = run(pkg, 42)
        b0, _ = run(pkg, 42)
        c0, _ = run(pkg, 7)
        assert a0 == b0 and a0 != c0
        assert a1 == ref
        assert all(0 <= t < 512 for t in a0 + c0)


def test_greedy_spec_in_grmac_mode_equals_jax():
    """GR-MAC row (the reduced paper config), digital and self drafters:
    equal streams and counters to JAX's speculative decode."""
    prompt = [3, 1, 4, 1, 5, 9, 2]
    for draft in ("digital", "self"):
        (jt, _, jc), (tt, _, tc) = (
            _spec(p, "paper-cim-120m", prompt, 10, draft=draft)
            for p in PKGS)
        assert tt == jt and tc == jc


def test_draft_arch_resolution():
    for pkg, get in ((PKGS[0], jax_get_config), (TORCH, torch_get_config)):
        arch = get("qwen2-1.5b").reduced()
        cim_on = arch.replace(cim=arch.cim.with_mode("grmac"))
        assert pkg.spec.draft_arch_for(cim_on, "self") is cim_on
        assert not pkg.spec.draft_arch_for(cim_on, "digital").cim.enabled
        over = pkg.spec.draft_arch_for(cim_on, {"head": "off"})
        assert over.cim.for_site("head").mode == "off"
        with pytest.raises(ValueError):
            pkg.spec.draft_arch_for(cim_on, get("mamba2-1.3b").reduced())
        with pytest.raises(ValueError):
            pkg.spec.draft_arch_for(cim_on, "turbo")
        with pytest.raises(ValueError):
            pkg.spec.SpecConfig(k=1)


STATS = {"draft_dispatches": 30, "verify_dispatches": 10,
         "repair_dispatches": 2, "spec_steps": 10, "spec_tokens": 40}


def test_price_speculation_equals_jax(monkeypatch):
    """On equal counters and equal fJ/Op per design (both packages' solves
    replaced by one table), the port's account equals JAX's; with their
    own Monte-Carlo solves the verdict is the same; disabled CIM reports
    ``enabled: False`` in both."""
    def fixed(granularity, fmt_x, fmt_w, n_r, **kw):
        return {"arch": "gr_row", "fj_per_op": 25.0 + n_r / 64,
                "enob": 8.0, "breakdown": {}, "conv_fj_per_op": 12500.0,
                "conv_enob": 12.0}

    jarch = jax_get_config("qwen2-1.5b").reduced()
    tarch = torch_get_config("qwen2-1.5b").reduced()
    jcim = jarch.replace(cim=jarch.cim.with_mode("grmac"))
    tcim = tarch.replace(cim=tarch.cim.with_mode("grmac"))
    for draft in ("digital", "self"):
        with monkeypatch.context() as m:
            m.setattr(jcosts, "design_energy_fj", fixed)
            m.setattr(tcosts, "design_energy_fj", fixed)
            want = jspec.price_speculation(
                jcim, jspec.draft_arch_for(jcim, draft), STATS, 4)
            got = tspec.price_speculation(
                tcim, tspec.draft_arch_for(tcim, draft), STATS, 4,
                device="cpu")
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
    want = jspec.price_speculation(
        jcim, jspec.draft_arch_for(jcim, "digital"), STATS, 4, n_cols=1 << 8)
    got = tspec.price_speculation(
        tcim, tspec.draft_arch_for(tcim, "digital"), STATS, 4,
        n_cols=1 << 8, device="cpu")
    assert got["energy_win"] == want["energy_win"] is False
    assert got["accepted_tokens_per_step"] == 4.0
    assert tspec.price_speculation(tarch, tarch, STATS, 4) == \
        jspec.price_speculation(jarch, jarch, STATS, 4) == {"enabled": False}


# -------------------------------------------------- the sampled verify rule
V, S, LANES = 6, 4, 4096
DRAFTS = [2, 0, 5]       # the chunk is [pending, d_1, d_2, d_3]
TEMP = 0.7


def _fixed_logits():
    return np.random.default_rng(11).normal(size=(S, V)).astype(np.float32)


def _exact_law(logits):
    """P(accepted drafts m, final token) of the rejection rule for greedy
    (point) drafts: accept d_{j+1} with p_j(d_{j+1}); at the first
    rejection the final token ~ p_m without d_{m+1}, after all ~ p_{S-1}."""
    p = np.exp(logits.astype(np.float64) / TEMP)
    p /= p.sum(-1, keepdims=True)
    law, reach = {}, 1.0
    for m in range(S):
        if m < S - 1:
            d = DRAFTS[m]
            resid = p[m].copy()
            resid[d] = 0.0
            resid /= resid.sum()
            for v in range(V):
                law[m, v] = reach * (1 - p[m, d]) * resid[v]
            reach *= p[m, d]
        else:
            for v in range(V):
                law[m, v] = reach * p[m, v]
    return law


def _chi2_p(counts: dict, law: dict, n: int) -> float:
    from scipy.stats import chi2
    cells = [c for c in law if law[c] * n >= 5]
    rest = 1.0 - sum(law[c] for c in cells)
    obs = [counts.get(c, 0) for c in cells] + [n - sum(
        counts.get(c, 0) for c in cells)]
    exp = [law[c] * n for c in cells] + [rest * n]
    stat = sum((o - e) ** 2 / e for o, e in zip(obs, exp) if e > 0)
    return float(chi2.sf(stat, len([e for e in exp if e > 0]) - 1))


def _histogram(packed):
    counts = {}
    for row in packed:
        m = int(row[S]) - 1
        counts[m, int(row[m])] = counts.get((m, int(row[m])), 0) + 1
    return counts


def test_sampled_verify_rule_chi_square_against_jax(monkeypatch):
    """Both packages' sampled verify on fixed logits (the model forward
    replaced by them), 4096 unseeded lanes at T 0.7: the histograms of
    (accepted drafts, final token) pass a chi-square test against the
    exact law at p >= 0.001 (seeds fixed: deterministic); a lane at T 0
    accepts exactly the greedy ids."""
    logits = _fixed_logits()
    law = _exact_law(logits)
    chunk = np.zeros((LANES, S), np.int32)
    chunk[:, 1:] = DRAFTS
    lens = np.full(LANES, S, np.int32)

    def fake_forward(params, toks, arch, **kw):
        """The fixed logits at every chunk position (a padded bucket's
        positions past S repeat the last row; nothing reads them)."""
        b, s = toks.shape
        lg = np.concatenate([logits, np.repeat(logits[-1:], s - S, 0)])
        if isinstance(toks, torch.Tensor):
            return (torch.tensor(lg).expand(b, s, V), torch.zeros(()),
                    kw["cache"])
        return jnp.broadcast_to(jnp.asarray(lg), (b, s, V)), 0.0, \
            kw["cache"]

    monkeypatch.setattr(jeng, "forward", fake_forward)
    monkeypatch.setattr(teng, "forward", fake_forward)
    fn = jeng._verify_raw(None, S)
    zero = np.zeros(LANES, np.int32)
    jpacked = np.asarray(fn(None, jnp.asarray(chunk), {}, jnp.asarray(zero),
                            jnp.asarray(lens), jax.random.PRNGKey(3),
                            jnp.full(LANES, TEMP, jnp.float32),
                            jnp.full(LANES, -1, jnp.int32),
                            jnp.asarray(zero))[0])
    eng = TORCH.engine("qwen2-1.5b", slots=LANES, ctx=8)
    eng._temp[:] = TEMP
    emitted, counts = eng.verify_chunk_sampled(chunk, lens, sampling.key(3))
    tpacked = np.concatenate([emitted, counts[:, None]], axis=1)
    for packed in (jpacked, tpacked):
        assert _chi2_p(_histogram(packed), law, LANES) >= 1e-3
        m = packed[:, S] - 1
        assert np.all(packed[np.arange(LANES), :S][:, :3][
            np.arange(3)[None, :] < m[:, None]] == np.broadcast_to(
                DRAFTS, (LANES, 3))[np.arange(3)[None, :] < m[:, None]])
    # temperature 0: exact greedy acceptance
    eng._temp[:] = 0.0
    greedy = logits.argmax(-1)
    emitted, counts = eng.verify_chunk_sampled(chunk, lens, sampling.key(4))
    a = 1
    while a < S and DRAFTS[a - 1] == greedy[a - 1]:
        a += 1
    assert np.all(counts == a)
    assert np.all(emitted[:, a - 1] == greedy[a - 1])
