"""The port's per-lane sampling (``serving.sampling`` and the engine's
sampling contract) against the JAX package's.

``jax.random`` streams cannot be reproduced in torch, so sampled parity is
by distribution: on fixed logits the port's and the reference's token
histograms over 2**14 draws each pass a chi-square test against
``softmax(logits / T)`` at p >= 0.001 (seeds fixed: the test is
deterministic). Everything greedy is held exactly: temperature-0 lanes
inside a sampled batch, the keyless fallback, streams and finish reasons.
The request-API cases mirror the reference's
tests/test_serving_sampling.py and tests/test_sampling_params.py on the
same reduced configs (CIM off, as there).
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.params import SamplingParams as JaxSP  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.params import RequestOutput  # noqa: E402
from repro_torch.serving.params import SamplingParams as TorchSP  # noqa: E402
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,  # noqa: E402
                                           StepClock)

_PARAMS = {}


def _setup(name="qwen2-1.5b"):
    """A reduced config in both packages, the reference's weights carried
    over (module-wide, shared by every test of the file)."""
    if name not in _PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _PARAMS[name] = (jarch, tarch, jp, tp)
    return _PARAMS[name]


def _engines(name="qwen2-1.5b", **cfg):
    """The same ServeConfig in both packages: (jax engine, port engine)."""
    jarch, tarch, jp, tp = _setup(name)
    cfg = {"batch_slots": 2, "max_ctx": 64, **cfg}
    return (jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg)),
            teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu"))


def _engine(name="qwen2-1.5b", **cfg):
    return _engines(name, **cfg)[1]


PROMPT = [3, 1, 4, 1, 5]


# ------------------------------------------------------------- the sampler
def _chi2_p(counts, probs):
    """Chi-square p-value of ``counts`` against ``probs``, by the
    regularized upper incomplete gamma function."""
    n = counts.sum()
    exp = probs / probs.sum() * n
    stat = float(((counts - exp) ** 2 / exp).sum())
    df = len(counts) - 1
    return float(torch.special.gammaincc(torch.tensor(df / 2.0,
                                                      dtype=torch.float64),
                                         torch.tensor(stat / 2.0,
                                                      dtype=torch.float64)))


V, DRAWS = 64, 1 << 14
LOGITS = np.linspace(-1.5, 1.5, V, dtype=np.float32)


def _softmax(t):
    z = LOGITS.astype(np.float64) / t
    e = np.exp(z - z.max())
    return e / e.sum()


@pytest.mark.parametrize("temp", [0.8, 1.5])
def test_sampled_histograms_match_the_softmax_in_both_packages(temp):
    """2**14 draws on fixed logits, one per seeded lane (seeds 0..2**14 -
    1, event 0), in each package: both histograms pass chi-square against
    softmax(logits / T) at p >= 0.001."""
    seeds = np.arange(DRAWS)
    ctrs = np.zeros(DRAWS, np.int64)
    logits = np.broadcast_to(LOGITS, (DRAWS, V))
    keys = jeng._lane_keys(jax.random.PRNGKey(0),
                           jax.numpy.asarray(seeds, jax.numpy.int32),
                           jax.numpy.asarray(ctrs, jax.numpy.int32))
    want = np.asarray(jax.vmap(lambda k, lg: jax.random.categorical(
        k, lg / max(temp, 1e-6)))(keys, jax.numpy.asarray(logits)))
    got = sampling.select(torch.tensor(logits), torch.full((DRAWS,), temp),
                          torch.tensor(sampling.lane_keys(0, seeds, ctrs)))
    assert got.dtype == torch.int32 and got.shape == (DRAWS,)
    probs = _softmax(temp)
    p_jax = _chi2_p(np.bincount(want, minlength=V), probs)
    p_port = _chi2_p(np.bincount(got.numpy(), minlength=V), probs)
    assert p_jax >= 1e-3 and p_port >= 1e-3, (p_jax, p_port)


def test_sampler_streams_are_pure_functions_of_integers():
    """A seeded lane's key depends only on (seed, event); an unseeded
    lane's on (caller key, lane); split and fold_in are deterministic and
    distinct; the draws are exact multiples of 2**-24 inside (0, 1)."""
    a = sampling.lane_keys(5, [7, -1, 7], [3, 0, 3])
    b = sampling.lane_keys(6, [-1, 7, -1], [0, 3, 0])
    assert a[0] == a[2] == b[1]                 # placement, caller key
    assert a[1] != b[0] and b[0] != b[2]        # unseeded: key and lane
    assert sampling.lane_keys(5, [7], [4])[0] != a[0]
    assert sampling.split(11) == sampling.split(11)
    k0, k1 = sampling.split(11)
    assert len({k0, k1, sampling.fold_in(11, 0), sampling.fold_in(11, 1),
                11}) == 5
    assert all(0 <= k < 2 ** 64 for k in (k0, k1, sampling.key(3)))
    u = sampling.uniform(torch.tensor(sampling.lane_keys(
        0, np.arange(256), np.zeros(256, np.int64))), 1024)
    assert u.dtype == torch.float32
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))


def test_integer_hash_matches_python_integers():
    """The int64 tensor hash equals the same hash on Python integers (no
    product reaches 2**63), so every device gives the same bits."""
    m32 = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m32
        x ^= x >> 15
        x = (x * 0x045D9F3B) & m32
        return x ^ (x >> 16)

    xs = [0, 1, 2 ** 31, m32, 0x9E3779B9, 123456789]
    got = sampling._mix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [mix(x) for x in xs]


def test_temperature_zero_lanes_take_the_argmax_exactly():
    logits = torch.tensor(np.random.default_rng(0).standard_normal(
        (6, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7, 0.0, 2.0])
    keys = torch.tensor(sampling.lane_keys(3, [-1] * 6, [0] * 6))
    ids = sampling.select(logits, temps, keys)
    greedy = torch.argmax(logits, -1).to(torch.int32)
    assert torch.equal(ids[temps == 0], greedy[temps == 0])


# ------------------------------------------- the contract at the prefill
def test_temperature_with_key_samples_without_warning():
    firsts = []
    for _ in range(2):
        eng = _engine(batch_slots=1, max_ctx=32, temperature=1.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            slot = eng.add_request(PROMPT, key=sampling.key(7))
        firsts.append(eng.tokens[slot][-1])
    assert firsts[0] == firsts[1]


def test_temperature_without_key_warns_and_is_greedy_as_in_jax():
    """temp > 0, no key: a UserWarning in both packages, and the first
    token is the greedy engine's, equal to JAX's."""
    firsts = []
    for j, t in zip(_engines(batch_slots=1, max_ctx=32, temperature=1.0),
                    ("jax", "torch")):
        with pytest.warns(UserWarning, match="falling back to greedy"):
            slot = j.add_request(PROMPT)
        firsts.append(j.tokens[slot][-1])
    eng_g = _engine(batch_slots=1, max_ctx=32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        slot = eng_g.add_request(PROMPT)
    assert firsts[0] == firsts[1] == eng_g.tokens[slot][-1]


def test_incremental_prefill_applies_same_contract():
    eng = _engine(batch_slots=1, max_ctx=32, temperature=0.7)
    slot = eng.begin_request(PROMPT)
    while eng.prefill_remaining(slot):
        eng.advance_prefill(slot)
    with pytest.warns(UserWarning, match="falling back to greedy"):
        eng.finish_prefill(slot)

    eng2 = _engine(batch_slots=1, max_ctx=32, temperature=0.7)
    slot2 = eng2.begin_request(PROMPT)
    while eng2.prefill_remaining(slot2):
        eng2.advance_prefill(slot2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng2.finish_prefill(slot2, key=sampling.key(3))


def test_token_prefill_samples_its_first_token_too():
    """The token-by-token path samples its final dispatch under the same
    rule: with a seed, the first token equals the bucketed path's."""
    sp = TorchSP(temperature=0.9, seed=4)
    firsts = []
    for mode in ("bucketed", "token"):
        eng = _engine(batch_slots=1, max_ctx=32, prefill_mode=mode)
        slot = eng.add_request(PROMPT, params=sp)
        firsts.append(eng.tokens[slot][-1])
        assert eng._ctr[slot] == 1
    assert firsts[0] == firsts[1]


def test_scheduler_threads_keys_per_request():
    def run():
        clock = StepClock()
        eng = _engine(batch_slots=2, max_ctx=32, temperature=1.0)
        sched = Scheduler(eng, SchedulerConfig(), clock=clock.now)
        rs = [sched.submit(PROMPT, params=TorchSP(max_tokens=4),
                           arrival=0.0) for _ in range(2)]
        key = sampling.key(11)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            steps = 0
            while not sched.idle():
                key, sub = sampling.split(key)
                sched.step(sub)
                clock.tick()
                steps += 1
                assert steps < 100
        return [r.generated for r in rs]

    a, b = run(), run()
    assert a == b
    # the two requests draw from different per-request keys
    assert a[0] != a[1]


# ------------------------------------------------------ the request API
def test_params_validation():
    with pytest.raises(ValueError):
        TorchSP(temperature=-0.1)
    with pytest.raises(ValueError):
        TorchSP(max_tokens=0)
    with pytest.raises(ValueError):
        TorchSP(spec_k=0)
    p = TorchSP(max_tokens=4)
    assert p.replace(max_tokens=8).max_tokens == 8
    assert p.max_tokens == 4


def _stream(eng, prompt, n, slot=None, **kw):
    if slot is None:
        slot = eng.add_request(prompt, **kw)
    while eng.active[slot] and len(eng.tokens[slot]) - len(prompt) < n:
        eng.step()
    return eng.tokens[slot][len(prompt):][:n], slot


def test_max_tokens_frees_slot_with_length_reason_as_in_jax():
    """mamba2 (an SSM lane): the cap frees the slot with reason "length"
    the step it is reached, a one-token cap at prefill time; streams and
    reasons equal JAX's."""
    out = []
    for eng, sp in zip(_engines("mamba2-1.3b"), (JaxSP, TorchSP)):
        slot = eng.add_request([2, 7, 1], params=sp(max_tokens=3))
        finished = []
        for _ in range(4):
            finished += eng.step().finished
        assert slot in finished and eng.free_slots() == 2
        s3 = eng.add_request([2, 7, 1], params=sp(max_tokens=1))
        assert not eng.active[s3]
        res = eng.step()
        assert s3 in res.finished
        out.append(([list(t) for t in eng.tokens],
                    [eng.finish_reason(s) for s in range(2)]))
    assert out[0] == out[1]
    assert out[1][1][0] == "length"


def test_per_request_temperature_mixed_batch_keeps_greedy_lane_exact():
    """A temperature-0 request beside a sampled one decodes exactly the
    JAX greedy engine's stream (CIM off: lanes do not couple); the
    sampled lane emits valid ids."""
    jax_eng, _ = _engines()
    ref, _ = _stream(jax_eng, [9, 8, 7], 8)
    eng = _engine()
    s0 = eng.add_request([9, 8, 7], params=TorchSP(temperature=0.0))
    s1 = eng.add_request([1, 2, 3], params=TorchSP(temperature=1.0),
                         key=sampling.key(5))
    for i in range(7):
        eng.step(sampling.key(i))
    assert eng.tokens[s0][3:][:8] == ref
    assert all(0 <= t < 512 for t in eng.tokens[s1][3:])


def test_seeded_sampling_is_placement_independent():
    """A seeded stream depends only on its seed and event count: not on
    its slot, the caller's keys or the traffic beside it."""
    prompt = [3, 1, 4, 1]

    def gen(sp, slot_of, step_keys, extra):
        eng = _engine(batch_slots=3)
        if extra:
            eng.add_request([7, 7], params=TorchSP(temperature=0.5, seed=9))
        s = eng.add_request(prompt, params=sp)
        assert s == slot_of
        for i in range(6):
            eng.step(sampling.key(100 + i) if step_keys else None)
        return eng.tokens[s][len(prompt):]

    sp = TorchSP(temperature=0.8, seed=123)
    a = gen(sp, 0, step_keys=False, extra=False)
    assert a == gen(sp, 1, step_keys=True, extra=True)
    assert len(a) == 7
    assert gen(sp.replace(seed=124), 0, step_keys=False, extra=False) != a


def test_step_result_outputs_typed_stream():
    eng = _engine()
    s0 = eng.add_request([1, 2, 3])
    res = eng.step()
    assert isinstance(res.outputs[0], RequestOutput)
    by_slot = {o.slot: o for o in res.outputs}
    assert by_slot[s0].tokens == [res[s0]]
    assert not by_slot[s0].finished and by_slot[s0].finish_reason is None
    assert by_slot[s0].pj_per_token is None        # CIM off: no pricing
    s1 = eng.add_request([4, 5], params=TorchSP(max_tokens=2))
    res = eng.step()
    o1 = {o.slot: o for o in res.outputs}[s1]
    assert o1.finished and o1.finish_reason == "length"


def test_scheduler_legacy_submit_equivalent_and_warns():
    def run(legacy):
        clk = StepClock()
        sched = Scheduler(_engine(), SchedulerConfig(), clock=clk.now)
        if legacy:
            with pytest.warns(DeprecationWarning):
                r = sched.submit([4, 5, 6], max_new_tokens=5)
        else:
            r = sched.submit([4, 5, 6], params=TorchSP(max_tokens=5))
        while not sched.idle():
            sched.step()
            clk.tick()
        return list(r.generated), r.finish_reason

    assert run(True) == run(False)
    toks, reason = run(False)
    assert len(toks) == 5 and reason == "length"
    clk = StepClock()
    sched = Scheduler(_engine(), SchedulerConfig(), clock=clk.now)
    with pytest.raises(ValueError):
        sched.submit([1, 2], max_new_tokens=4, params=TorchSP(max_tokens=4))
