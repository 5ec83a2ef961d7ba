"""The port's continuous-batching scheduler (``serving.scheduler``)
against the JAX package's: every scenario of the reference's
tests/test_scheduler.py runs through both packages on the same weights and
the same virtual ``StepClock``, and every request's stream, state, finish
reason, preemptions and policy-clock stamps, the engine's and the
scheduler's counters and every policy-clock metric of ``metrics()`` must
be exactly equal (wall-clock metrics are not compared). The four cache
families are the reference's (reduced, CIM off, as there); one open-loop
scenario runs ``paper-cim-120m.reduced()`` in GR-MAC mode with the
prefill budget, preemption and the prefix cache on.

Preemption in GR-MAC mode changes a stream in the reference as in the
port: the recompute resume prefills prompt + generated tokens in other
chunks than the first run, and the kernel's pre-scale sees other
activations (ROADMAP §C). So stream invariance under preemption is held
with the CIM path off, and the GR-MAC scenario is held to JAX.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.params import SamplingParams as JaxSP  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.params import SamplingParams as TorchSP  # noqa: E402
from repro_torch.serving.scheduler import (FINISHED, PREFILLING,  # noqa: E402
                                           RUNNING, WAITING)

FAMILIES = [
    ("attn", "qwen2-1.5b"),
    ("rglru", "recurrentgemma-9b"),
    ("ssm", "mamba2-1.3b"),
    ("moe", "grok-1-314b"),
]
# metrics read from the wall clock: machine-dependent, never compared
WALL = ("wall_s", "goodput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
        "tpot_p50_ms", "tpot_p99_ms")

_PARAMS = {}


def _setup(name):
    if name not in _PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _PARAMS[name] = (jarch, tarch, jp, tp)
    return _PARAMS[name]


class Pkg:
    """One package's serving modules, so a scenario is written once."""

    def __init__(self, name):
        self.name = name
        self.sched = jsched if name == "jax" else tsched
        self.SP = JaxSP if name == "jax" else TorchSP

    def engine(self, arch="qwen2-1.5b", slots=2, ctx=64, **cfg_kw):
        jarch, tarch, jp, tp = _setup(arch)
        cfg = dict(batch_slots=slots, max_ctx=ctx, **cfg_kw)
        if self.name == "jax":
            return jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg))
        return teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu")

    def scheduler(self, eng, clock, cls=None, **cfg_kw):
        cls = cls or self.sched.Scheduler
        return cls(eng, self.sched.SchedulerConfig(**cfg_kw), clock=clock.now)

    def submit(self, sched, prompt, n, arrival=0.0):
        return sched.submit(prompt, params=self.SP(max_tokens=n),
                            arrival=arrival)


PKGS = (Pkg("jax"), Pkg("torch"))


def _drain(sched, clock, max_steps=500):
    steps = 0
    while not sched.idle():
        sched.step()
        clock.tick()
        steps += 1
        assert steps < max_steps, "scheduler failed to drain"
    return steps


def _observe(sched, slo_ttft=None):
    """Everything a scenario is held to, the wall clock left out."""
    m = sched.metrics(slo_ttft=slo_ttft)
    return {
        "requests": [(r.rid, r.prompt, r.state, r.slot, r.finish_reason,
                      r.generated, r.preemptions, r.resume_prompt,
                      r.arrival, r.t_admit, r.t_first, r.t_finish)
                     for r in sched.requests],
        "engine": {k: v for k, v in sched.engine.stats.items()},
        "sched": dict(sched.stats),
        "metrics": {k: v for k, v in m.items() if k not in WALL},
        "tokens": [[int(t) for t in s] for s in sched.engine.tokens],
    }


def _both(scenario):
    """Run ``scenario(pkg) -> observation`` through both packages; the
    port's must equal JAX's. Returns the port's."""
    want, got = (scenario(p) for p in PKGS)
    assert got == want
    return got


def test_fifo_admission_and_state_machine():
    def run(pkg):
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=2), clock)
        rs = [pkg.submit(sched, [3, 1, 4, 1, 5], 3) for _ in range(3)]
        states = [[r.state for r in rs]]
        sched.step()
        clock.tick()
        states.append([(r.state, r.slot) for r in rs])
        _drain(sched, clock)
        return states, _observe(sched)

    states, obs = _both(run)
    assert states[0] == [WAITING] * 3
    assert states[1] == [(RUNNING, 0), (RUNNING, 1), (WAITING, None)]
    reqs = obs["requests"]
    assert [r[2] for r in reqs] == [FINISHED] * 3
    assert [r[4] for r in reqs] == ["length"] * 3
    assert reqs[2][9] > reqs[0][9]
    assert obs["metrics"]["completed"] == 3


def test_token_mode_engine_and_speculation_are_refused():
    eng = PKGS[1].engine(prefill_mode="token")
    with pytest.raises(ValueError, match="bucketed"):
        tsched.Scheduler(eng)
    for pkg in PKGS:       # speculation is ported: the reference's refusal
        with pytest.raises(ValueError, match="SpecConfig or SpecDecoder"):
            pkg.sched.Scheduler(pkg.engine(), spec=object())
    with pytest.raises(ValueError, match="admission"):
        tsched.Scheduler(PKGS[1].engine(),
                         tsched.SchedulerConfig(admission="sjf"))


@pytest.mark.parametrize("family,name", FAMILIES)
def test_scheduler_matches_hand_placed_engine_and_jax(family, name):
    """Fixed, non-overflowing arrivals and an unbounded budget: the
    scheduler is dispatch for dispatch the hand-placed
    ``add_request``/``step`` calls, and equal to JAX's."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4]]
    n_new = 5

    def run(pkg):
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(name), clock,
                              prefill_token_budget=None)
        for p in prompts:
            pkg.submit(sched, p, n_new)
        _drain(sched, clock)
        hand = pkg.engine(name)
        slots = [hand.add_request(p) for p in prompts]
        for _ in range(n_new - 1):
            hand.step()
        return (_observe(sched),
                [hand.tokens[s][len(p):len(p) + n_new]
                 for s, p in zip(slots, prompts)],
                {k: hand.stats[k] for k in ("prefill_dispatches",
                                            "decode_steps")})

    obs, hand, hand_stats = _both(run)
    assert [r[5] for r in obs["requests"]] == hand, f"{family}: diverged"
    assert {k: obs["engine"][k] for k in hand_stats} == hand_stats


def test_prefill_budget_interleaves_across_steps():
    def run(pkg):
        clock = pkg.sched.StepClock()
        eng = pkg.engine()
        sched = pkg.scheduler(eng, clock, prefill_token_budget=4)
        r = pkg.submit(sched, list(range(1, 13)), 3)
        seen = []
        for _ in range(3):
            sched.step()
            clock.tick()
            seen.append((r.state, eng.prefill_remaining(r.slot),
                         eng.stats["decode_steps"], r.t_first,
                         r.n_generated))
        _drain(sched, clock)
        return seen, _observe(sched)

    seen, obs = _both(run)
    assert seen[0][:3] == (PREFILLING, 8, 0)
    assert seen[1][:2] == (PREFILLING, 4) and seen[1][3] is None
    assert seen[2][0] == RUNNING and seen[2][4] == 2
    assert obs["requests"][0][4] == "length"


def test_budget_spends_fifo_across_requests():
    def run(pkg):
        clock = pkg.sched.StepClock()
        eng = pkg.engine()
        sched = pkg.scheduler(eng, clock, prefill_token_budget=8)
        r0 = pkg.submit(sched, list(range(1, 13)), 4)
        r1 = pkg.submit(sched, list(range(1, 13)), 4)
        sched.step()
        first = (eng.prefill_remaining(r0.slot),
                 eng.prefill_remaining(r1.slot))
        sched.step()
        second = (r0.state, eng.prefill_remaining(r1.slot))
        _drain(sched, clock)
        return first, second, _observe(sched)

    first, second, _ = _both(run)
    assert first == (4, 12) and second == (RUNNING, 8)


def test_admission_rejects_prompt_that_cannot_fit():
    def run(pkg):
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=2, ctx=32), clock)
        pkg.submit(sched, list(range(1, 40)), 4)
        pkg.submit(sched, [5, 6, 7], 2)
        _drain(sched, clock)
        return _observe(sched)

    obs = _both(run)
    big, ok = obs["requests"]
    assert big[4] == "rejected" and big[5] == [] and big[9] is None
    assert ok[4] == "length"
    assert obs["metrics"]["rejected"] == 1
    assert obs["metrics"]["completed"] == 1


def test_max_new_tokens_one_finishes_at_prefill():
    def run(pkg):
        clock = pkg.sched.StepClock()
        eng = pkg.engine(slots=1)
        sched = pkg.scheduler(eng, clock)
        pkg.submit(sched, [3, 1, 4], 1)
        sched.step()
        return eng.free_slots(), _observe(sched)

    free, obs = _both(run)
    assert free == 1 and obs["requests"][0][2:5] == (FINISHED, None,
                                                      "length")
    assert obs["engine"]["decode_steps"] == 0


def test_eos_finish_reason(monkeypatch):
    """An EOS scripted on the second token through the engine's single
    ``_fetch`` seam finishes the request with reason "eos"."""
    script = [[5], [9], [7]]
    it = {"t": 0}

    def fake_fetch(ids_dev):
        row = script[min(it["t"], len(script) - 1)]
        it["t"] += 1
        return np.asarray(row, np.int32)

    monkeypatch.setattr(teng.Engine, "_fetch", staticmethod(fake_fetch))
    clock = tsched.StepClock()
    eng = PKGS[1].engine(slots=1)
    sched = PKGS[1].scheduler(eng, clock)
    r = sched.submit([3, 1, 4], params=TorchSP(max_tokens=10, eos_id=7),
                     arrival=0.0)
    _drain(sched, clock)
    assert r.finish_reason == "eos"
    assert r.generated == [5, 9, 7]
    assert eng.free_slots() == 1


@pytest.mark.parametrize("cache", [None, 1 << 24])
def test_preemption_resume_stream_is_invariant(cache):
    """LIFO preemption with recompute resume, with the prefix cache off
    and on: the preempted greedy request's stream equals an undisturbed
    run's; with the cache the resume adopts its own 8-token boundary."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    n_new = 6

    def run(pkg):
        clock = pkg.sched.StepClock()
        ref = pkg.scheduler(pkg.engine(slots=1), clock,
                            prefill_token_budget=None)
        r_ref = pkg.submit(ref, prompt, n_new)
        _drain(ref, clock)
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=1, prefix_cache_bytes=cache),
                              clock, prefill_token_budget=None,
                              preempt_age=2.0)
        pkg.submit(sched, prompt, n_new)
        pkg.submit(sched, [2, 7, 1], 2)
        _drain(sched, clock)
        return r_ref.generated, _observe(sched), _observe(ref)

    ref_stream, obs, ref_obs = _both(run)
    r0, r1 = obs["requests"]
    assert r0[6] == 1 and r1[6] == 0
    assert r0[4] == "length" and r0[5] == ref_stream
    assert obs["sched"]["admitted"] == 3 and obs["metrics"]["preempted"] == 1
    m = obs["metrics"]
    if cache is None:
        assert "prefix_hits" not in m and m["recompute_tokens_saved"] == 0
    else:
        assert m["recompute_tokens_saved"] == len(prompt)
        assert m["prefill_tokens_saved"] == len(prompt)
        assert m["prefix_hits"] == 1
        assert "prefix_hits" not in ref_obs["metrics"]


def test_static_batching_blocks_until_batch_drains():
    def run(pkg):
        out = []
        for cls in (pkg.sched.StaticBatchScheduler, pkg.sched.Scheduler):
            clock = pkg.sched.StepClock()
            sched = cls(pkg.engine(slots=2), clock=clock.now)
            for n in (2, 8, 2):
                pkg.submit(sched, [3, 1, 4], n)
            _drain(sched, clock)
            out.append(_observe(sched))
        return out

    static, cont = (o["requests"] for o in _both(run))
    assert static[2][9] > static[1][11]          # waited for the straggler
    assert cont[2][9] < static[2][9]
    assert cont[2][9] <= cont[0][11] + 1.0
    assert all(r[4] == "length" for r in static + cont)


def test_pj_per_token_threads_from_step_result(monkeypatch):
    monkeypatch.setattr(teng.Engine, "_pj_per_token", lambda self: 42.0)
    clock = tsched.StepClock()
    sched = PKGS[1].scheduler(PKGS[1].engine(slots=1), clock)
    assert sched.pj_per_token is None
    PKGS[1].submit(sched, [3, 1, 4], 3)
    _drain(sched, clock)
    m = sched.metrics()
    assert sched.pj_per_token == m["pj_per_token"] == 42.0
    assert m["energy_pj"] == 42.0 * m["generated_tokens"]


@pytest.mark.parametrize("synth", ["synth_traffic",
                                   "synth_shared_prefix_traffic"])
def test_synthetic_traffic_equals_jax(synth):
    """The same seed gives the same traffic in both packages (the same
    ``np.random.RandomState`` draws), and the rate scales arrivals only."""
    kw = dict(seed=7, vocab_size=100)
    if synth == "synth_shared_prefix_traffic":
        kw.update(n_prefixes=3, prefix_len=8, user_len=(2, 5),
                  out_len=(2, 4))

    def trace(mod, rate):
        return [(t.arrival, t.prompt, t.max_new_tokens)
                for t in getattr(mod, synth)(12, rate, **kw)]

    a = trace(tsched, 0.5)
    assert a == trace(jsched, 0.5) == trace(tsched, 0.5)
    c = trace(tsched, 1.0)
    np.testing.assert_allclose([t[0] for t in c], [t[0] / 2 for t in a])
    assert [t[1:] for t in c] == [t[1:] for t in a]
    if synth == "synth_shared_prefix_traffic":
        heads = [tuple(t[1][:8]) for t in a]
        assert len(set(heads)) <= 3
        assert max(heads.count(h) for h in set(heads)) >= 2


def test_shortest_prompt_admission_order():
    def run(pkg):
        out = []
        for kw in ({"admission": "shortest_prompt"}, {}):
            clock = pkg.sched.StepClock()
            sched = pkg.scheduler(pkg.engine(slots=1), clock, **kw)
            for n in (12, 6, 3):
                pkg.submit(sched, list(range(1, n + 1)), 2)
            _drain(sched, clock)
            out.append(_observe(sched))
        return out

    sjf, fifo = _both(run)
    long_, mid, short = sjf["requests"]
    assert short[9] < mid[9] < long_[9]
    assert sjf["sched"]["admission_reorders"] == 2
    assert all(r[4] == "length" and len(r[5]) == 2
               for r in sjf["requests"])
    t = [r[9] for r in fifo["requests"]]
    assert t[0] < t[1] < t[2]
    assert fifo["metrics"]["admission_reorders"] == 0


def test_admission_age_bound_stops_starvation():
    def run(pkg):
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=1), clock,
                              admission="shortest_prompt",
                              admission_age_bound=0.5)
        pkg.submit(sched, list(range(1, 13)), 2)
        for _ in range(3):
            pkg.submit(sched, [7, 8, 9], 2)
        _drain(sched, clock)
        return _observe(sched)

    obs = _both(run)
    long_, s0, s1, s2 = (r[9] for r in obs["requests"])
    assert s0 < long_ < s1 < s2
    assert obs["sched"]["admission_reorders"] == 1


def test_closed_loop_holds_concurrency_and_equals_jax():
    def run(pkg):
        traffic = pkg.sched.synth_traffic(6, 0.3, seed=1, vocab_size=512,
                                          prompt_len=(3, 12), out_len=(2, 5))
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=2), clock,
                              prefill_token_budget=6)
        peak = [0]

        def tick(cost=1.0):
            live = (len(sched.waiting) + len(sched.prefilling)
                    + len(sched.running))
            peak[0] = max(peak[0], live)
            clock.tick(cost)

        steps = pkg.sched.run_closed_loop(sched, traffic, concurrency=2,
                                          tick=tick)
        return steps, peak[0], _observe(sched)

    steps, peak, obs = _both(run)
    assert obs["metrics"]["completed"] == 6 and peak == 2
    assert steps == obs["metrics"]["sched_steps"]


def test_open_loop_run_equals_jax():
    def run(pkg):
        traffic = pkg.sched.synth_traffic(6, 0.3, seed=1, vocab_size=512,
                                          prompt_len=(3, 12), out_len=(2, 5))
        clock = pkg.sched.StepClock()
        sched = pkg.scheduler(pkg.engine(slots=2), clock,
                              prefill_token_budget=6)
        pkg.sched.run_open_loop(sched, traffic, tick=clock.tick)
        return _observe(sched, slo_ttft=30.0)

    obs = _both(run)
    m = obs["metrics"]
    assert m["completed"] == 6
    assert m["decode_steps"] > 0 and m["prefill_dispatches"] > 0


def test_grmac_open_loop_with_preemption_and_prefix_cache_equals_jax(
        monkeypatch):
    """paper-cim-120m.reduced() in GR-MAC mode, 4 slots: mixed open-loop
    traffic (uniform prompts and Zipf-shared 16-token system prompts)
    above capacity, a 16-token prefill budget, preemption at age 20 and
    the prefix cache on. Every request's stream, stamp and every policy
    metric equal JAX's; the run preempts and hits. The energy thunk is
    replaced in both packages (the seeded pricing is held elsewhere)."""
    monkeypatch.setattr(jeng.Engine, "_pj_per_token", lambda self: 42.0)
    monkeypatch.setattr(teng.Engine, "_pj_per_token", lambda self: 42.0)

    def run(pkg):
        s = pkg.sched
        traffic = sorted(
            s.synth_traffic(12, 0.5, seed=0, vocab_size=512,
                            prompt_len=(8, 30), out_len=(4, 12))
            + s.synth_shared_prefix_traffic(
                8, 0.8, seed=1, vocab_size=512, n_prefixes=2, prefix_len=16,
                user_len=(3, 8), out_len=(4, 8)),
            key=lambda t: t.arrival)
        clock = s.StepClock()
        sched = pkg.scheduler(
            pkg.engine("paper-cim-120m", slots=4, ctx=96,
                       prefix_cache_bytes=1 << 24),
            clock, prefill_token_budget=16, preempt_age=20.0)
        s.run_open_loop(sched, traffic, tick=clock.tick)
        return _observe(sched, slo_ttft=30.0)

    m = _both(run)["metrics"]
    assert m["completed"] == 20 and m["preempted"] >= 1
    assert m["prefix_hits"] >= 1 and m["recompute_tokens_saved"] > 0
    assert m["pj_per_token"] == 42.0
