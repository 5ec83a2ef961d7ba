"""The port's hot-path invariant harness (``repro_torch.analysis.invariants``)
against the JAX package's (``repro.analysis.invariants``): each of the
four drives (serve script, scheduler, prefix cache, speculative decode)
runs through the port on the reference's own weights (``init_params`` at
PRNGKey(0), converted by ``convert.params_from_jax``) with no violation,
and the counters both packages have (fetches, steps, completed, the
prefix-cache and speculative counters, ``forced_mismatch``, ``sampled``,
the dispatch keys and their number) equal the reference's run in this
process. The detections hold: a dispatch whose signature drifts (the
counterpart of a retrace) and a step that fetches twice each raise
``InvariantViolation``.

On the CPU no device→host crossing exists (``d2h`` is 0); the card
checks crossings against fetches (``chip_smoke.py``'s
``analysis_invariants``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import invariants as jinv  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.analysis import invariants as inv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeConfig  # noqa: E402

DRIVES = ("run_invariants", "run_scheduler_invariants",
          "run_prefix_invariants", "run_spec_invariants")
# counters of the reference's report that the port's report has too
SHARED = ("fetches", "steps", "completed", "prefill_executables",
          "prefix_hits", "prefix_misses", "prefix_inserts",
          "prefill_tokens_saved", "spec_steps", "spec_tokens",
          "draft_dispatches", "verify_dispatches", "repair_dispatches",
          "forced_mismatch", "sampled")


@pytest.fixture(scope="module")
def params():
    """The reference's drive weights, converted once per config."""
    out = {}
    for name in inv.INVARIANT_CONFIGS:
        arch = jax_get_config(name).reduced()
        tree = jax.tree.map(np.asarray,
                            jax_init_params(jax.random.PRNGKey(0), arch))
        out[name] = params_from_jax(tree, get_config(name).reduced(), "cpu")
    return out


@pytest.fixture(scope="module")
def reports(params):
    """Each drive's report from both packages, run once."""
    return {fn: (getattr(jinv, fn)(),
                 getattr(inv, fn)(device="cpu", params=params))
            for fn in DRIVES}


@pytest.mark.parametrize("drive", DRIVES)
def test_drive_is_clean_and_its_counters_equal_the_reference(reports,
                                                             drive):
    want, got = reports[drive]
    assert want["violations"] == 0
    assert got["violations"] == 0, got["configs"]
    assert got["failed"] == []
    for name in inv.INVARIANT_CONFIGS:
        w, g = want["configs"][name], got["configs"][name]
        shared = [k for k in SHARED if k in w]
        assert {k: g[k] for k in shared} == {k: w[k] for k in shared}, name
        # one executable per key there, one signature per key here
        assert set(g["traces"]) == set(w["traces"]), name
        assert g["compiles"] == w["compiles"] == len(g["signatures"]), name
        assert g["d2h"] == 0                     # no crossing on the CPU


def _engine(batch_slots=2, max_ctx=64):
    arch = get_config("qwen2-1.5b").reduced()
    from repro_torch.models import init_params
    return inv.InstrumentedEngine(arch, init_params(arch, 0, device="cpu"),
                                  ServeConfig(batch_slots=batch_slots,
                                              max_ctx=max_ctx),
                                  device="cpu")


def test_signature_drift_is_detected():
    """A key whose dispatch issues other operations on its second call is
    the counterpart of a retrace: ``check`` refuses it."""
    eng = _engine(batch_slots=1, max_ctx=16)
    eng._dispatch("decode[probe]", lambda x: x * 2, torch.zeros(2))
    eng._dispatch("decode[probe]", lambda x: x * 2 + 1, torch.zeros(2))
    assert eng.traces["decode[probe]"] == 2
    assert len(eng.signatures["decode[probe]"]) == 2
    with pytest.raises(inv.InvariantViolation, match="signature drifted"):
        eng.check()


def test_extra_transfer_is_detected():
    """A second host crossing in the decode hot path fails the step."""

    class TwoFetchEngine(inv.InstrumentedEngine):
        def _decode_choose(self, *a, **kw):
            ids = super()._decode_choose(*a, **kw)
            self._fetch(ids)                     # the regression under test
            return ids

    arch = get_config("qwen2-1.5b").reduced()
    from repro_torch.models import init_params
    eng = TwoFetchEngine(arch, init_params(arch, 0, device="cpu"),
                         ServeConfig(batch_slots=1, max_ctx=32),
                         device="cpu")
    eng.add_request([3, 1, 4])
    with pytest.raises(inv.InvariantViolation, match="transfers"):
        eng.step()


def test_scheduler_extra_transfer_is_detected():
    """The injected second crossing is caught when the continuous-batching
    scheduler issues the step."""
    from repro_torch.models import init_params
    from repro_torch.serving.params import SamplingParams
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               StepClock)

    class TwoFetchEngine(inv.InstrumentedEngine):
        def _decode_choose(self, *a, **kw):
            ids = super()._decode_choose(*a, **kw)
            self._fetch(ids)
            return ids

    arch = get_config("qwen2-1.5b").reduced()
    clock = StepClock()
    sched = Scheduler(TwoFetchEngine(arch, init_params(arch, 0, device="cpu"),
                                     ServeConfig(batch_slots=1, max_ctx=32),
                                     device="cpu"),
                      SchedulerConfig(prefill_token_budget=None),
                      clock=clock.now)
    sched.submit([3, 1, 4], params=SamplingParams(max_tokens=4),
                 arrival=0.0)
    with pytest.raises(inv.InvariantViolation, match="transfers"):
        for _ in range(8):
            sched.step()
            clock.tick()


def test_fresh_bucket_for_a_greedy_verify_is_detected():
    """A greedy verify chunk whose bucket admission never dispatched would
    be a new executable in the reference: refused."""
    eng = _engine()
    eng.add_request([3, 1, 4, 1, 5])                     # bucket 8
    with pytest.raises(inv.InvariantViolation, match="fresh"):
        eng.verify_chunk(np.zeros((2, 12), np.int64),
                         np.array([12, 0]))              # bucket 16


def test_serve_script_in_grmac_mode_counts_the_calls_in_signatures():
    """In GR-MAC mode every dispatch's signature carries the model's
    projections (here the plain version's calls: 2 layers x 7 + head)."""
    rep = inv._drive("qwen2-1.5b", device="cpu", mode="grmac")
    arch = get_config("qwen2-1.5b").reduced()
    want = 7 * arch.n_layers + 1
    assert {sig[0] for sig in rep["signatures"].values()} == {want}
    assert rep["fetches"] == 2 + rep["steps"]
