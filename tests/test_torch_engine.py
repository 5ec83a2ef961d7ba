"""The port's serving engine against the JAX ``Engine`` on
``paper-cim-120m.reduced()`` and, with every projection through GR-MAC, the
reduced ``gemma3-1b``, ``recurrentgemma-9b``, ``mamba2-1.3b`` and
``grok-1-314b`` (MoE; the reference's own MoE serving tests use grok):
greedy token streams, step results and finish reasons must be identical
for the same prompts and slot placement.

The CIM pre-scale couples the lanes of a dispatch (one absmax over the
whole activation), so every scenario replays whole batches through both
engines, never prompts one at a time.
"""
import dataclasses

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
from repro_torch.core.cim_config import CIMConfig  # noqa: E402
from repro_torch.models import init_params as torch_init_params  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.params import SamplingParams as TorchSP  # noqa: E402

JARCH = jax_get_config("paper-cim-120m").reduced()
TARCH = torch_get_config("paper-cim-120m").reduced()


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax.random.PRNGKey(0), JARCH)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), TARCH, "cpu")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 512, n)]


def _run(engine, sp_cls, script):
    """Replay ``script`` and record every observable: slots claimed, each
    step's tokens / finished / typed outputs, final streams and reasons."""
    log = []
    for op, *args in script:
        if op == "add":
            prompt, kw = args
            log.append(("slot", engine.add_request(
                prompt, params=sp_cls(**kw) if kw else None)))
        elif op == "step":
            for _ in range(args[0]):
                r = engine.step()
                log.append(("step", dict(r), list(r.finished),
                            [(o.slot, o.tokens, o.finished, o.finish_reason)
                             for o in r.outputs]))
        elif op == "release":
            engine.release_slot(args[0])
            log.append(("free", engine.free_slots()))
    b = engine.cfg.batch_slots
    log.append(("tokens", [[int(t) for t in engine.tokens[s]]
                           for s in range(b)]))
    log.append(("reasons", [engine.finish_reason(s) for s in range(b)]))
    log.append(("lengths", [int(x) for x in engine.lengths]))
    return log


def _final(log, key):
    return next(entry[1] for entry in reversed(log) if entry[0] == key)


def _both(params, script, **cfg):
    jp, tp = params
    want = _run(jeng.Engine(JARCH, jp, jeng.ServeConfig(**cfg)), JaxSP, script)
    got = _run(teng.Engine(TARCH, tp, teng.ServeConfig(**cfg), device="cpu"),
               TorchSP, script)
    return got, want


SCENARIOS = {
    # two slots at different lengths, a third joining mid-decode
    "join": (dict(batch_slots=4, max_ctx=64),
             [("add", _prompt(1, 5), {}), ("add", _prompt(2, 12), {}),
              ("step", 5), ("add", _prompt(3, 33), {}), ("step", 4)]),
    # a prompt longer than prefill_bucket_max: three chunk dispatches
    "multi_chunk": (dict(batch_slots=2, max_ctx=64, prefill_bucket_max=16),
                    [("add", _prompt(4, 40), {}), ("add", _prompt(5, 9), {}),
                     ("step", 5)]),
    # per-request caps, including a one-token cap finished at prefill
    "max_tokens": (dict(batch_slots=3, max_ctx=64),
                   [("add", _prompt(6, 7), {"max_tokens": 3}),
                    ("add", _prompt(7, 10), {"max_tokens": 1}),
                    ("add", _prompt(8, 4), {}), ("step", 5)]),
    # release a live slot and reuse it (its cache is zeroed on the claim)
    "release_reuse": (dict(batch_slots=2, max_ctx=64),
                      [("add", _prompt(9, 6), {}), ("add", _prompt(10, 8), {}),
                       ("step", 3), ("release", 0), ("add", _prompt(11, 5), {}),
                       ("step", 4)]),
    # context exhaustion: lane 0 finishes by ctx and keeps riding along in
    # the decode at index max_ctx, where the write clamps to the last slot
    "ctx": (dict(batch_slots=2, max_ctx=24),
            [("add", _prompt(12, 20), {}), ("add", _prompt(13, 5), {}),
             ("step", 12)]),
    # the legacy token-by-token prefill path
    "token_prefill": (dict(batch_slots=2, max_ctx=64, prefill_mode="token"),
                      [("add", _prompt(14, 6), {}), ("add", _prompt(15, 3), {}),
                       ("step", 3)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(params, name):
    cfg, script = SCENARIOS[name]
    got, want = _both(params, script, **cfg)
    assert got == want


def test_engine_eos_matches_jax(params):
    """A default EOS id and a per-request one, taken from the streams of an
    EOS-free run so that both fire mid-decode."""
    _, tp = params
    script = [("add", _prompt(16, 6), {}), ("add", _prompt(17, 9), {}),
              ("step", 6)]
    free = _run(teng.Engine(TARCH, tp, teng.ServeConfig(batch_slots=2,
                                                        max_ctx=64),
                            device="cpu"), TorchSP, script)
    streams = _final(free, "tokens")
    eos0 = streams[0][6 + 3]          # slot 0's fourth generated token
    eos1 = streams[1][9 + 2]          # slot 1's third generated token
    script = [("add", _prompt(16, 6), {}),
              ("add", _prompt(17, 9), {"eos_id": eos1}), ("step", 6)]
    got, want = _both(params, script, batch_slots=2, max_ctx=64, eos_id=eos0)
    assert got == want
    assert _final(got, "reasons") == ["eos", "eos"]


def test_bucketed_prefill_equals_token_prefill_in_the_port(params):
    """With the CIM path off (no lane coupling through the pre-scale) the
    bucketed and the token-by-token prefill give the same greedy streams."""
    _, tp = params
    arch = dataclasses.replace(TARCH, cim=CIMConfig())
    script = [("add", _prompt(18, 11), {}), ("add", _prompt(19, 21), {}),
              ("step", 5)]
    runs = [_run(teng.Engine(arch, tp, teng.ServeConfig(
                batch_slots=2, max_ctx=64, prefill_mode=mode,
                prefill_bucket_max=8), device="cpu"), TorchSP, script)
            for mode in ("bucketed", "token")]
    assert _final(runs[0], "tokens") == _final(runs[1], "tokens")


def test_one_fetch_per_step_and_per_first_token(params, monkeypatch):
    _, tp = params
    eng = teng.Engine(TARCH, tp, teng.ServeConfig(batch_slots=2, max_ctx=64,
                                                  prefill_bucket_max=8),
                      device="cpu")
    fetched = []
    real = eng._fetch
    monkeypatch.setattr(eng, "_fetch",
                        lambda ids: fetched.append(tuple(ids.shape))
                        or real(ids))
    eng.add_request(_prompt(20, 19))           # three chunks, one selection
    assert fetched == [(2,)]
    for n in range(1, 4):
        eng.step()
        assert fetched == [(2,)] * (n + 1)
    assert eng.stats == {"prefill_dispatches": 3, "decode_steps": 3,
                         "prefill_tokens": 19}


def test_engine_refuses_what_is_not_ported(params):
    _, tp = params
    with pytest.raises(NotImplementedError, match="sampling"):
        teng.Engine(TARCH, tp, teng.ServeConfig(temperature=0.7),
                    device="cpu")
    eng = teng.Engine(TARCH, tp, teng.ServeConfig(batch_slots=1, max_ctx=16),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.add_request([1, 2], params=TorchSP(temperature=1.0))
    with pytest.raises(ValueError, match="max_ctx"):
        eng.add_request(list(range(16)))
    eng.add_request([1, 2, 3])
    with pytest.raises(RuntimeError, match="no free slots"):
        eng.add_request([4])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(params,
                                                           monkeypatch):
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.Engine(TARCH, tp, teng.ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_init_params(TARCH, seed=0)


# ------------------------------------------------------------------ energy
def test_pj_per_token_is_the_energy_reports_decode_value(params):
    """Every step result and request output reads the decode-phase pJ per
    token of ``energy_report``, priced on the first read (not before), a
    completion surfaced from prefill time included; None with the CIM path
    off."""
    _, tp = params
    eng = teng.Engine(TARCH, tp, teng.ServeConfig(batch_slots=3, max_ctx=64),
                      device="cpu")
    eng.add_request(_prompt(31, 7))
    eng.add_request(_prompt(30, 5), params=TorchSP(max_tokens=1))
    results = [eng.step() for _ in range(3)]
    assert "pj_per_token" not in eng.stats and eng._energy is None
    want = teng.energy_report(TARCH, device="cpu")["pj_per_token"]
    assert want > 0
    assert results[0].outputs[0].finish_reason == "length"
    for r in results:
        assert r.pj_per_token == want
        assert [o.pj_per_token for o in r.outputs] == [want] * len(r.outputs)
    assert eng.stats["pj_per_token"] == want
    assert eng.energy_per_token() is eng.energy_per_token()

    off = dataclasses.replace(TARCH, cim=CIMConfig())
    eng = teng.Engine(off, tp, teng.ServeConfig(batch_slots=1, max_ctx=64),
                      device="cpu")
    eng.add_request(_prompt(32, 4))
    r = eng.step()
    assert r.pj_per_token is None and r.outputs[0].pj_per_token is None
    assert eng.energy_per_token() is None
    assert teng.energy_report(off, device="cpu") == {"enabled": False}


def test_reading_pj_per_token_leaves_the_streams_unchanged(params):
    _, tp = params
    streams = []
    for read in (False, True):
        eng = teng.Engine(TARCH, tp, teng.ServeConfig(batch_slots=2,
                                                      max_ctx=64),
                          device="cpu")
        eng.add_request(_prompt(33, 9))
        for _ in range(3):
            r = eng.step()
            if read:
                assert r.pj_per_token is not None
        eng.add_request(_prompt(34, 6))
        for _ in range(3):
            eng.step()
        streams.append([list(t) for t in eng.tokens])
    assert streams[0] == streams[1]


def _keys(tree):
    """The nested key structure of a report (leaves dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_energy_report_keys_match_jax():
    nc = 1 << 7
    want = jeng.energy_report(JARCH, prefill_bucket=16, n_cols=nc)
    got = teng.energy_report(TARCH, prefill_bucket=16, n_cols=nc,
                             device="cpu")
    assert _keys(got) == _keys(want)
    for phase in ("decode", "prefill", "train"):
        for key in ("tokens", "macs_per_token", "ops_per_token",
                    "analog_ops_per_token"):
            assert got["phases"][phase][key] == want["phases"][phase][key]


# ------------------------------------------------------------ other blocks
FAMILIES = ["gemma3-1b", "recurrentgemma-9b", "mamba2-1.3b", "grok-1-314b"]
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


FAMILY_SCENARIOS = {
    # a request joining a live batch: prefilled with the other lane frozen
    "join": (dict(batch_slots=2, max_ctx=64),
             [("add", _prompt(21, 6), {}), ("step", 3),
              ("add", _prompt(22, 3), {}), ("step", 5)]),
    # a 70-token prompt, one chunk (bucket 128) longer than the 64-token
    # window: the ring wraps inside the prefill, and again in decode
    "long_chunk": (dict(batch_slots=2, max_ctx=256),
                   [("add", _prompt(23, 70), {}), ("add", _prompt(24, 5), {}),
                    ("step", 6)]),
    # chunks of 8 tokens: chunk boundaries inside the recurrences
    "multi_chunk": (dict(batch_slots=2, max_ctx=64, prefill_bucket_max=8),
                    [("add", _prompt(25, 21), {}), ("add", _prompt(26, 11), {}),
                     ("step", 5)]),
    # release a live slot and reuse it: its rings, recurrent states and
    # conv windows are zeroed on the claim
    "release_reuse": (dict(batch_slots=2, max_ctx=64),
                      [("add", _prompt(27, 6), {}), ("add", _prompt(28, 8), {}),
                       ("step", 3), ("release", 0),
                       ("add", _prompt(29, 5), {}), ("step", 4)]),
}


@pytest.mark.parametrize("scenario", sorted(FAMILY_SCENARIOS))
@pytest.mark.parametrize("name", FAMILIES)
def test_family_engine_matches_jax(name, scenario):
    """Whole-batch Engine scenarios on the reduced gemma3, recurrentgemma,
    mamba2 and grok configs with every projection (grok's router too)
    through GR-MAC: identical streams, step results, finish reasons and
    lengths."""
    jarch, tarch, jp, tp = _family(name)
    cfg, script = FAMILY_SCENARIOS[scenario]
    want = _run(jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg)), JaxSP, script)
    got = _run(teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu"),
               TorchSP, script)
    assert got == want


@pytest.mark.parametrize("bucket_max", [8, 128])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_bucketed_prefill_equals_token_prefill_in_the_port(
        name, bucket_max):
    """With the CIM path off, a bucketed prefill (chunks of 8, or a
    70-token prompt in one chunk longer than the 64-token window) gives
    the token-by-token prefill's greedy streams in every block kind. For
    grok this holds because no expert overflows in either mode: a chunk's
    padded steps take no capacity, and at most one of each token's two
    assignments reaches an expert whose capacity is 1.25x the mean."""
    _, tarch, _, tp = _family(name)
    arch = dataclasses.replace(tarch, cim=CIMConfig())
    script = [("add", _prompt(30, 70), {}), ("add", _prompt(31, 21), {}),
              ("step", 5)]
    runs = [_run(teng.Engine(arch, tp, teng.ServeConfig(
                batch_slots=2, max_ctx=128, prefill_mode=mode,
                prefill_bucket_max=bucket_max), device="cpu"), TorchSP, script)
            for mode in ("bucketed", "token")]
    assert _final(runs[0], "tokens") == _final(runs[1], "tokens")


def test_moe_decode_overflow_matches_jax(monkeypatch):
    """Eight slots of reduced grok, GR-MAC: in decode all 8 lanes route (the
    freed and idle ones too, on their last token) and 16 assignments share
    a capacity of 5 an expert, so assignments are dropped. The port drops
    exactly where the reference does: the streams stay identical."""
    from repro_torch.models import moe as torch_moe

    jarch, tarch, jp, tp = _family("grok-1-314b")
    dropped = []
    real = torch_moe.dispatch

    def counting(xf, expert_idx, valid, e, cap):
        buf, slot, keep = real(xf, expert_idx, valid, e, cap)
        if xf.shape[0] == 8:                      # a layer of a decode step
            dropped.append(int((~keep).sum()))
        return buf, slot, keep

    monkeypatch.setattr(torch_moe, "dispatch", counting)
    cfg = dict(batch_slots=8, max_ctx=64)
    script = ([("add", _prompt(40 + i, 3 + 2 * i), {}) for i in range(6)]
              + [("step", 4), ("release", 2), ("step", 3)])
    want = _run(jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg)), JaxSP,
                script)
    got = _run(teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu"),
               TorchSP, script)
    assert got == want
    assert len(dropped) == 7 * tarch.n_layers and sum(dropped) > 0
