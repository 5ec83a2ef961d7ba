"""The port's scopes (``core.scopes``) on the profiler's clock: with no
profiler recording, a scope is the stack's push and pop and nothing else;
under ``torch.profiler`` every layer boundary is a user annotation,
nested as the layers call each other (CPU, ``paper-cim-120m.reduced()``:
a scheduler run with two prefill chunks and decode steps, one train step
under remat; the SSM block's ``ssm.recurrence`` and ``ssm.step`` on a
tiny mamba2's prefill and decode). ``cim.pack``, the per-call packing of
the card's route, is held on the card (``tests/test_torch_gpu.py``)."""
import re

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import scopes  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (Engine, SamplingParams,  # noqa: E402
                                 Scheduler, SchedulerConfig, ServeConfig)
from repro_torch.training.optimizer import (OptimizerConfig,  # noqa: E402
                                            init_opt_state)
from repro_torch.training.trainer import (TrainConfig,  # noqa: E402
                                          make_train_step)

# the names the benchmark gives its own spans around the program's calls
BENCHMARK_SPANS = {"Engine.step", "Engine.advance_prefill",
                   "Engine.finish_prefill", "train_step"}
SITE = r"cim_\w+?_m\d+_k\d+_n\d+"
DECODE = ["sched.step", "sched.decode", r"engine\.decode\[sample=False\]"]
PREFILL = ["sched.step", "sched.prefill", r"engine\.prefill\[bucket=8\]"]
CPU = torch.autograd.DeviceType.CPU


def test_no_profiler_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    assert scopes.current() == []
    with scopes.named_scope("a"), scopes.named_scope("b"):
        assert scopes.current() == ["a", "b"]
    assert scopes.current() == [] and opened == []


def _chains(prof) -> list:
    """Each recorded scope with the scopes enclosing it on its thread,
    outermost first, and its (start, end)."""
    out = []
    for e in prof.events():
        if not (e.is_user_annotation and e.device_type == CPU):
            continue
        chain, p = [e.name], e.cpu_parent
        while p is not None:
            if p.is_user_annotation:
                chain.insert(0, p.name)
            p = p.cpu_parent
        out.append((chain, (e.time_range.start, e.time_range.end)))
    return out


@pytest.fixture(scope="module")
def recorded():
    """The scopes of a profiled scheduler run (a 12-token prompt: two
    chunks under a budget of 8, then decode steps) and train step."""
    arch = get_config("paper-cim-120m").reduced().replace(remat=True)
    params = init_params(arch, 0, device="cpu")
    sched = Scheduler(Engine(arch, params, ServeConfig(
        batch_slots=2, max_ctx=32, prefill_bucket_min=8,
        prefill_bucket_max=8), device="cpu"),
        SchedulerConfig(prefill_token_budget=8))
    step = make_train_step(arch, TrainConfig(opt=OptimizerConfig()))
    state = init_opt_state(params, OptimizerConfig())
    ids = torch.randint(1, arch.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.submit(list(range(1, 13)), params=SamplingParams(max_tokens=3))
        for _ in range(4):
            sched.step()
        step(params, state, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
    return _chains(prof)


def _has(recorded, want) -> bool:
    return any(len(chain) == len(want) and all(
        re.fullmatch(w, c) for w, c in zip(want, chain))
        for chain, _ in recorded)


@pytest.mark.parametrize("want", [
    ["sched.step", "sched.preempt"],
    ["sched.step", "sched.admit"],
    DECODE + ["model.layer", SITE, r"cim\.prescale"],
    DECODE + ["model.layer", r"attn\.cache_write"],
    DECODE + [r"engine\.h2d"],
    DECODE + [r"engine\.choose"],
    DECODE + [r"model\.embed"],
    DECODE + [r"model\.head", SITE, r"cim\.prescale"],
    ["sched.step", "sched.decode", r"engine\.fetch"],
    PREFILL + ["model.layer", r"attn\.cache_write"],
    ["sched.step", "sched.prefill", r"engine\.h2d"],
    ["sched.step", "sched.prefill", r"engine\.fetch"],
    ["train.forward", "model.layer", SITE, r"cim\.prescale"],
    # remat's recomputation, inside the backward
    ["train.backward", "model.layer", SITE, r"cim\.prescale"],
    ["train.optimizer"],
], ids=lambda w: ">".join(w[-2:]))
def test_scopes_nest_as_the_layers_call(recorded, want):
    assert _has(recorded, want), sorted({">".join(c) for c, _ in recorded})


def test_fetch_waits_outside_the_dispatch(recorded):
    fetches = [c for c, _ in recorded if c[-1] == "engine.fetch"]
    assert fetches and not any(n.startswith("engine.decode")
                               for c in fetches for n in c)


def test_train_phases_are_disjoint_in_order(recorded):
    spans = {c[0]: t for c, t in recorded if len(c) == 1
             and c[0].startswith("train.")}
    f, b, o = (spans[k] for k in ("train.forward", "train.backward",
                                  "train.optimizer"))
    assert f[0] < f[1] <= b[0] < b[1] <= o[0] < o[1]


def test_no_scope_takes_a_benchmark_span_name(recorded):
    names = {n for c, _ in recorded for n in c}
    assert names and not names & BENCHMARK_SPANS


# the SSM block's recurrence (tiny mamba2, GR-MAC on every projection)
SSM_CHUNK, SSM_LANES = 5, 2


def _ssm_arch():
    arch = get_config("mamba2-1.3b").reduced()
    return arch.replace(cim=arch.cim.with_mode("grmac"))


def _ssm_serve(arch, params):
    """A prefill of a chunk of ``SSM_CHUNK`` (lane 1 padded after 3) and
    one decode step from it: their logits."""
    from repro_torch.models import decode_step, init_cache, prefill_step

    cache = init_cache(arch, SSM_LANES, 16, torch.float32, "cpu")
    toks = torch.randint(1, arch.vocab_size, (SSM_LANES, SSM_CHUNK),
                         generator=torch.Generator().manual_seed(1))
    zero = torch.zeros(SSM_LANES, dtype=torch.int64)
    lens = torch.tensor([SSM_CHUNK, 3])
    first, ids, cache = prefill_step(params, toks, arch, cache, zero, lens)
    nxt, _ = decode_step(params, ids[:, -1:].to(torch.int64), arch, cache,
                         lens, active=torch.ones(SSM_LANES, dtype=torch.bool))
    return first, nxt


@pytest.fixture(scope="module")
def ssm_model():
    arch = _ssm_arch()
    return arch, init_params(arch, 0, device="cpu")


@pytest.fixture(scope="module")
def ssm_recorded(ssm_model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = _ssm_serve(*ssm_model)
    return _chains(prof), logits


@pytest.mark.parametrize("want", [
    ["model.layer", r"ssm\.recurrence"],
    ["model.layer", r"ssm\.recurrence", r"ssm\.step"],
    ["model.layer", r"ssm\.recurrence", r"ssm\.step", "dig_ssm_ssd"],
    # decode's one step, with no loop around it
    ["model.layer", r"ssm\.step"],
], ids=lambda w: ">".join(w[-2:]))
def test_ssm_scopes_nest_in_the_layer(ssm_recorded, want):
    chains, _ = ssm_recorded
    assert _has(chains, want), sorted({">".join(c) for c, _ in chains})
    # nowhere else: a step in a layer's loop or in the layer itself, a
    # recurrence in a layer
    for chain, _ in chains:
        if chain[-1] == "ssm.recurrence":
            assert chain == ["model.layer", "ssm.recurrence"], chain
        if chain[-1] == "ssm.step":
            assert chain in (["model.layer", "ssm.recurrence", "ssm.step"],
                             ["model.layer", "ssm.step"]), chain


def test_ssm_steps_count_the_chunk_and_the_decode(ssm_model, ssm_recorded):
    arch, _ = ssm_model
    chains, _ = ssm_recorded
    steps = sum(c[-1] == "ssm.step" for c, _ in chains)
    recurrences = sum(c[-1] == "ssm.recurrence" for c, _ in chains)
    # every step of the chunk runs for every layer, the padded ones too;
    # a decode runs one a layer, outside any loop
    assert steps == (SSM_CHUNK + 1) * arch.n_layers
    assert recurrences == arch.n_layers


def test_ssm_logits_equal_with_and_without_a_profiler(ssm_model,
                                                      ssm_recorded):
    _, traced = ssm_recorded
    plain = _ssm_serve(*ssm_model)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The dispatcher operations a block issues, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_ssm_scopes_add_no_op_without_a_profiler(ssm_model, monkeypatch):
    import contextlib

    from repro_torch.models import ssm

    opened, entered = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with _Ops() as scoped:
        want = _ssm_serve(*ssm_model)

    def bare(name):
        entered.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(ssm, "named_scope", bare)
    with _Ops() as unscoped:
        got = _ssm_serve(*ssm_model)
    assert {"ssm.recurrence", "ssm.step"} <= set(entered)
    assert opened == [] and scoped.ops == unscoped.ops
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_ssm_scopes_keep_the_audit_clean(phase):
    from repro_torch.analysis.op_audit import audit_phase

    res = audit_phase(_ssm_arch(), phase)
    assert res["untagged"] == 0, res["untagged_details"][:3]
    assert res["ledger_mismatches"] == 0, res["ledger_mismatch_details"][:3]
    assert res["calls"] > 0
