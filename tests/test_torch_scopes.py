"""The port's scopes (``core.scopes``) on the profiler's clock: with no
profiler recording, a scope is the stack's push and pop and nothing else;
under ``torch.profiler`` every layer boundary is a user annotation,
nested as the layers call each other (CPU, ``paper-cim-120m.reduced()``:
a scheduler run with two prefill chunks and decode steps, one train step
under remat). ``cim.pack``, the per-call packing of the card's route, is
held on the card (``tests/test_torch_gpu.py``)."""
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
