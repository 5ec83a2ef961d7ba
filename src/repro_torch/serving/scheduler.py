"""Continuous-batching scheduler over the slot ``Engine``: the port's
counterpart of ``repro.serving.scheduler``, policy for policy.

The engine has the fast serving primitives — bucketed chunked prefill,
fused one-transfer decode, per-slot EOS freeing — but no brain above
them: callers hand-place requests into slots and ``add_request`` raises
when they are full. This module is that brain: a vLLM-style scheduler
with a FIFO request queue (or shortest-prompt-first admission with an
anti-starvation age bound — ``SchedulerConfig.admission``), admission
control, chunked prefill *interleaved* into decode iterations under a
per-step token budget, and per-request TTFT/TPOT/pJ-per-token
accounting. When the engine carries a prefix cache
(``serving.prefix_cache``) admission adopts cached prefixes
transparently: the prefill budget is charged only for suffix tokens
actually dispatched, preemption recompute-resume becomes a (mostly)
cache hit, and ``metrics()`` reports hit rate,
``prefill_tokens_saved`` and ``recompute_tokens_saved`` beside the
cache counters. Traffic drivers: ``run_open_loop`` (Poisson offered
load) and ``run_closed_loop`` (fixed client concurrency).

Per-request knobs enter through ``SamplingParams``
(``submit(prompt, params=...)``; legacy ``max_new_tokens``/``eos_id``
kwargs convert under a DeprecationWarning), and every decode iteration
emits a typed ``RequestOutput`` stream that the scheduler consumes
instead of poking the slot->token dict. ``Scheduler(..., spec=
SpecConfig(...))`` swaps the engine's step for
``serving.speculative.SpecDecoder`` iterations (several tokens a lane);
the virtual clock charges draft, verify and repair dispatches one unit
each.

Sampling keys are ``serving.sampling`` keys (Python ints): ``step(key)``
splits one for the prefills and one for the decode, and folds each
request's id into the prefill key, exactly where the reference calls
``jax.random``.

Queue states
------------
::

    WAITING ──admit──▶ PREFILLING ──finish_prefill──▶ RUNNING ──▶ FINISHED
       ▲                    │                            │
       └────── PREEMPTED ◀──┴────────────────────────────┘

* **WAITING**    — queued, no slot. FIFO order (arrival order as
  submitted; re-queued preempted requests go to the *back*).
* **PREFILLING** — slot claimed (``Engine.begin_request``); the prompt
  drains chunk-by-chunk through ``advance_prefill``. The lane is not in
  the decode batch yet, so mid-prefill requests cost decode lanes
  nothing.
* **RUNNING**    — prefill finished (``finish_prefill`` sampled the first
  output token — that instant is the request's TTFT); the lane decodes
  one token per engine step.
* **PREEMPTED**  — evicted under overload (see below); resumes by
  *recompute*: its prompt-so-far (original prompt + generated tokens)
  re-prefills when re-admitted, which reconstructs the evicted cache
  exactly, so a preempted greedy request's token stream is identical to
  an uninterrupted run.
* **FINISHED**   — terminal. ``finish_reason`` is one of ``"eos"``
  (engine-reported EOS), ``"length"`` (scheduler-side ``max_new_tokens``
  stop, or a resume that can no longer fit the context), ``"ctx"``
  (engine context exhaustion at ``max_ctx``), or ``"rejected"``
  (admission control: the prompt can never fit ``max_ctx``).

Prefill token budget
--------------------
``SchedulerConfig.prefill_token_budget`` caps how many *prompt* tokens
may be prefilled per scheduler step, spent FIFO across PREFILLING
requests. Each spend is one bucketed chunk dispatch of at most
``min(budget_left, remaining, prefill_bucket_max)`` tokens — a
budget-truncated chunk pads up to the next power-of-two bucket, so
interleaving uses only the buckets the blocking path uses. A bounded budget keeps running lanes'
inter-token latency (TPOT) bounded: every scheduler step runs at most
``budget`` prompt tokens of prefill before the decode dispatch. Budget
``None`` prefills each admitted prompt to completion at admission — with
that setting and a never-overflowing arrival schedule the scheduler is
dispatch-for-dispatch identical to hand-placed
``add_request``/``step`` calls (tests/test_torch_scheduler.py).

Preemption policy
-----------------
Slots are fixed-size dense caches, so there is no mid-decode memory
overflow to react to; preemption here is queue-overload anti-starvation,
off by default. With ``preempt_age`` set, when the queue head has waited
longer than ``preempt_age`` (policy-clock units) and no slot is free,
the scheduler evicts the most recently admitted in-flight request (LIFO,
at most one per step, ``Engine.release_slot``) and re-queues it at the
back in recompute mode. The freed slot admits the starved head on the
same step.

Goodput
-------
``Scheduler.metrics(slo_ttft=...)`` defines goodput the way the serving
literature does: **completed tokens per unit time counting only requests
that met the latency SLO** (here: policy-clock TTFT ≤ ``slo_ttft``;
rejected requests never count). Tokens-per-policy-step
(``goodput_tok_per_step``) is deterministic under the virtual
``StepClock``, so it can be held exactly, while ``goodput_tok_s`` uses
wall time.

Clocks: every event is stamped twice — with the injectable policy
``clock`` (a virtual ``StepClock`` in tests: deterministic scheduling
and SLO accounting) and with ``time.perf_counter()`` wall time (latency
metrics in ms, machine-dependent). Real deployments pass a wall clock as
the policy clock and the two coincide.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.scopes import named_scope
from repro_torch.serving import sampling
from repro_torch.serving.engine import Engine
from repro_torch.serving.params import SamplingParams

__all__ = [
    "WAITING", "PREFILLING", "RUNNING", "PREEMPTED", "FINISHED",
    "Request", "SchedulerConfig", "Scheduler", "StaticBatchScheduler",
    "StepClock", "TrafficRequest", "synth_traffic",
    "synth_shared_prefix_traffic", "run_open_loop", "run_closed_loop",
]

# request states (plain strings: they go straight into JSON reports)
WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One queued generation request plus its measured lifecycle.

    ``t_*`` timestamps are policy-clock (virtual steps under a StepClock),
    ``wall_*`` are ``time.perf_counter()`` seconds; ``generated`` holds
    every emitted token including the prefill-sampled first one, across
    preemptions."""
    rid: int
    prompt: List[int]
    max_new_tokens: Optional[int] = None
    arrival: float = 0.0
    eos_id: Optional[int] = None
    # the request's full SamplingParams (the canonical knob record;
    # max_new_tokens/eos_id above mirror it for compatibility)
    params: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    state: str = WAITING
    slot: Optional[int] = None
    finish_reason: Optional[str] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # resume prompt after preemption (original prompt + generated so far)
    resume_prompt: Optional[List[int]] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    wall_arrival: Optional[float] = None
    wall_admit: Optional[float] = None
    wall_first: Optional[float] = None
    wall_finish: Optional[float] = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.arrival

    @property
    def ttft_wall(self) -> Optional[float]:
        if self.wall_first is None or self.wall_arrival is None:
            return None
        return self.wall_first - self.wall_arrival

    @property
    def tpot_wall(self) -> Optional[float]:
        """Wall seconds per output token after the first (None until
        finished or with a single token)."""
        if self.wall_finish is None or self.wall_first is None:
            return None
        if self.n_generated <= 1:
            return None
        return (self.wall_finish - self.wall_first) / (self.n_generated - 1)


@dataclasses.dataclass
class SchedulerConfig:
    # max prompt tokens prefilled per scheduler step (None = unbounded:
    # every admitted prompt prefills to completion at admission, i.e. the
    # blocking add_request behavior)
    prefill_token_budget: Optional[int] = 128
    # anti-starvation preemption (None = never preempt): when the queue
    # head has waited > preempt_age policy units and no slot is free,
    # evict the most recently admitted in-flight request (recompute)
    preempt_age: Optional[float] = None
    # admission ordering over the WAITING queue: "fifo" (arrival order,
    # the default) or "shortest_prompt" (admit the shortest effective
    # prompt first — lowest time-to-slot-free, the classic SJF latency
    # win; ties break FIFO)
    admission: str = "fifo"
    # anti-starvation bound for non-FIFO admission: once the queue head
    # has waited > this many policy units it is admitted first
    # regardless of ordering (None = pure policy, head can starve under
    # a stream of short prompts)
    admission_age_bound: Optional[float] = None


class Scheduler:
    """FIFO continuous-batching scheduler over one ``Engine``.

    Drive it with ``submit`` + repeated ``step`` (or ``run_open_loop``
    for a pre-generated arrival trace). Requires the engine's bucketed
    prefill mode — the token-mode oracle has no chunk seam to interleave
    through."""

    def __init__(self, engine: Engine, cfg: SchedulerConfig = None, *,
                 clock: Callable[[], float] = time.perf_counter,
                 spec=None):
        if engine.cfg.prefill_mode != "bucketed":
            raise ValueError(
                "scheduler requires prefill_mode='bucketed' (the token "
                "oracle has no chunk seam to interleave through)")
        # speculative decode: a SpecConfig (or a SpecDecoder over this
        # engine) replaces the engine's step
        self._spec = None
        if spec is not None:
            from repro_torch.serving.speculative import (SpecConfig,
                                                         SpecDecoder)
            if isinstance(spec, SpecDecoder):
                if spec.engine is not engine:
                    raise ValueError(
                        "SpecDecoder is bound to a different engine")
                self._spec = spec
            elif isinstance(spec, SpecConfig):
                self._spec = SpecDecoder(engine, spec)
            else:
                raise ValueError(
                    f"spec must be a SpecConfig or SpecDecoder, got "
                    f"{spec!r}")
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        if self.cfg.admission not in ("fifo", "shortest_prompt"):
            raise ValueError(
                f"unknown admission policy {self.cfg.admission!r} "
                "(choices: 'fifo', 'shortest_prompt')")
        self.clock = clock
        self.waiting: Deque[Request] = deque()
        self.prefilling: List[Request] = []     # admission order
        self.running: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        self.requests: List[Request] = []
        self._next_rid = 0
        self._last_result = None
        self.stats = {"steps": 0, "decode_steps": 0, "admitted": 0,
                      "preempted": 0, "rejected": 0,
                      "queue_depth_max": 0, "queue_depth_sum": 0,
                      "admission_reorders": 0,
                      "recompute_tokens_saved": 0}

    # ------------------------------------------------------------ intake
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               arrival: Optional[float] = None, *,
               params: Optional[SamplingParams] = None) -> Request:
        """Queue a request (state WAITING). Per-request knobs arrive as a
        ``SamplingParams`` (``params=``) — its ``max_tokens`` / ``eos_id``
        / ``temperature`` / ``seed`` / ``spec_k`` are threaded to the
        engine at admission. The legacy ``max_new_tokens``/``eos_id``
        kwargs are accepted for one release under a DeprecationWarning
        and convert to the equivalent params bit-identically. ``arrival``
        defaults to the policy clock's now; open-loop traffic passes the
        trace's arrival time so queueing delay is measured against the
        *offered* load."""
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if params is not None:
            if max_new_tokens is not None or eos_id is not None:
                raise ValueError(
                    "pass params= or the legacy max_new_tokens/eos_id "
                    "kwargs, not both")
        else:
            if max_new_tokens is not None or eos_id is not None:
                warnings.warn(
                    "Scheduler.submit(max_new_tokens=..., eos_id=...) is "
                    "deprecated; pass params=SamplingParams(max_tokens="
                    "..., eos_id=...)", DeprecationWarning, stacklevel=2)
            params = SamplingParams(max_tokens=max_new_tokens,
                                    eos_id=eos_id)
        r = Request(rid=self._next_rid, prompt=list(prompt),
                    max_new_tokens=params.max_tokens, eos_id=params.eos_id,
                    params=params,
                    arrival=self.clock() if arrival is None else arrival,
                    wall_arrival=time.perf_counter())
        self._next_rid += 1
        self.requests.append(r)
        self.waiting.append(r)
        return r

    def idle(self) -> bool:
        return not (self.waiting or self.prefilling or self.running)

    @property
    def pj_per_token(self) -> Optional[float]:
        """Decode-phase CIM pJ per generated token, threaded from the
        last ``StepResult.pj_per_token`` (lazily priced; None before the
        first decode step or when the arch serves without the CIM path)."""
        if self._last_result is None:
            return None
        return self._last_result.pj_per_token

    # ----------------------------------------------------------- lifecycle
    def _finish(self, r: Request, reason: str, now: float,
                wall: float) -> None:
        r.state = FINISHED
        r.finish_reason = reason
        r.t_finish = now
        r.wall_finish = wall
        r.slot = None
        self.finished.append(r)

    def _admissible(self) -> int:
        """Slots this step's admission phase may claim (the hook the
        static-batching baseline overrides)."""
        return self.engine.free_slots()

    @staticmethod
    def _effective_prompt(r: Request) -> List[int]:
        return r.resume_prompt if r.resume_prompt is not None else r.prompt

    def _next_waiting(self, now: float) -> int:
        """Queue index of the next request to admit. FIFO by default;
        ``admission="shortest_prompt"`` picks the shortest effective
        prompt (ties break FIFO) — unless the queue head has aged past
        ``admission_age_bound``, in which case the head goes first
        (anti-starvation)."""
        if self.cfg.admission == "fifo" or len(self.waiting) <= 1:
            return 0
        bound = self.cfg.admission_age_bound
        if bound is not None and (now - self.waiting[0].arrival) > bound:
            return 0
        return min(range(len(self.waiting)),
                   key=lambda i: (len(self._effective_prompt(
                       self.waiting[i])), i))

    def _admit(self, now: float, wall: float) -> List[Request]:
        admitted = []
        budget = self._admissible()
        while self.waiting and budget > 0:
            idx = self._next_waiting(now)
            if idx != 0:
                self.stats["admission_reorders"] += 1
            r = self.waiting[idx]
            prompt = self._effective_prompt(r)
            if len(prompt) >= self.engine.cfg.max_ctx:
                del self.waiting[idx]
                if r.resume_prompt is not None:
                    # a resume that no longer fits: keep what it generated
                    self._finish(r, "length", now, wall)
                else:
                    self.stats["rejected"] += 1
                    self._finish(r, "rejected", now, wall)
                continue
            del self.waiting[idx]
            p = r.params
            if r.resume_prompt is not None and p.max_tokens is not None:
                # recompute resume: tokens generated before eviction are
                # part of the resume prompt, so the engine-side cap must
                # count only what is still owed
                p = p.replace(max_tokens=max(1, p.max_tokens
                                             - r.n_generated))
            r.slot = self.engine.begin_request(prompt, params=p)
            if r.resume_prompt is not None:
                # preemption recompute that the prefix cache absorbed:
                # the evicted lane's own boundary snapshots make the
                # re-prefill a (mostly) cache hit
                self.stats["recompute_tokens_saved"] += \
                    self.engine.adopted_prefix(r.slot)
            r.state = PREFILLING
            r.t_admit = now
            r.wall_admit = wall
            self.prefilling.append(r)
            self.stats["admitted"] += 1
            admitted.append(r)
            budget -= 1
        return admitted

    def _spend_prefill_budget(self, now: float,
                              key: Optional[int]) -> int:
        budget = self.cfg.prefill_token_budget
        spent = 0
        for r in list(self.prefilling):
            while self.engine.prefill_remaining(r.slot):
                left = None if budget is None else budget - spent
                if left is not None and left <= 0:
                    return spent
                got = self.engine.advance_prefill(r.slot, max_tokens=left)
                spent += got
            # prompt drained: first output token now, TTFT stamps here
            sub = None if key is None else sampling.fold_in(key, r.rid)
            first = self.engine.finish_prefill(r.slot, key=sub)
            self.prefilling.remove(r)
            r.generated.append(first)
            r.t_first = now
            r.wall_first = time.perf_counter()
            if not self.engine.active[r.slot]:
                # engine finished it at prefill time (first token was the
                # EOS, or a one-token max_tokens cap) and freed the slot
                self._finish(r, self.engine.finish_reason(r.slot) or "eos",
                             now, r.wall_first)
            elif (r.max_new_tokens is not None
                  and r.n_generated >= r.max_new_tokens):
                # legacy fallback; params-carrying requests are capped
                # inside the engine and never reach this branch
                self.engine.release_slot(r.slot)
                self._finish(r, "length", now, r.wall_first)
            else:
                r.state = RUNNING
                self.running[r.slot] = r
        return spent

    def _decode(self, now: float, key: Optional[int]) -> dict:
        result = (self._spec.step(key) if self._spec is not None
                  else self.engine.step(key))
        self._last_result = result
        self.stats["decode_steps"] += 1
        wall = time.perf_counter()
        # the typed RequestOutput stream carries every token this
        # iteration emitted
        for out in result.outputs:
            r = self.running.get(out.slot)
            if r is not None:
                r.generated.extend(out.tokens)
        for slot in result.finished:
            # engine-side completion: EOS, max_tokens, or context
            # exhaustion — the engine records which. Slots with no bound
            # request (e.g. freed at prefill time and already accounted)
            # are skipped.
            r = self.running.pop(slot, None)
            if r is None:
                continue
            reason = self.engine.finish_reason(slot)
            if reason is None:
                eos = (r.eos_id if r.eos_id is not None
                       else self.engine.cfg.eos_id)
                reason = "eos" if (eos is not None and r.generated
                                   and r.generated[-1] == eos) else "ctx"
            self._finish(r, reason, now, wall)
        for slot, r in list(self.running.items()):
            # legacy fallback; params-carrying requests are capped inside
            # the engine and surface through result.finished above
            if (r.max_new_tokens is not None
                    and r.n_generated >= r.max_new_tokens):
                self.engine.release_slot(slot)
                del self.running[slot]
                self._finish(r, "length", now, wall)
        return dict(result)

    def _maybe_preempt(self, now: float) -> Optional[Request]:
        age = self.cfg.preempt_age
        if age is None or not self.waiting:
            return None
        if self.engine.free_slots() > 0:
            return None
        if (now - self.waiting[0].arrival) <= age:
            return None
        live = self.prefilling + list(self.running.values())
        if not live:
            return None
        victim = max(live, key=lambda r: r.t_admit)   # LIFO: newest admit
        self.engine.release_slot(victim.slot)
        if victim in self.prefilling:
            self.prefilling.remove(victim)
        else:
            del self.running[victim.slot]
        victim.state = PREEMPTED
        victim.slot = None
        victim.preemptions += 1
        # recompute resume: re-prefill everything emitted so far, which
        # reconstructs the evicted cache exactly (greedy streams are
        # preemption-invariant — tested)
        victim.resume_prompt = list(victim.prompt) + list(victim.generated)
        self.waiting.append(victim)   # back of the queue: FIFO fairness
        self.stats["preempted"] += 1
        return victim

    # ------------------------------------------------------------- step
    def step(self, key: Optional[int] = None) -> dict:
        """One scheduler iteration: preempt (if starving) → admit →
        budgeted prefill → one decode dispatch for the running lanes.
        Returns a summary dict (admitted/prefilled/decoded/finished
        counts) for observability; request objects carry the full
        accounting. Pass ``key`` to sample (split per use; greedy
        otherwise)."""
        with named_scope("sched.step"):
            now = self.clock()
            wall = time.perf_counter()
            self.stats["steps"] += 1
            depth = len(self.waiting)
            self.stats["queue_depth_max"] = max(
                self.stats["queue_depth_max"], depth)
            self.stats["queue_depth_sum"] += depth

            with named_scope("sched.preempt"):
                self._maybe_preempt(now)
            k_fill = k_dec = None
            if key is not None:
                k_fill, k_dec = sampling.split(key)
            with named_scope("sched.admit"):
                admitted = self._admit(now, wall)
            n_before = len(self.finished)
            with named_scope("sched.prefill"):
                spent = self._spend_prefill_budget(now, k_fill)
            decoded = {}
            if self.running:
                with named_scope("sched.decode"):
                    decoded = self._decode(now, k_dec)
            return {
                "admitted": [r.rid for r in admitted],
                "prefill_tokens": spent,
                "decoded": decoded,
                "finished": [r.rid for r in self.finished[n_before:]],
                "queue_depth": depth,
            }

    # ----------------------------------------------------------- metrics
    def metrics(self, slo_ttft: Optional[float] = None) -> dict:
        """Aggregate serving metrics over finished requests.

        ``slo_ttft`` is a policy-clock TTFT bound; requests over it (or
        rejected) are excluded from goodput. Latency percentiles are
        reported in wall ms (machine-dependent) and policy units
        (deterministic under ``StepClock``)."""
        done = [r for r in self.finished if r.finish_reason != "rejected"]
        ttft_w = [r.ttft_wall for r in done if r.ttft_wall is not None]
        tpot_w = [r.tpot_wall for r in done if r.tpot_wall is not None]
        ttft_p = [r.ttft for r in done if r.ttft is not None]
        in_slo = [r for r in done
                  if slo_ttft is None
                  or (r.ttft is not None and r.ttft <= slo_ttft)]
        good_tokens = sum(r.n_generated for r in in_slo)
        t0 = min((r.arrival for r in self.requests), default=0.0)
        t1 = max((r.t_finish for r in done), default=t0)
        w0 = min((r.wall_arrival for r in self.requests), default=0.0)
        w1 = max((r.wall_finish for r in done), default=w0)
        makespan = max(t1 - t0, 1e-12)
        wall_s = max(w1 - w0, 1e-12)

        def pct(xs, q, scale=1.0):
            return float(np.percentile(xs, q) * scale) if xs else None

        pj = self.pj_per_token
        out = {
            "completed": len(done),
            "completed_in_slo": len(in_slo),
            "rejected": self.stats["rejected"],
            "preempted": self.stats["preempted"],
            "sched_steps": self.stats["steps"],
            "decode_steps": self.stats["decode_steps"],
            "prefill_dispatches": self.engine.stats["prefill_dispatches"],
            "queue_depth_max": self.stats["queue_depth_max"],
            "queue_depth_mean": (self.stats["queue_depth_sum"]
                                 / max(1, self.stats["steps"])),
            "generated_tokens": sum(r.n_generated for r in done),
            "goodput_tokens": good_tokens,
            "makespan_steps": makespan,
            "goodput_tok_per_step": good_tokens / makespan,
            "wall_s": wall_s,
            "goodput_tok_s": good_tokens / wall_s,
            "ttft_p50_ms": pct(ttft_w, 50, 1e3),
            "ttft_p99_ms": pct(ttft_w, 99, 1e3),
            "tpot_p50_ms": pct(tpot_w, 50, 1e3),
            "tpot_p99_ms": pct(tpot_w, 99, 1e3),
            "ttft_p50_steps": pct(ttft_p, 50),
            "ttft_p99_steps": pct(ttft_p, 99),
            "pj_per_token": pj,
            "energy_pj": (None if pj is None
                          else pj * sum(r.n_generated for r in done)),
            # prefill work actually dispatched vs absorbed by the prefix
            # cache (saved = adopted tokens; both exact under StepClock)
            "prefill_tokens_dispatched": self.engine.stats["prefill_tokens"],
            "prefill_tokens_saved": self.engine.stats["prefix_hit_tokens"],
            "recompute_tokens_saved": self.stats["recompute_tokens_saved"],
            "admission_reorders": self.stats["admission_reorders"],
            # speculative-decode counters (all 0 without spec=): exact
            # under StepClock, like the other leaves
            "draft_dispatches": self.engine.stats["draft_dispatches"],
            "verify_dispatches": self.engine.stats["verify_dispatches"],
            "repair_dispatches": self.engine.stats["repair_dispatches"],
            "spec_steps": self.engine.stats["spec_steps"],
            "spec_tokens": self.engine.stats["spec_tokens"],
            "accepted_tokens_per_step": (
                self.engine.stats["spec_tokens"]
                / max(1, self.engine.stats["spec_steps"])),
        }
        pc = self.engine.prefix_cache
        if pc is not None:
            out.update({
                "prefix_hits": pc.stats["hits"],
                "prefix_misses": pc.stats["misses"],
                "prefix_inserts": pc.stats["inserts"],
                "prefix_evictions": pc.stats["evictions"],
                "prefix_bytes": pc.stats["bytes"],
                "prefix_hit_rate": pc.hit_rate(),
            })
        return out


class StaticBatchScheduler(Scheduler):
    """The naive blocking-admission baseline: admission waits for the
    WHOLE previous batch to drain (classic static batching — the
    pre-continuous-batching world), and every admitted prompt prefills
    to completion before any decode resumes. Same engine, same
    dispatches per request; freed slots simply idle while stragglers
    finish: the baseline continuous batching is measured against."""

    def __init__(self, engine: Engine, cfg: SchedulerConfig = None, *,
                 clock: Callable[[], float] = time.perf_counter,
                 spec=None):
        cfg = dataclasses.replace(cfg or SchedulerConfig(),
                                  prefill_token_budget=None,
                                  preempt_age=None)
        super().__init__(engine, cfg, clock=clock, spec=spec)

    def _admissible(self) -> int:
        if self.running or self.prefilling:
            return 0
        return self.engine.free_slots()


class StepClock:
    """Virtual policy clock in *dispatch-cost* units. ``run_open_loop``
    ticks it by the number of dispatches the scheduler step
    issued (each decode step and each prefill chunk = 1 unit; an idle
    wait between arrivals = 1 unit), so virtual time charges a blocking
    prefill burst what it actually costs the device instead of hiding it
    inside one "step". Under it every scheduling decision — admission
    order, chunk slicing, dispatch and completion counts — is a pure
    function of the (seeded) traffic, so the counts can be held equal
    across machines and devices while wall-clock latency is measured
    alongside."""

    def __init__(self, dt: float = 1.0):
        self.t = 0.0
        self.dt = dt

    def now(self) -> float:
        return self.t

    def tick(self, dt: Optional[float] = None) -> None:
        self.t += self.dt if dt is None else dt * self.dt


def _dispatch_count(eng: Engine) -> int:
    """Total dispatches the engine has issued — the virtual clock's cost
    unit. Speculative draft/verify/repair dispatches cost a clock unit
    each, like a decode step or a prefill chunk."""
    s = eng.stats
    return (s["prefill_dispatches"] + s["decode_steps"]
            + s["draft_dispatches"] + s["verify_dispatches"]
            + s["repair_dispatches"])


@dataclasses.dataclass
class TrafficRequest:
    arrival: float
    prompt: List[int]
    max_new_tokens: int


def synth_traffic(n: int, rate: float, *, seed: int, vocab_size: int,
                  prompt_len=(8, 48), out_len=(4, 16)) -> List[TrafficRequest]:
    """Seeded open-loop Poisson traffic: exponential inter-arrivals at
    ``rate`` requests per policy-time unit, uniform prompt/output length
    distributions (inclusive bounds), uniform random token ids.

    The arrival *pattern* is rate-invariant: unit-rate gaps are drawn
    first and scaled by ``1/rate``, so sweeping ``rate`` offers the same
    request sequence faster or slower — goodput curves across rates are
    then directly comparable."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0, size=n)) / rate
    plens = rng.randint(prompt_len[0], prompt_len[1] + 1, size=n)
    olens = rng.randint(out_len[0], out_len[1] + 1, size=n)
    return [
        TrafficRequest(
            arrival=float(arrivals[i]),
            prompt=[int(t) for t in
                    rng.randint(1, vocab_size, size=int(plens[i]))],
            max_new_tokens=int(olens[i]))
        for i in range(n)
    ]


def synth_shared_prefix_traffic(
        n: int, rate: float, *, seed: int, vocab_size: int,
        n_prefixes: int = 4, prefix_len: int = 24, zipf_s: float = 1.1,
        user_len=(4, 16), out_len=(4, 16)) -> List[TrafficRequest]:
    """Seeded Poisson traffic whose prompts share system prompts: each
    request draws one of ``n_prefixes`` fixed ``prefix_len``-token
    system prompts with Zipf(``zipf_s``) rank probabilities (a few
    prompts dominate, like production templates do) and appends a unique
    uniform-random user suffix. Arrival gaps are rate-invariant exactly
    as in ``synth_traffic``. Keep ``prefix_len`` a multiple of the
    engine's ``prefill_bucket_min`` so the shared part is a cacheable
    chunk boundary."""
    rng = np.random.RandomState(seed)
    pool = [[int(t) for t in rng.randint(1, vocab_size, size=prefix_len)]
            for _ in range(n_prefixes)]
    probs = 1.0 / np.arange(1, n_prefixes + 1) ** zipf_s
    probs /= probs.sum()
    arrivals = np.cumsum(rng.exponential(1.0, size=n)) / rate
    picks = rng.choice(n_prefixes, size=n, p=probs)
    ulens = rng.randint(user_len[0], user_len[1] + 1, size=n)
    olens = rng.randint(out_len[0], out_len[1] + 1, size=n)
    return [
        TrafficRequest(
            arrival=float(arrivals[i]),
            prompt=pool[int(picks[i])] + [
                int(t) for t in rng.randint(1, vocab_size,
                                            size=int(ulens[i]))],
            max_new_tokens=int(olens[i]))
        for i in range(n)
    ]


def run_open_loop(sched: Scheduler, traffic: Sequence[TrafficRequest], *,
                  tick: Optional[Callable[[float], None]] = None,
                  max_steps: int = 200_000,
                  key: Optional[int] = None) -> int:
    """Drive ``sched`` through an open-loop arrival trace until every
    request finishes: release arrivals whose time has come, step, tick
    the virtual clock (or sleep briefly on a wall clock while idle).

    ``tick`` (typically ``StepClock.tick``) receives the step's
    dispatch cost — the number of dispatches (prefill chunks +
    decode) the step issued, minimum 1 — so virtual time is charged per
    unit of device work, not per scheduler iteration; an idle wait
    between arrivals costs 1. Returns the number of scheduler steps
    taken."""
    i, steps = 0, 0
    while True:
        now = sched.clock()
        while i < len(traffic) and traffic[i].arrival <= now:
            t = traffic[i]
            sched.submit(t.prompt, arrival=t.arrival,
                         params=SamplingParams(
                             max_tokens=t.max_new_tokens))
            i += 1
        if i >= len(traffic) and sched.idle():
            return steps
        if sched.idle():
            # between arrivals: advance time without burning dispatches
            if tick is not None:
                tick(1.0)
            else:
                time.sleep(1e-4)
            continue
        key, sub = ((None, None) if key is None
                    else sampling.split(key))
        before = _dispatch_count(sched.engine)
        sched.step(sub)
        after = _dispatch_count(sched.engine)
        steps += 1
        if tick is not None:
            tick(max(1.0, float(after - before)))
        if steps >= max_steps:
            raise RuntimeError(
                f"open-loop run exceeded {max_steps} steps with "
                f"{len(sched.waiting)} waiting / {len(sched.running)} "
                "running — traffic does not drain")


def run_closed_loop(sched: Scheduler, traffic: Sequence[TrafficRequest], *,
                    concurrency: int,
                    tick: Optional[Callable[[float], None]] = None,
                    max_steps: int = 200_000,
                    key: Optional[int] = None) -> int:
    """Drive ``sched`` closed-loop at fixed concurrency: keep exactly
    ``concurrency`` requests in flight (submitted minus finished),
    topping up from ``traffic`` (arrival times ignored — each request
    "arrives" the moment a virtual client submits it) the instant one
    completes, until the trace is exhausted and drained. The classic
    benchmark-client model, complementary to ``run_open_loop``'s
    offered-load one: latency here measures the service at a fixed
    population instead of under a fixed arrival rate. Ticks the clock
    per dispatch exactly like the open-loop driver; returns the number
    of scheduler steps taken."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    i, steps = 0, 0
    while True:
        while i < len(traffic) and (i - len(sched.finished)) < concurrency:
            t = traffic[i]
            sched.submit(t.prompt, params=SamplingParams(
                max_tokens=t.max_new_tokens))
            i += 1
        if i >= len(traffic) and sched.idle():
            return steps
        key, sub = ((None, None) if key is None
                    else sampling.split(key))
        before = _dispatch_count(sched.engine)
        sched.step(sub)
        after = _dispatch_count(sched.engine)
        steps += 1
        if tick is not None:
            tick(max(1.0, float(after - before)))
        if steps >= max_steps:
            raise RuntimeError(
                f"closed-loop run exceeded {max_steps} steps with "
                f"{len(sched.waiting)} waiting / {len(sched.running)} "
                "running — traffic does not drain")
