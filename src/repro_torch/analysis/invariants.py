"""Hot-path invariant checks for the serving engine; the port's counterpart
of ``repro.analysis.invariants``.

Two properties must never regress silently:

1. **Dispatch budget** — the counterpart of the reference's compile budget
   (the port compiles nothing). ``InstrumentedEngine`` interposes on the
   engine's dispatch seam (``Engine._dispatch``) and records each
   dispatch's *signature*: the GR-MAC calls (kernel launches and plain
   version calls) and the aten operations it issued, counted by a
   ``TorchDispatchMode``. Every dispatch of a key (``decode[sample=…]``,
   ``prefill[bucket=…]``, ``verify[bucket=…]``, ``draft[…]``, the
   reference's keys) must have the same signature: shape drift, a branch
   on data, or an operation that a step adds would show up as a second
   signature of one key, as a retrace does in the reference. The "self"
   drafter must dispatch under the decode key, and a greedy verify or
   repair chunk must use a bucket that admission prefill already used.
2. **One device→host transfer per decode step** — the host sees exactly
   one ``(batch_slots,)`` int32 fetch per ``step`` (and per first-token
   selection), through ``Engine._fetch``. On the card the mode also counts
   every real crossing in the engine's entry points (a copy from a CUDA
   tensor to the CPU, ``_local_scalar_dense``, ``nonzero``, ``equal`` or
   ``is_nonzero`` on a CUDA tensor) and that count must equal the fetches:
   stronger than the reference, which cannot see transfers on its CPU
   backend. Host→device copies of the per-step host state
   (``Engine._snapshot``) are not fetches and are not counted.

``run_invariants`` drives a deterministic serve script over reduced
configs of the three cache families (attention KV, RG-LRU, SSM);
``run_scheduler_invariants`` the same properties through the
continuous-batching layer (prefill chunks interleaved with decode steps);
``run_prefix_invariants`` under a hit-heavy prefix-cache trace;
``run_spec_invariants`` under speculative decode (self-draft scheduler
traffic, an always-wrong drafter that forces rollback and repair, and a
sampled verify). The scripts, traffic and fetch arithmetic are the
reference's. Weights are drawn on the CPU (``init_params`` with seed 0)
and moved to ``device``, or passed in (``params``: config name → tree).
``mode`` sets the configs' CIM mode (None: their own, off for these
three; ``"grmac"`` sends every projection through the GR-MAC kernel on
the card).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.serving.engine import Engine, ServeConfig

__all__ = ["InvariantViolation", "InstrumentedEngine", "run_invariants",
           "run_scheduler_invariants", "run_prefix_invariants",
           "run_spec_invariants", "INVARIANT_CONFIGS"]

# Reduced configs of the three cache families (attention KV, RG-LRU
# recurrent, SSM state), the reference's subset.
INVARIANT_CONFIGS = ("qwen2-1.5b", "recurrentgemma-9b", "mamba2-1.3b")

_aten = torch.ops.aten
_SYNCS = frozenset({_aten._local_scalar_dense.default,
                    _aten.nonzero.default, _aten.equal.default,
                    _aten.is_nonzero.default})


class InvariantViolation(AssertionError):
    """A machine-checked hot-path invariant was breached."""


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


class _Counter(TorchDispatchMode):
    """Counts aten operations and device→host crossings."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.d2h = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func is _aten._to_copy.default:
            dev = kwargs.get("device")
            if _on_card(args[0]) and dev is not None \
                    and torch.device(dev).type == "cpu":
                self.d2h += 1
        elif func is _aten.copy_.default:
            if _on_card(args[1]) and not _on_card(args[0]):
                self.d2h += 1
        elif func in _SYNCS and _on_card(args[0]):
            self.d2h += 1
        return func(*args, **kwargs)


def _grmac_calls() -> int:
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.kernels.ref import grmac_matmul_ref
    return grmac_matmul_cuda.launches + grmac_matmul_ref.calls


# The engine's entry points the counting mode spans (the scheduler and the
# speculative decoder reach the engine only through them).
_ENTRIES = ("add_request", "begin_request", "advance_prefill",
            "finish_prefill", "release_slot", "draft_step", "verify_chunk",
            "verify_chunk_sampled", "repair_chunk", "spec_snapshot",
            "spec_restore")


class InstrumentedEngine(Engine):
    """Engine with dispatch and transfer counters on its seams.

    ``traces`` counts the dispatches of each key, ``signatures`` holds the
    distinct (GR-MAC calls, aten operations) signatures each key showed,
    ``fetches`` the ``_fetch`` calls and ``d2h`` the device→host crossings
    inside the engine's entry points (on the card; 0 on the CPU, where no
    crossing exists).
    """

    def __init__(self, *args, **kwargs):
        self.traces: Dict[str, int] = {}
        self.signatures: Dict[str, set] = {}
        self.fetches = 0
        self.d2h = 0
        self.steps_checked = 0
        self._mode: Optional[_Counter] = None
        super().__init__(*args, **kwargs)

    def _counting(self, fn, *args, **kwargs):
        """``fn`` under the counting mode (entered once: nested entry
        points count in the outer one)."""
        if self._mode is not None:
            return fn(*args, **kwargs)
        self._mode = _Counter()
        try:
            with self._mode:
                return fn(*args, **kwargs)
        finally:
            self.d2h += self._mode.d2h
            self._mode = None

    def _dispatch(self, key: str, fn, *args):
        def counted():
            ops, calls = self._mode.ops, _grmac_calls()
            out = fn(*args)
            sig = (_grmac_calls() - calls, self._mode.ops - ops)
            self.traces[key] = self.traces.get(key, 0) + 1
            self.signatures.setdefault(key, set()).add(sig)
            return out
        return self._counting(counted)

    def _require_dispatched_bucket(self, what: str, k: int) -> None:
        key = f"prefill[bucket={self._bucket(k)}]"
        if key not in self.traces:
            raise InvariantViolation(
                f"{what} chunk needed a fresh {key} dispatch: greedy "
                "speculative verification must reuse the buckets admission "
                "prefill already dispatched")

    def verify_chunk(self, chunk: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
        self._require_dispatched_bucket("verify", chunk.shape[1])
        return self._counting(super().verify_chunk, chunk, lens)

    def repair_chunk(self, chunk: np.ndarray, lens: np.ndarray,
                     index: np.ndarray) -> None:
        self._require_dispatched_bucket("repair", chunk.shape[1])
        return self._counting(super().repair_chunk, chunk, lens, index)

    def _fetch(self, ids_dev) -> np.ndarray:  # instance over staticmethod
        self.fetches += 1
        return Engine._fetch(ids_dev)

    def step(self, key: Optional[int] = None):
        before, d2h = self.fetches, self.d2h
        live = bool(self.active.any())
        result = self._counting(super().step, key)
        delta = self.fetches - before
        want = 1 if live else 0
        if delta != want:
            raise InvariantViolation(
                f"decode step performed {delta} device->host transfers "
                f"(expected exactly {want}): every host-visible value must "
                "route through the single Engine._fetch of sampled ids")
        if self.device.type == "cuda" and self.d2h - d2h != delta:
            raise InvariantViolation(
                f"decode step crossed device->host {self.d2h - d2h} times "
                f"for {delta} fetches: a transfer bypassed Engine._fetch")
        self.steps_checked += 1
        return result

    def check(self) -> dict:
        """Assert the dispatch budget and the transfer count; return the
        counter report."""
        drift = {k: sorted(v) for k, v in self.signatures.items()
                 if len(v) > 1}
        if drift:
            raise InvariantViolation(
                f"dispatch signature drifted within a key: {drift} — the "
                "counterpart of a retrace: a dispatch's shapes, its "
                "operations or its GR-MAC calls changed between calls")
        if not self.traces:
            raise InvariantViolation("harness ran nothing: no dispatches")
        if self.device.type == "cuda" and self.d2h != self.fetches:
            raise InvariantViolation(
                f"{self.d2h} device->host crossings for {self.fetches} "
                "fetches: a transfer bypassed Engine._fetch")
        return {
            "traces": dict(sorted(self.traces.items())),
            "signatures": {k: list(next(iter(v)))
                           for k, v in sorted(self.signatures.items())},
            "compiles": sum(len(v) for v in self.signatures.values()),
            "fetches": self.fetches,
            "d2h": self.d2h,
            "steps": self.steps_checked,
        }


def _entry(name):
    base = getattr(Engine, name)

    def counted(self, *args, **kwargs):
        return self._counting(base, self, *args, **kwargs)

    counted.__name__ = name
    counted.__doc__ = base.__doc__
    return counted


for _name in _ENTRIES:
    if _name not in InstrumentedEngine.__dict__:
        setattr(InstrumentedEngine, _name, _entry(_name))


def _params(arch, device, params):
    """Seeded weights drawn on the CPU and moved to ``device``."""
    from repro_torch.models import init_params, to_device
    if params is not None:
        return to_device(params, device)
    return to_device(init_params(arch, 0, device="cpu"), device)


def _reduced(arch_name: str, mode: Optional[str]):
    from repro_torch.configs import get_config
    arch = get_config(arch_name).reduced()
    return arch if mode is None else arch.replace(
        cim=arch.cim.with_mode(mode))


def _drive(arch_name: str, decode_steps: int = 4, *, device=None,
           params=None, mode=None) -> dict:
    """One deterministic serve script: two prompts sharing a bucket, a
    decode burst; the same bucket and decode keys serve all of it with one
    signature each."""
    from repro_torch.core.device import resolve_device
    device = resolve_device(device)
    arch = _reduced(arch_name, mode)
    eng = InstrumentedEngine(arch, _params(arch, device, params),
                             ServeConfig(batch_slots=2, max_ctx=64),
                             device=device)
    eng.add_request([3, 1, 4, 1, 5])         # bucket 8
    eng.add_request([2, 7])                  # same bucket 8
    for _ in range(decode_steps):
        eng.step()
    report = eng.check()
    n_prefill = sum(1 for k in eng.traces if k.startswith("prefill"))
    n_decode = sum(1 for k in eng.traces if k.startswith("decode"))
    if n_prefill != 1 or n_decode != 1:
        raise InvariantViolation(
            f"{arch_name}: expected 1 prefill + 1 decode key, got "
            f"{dict(eng.traces)}")
    # prefill fetches: one first-token selection per add_request
    if eng.fetches != 2 + eng.steps_checked:
        raise InvariantViolation(
            f"{arch_name}: {eng.fetches} fetches for 2 prefills + "
            f"{eng.steps_checked} steps (expected "
            f"{2 + eng.steps_checked})")
    return report


def _run_all(drive, configs, device, params, mode) -> dict:
    out: Dict[str, dict] = {}
    failures: List[str] = []
    for name in configs:
        try:
            out[name] = drive(name, device=device,
                              params=(params or {}).get(name), mode=mode)
        except InvariantViolation as e:   # keep auditing the rest
            out[name] = {"error": str(e)}
            failures.append(name)
    return {"configs": out, "violations": len(failures),
            "failed": failures}


def run_invariants(configs=INVARIANT_CONFIGS, *,
                   device: Optional[Union[str, torch.device]] = None,
                   params: Optional[dict] = None,
                   mode: Optional[str] = None) -> dict:
    """Run the serve script over ``configs`` on ``device`` (None: the
    card); returns the JSON-able counter report. A breach is reported per
    config (``violations``, ``failed``)."""
    return _run_all(_drive, configs, device, params, mode)


def _drive_scheduler(arch_name: str, n_requests: int = 5, *, device=None,
                     params=None, mode=None) -> dict:
    """Seeded scheduler traffic over an instrumented engine: more requests
    than slots, a prefill token budget small enough that prompts drain
    across several decode iterations (a bucket-16 chunk plus a bucket-8
    remainder), completion by ``max_new_tokens`` only."""
    from repro_torch.core.device import resolve_device
    from repro_torch.serving.scheduler import (
        Scheduler, SchedulerConfig, StepClock, run_open_loop, synth_traffic)

    device = resolve_device(device)
    arch = _reduced(arch_name, mode)
    eng = InstrumentedEngine(arch, _params(arch, device, params),
                             ServeConfig(batch_slots=2, max_ctx=64),
                             device=device)
    clock = StepClock()
    sched = Scheduler(eng, SchedulerConfig(prefill_token_budget=10),
                      clock=clock.now)
    traffic = synth_traffic(n_requests, 0.5, seed=0,
                            vocab_size=arch.vocab_size,
                            prompt_len=(3, 14), out_len=(2, 6))
    run_open_loop(sched, traffic, tick=clock.tick)
    report = eng.check()
    n_decode = sum(1 for k in eng.traces if k.startswith("decode"))
    if n_decode != 1:
        raise InvariantViolation(
            f"{arch_name}: scheduler-driven serving used {n_decode} decode "
            f"keys (expected 1): {dict(eng.traces)}")
    done = [r for r in sched.finished if r.finish_reason != "rejected"]
    if len(done) != n_requests:
        raise InvariantViolation(
            f"{arch_name}: {len(done)}/{n_requests} requests completed "
            "under the scheduler")
    want = sched.stats["admitted"] + eng.steps_checked
    if eng.fetches != want:
        raise InvariantViolation(
            f"{arch_name}: {eng.fetches} fetches for "
            f"{sched.stats['admitted']} admissions + {eng.steps_checked} "
            f"decode steps (expected {want})")
    report["completed"] = len(done)
    report["prefill_executables"] = sum(
        1 for k in eng.traces if k.startswith("prefill"))
    return report


def run_scheduler_invariants(configs=INVARIANT_CONFIGS, *, device=None,
                             params=None, mode=None) -> dict:
    """Scheduler-layer invariant run (``_drive_scheduler``); same report
    shape as ``run_invariants``."""
    return _run_all(_drive_scheduler, configs, device, params, mode)


def _drive_prefix(arch_name: str, n_requests: int = 8, *, device=None,
                  params=None, mode=None) -> dict:
    """Hit-heavy prefix-cache trace: shared-prefix traffic with the cache
    on, so most admissions adopt a cached prefix and prefill only
    suffixes. Adoption and insertion stay on the device: the dispatch
    budget and the fetch arithmetic are unchanged."""
    from repro_torch.core.device import resolve_device
    from repro_torch.serving.scheduler import (
        Scheduler, SchedulerConfig, StepClock, run_open_loop,
        synth_shared_prefix_traffic)

    device = resolve_device(device)
    arch = _reduced(arch_name, mode)
    eng = InstrumentedEngine(
        arch, _params(arch, device, params),
        ServeConfig(batch_slots=2, max_ctx=64, prefix_cache_bytes=1 << 24),
        device=device)
    clock = StepClock()
    sched = Scheduler(eng, SchedulerConfig(prefill_token_budget=8),
                      clock=clock.now)
    traffic = synth_shared_prefix_traffic(
        n_requests, 0.5, seed=0, vocab_size=arch.vocab_size,
        n_prefixes=2, prefix_len=16, user_len=(3, 10), out_len=(2, 6))
    run_open_loop(sched, traffic, tick=clock.tick)
    report = eng.check()
    pc = eng.prefix_cache
    if pc.stats["hits"] < 1:
        raise InvariantViolation(
            f"{arch_name}: hit-heavy trace produced no prefix hits "
            f"({pc.stats}): the drive is not exercising the cache")
    done = [r for r in sched.finished if r.finish_reason != "rejected"]
    if len(done) != n_requests:
        raise InvariantViolation(
            f"{arch_name}: {len(done)}/{n_requests} requests completed "
            "under the prefix-cache scheduler")
    want = sched.stats["admitted"] + eng.steps_checked
    if eng.fetches != want:
        raise InvariantViolation(
            f"{arch_name}: {eng.fetches} fetches for "
            f"{sched.stats['admitted']} admissions + {eng.steps_checked} "
            f"decode steps (expected {want}): prefix adoption and "
            "insertion must stay on the device")
    report["completed"] = len(done)
    report["prefix_hits"] = pc.stats["hits"]
    report["prefix_misses"] = pc.stats["misses"]
    report["prefix_inserts"] = pc.stats["inserts"]
    report["prefill_tokens_saved"] = eng.stats["prefix_hit_tokens"]
    return report


def run_prefix_invariants(configs=INVARIANT_CONFIGS, *, device=None,
                          params=None, mode=None) -> dict:
    """Prefix-cache invariant run (``_drive_prefix``); same report shape
    as ``run_invariants``."""
    return _run_all(_drive_prefix, configs, device, params, mode)


def _drive_spec(arch_name: str, n_requests: int = 5, *, device=None,
                params=None, mode=None) -> dict:
    """Three speculative-decode scripts over instrumented engines.

    (a) Scheduler-driven greedy self-speculation over seeded traffic: the
    self drafter dispatches under the decode key, every greedy verify /
    repair chunk uses a bucket admission already dispatched, and the
    transfer ledger closes: one fetch per admission, per sequential step,
    per draft dispatch and per verify dispatch; a repair adds none.

    (b) An always-wrong drafter: every iteration accepts exactly one token
    and, where the cache has rollback-sensitive state (local rings,
    RG-LRU, SSM), restores and repairs; global attention never repairs.

    (c) Sampled verification: one ``verify[bucket]`` key, one signature.
    """
    from repro_torch.core.device import resolve_device
    from repro_torch.serving import sampling
    from repro_torch.serving.params import SamplingParams
    from repro_torch.serving.scheduler import (
        Scheduler, SchedulerConfig, StepClock, run_open_loop, synth_traffic)
    from repro_torch.serving.speculative import SpecConfig, SpecDecoder

    device = resolve_device(device)
    arch = _reduced(arch_name, mode)
    params = _params(arch, device, params)
    serve = ServeConfig(batch_slots=2, max_ctx=64)

    # --- (a) scheduler traffic, greedy self-draft speculation
    eng = InstrumentedEngine(arch, params, serve, device=device)
    clock = StepClock()
    sched = Scheduler(eng, SchedulerConfig(prefill_token_budget=10),
                      clock=clock.now, spec=SpecConfig(k=4, draft="self"))
    traffic = synth_traffic(n_requests, 0.5, seed=0,
                            vocab_size=arch.vocab_size,
                            prompt_len=(3, 14), out_len=(2, 6))
    run_open_loop(sched, traffic, tick=clock.tick)
    report = eng.check()
    st = eng.stats
    if st["spec_steps"] < 1 or st["spec_tokens"] <= st["spec_steps"]:
        raise InvariantViolation(
            f"{arch_name}: spec drive is not speculating (spec_steps="
            f"{st['spec_steps']}, spec_tokens={st['spec_tokens']})")
    extra = [k for k in eng.traces
             if not (k.startswith("decode[") or k.startswith("prefill["))]
    if extra:
        raise InvariantViolation(
            f"{arch_name}: self-draft speculation dispatched keys of its "
            f"own: {extra}; the self drafter must be the decode dispatch "
            "and greedy verify the admission prefill buckets")
    done = [r for r in sched.finished if r.finish_reason != "rejected"]
    if len(done) != n_requests:
        raise InvariantViolation(
            f"{arch_name}: {len(done)}/{n_requests} requests completed "
            "under the speculative scheduler")
    want = (sched.stats["admitted"] + eng.steps_checked
            + st["draft_dispatches"] + st["verify_dispatches"])
    if eng.fetches != want:
        raise InvariantViolation(
            f"{arch_name}: {eng.fetches} fetches for "
            f"{sched.stats['admitted']} admissions + {eng.steps_checked} "
            f"sequential steps + {st['draft_dispatches']} drafts + "
            f"{st['verify_dispatches']} verifies (expected {want}): "
            "repair and restore must cross nothing to the host")
    report["completed"] = len(done)
    for k in ("spec_steps", "spec_tokens", "draft_dispatches",
              "verify_dispatches", "repair_dispatches"):
        report[k] = st[k]

    # --- (b) always-wrong drafter: rollback + fetch-free repair
    eng2 = InstrumentedEngine(arch, params, serve, device=device)
    dec2 = SpecDecoder(eng2, SpecConfig(k=4, draft="self"),
                       draft_fn=lambda cur, t: (cur + 1) % arch.vocab_size)
    s2 = eng2.add_request([3, 1, 4, 1, 5],
                          params=SamplingParams(max_tokens=6))
    while eng2.active[s2]:
        dec2.step()
    eng2.check()
    st2 = eng2.stats
    if st2["spec_tokens"] != st2["spec_steps"]:
        raise InvariantViolation(
            f"{arch_name}: an always-wrong drafter accepted "
            f"{st2['spec_tokens']} tokens over {st2['spec_steps']} steps "
            "(greedy acceptance must keep exactly the correction token)")
    needs_rollback = bool(eng2.spec_snapshot())
    if needs_rollback != (st2["repair_dispatches"] > 0):
        raise InvariantViolation(
            f"{arch_name}: {st2['repair_dispatches']} repair dispatches "
            f"but rollback-sensitive state present={needs_rollback}: "
            "recurrent/ring archs must repair on partial acceptance and "
            "pure global-attention archs must never")
    want2 = 1 + eng2.steps_checked + st2["verify_dispatches"]
    if eng2.fetches != want2:
        raise InvariantViolation(
            f"{arch_name}: forced-mismatch drive fetched {eng2.fetches} "
            f"(expected {want2}: 1 admission + {eng2.steps_checked} "
            f"sequential steps + {st2['verify_dispatches']} verifies; "
            "draft_fn drafts and repair dispatches fetch nothing)")
    report["forced_mismatch"] = {
        "repair_dispatches": st2["repair_dispatches"],
        "needs_rollback": needs_rollback,
    }

    # --- (c) sampled verification: one verify key, one signature
    eng3 = InstrumentedEngine(arch, params, serve, device=device)
    dec3 = SpecDecoder(eng3, SpecConfig(k=4, draft="self"))
    eng3.add_request([2, 7, 1], params=SamplingParams(
        temperature=0.7, seed=3, max_tokens=32))
    for i in range(3):
        dec3.step(sampling.key(i))
    eng3.check()
    n_verify = sum(1 for k in eng3.traces if k.startswith("verify["))
    if n_verify != 1:
        raise InvariantViolation(
            f"{arch_name}: sampled speculation used {n_verify} verify "
            f"keys (expected exactly 1): {dict(eng3.traces)}")
    st3 = eng3.stats
    want3 = (1 + eng3.steps_checked + st3["draft_dispatches"]
             + st3["verify_dispatches"])
    if eng3.fetches != want3:
        raise InvariantViolation(
            f"{arch_name}: sampled drive fetched {eng3.fetches} "
            f"(expected {want3}): the packed verify result must be the "
            "dispatch's single fetch")
    # structural counts only: sampled acceptance depends on the draws
    report["sampled"] = {
        "verify_executables": n_verify,
        "draft_dispatches": st3["draft_dispatches"],
        "verify_dispatches": st3["verify_dispatches"],
    }
    return report


def run_spec_invariants(configs=INVARIANT_CONFIGS, *, device=None,
                        params=None, mode=None) -> dict:
    """Speculative-decode invariant run (``_drive_spec``); same report
    shape as ``run_invariants``."""
    return _run_all(_drive_spec, configs, device, params, mode)
