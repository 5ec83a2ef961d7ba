"""The closed-loop serving driver: ``clients`` clients each keep one
request in flight through the port's ``Scheduler`` over its ``Engine``,
for a measured window, then the reference judges every token served.

Stamps are the benchmark's own, taken where the tokens reach the host: a
first token when ``Engine.finish_prefill`` returns it, a decoded token
when ``Engine.step`` returns. Set-up ends with a ramp: the loop runs until
as many requests as there are clients have ended, so that the lanes no
longer start and end together. The window then opens, and closes at the
end of the first scheduler step that ends ``seconds`` or more after it
opened; the rate is over all of it.
"""
from __future__ import annotations

import sys
import time
import types
from typing import Optional

import numpy as np
import torch

from perfbench.harness import report, roofline, trace, traffic
from perfbench.harness.spec import reference_module, reference_model
from perfbench.reference import replay as replay_mod

SPANS = ("Engine.step", "Engine.advance_prefill", "Engine.finish_prefill")


class Run:
    """What one run of a serving cell leaves for the metrics and the
    check: stamps, spans, counts, the program's requests."""

    def __init__(self):
        self.times: dict = {}          # request index -> token stamps
        self.first_t: dict = {}
        self.decode_spans = []         # (t0, t1, [keys attended per lane])
        self.prefill_spans = []        # (t0, t1, tokens, bucket, offset)
        self.steps = 0
        self.t0 = self.t1 = 0.0
        self.slice: Optional[tuple] = None
        self.trace: Optional[trace.Trace] = None
        self.requests = []


def _instrument(eng, sched, run: Run, tracing: list):
    """Spans around the calls into the engine (instance attributes: the
    program's code is not changed)."""
    step, advance, finish = (eng.step, eng.advance_prefill,
                             eng.finish_prefill)
    rid_of = {}

    def step_(*a, **k):
        keys = (eng.lengths[eng.active] + 1).tolist()
        t0 = time.perf_counter()
        with trace.span("Engine.step", tracing[0]):
            out = step(*a, **k)
        run.decode_spans.append((t0, time.perf_counter(), keys))
        return out

    def advance_(slot, max_tokens=None):
        off = int(eng.lengths[slot])
        t0 = time.perf_counter()
        with trace.span("Engine.advance_prefill", tracing[0]):
            got = advance(slot, max_tokens)
        b = eng.cfg.prefill_bucket_min
        while b < got:
            b *= 2
        run.prefill_spans.append((t0, time.perf_counter(), got, b, off))
        return got

    def finish_(slot, key=None):
        r = next(r for r in sched.prefilling if r.slot == slot)
        with trace.span("Engine.finish_prefill", tracing[0]):
            out = finish(slot, key)
        run.first_t[rid_of[r.rid]] = time.perf_counter()
        return out

    eng.step, eng.advance_prefill, eng.finish_prefill = (step_, advance_,
                                                         finish_)
    return rid_of


def drive(cell, seed: int, seconds: float, tracing: bool, device,
          program, *, hook=None) -> tuple:
    """Set up the port, warm it, run the window. Returns (run, engine,
    scheduler, requests, set-up end time)."""
    mix, e = cell.mix, cell.mix["engine"]
    cfg = cell.config
    ref = reference_model(cfg)
    params = ref.make_params(seed, device)
    reqs = traffic.closed_loop_requests(mix, cfg["arch"]["vocab_size"],
                                        seed)
    a = program.arch(cfg)
    eng = program.engine(a, params, e, device)
    del params
    program.warm_serving(eng, a, e, device)
    sched = program.scheduler(eng, e)
    run = Run()
    on = [False]
    rid_of = _instrument(eng, sched, run, on)
    if hook is not None:
        hook(eng, sched)

    clients = mix["clients"]
    lead = min(mix.get("trace_lead_s", 2.0), seconds / 4)
    length = mix.get("trace_seconds", 4.0)
    prof = None
    state = {"i": 0, "live": {}}

    def step():
        """Top the clients up, one scheduler step, stamp its tokens."""
        i, live = state["i"], state["live"]
        while i < len(reqs) and i - len(sched.finished) < clients:
            r = sched.submit(reqs[i]["prompt"], params=program.SamplingParams(
                max_tokens=reqs[i]["max_tokens"]))
            rid_of[r.rid] = i
            run.requests.append(r)
            live[i] = (r, 0)
            i += 1
        state["i"] = i
        n_dec = len(run.decode_spans)
        sched.step()
        run.steps += 1
        dec_t = (run.decode_spans[-1][1] if len(run.decode_spans) > n_dec
                 else None)
        for idx, (r, seen) in list(live.items()):
            n = len(r.generated)
            if n > seen:
                ts = run.times.setdefault(idx, [])
                if seen == 0:
                    ts.append(run.first_t[idx])
                    seen = 1
                ts.extend([dec_t] * (n - seen))
                live[idx] = (r, n)
            if r.state == "finished":
                del live[idx]
        return time.perf_counter()

    # the ramp: until every client has seen a request end, the lanes start
    # and end together; the window opens on the steady loop after it
    while len(sched.finished) < clients:
        step()
    _sync(device)
    setup_end = time.perf_counter()
    run.t0 = time.perf_counter()
    while True:
        if tracing and prof is None and time.perf_counter() - run.t0 >= lead:
            _sync(device)
            prof = trace.profiler()
            prof.__enter__()
            on[0] = True
            run.slice = (time.perf_counter(), None)
        end = step()
        if prof is not None and end - run.slice[0] >= length:
            _sync(device)
            run.slice = (run.slice[0], time.perf_counter())
            on[0] = False
            prof.__exit__(None, None, None)
            run.t1 = end
            run.trace = trace.Trace(prof, run.slice[1] - run.slice[0],
                                    SPANS)
            break
        if end - run.t0 >= seconds or (state["i"] >= len(reqs)
                                       and sched.idle()):
            run.t1 = end
            break
    return run, eng, sched, reqs, setup_end


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(run: Run) -> dict:
    """The rate and the gaps' tails over the window [t0, t1], and the rate
    over each half of it."""
    t0, t1 = run.t0, run.t1
    stamps = [s for ts in run.times.values() for s in ts]
    toks = sum(t0 <= s <= t1 for s in stamps)
    mid = (t0 + t1) / 2
    itl = [b - a for ts in run.times.values() for a, b in zip(ts, ts[1:])
           if t0 <= a and b <= t1]
    out = {"gen_tok_s": toks / (t1 - t0), "tokens": toks, "gaps": len(itl),
           "halves_tok_s": [sum(t0 <= s <= mid for s in stamps) / (mid - t0),
                            sum(mid < s <= t1 for s in stamps) / (t1 - mid)]}
    for q in (95, 99):
        out[f"itl_p{q}_ms"] = 1e3 * percentile(itl, q) if itl else None
    return out


def served_tokens(run: Run) -> dict:
    return {run_idx: list(r.generated)
            for run_idx, r in enumerate(run.requests)}


def check(cell, seed: int, run: Run, reqs, device, control: str = None
          ) -> dict:
    """Replay the run on the reference (and the control beside it) and
    return the widest gap of the served tokens (and of the control's)."""
    cfg, e = cell.config, cell.mix["engine"]
    params = reference_model(cfg).make_params(seed, device)
    lanes = [replay_mod.Lanes(reference_model(cfg), params,
                              e["batch_slots"], e["max_ctx"], device)]
    if control is not None:
        lanes.append(replay_mod.Lanes(
            reference_model(cfg, "fp8" if control == "fp8" else "f32"),
            params, e["batch_slots"], e["max_ctx"], device,
            tf32=control == "tf32"))
    result = replay_mod.replay(
        lanes, reqs, served_tokens(run), steps=run.steps,
        clients=cell.mix["clients"], slots=e["batch_slots"],
        max_ctx=e["max_ctx"], bucket_min=e["prefill_bucket_min"],
        bucket_max=e["prefill_bucket_max"],
        budget=e["prefill_token_budget"], device=device)
    finished = [rid for rid, r in enumerate(run.requests)
                if r.state == "finished"]
    if sorted(finished) != sorted(result["finished"]):
        raise AssertionError(
            f"the port finished {len(finished)} requests, the policy "
            f"{len(result['finished'])}")
    out = replay_mod.widest(result)
    out["requests"] = len(finished)
    return out


def useful_work(run: Run, cell, t0: float, t1: float) -> dict:
    """Tokens a model forward was needed for inside [t0, t1] (prompt tokens
    prefilled and decode lanes, each with the keys it attended) and their
    model flops, by the counts of the configuration's reference."""
    arch, ref = cell.config["arch"], reference_module(cell.config)
    per_token = 2 * roofline.matmul_params(ref.projections(arch))
    tokens, steps, flops = 0, 0, 0
    for s, t, keys_l in run.decode_spans:
        if t0 <= s and t <= t1:
            tokens += len(keys_l)
            flops += sum(per_token + ref.token_flops(arch, k) for k in keys_l)
            steps += 1
    dispatches = {}
    prompt = 0
    for s, t, got, b, off in run.prefill_spans:
        if t0 <= s and t <= t1:
            prompt += got
            flops += sum(per_token + ref.token_flops(arch, k)
                         for k in range(off + 1, off + got + 1))
            dispatches[b] = dispatches.get(b, 0) + 1
    return {"decode_tokens": tokens, "prompt_tokens": prompt,
            "decode_steps": steps, "prefill_dispatches": dispatches,
            "model_flops": flops}


def result_line(checked: dict, limits: dict) -> tuple:
    """(correct, the compared numbers beside their limits)."""
    gap = checked.get("served_gap")
    lim = limits.get("served_gap")
    least = limits.get("min_tokens", 1)
    checks = {"served_gap": {"value": gap, "limit": lim},
              "tokens_judged": {"value": checked["tokens"], "limit": least}}
    correct = (lim is not None and gap is not None and gap <= lim
               and checked["tokens"] >= least)
    return correct, checks



def measure(cell, args, program, t_start: float) -> report.Result:
    """One run of the cell: set-up, the window, the check."""
    run, eng, sched, reqs, setup_end = drive(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", program)
    dev = report.device_info(cell.chips)
    attempted = len(run.requests)
    failed = sum(r.state == "finished" and r.finish_reason != "length"
                 for r in run.requests)
    e2e = end_to_end(run)
    extra = {}
    if args.trace:
        ts, te = run.slice
        ctx = _context(cell, run, ts, te)
        metrics = report.per_layer(cell, ctx)
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        extra["breakdown"] = run.trace.breakdown()
    else:
        metrics = report.end_to_end(cell, e2e, setup_end - t_start)
    del eng, sched
    report.free_memory()
    t = time.perf_counter()
    try:
        correct, checks = result_line(
            check(cell, args.seed, run, reqs, "cuda"), cell.limits)
    except (LookupError, AssertionError) as exc:
        print(f"check failed: {exc}", file=sys.stderr)
        correct, checks = False, {"served_gap": {
            "value": None, "limit": cell.limits.get("served_gap")}}
    print(f"timing set-up {setup_end - t_start:.3f} s, window "
          f"{run.t1 - run.t0:.3f} s, {run.steps} steps, "
          f"{e2e['gen_tok_s']} tokens/s, by half {e2e['halves_tok_s']}, "
          f"itl p95 {e2e['itl_p95_ms']} p99 {e2e['itl_p99_ms']} ms, "
          f"reference {time.perf_counter() - t:.3f} s", file=sys.stderr)
    return report.Result(correct, attempted, failed, metrics, dev, checks,
                         extra)


def _context(cell, run: Run, ts: float, te: float):
    """What the per-layer readers of a serving cell read."""
    arch = cell.config["arch"]
    return types.SimpleNamespace(
        kind="serve", cell=cell, arch=arch, n_r=cell.config["cim"]["n_r"],
        projections=reference_module(cell.config).projections(arch),
        run=run, trace=run.trace, slice=(ts, te), seconds=te - ts,
        work=useful_work(run, cell, ts, te))


def calibrate(cell, seed: int, seconds: float, program, control=None,
              fault=None) -> dict:
    """The program's readings on one seed (the lower), and with
    ``control`` ("tf32" or "fp8") the control's beside them (the upper)."""
    if fault is not None:
        raise ValueError("serving faults are planted by the tests")
    run, eng, sched, reqs, _ = drive(cell, seed, seconds, False, "cuda",
                                     program)
    line = dict(end_to_end(run), steps=run.steps)
    del eng, sched
    report.free_memory()
    t = time.perf_counter()
    line.update(check(cell, seed, run, reqs, "cuda", control=control),
                ref_s=time.perf_counter() - t)
    return line
