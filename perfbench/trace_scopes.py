#!/usr/bin/env python3
"""Where a cell's host and device time go, by the program's scopes (not
run by the benchmark's own runs):

    python3 perfbench/trace_scopes.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

Runs the cell once as ``run.py --trace 1`` runs it (its line is printed
as run.py prints it), keeps the profiler of the traced slice, and prints
one JSON line more, appended to ``--out``:

* ``device_by_scope``: the device seconds of the slice put down to the
  innermost scope open where each operation was launched
  (``harness.scopes``), the ten largest and "no scope", beside the
  device's total and the share the scopes account for;
* ``device_ops``: the ten largest operations by name, each with the
  scopes that launched it;
* ``idle_gaps``: the ten longest idle gaps of the device, each labelled
  with the benchmark's span, the scopes open on the host and its
  innermost operation;
* ``host_by_scope``: each scope's host seconds, total and self, and its
  count;
* per step (``Engine.step`` or ``train_step`` spans): the host's split
  of a decode step into ``engine.h2d``, the rest of the enqueue and
  ``engine.fetch``, and the device ms put down to ``cim.prescale`` in
  the decode dispatches, ``cim.pack`` and ``train.optimizer``.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TOP = 10


def per_step(sc, name: str) -> dict:
    """Host ms a step of the ``name`` spans: their mean, and the mean of
    the decode dispatch's h2d copies, the rest of its enqueue and the
    fetch inside them."""
    from perfbench.harness import scopes as S
    host = [(h.start, h.end, h.name) for h in sc.scopes]
    steps = [(h.start, h.end) for h in sc.spans if h.name == name]
    if not steps:
        return {}
    n = len(steps)
    decode = S.inside(S.interval(host, "engine.decode["), steps)
    h2d = S.inside(S.interval(host, "engine.h2d"), decode)
    fetch = S.inside(S.interval(host, "engine.fetch"), steps)

    def total(ivs):
        return 1e-3 * sum(e - s for s, e in ivs) / n
    return {"steps": n, "step_ms": total(steps), "h2d_ms": total(h2d),
            "enqueue_ms": total(decode) - total(h2d),
            "fetch_ms": total(fetch)}


def report(prof, spans) -> dict:
    """The line of one traced slice: ``prof`` its profiler, ``spans`` the
    names of the driver's spans."""
    from perfbench.harness import scopes as S
    from perfbench.harness import trace
    sc = S.Scopes.from_profiler(prof.events(), spans)
    # the device's total and idle gaps as the benchmark reduces them (the
    # slice's length is not read here)
    tr = trace.Trace(prof, 0.0, spans)
    by_scope = sc.device_by_scope()
    total = sum(v[0] for v in tr.by_name.values())
    put = sum(by_scope.values())
    by_op = {}
    for d in sc.device:
        i = sc.owner(d)
        who = S.site(sc.scopes[i].name) if i >= 0 else S.NO_SCOPE
        row = by_op.setdefault(d.name, [0.0, {}])
        row[0] += 1e-6 * (d.end - d.start)
        row[1][who] = row[1].get(who, 0.0) + 1e-6 * (d.end - d.start)
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:TOP]
    steps = {n: len([h for h in sc.spans if h.name == n]) for n in spans}
    decode_steps = steps.get("Engine.step", 0)
    train_steps = steps.get("train_step", 0)
    line = {
        "device_total_s": total, "device_put_down_s": put,
        "device_put_down_share": put / total if total else None,
        "device_by_scope": sorted(
            ([k, v] for k, v in by_scope.items() if k != S.NO_SCOPE),
            key=lambda kv: -kv[1])[:TOP] + [[S.NO_SCOPE,
                                             by_scope.get(S.NO_SCOPE, 0.0)]],
        "device_ops": [[k[:160], v[0], sorted(v[1].items(),
                                              key=lambda kv: -kv[1])[:3]]
                       for k, v in top_ops],
        "idle_gaps": [[sc.label((a + b) / 2), g * 1e-6]
                      for g, a, b in tr._gaps],
        "host_by_scope": sorted(([k] + v for k, v in
                                 sc.host_seconds().items()),
                                key=lambda r: -r[1]),
        "steps": steps,
    }
    if decode_steps:
        line["decode_step"] = per_step(sc, "Engine.step")
        line["prescale_ms_per_decode_step"] = 1e3 * sc.device_seconds(
            "cim.prescale", under="engine.decode[") / decode_steps
    if train_steps:
        line["train_step"] = per_step(sc, "train_step")
        for name in ("cim.pack", "train.optimizer"):
            line[f"{name}_device_ms_per_train_step"] = \
                1e3 * sc.device_seconds(name) / train_steps
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from perfbench import run
    from perfbench.harness import trace
    from perfbench.harness.spec import Cell, driver
    kept = []
    make = trace.profiler

    def keep():
        kept.append(make())
        return kept[-1]
    # the drivers make their profiler through ``trace.profiler``
    trace.profiler = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not kept:
        return rc or 1
    cell = Cell(args.workload)
    line = {"workload": cell.name, "seed": args.seed,
            **report(kept[-1], driver(cell).SPANS)}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
