"""CLI for the analysis passes: ``python -m repro_torch.analysis``.

Runs the ledger audit (``op_audit``) over the requested configs × phases,
and the engine invariant drives (unless ``--no-invariants``) on
``--device`` (default: the card), and writes one JSON report where
``--out`` points (nothing is written otherwise). Exit status 1 on any
finding (an untagged contraction, a ledger mismatch, an invariant
violation), else 0.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu \
        --configs paper-cim-120m --out /tmp/audit.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

__all__ = ["main", "build_report"]

PHASES = ("prefill", "decode", "train")
_DRIVES = (("invariants", "run_invariants", "invariants"),
           ("scheduler_invariants", "run_scheduler_invariants",
            "scheduler invariants"),
           ("prefix_invariants", "run_prefix_invariants",
            "prefix-cache invariants"),
           ("spec_invariants", "run_spec_invariants",
            "speculative invariants"))


def build_report(config_names: List[str], phases=PHASES, *,
                 invariants: bool = True, device=None,
                 verbose: bool = True) -> dict:
    """The report of ``op_audit`` over ``config_names`` × ``phases`` and,
    with ``invariants``, of the four invariant drives on ``device``."""
    from repro_torch.analysis import invariants as inv
    from repro_torch.analysis.op_audit import audit_arch
    from repro_torch.configs import get_config

    report = {"schema": 1, "phases": list(phases), "configs": {}}
    failures = 0
    for name in sorted(config_names):
        res = audit_arch(get_config(name), phases)
        report["configs"][name] = res
        failures += res["failures"]
        if verbose:
            tot = {k: sum(ph[k] for ph in res["phases"].values())
                   for k in ("dot_generals", "tagged_values",
                             "declared_digital", "untagged",
                             "ledger_mismatches")}
            print(f"[audit] {name}: {tot['dot_generals']} contractions = "
                  f"{tot['tagged_values']} tagged + "
                  f"{tot['declared_digital']} declared-digital "
                  f"(+gains/transposes) | untagged={tot['untagged']} "
                  f"mismatches={tot['ledger_mismatches']} "
                  f"failures={res['failures']}")
    if invariants:
        for key, fn, what in _DRIVES:
            res = getattr(inv, fn)(device=device)
            report[key] = res
            failures += res["violations"]
            if verbose:
                print(f"[audit] {what}: {res['violations']} violations "
                      f"across {len(res['configs'])} configs")
    report["failures"] = failures
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Ledger-completeness audit + hot-path invariant checks")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="config names to audit (default: paper-cim-120m)")
    ap.add_argument("--all-configs", action="store_true",
                    help="audit every registered config")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=list(PHASES))
    ap.add_argument("--out", default=None, help="write the JSON report")
    ap.add_argument("--no-invariants", action="store_true",
                    help="skip the engine invariant drives")
    ap.add_argument("--device", default=None,
                    help="device of the invariant drives (default: the "
                         "CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_configs
    if args.all_configs:
        names = list(list_configs())
    elif args.configs:
        names = list(args.configs)
    else:
        names = ["paper-cim-120m"]

    report = build_report(names, tuple(args.phases),
                          invariants=not args.no_invariants,
                          device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[audit] report -> {args.out}")
    if report["failures"]:
        print(f"[audit] FAILED: {report['failures']} findings",
              file=sys.stderr)
        return 1
    print("[audit] OK: ledger complete, invariants hold")
    return 0
