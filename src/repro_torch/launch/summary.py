"""Aggregate dry-run / roofline / energy JSON records into markdown
tables; the port's counterpart of ``repro.launch.summary``. ``--energy``
renders the ledger-derived per-phase pJ/token record
(``experiments/bench/e2e_energy.json``, read only) and, when the
``e2e_pareto`` record exists, each arch's per-site Pareto frontier, the
chosen ``site_overrides`` deployment and the per-phase deployment-level
energy/accuracy fronts.

    python -m repro_torch.launch.summary [--dir build/dryrun] [--roofline]
    python -m repro_torch.launch.summary --energy
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.mesh import HW


def load(out_dir: str, roofline: bool):
    rows = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        d = json.load(open(f))
        is_roof = f.endswith("_roofline.json")
        if is_roof != roofline:
            continue
        rows.append(d)
    return rows


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(rows):
    """The port's records time the trace (``trace_s``) where the
    reference's time the compile; the column is named by what they hold."""
    secs = "trace_s" if any("trace_s" in d for d in rows) else "compile_s"
    print(f"| arch | shape | mesh | status | {secs} | mem/dev GiB | "
          "flops/dev | coll GiB/dev |")
    print("|---|---|---|---|---|---|---|---|")
    for d in rows:
        if d["status"] != "ok":
            print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                  f"{d['status']}: {d.get('reason', d.get('error',''))[:60]} "
                  f"| | | | |")
            continue
        print(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | ok "
            f"| {d[secs]} | {fmt_bytes(d['bytes_per_device']['peak_est'])} "
            f"| {d['cost']['flops_per_device']:.3g} "
            f"| {d['cost']['collective_bytes_per_device']/2**30:.3f} |")


def roofline_table(rows):
    """Three roofline terms + a fusion-adjusted memory *lower bound*
    (args+outputs traffic only — perfect fusion) at the H100's HBM rate,
    bracketing HBM time between t_mem_lb and t_mem (the unfused upper
    bound)."""
    hbm_bw = HW.HBM_BW
    print("| arch | shape | t_comp ms | t_mem ms (UB) | t_mem_lb ms "
          "| t_coll ms | dominant (bracket) | HLO/model | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        if d["status"] != "ok":
            continue
        r = d["roofline"]
        b = d["bytes_per_device"]
        t_lb = (b["arguments"] + b["outputs"]) / hbm_bw
        terms = {"compute": r["t_compute_s"], "memory_lb": t_lb,
                 "collective": r["t_collective_s"]}
        dom_lb = max(terms, key=terms.get)
        dom = r["dominant"] if r["dominant"] == dom_lb.replace("_lb", "") \
            else f"{r['dominant']}→{dom_lb}"
        print(
            f"| {d['arch']} | {d['shape']} "
            f"| {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
            f"| {t_lb*1e3:.2f} "
            f"| {r['t_collective_s']*1e3:.2f} | {dom} "
            f"| {r['hlo/model']:.2f} | {r['roofline_fraction']:.3f} |")


def energy_table(path: str):
    """Per-arch × per-phase pJ/token from the trace-derived CostLedger
    record (benchmarks/e2e_energy.py): the deployment bottom line."""
    with open(path) as f:
        recs = json.load(f)
    print("| arch | fJ/Op (conv) | decode pJ/tok | prefill pJ/tok | "
          "train pJ/tok | decode GOps/tok |")
    print("|---|---|---|---|---|---|")
    for arch, r in sorted(recs.items()):
        ph = r["phases"]
        print(
            f"| {arch} | {r['fj_per_op']:.1f} "
            f"({r['conventional_fj_per_op']:.1f}) "
            f"| {ph['decode']['pj_per_token']:.0f} "
            f"| {ph['prefill']['pj_per_token']:.0f} "
            f"| {ph['train']['pj_per_token']:.0f} "
            f"| {ph['decode']['ops_per_token']/1e9:.3f} |")


def _fmt_design(d: dict) -> str:
    return f"{d['fmt_x']}/n{d['n_r']}/{d['granularity']}"


def pareto_table(path: str):
    """Per-arch per-site Pareto frontier (decode phase) + the chosen
    ``site_overrides`` deployment and the per-phase deployment-level
    energy/accuracy fronts, from the ``--pareto`` record."""
    try:
        with open(path) as f:
            recs = json.load(f)
    except OSError:
        return
    for arch, rec in sorted(recs.items()):
        dec = rec["phases"]["decode"]
        print(f"\n### {arch} — per-site frontier @ decode "
              f"(budget {rec['budget_sqnr_db']:.1f} dB)")
        print("| site | GOps/tok | chosen | fJ/Op | SQNR dB | "
              "front (fJ/Op @ dB) |")
        print("|---|---|---|---|---|---|")
        for site, s in sorted(dec["sites"].items()):
            if s.get("mode") == "off" or "front" not in s:
                print(f"| {site} | {s['ops_per_token']/1e9:.3f} | off "
                      "| | | |")
                continue
            chosen = s["chosen"]
            front = " → ".join(
                f"{c['fj_per_op']:.1f}@{c['sqnr_db']:.1f}"
                for c in s["front"].values())
            fj = s["chosen_fj_per_op"]
            sq = next((c["sqnr_db"] for k, c in s["front"].items()
                       if k == chosen), None)
            print(f"| {site} | {s['ops_per_token']/1e9:.3f} | {chosen} "
                  f"| {fj:.1f} | {sq:.1f} | {front} |"
                  if fj is not None else
                  f"| {site} | {s['ops_per_token']/1e9:.3f} | {chosen} "
                  f"| | | {front} |")
        ov = dec["site_overrides"]
        print("site_overrides: "
              + json.dumps(ov, sort_keys=True, default=str))
        for phase, ph in rec["phases"].items():
            pts = " → ".join(
                f"{k}:{p['pj_per_token']:.0f}pJ"
                for k, p in ph["front"].items())
            print(f"{phase}: chosen {ph['pj_per_token']:.0f} pJ/tok "
                  f"(base {ph['base_pj_per_token']:.0f}) | front: {pts}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--energy", action="store_true",
                    help="render experiments/bench/e2e_energy.json (+ the "
                         "e2e_pareto frontier record when present)")
    ap.add_argument("--energy-record",
                    default="experiments/bench/e2e_energy.json")
    ap.add_argument("--pareto-record",
                    default="experiments/bench/e2e_pareto.json")
    args = ap.parse_args(argv)
    if args.energy:
        energy_table(args.energy_record)
        pareto_table(args.pareto_record)
        return
    rows = load(args.dir, args.roofline)
    if args.roofline:
        roofline_table(rows)
    else:
        dryrun_table(rows)


if __name__ == "__main__":
    main()
