"""Per-site design-space exploration: trace a real model's matmul sites
(on ``meta``), sweep the (format x n_r x granularity) candidate grid per
site against an accuracy budget, and print the Pareto fronts plus the
ready-to-apply ``site_overrides`` deployment
(``core.dse.explore_pareto``).

Run:  PYTHONPATH=src python -m repro_torch.examples.site_pareto \\
          --arch paper-cim-120m --budget 35 [--phase decode] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config, list_configs
from repro_torch.core import costs, dse
from repro_torch.core.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-cim-120m",
                    choices=list_configs())
    ap.add_argument("--budget", type=float,
                    default=dse.PAPER_SQNR_STANDARD_DB,
                    help="per-site accuracy floor in SQNR dB "
                         "(paper standard: 35)")
    ap.add_argument("--phase", default="decode",
                    choices=("decode", "prefill", "train"))
    ap.add_argument("--n-cols", type=int, default=1 << 10,
                    help="Monte-Carlo columns per ENOB solve")
    ap.add_argument("--device", default=None,
                    help="torch device of the Monte-Carlo solves (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = get_config(args.arch)
    if not arch.cim.enabled:
        arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    trace = {"decode": costs.trace_decode,
             "prefill": costs.trace_prefill,
             "train": costs.trace_train}[args.phase]
    ledger = trace(arch)

    res = dse.explore_pareto(
        arch.cim, ledger,
        budget=dse.SiteBudget(min_sqnr_db=args.budget),
        n_cols=args.n_cols, device=dev)

    print(f"{args.arch} · {args.phase} · budget {args.budget:.1f} dB")
    for site, info in sorted(res["sites"].items()):
        if "front" not in info:
            print(f"  {site:12s} digital ({info['ops']:.3g} Ops)")
            continue
        front = " -> ".join(
            f"{c['fmt_x']}/n{c['n_r']}/{c['granularity']}"
            f"[{c['fj_per_op']:.1f} fJ/Op @ {c['sqnr_db']:.1f} dB]"
            for c in info["front"])
        chosen = info["chosen"]
        label = chosen if isinstance(chosen, str) else \
            f"{chosen['fmt_x']}/n{chosen['n_r']}/{chosen['granularity']}"
        print(f"  {site:12s} front: {front}\n"
              f"  {'':12s} chosen: {label} "
              f"(base {info['base']['fmt_x']}/n{info['base']['n_r']}/"
              f"{info['base']['granularity']})")
    print("deployment front (total pJ vs weakest-site SQNR):")
    for p in res["front"]:
        print(f"  >= {p['sqnr_db']:5.1f} dB : {p['pj']:.3g} pJ")
    print(f"ledger energy: chosen {res['pj']:.3g} pJ "
          f"vs base {res['base_pj']:.3g} pJ")
    print("ready-to-apply site_overrides:")
    for site, ov in sorted(res["site_overrides"].items()):
        print(f"  {site}: {ov if isinstance(ov, str) else ov.as_dict()}")
    # the emitted mapping applies in one call: this config now *runs* the
    # chosen mixed deployment (and core.costs prices it identically)
    cfg = arch.cim.with_site_overrides(res["site_overrides"])
    assert cfg == res["config"]
    return res


if __name__ == "__main__":
    main()
