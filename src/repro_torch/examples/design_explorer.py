"""Interactive-ish design-space exploration: pick a workload's dynamic-range
and precision needs, get the energy-optimal CIM configuration (the paper's
Fig. 12 as a tool). For the per-*site* sweep over a traced model (formats x
n_r x granularity with accuracy budgets and Pareto fronts), see
``repro_torch.examples.site_pareto``.

Run:  PYTHONPATH=src python -m repro_torch.examples.design_explorer \\
          --sqnr 35 --dr 60 [--device cpu]
"""
import argparse
import math

import torch

from repro_torch.core import dse as S
from repro_torch.core import formats as F
from repro_torch.core.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sqnr", type=float, default=35.0, help="target SQNR dB")
    ap.add_argument("--dr", type=float, default=60.0, help="target DR dB")
    ap.add_argument("--n_r", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device of the Monte-Carlo solves (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    nm = max(1, math.ceil((args.sqnr - 10.79) / 6.02))
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"target: SQNR>={args.sqnr} dB (N_M={nm}), DR>={args.dr} dB")
    best = None
    for ne in (1, 2, 3, 4):
        fmt = F.FPFormat(ne, nm)
        dr_db, sqnr_db = S.spec_of_format(fmt)
        if dr_db < args.dr:
            continue
        pt = S.evaluate_point(gen, fmt, n_r=args.n_r, n_cols=1 << 12)
        for label, e in [("conventional", pt.conv),
                         (f"GR[{pt.gr_arch}]", pt.gr)]:
            if e is None:
                continue
            enob = pt.enob_conv if label == "conventional" else pt.enob_gr
            print(f"  {fmt.name}: {label:16s} {e.total:9.1f} fJ/Op "
                  f"(ADC {enob:.1f} b) breakdown="
                  f"{ {k: round(v, 1) for k, v in e.as_dict().items()} }")
            if e.total and (best is None or e.total < best[0]):
                best = (e.total, fmt.name, label)
    if best:
        print(f"==> optimal: {best[1]} via {best[2]} at {best[0]:.1f} fJ/Op")
    else:
        print("==> no feasible design point (DR beyond the gain-ranging span;"
              " add global normalization)")
    return best


if __name__ == "__main__":
    main()
