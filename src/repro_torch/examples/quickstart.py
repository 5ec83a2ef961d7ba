"""Quickstart: the paper's contribution in 30 lines.

1. Quantize activations/weights to low-bit FP formats.
2. Run a matmul through the GR-MAC simulation (row normalization, 8 b ADC).
3. Compare against the conventional FP->INT CIM at the same ADC resolution.
4. Price both designs with the paper's 28 nm energy model.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import FP4_E2M1, FP6_E3M2
from repro_torch.core.adc import required_enob
from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.device import require_full_f32, resolve_device
from repro_torch.core.distributions import gaussian_outliers, uniform
from repro_torch.core.dse import evaluate_point
from repro_torch.kernels.ops import cim_matmul


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--n-cols", type=int, default=1 << 14,
                    help="Monte-Carlo columns per ENOB solve")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        require_full_f32()

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((64, 512)) * 0.1,  # LLM-ish
                     dtype=torch.float32, device=dev)
    w = torch.tensor(rng.standard_normal((512, 256)) * 0.05,
                     dtype=torch.float32, device=dev)

    exact = x @ w
    for gran in ["row", "unit"]:
        cfg = CIMConfig(mode="grmac", granularity=gran,
                        fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32)
        out = cim_matmul(x, w, cfg)
        rel = float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact))
        print(f"GR-MAC [{gran:4s}]  rel err vs exact fp32: {rel:.4f}")

    # ADC requirement: the GR-MAC bound is data-INVARIANT (contribution 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dist in [uniform(), gaussian_outliers()]:
        rc = required_enob(gen, "conv", dist, FP6_E3M2, n_cols=args.n_cols)
        ru = required_enob(gen, "gr_unit", dist, FP6_E3M2,
                           n_cols=args.n_cols)
        print(f"{dist.name:24s} ADC: conv {rc.enob:5.2f} b -> GR "
              f"{ru.enob:5.2f} b  (saves {rc.enob - ru.enob:.2f} b)")

    # energy at the FP6_E3M2 design point (paper Fig. 12)
    pt = evaluate_point(gen, FP6_E3M2, n_cols=1 << 12)
    print(f"energy/Op: conventional {pt.conv.total:8.1f} fJ "
          f"(out of practical range) | GR-CIM {pt.gr.total:5.1f} fJ "
          f"[{pt.gr_arch}]")


if __name__ == "__main__":
    main()
