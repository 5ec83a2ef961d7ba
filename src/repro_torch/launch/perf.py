"""Perf-iteration driver: run one dry-run cell with a named experiment
variant (config overrides) and print the roofline-term deltas against a
baseline record; the port's counterpart of ``repro.launch.perf``.

    python -m repro_torch.launch.perf --arch arctic-480b --shape train_4k \\
        --variant microbatch8 --set microbatches=8

The JSON goes to ``--out`` (default ``build/perf``, outside the committed
records).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import run_cell

__all__ = ["DEFAULT_OUT", "parse_overrides", "main"]

DEFAULT_OUT = "build/perf"


def parse_overrides(pairs) -> dict:
    """``key=value`` strings as ArchConfig overrides (int, float, bool or
    str)."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--roofline-mode", action="store_true", default=True)
    ap.add_argument("--no-roofline-mode", dest="roofline_mode",
                    action="store_false")
    ap.add_argument("--cim", default="off")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--cache-dtype", default="bfloat16")
    ap.add_argument("--algorithm", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--layout", default="fsdp", choices=["fsdp", "zero1"])
    ap.add_argument("--model-parallel", type=int, default=16)
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override key=value (int/float/bool/str)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON to diff against")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    r = run_cell(args.arch, args.shape, False, cim=args.cim,
                 roofline_mode=args.roofline_mode,
                 overrides=parse_overrides(args.set),
                 tag_suffix=f"_{args.variant}",
                 microbatches=args.microbatches,
                 grad_compression=args.grad_compression,
                 cache_dtype=args.cache_dtype,
                 algorithm=args.algorithm, layout=args.layout,
                 model_parallel=args.model_parallel, out_dir=args.out)
    if args.baseline and r["status"] == "ok":
        with open(args.baseline) as f:
            base = json.load(f)
        br, nr = base["roofline"], r["roofline"]
        print(f"{'term':14s} {'baseline':>12s} {'variant':>12s} {'delta':>8s}")
        for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
            d = (nr[k] - br[k]) / max(br[k], 1e-12) * 100
            print(f"{k:14s} {br[k]:12.4f} {nr[k]:12.4f} {d:+7.1f}%")
        bm = base["bytes_per_device"]["peak_est"] / 2**30
        nm = r["bytes_per_device"]["peak_est"] / 2**30
        print(f"{'mem GiB/dev':14s} {bm:12.2f} {nm:12.2f} "
              f"{(nm-bm)/bm*100:+7.1f}%")
    return r


if __name__ == "__main__":
    main()
