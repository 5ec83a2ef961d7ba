#!/usr/bin/env python3
"""Readings from which a cell's correctness limits are set (not run by the
benchmark's own runs):

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control tf32|fp8] [--fault half_batch]

For each seed, in one process: the port set up and run for the window as
``run.py`` runs it, then the numbers the check compares (the lower
readings), and with ``--control`` the same numbers of the reference
computed in the lower precision, put in the port's place (the upper
readings). ``--fault`` plants one of the driver's faults in the program
(the train driver's ``FAULTS``). One JSON line a seed on standard output,
and appended to ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", choices=("tf32", "fp8"))
    p.add_argument("--fault", help="a fault of the cell's driver")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from perfbench.harness import program, report
    from perfbench.harness.spec import Cell, driver, pin_host
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    pin_host()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    drive = driver(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": cell.name, "seed": seed,
                "card": torch.cuda.get_device_name(0),
                **drive.calibrate(cell, seed, args.seconds, program,
                                  args.control, args.fault)}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        report.free_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
