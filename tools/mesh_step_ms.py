"""Host cost of the SPMD program on a mesh of one rank, on a CUDA card:
paper-cim-120m at full width through the GR-MAC kernel.

* serve: the Engine's decode step (8 slots, ctx 512, eight prompts) with
  no mesh and under ``local_mesh()`` (a 1 x 1 NCCL mesh, plain weights),
  as ``chip_smoke.py``'s ``serve`` and ``spmd_serve`` phases run it;
* train: the train step at 8 x 128 under that mesh on plain tensors and
  on the state placed as DTensors (``param_specs``), as the fault drill's
  uninterrupted and DTensor steps run it (deterministic algorithms on
  for these, as there).

The two modes of each pair alternate round by round, so that they share
the host's load. A cProfile of a few meshed decode and DTensor train
steps then gives, per step, the host time of the SPMD program's own
functions (inflated by the profiler alike for every function).

    python tools/mesh_step_ms.py [--src DIR] [--rounds 8] [--steps 8]

``--src`` is the ``src`` directory of the checkout to measure (default:
this one's), so that another commit, unpacked beside it, is measured in
the same run. Prints the card's name and power limit, then one JSON line
a measurement.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

# the SPMD program's helpers whose host time the profile reports (those
# a commit lacks are left out of its line)
PROFILED = ("_spmd_serve", "_layer_cache", "put_back", "gather_tree",
            "gather_full", "split_model", "local_rows", "all_reduce_max",
            "_groups", "mesh_sizes")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _profiled(prof: cProfile.Profile, steps: int) -> dict:
    """Per-step ms (own, cumulative) and calls of ``PROFILED``, and the
    ten functions of any module with the most own time a step."""
    out, own = {}, []
    for (fname, line, name), (_, nc, tt, ct, _) in pstats.Stats(
            prof).stats.items():
        own.append((1e3 * tt / steps, f"{Path(fname).name}:{line}({name})"))
        if name in PROFILED and "repro_torch" in fname:
            row = out.setdefault(name, {"calls": 0, "own_ms": 0.0,
                                        "cum_ms": 0.0})
            row["calls"] += nc / steps
            row["own_ms"] += 1e3 * tt / steps
            row["cum_ms"] = max(row["cum_ms"], 1e3 * ct / steps)
    out["top_own_ms"] = sorted(own, reverse=True)[:10]
    out["profiled_ms"] = 1e3 * sum(
        tt for _, _, tt, _, _ in pstats.Stats(prof).stats.values()) / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import param_specs, use_mesh
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.training.fault import reshard_tree
    from repro_torch.training.optimizer import (OptimizerConfig,
                                                init_opt_state)
    from repro_torch.training.trainer import TrainConfig, make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    dev = torch.device("cuda")
    arch = get_config("paper-cim-120m")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, arch.vocab_size, n)]
               for n in (5, 8, 12, 17, 24, 33, 40, 60)]
    params = init_params(arch, 0, device=dev)

    def decode_ms(steps, prof=None):
        engine = Engine(arch, params, ServeConfig(batch_slots=8,
                                                  max_ctx=512), device=dev)
        for p in prompts:
            engine.add_request(p)
        torch.cuda.synchronize()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            engine.step()
            torch.cuda.synchronize()
            if prof is not None:
                prof.disable()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    data = SyntheticLM(DataConfig(global_batch=8, seq_len=128,
                                  vocab_size=arch.vocab_size), device=dev)
    tcfg = TrainConfig(steps=12, opt=OptimizerConfig(
        lr=3e-4, warmup_steps=5, total_steps=12))
    step_fn = make_train_step(arch, tcfg)

    def train_ms(state, steps, step0, prof=None):
        p, o = state
        ms = []
        torch.use_deterministic_algorithms(True, warn_only=True)
        for step in range(step0, step0 + steps):
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            p, o, m = step_fn(p, o, data.batch_at(step))
            float(m["loss"])
            if prof is not None:
                prof.disable()
            ms.append(1e3 * (time.perf_counter() - t0))
        torch.use_deterministic_algorithms(False)
        return (p, o), ms

    serve = {"no_mesh": [], "mesh_1x1": []}
    train = {"plain": [], "dtensor": []}
    with local_mesh() as mesh:
        p = init_params(arch, 0, device=dev)
        plain = (p, init_opt_state(p, tcfg.opt))
        with use_mesh(mesh):
            placed = reshard_tree({"params": plain[0], "opt": plain[1]},
                                  mesh, {"params": param_specs(plain[0], mesh),
                                         "opt": param_specs(plain[1], mesh)})
        dtensor = (placed["params"], placed["opt"])
        del placed
        for r in range(args.rounds):
            serve["no_mesh"] += decode_ms(args.steps)
            with use_mesh(mesh):
                serve["mesh_1x1"] += decode_ms(args.steps)
                plain, ms = train_ms(plain, 3, 3 * r)
                train["plain"] += ms
                dtensor, ms = train_ms(dtensor, 3, 3 * r)
                train["dtensor"] += ms
        prof_serve, prof_train = cProfile.Profile(), cProfile.Profile()
        with use_mesh(mesh):
            decode_ms(args.steps, prof_serve)
            train_ms(dtensor, 2, 0, prof_train)

    common = {"src": args.src, "arch": arch.name, "card": card}
    print(json.dumps({"of": "serve_decode_step", "slots": 8, "ctx": 512,
                      "rounds": args.rounds, "steps_a_round": args.steps,
                      **{f"{k}_ms_median": _median(v)
                         for k, v in serve.items()},
                      "ms": serve, **common}))
    print(json.dumps({"of": "train_step", "batch": [8, 128],
                      "rounds": args.rounds, "steps_a_round": 3,
                      **{f"{k}_ms_median": _median(v)
                         for k, v in train.items()},
                      "ms": train, **common}))
    print(json.dumps({"of": "host_profile", "steps": {
        "serve_decode_mesh_1x1": args.steps, "train_dtensor": 2},
        "serve_decode_mesh_1x1": _profiled(prof_serve, args.steps),
        "train_dtensor": _profiled(prof_train, 2), **common}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
