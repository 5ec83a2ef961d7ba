"""Training launcher: builds the mesh, runs the resilient training loop on
it, or the supervised fault drill; the port's counterpart of
``repro.launch.train``. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 20 --batch 8 --seq 128 --device cpu

``--drill`` runs the same configuration under the supervised fault drill
(``training.supervisor``): a seeded ``FaultPlan`` (kill, device loss,
straggler) is injected into the loop, failures are detected and recovered
(freshest checkpoint tier, elastic resume on DTensors), and the run prints
its GoodPut partition, fault counters and pJ per useful token as JSON.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-cim-120m \
        --steps 12 --drill --drill-faults 3

The local mesh is 1 x 1 on a world-1 process group (NCCL on the card,
gloo on the CPU), started here and ended on exit; ``--production-mesh``
takes the 16 x 16 mesh of a process group of 256 ranks that is already up.
"""
import argparse
import json
import tempfile
from contextlib import nullcontext
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import local_mesh, make_production_mesh
from repro_torch.parallel.sharding import use_mesh
from repro_torch.training.fault import make_fault_plan
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.supervisor import (DrillConfig, Supervisor,
                                             price_drill)
from repro_torch.training.trainer import TrainConfig, train


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--cim", default="off")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--heartbeat-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs a process group of 256 ranks)")
    ap.add_argument("--drill", action="store_true",
                    help="run under the supervised fault-drill harness "
                         "(seeded kill/device-loss/straggler injection)")
    ap.add_argument("--drill-faults", type=int, default=3)
    ap.add_argument("--drill-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the launcher; returns the drill's report (with its energy) or
    the last step's metrics, as printed."""
    args = parse_args(argv)
    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.cim != "off":
        arch = arch.replace(cim=arch.cim.with_mode(args.cim))

    mesh_ctx = (nullcontext(make_production_mesh()) if args.production_mesh
                else local_mesh(args.device))
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=arch.vocab_size,
                      embedding_dim=arch.d_model
                      if arch.input_mode == "embeddings" else 0)
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, log_every=5,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=5,
                            total_steps=args.steps))
    data = SyntheticLM(dcfg, device=args.device)
    if args.drill:
        plan = make_fault_plan(args.drill_seed, args.steps,
                               n_faults=args.drill_faults)
        with tempfile.TemporaryDirectory() as wd, mesh_ctx as mesh, \
                use_mesh(mesh):
            drill_cfg = DrillConfig(workdir=args.ckpt_dir or wd,
                                    steps=args.steps)
            report = Supervisor(arch, tcfg, drill_cfg, data, plan,
                                seed=args.drill_seed,
                                device=args.device).run_drill()
        report["energy"] = price_drill(
            arch, report, tokens_per_step=args.batch * args.seq,
            device=args.device)
        shown = {k: v for k, v in report.items() if k != "losses"}
        print(json.dumps(shown, indent=1))
        return report

    with mesh_ctx as mesh, use_mesh(mesh):
        metrics = train(arch, tcfg, data, heartbeat_dir=args.heartbeat_dir,
                        device=args.device)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
