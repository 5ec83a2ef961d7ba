"""End-to-end driver: train ``paper-cim-120m`` with the GR-CIM path on
(fake-quant QAT by default; ``--cim grmac`` runs every projection through
the GR-MAC simulation, on the card through its kernel), checkpointing and
resume included.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 300] [--cim grmac] [--small] [--device cpu]
(``--small`` trains the reference example's 15M variant quickly.)
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.training import OptimizerConfig, TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cim", default="fakequant",
                    choices=["off", "fakequant", "grmac"])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    arch = get_config("paper-cim-120m")
    arch = arch.replace(cim=arch.cim.with_mode(args.cim))
    if args.small:
        arch = arch.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                            d_head=64, d_ff=1024, vocab_size=2048)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=arch.vocab_size, seed=0)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=100, log_every=10,
        opt=OptimizerConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps))
    metrics = train(arch, tcfg, SyntheticLM(dcfg, device=args.device),
                    device=args.device)
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
