"""Batched serving with the GR-CIM inference path + per-token energy report.

The engine prefills each prompt through the chunked bucketed path (the
whole prompt padded to a power-of-two bucket and written into the KV /
recurrent caches at per-slot offsets in one dispatch), and decode takes
the greedy token on the device, so each ``step`` moves one small int32
tensor back to the host. On the card every projection of
``paper-cim-120m`` (85 a forward) runs the GR-MAC kernel; ``--small``
serves the reference example's 4-layer, 256-wide variant.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
          [--small] [--steps 16] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import Engine, ServeConfig, energy_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the reference example's 4-layer variant")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    arch = get_config("paper-cim-120m")
    if args.small:
        arch = arch.replace(
            n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
            d_ff=1024, vocab_size=2048)
    params = init_params(arch, 0, device=args.device)
    eng = Engine(arch, params, ServeConfig(batch_slots=4, max_ctx=128),
                 device=args.device)

    s0 = eng.add_request([1, 2, 3, 4, 5])
    s1 = eng.add_request([10, 20, 30])
    print(f"prefilled slots {s0}, {s1} in "
          f"{eng.stats['prefill_dispatches']} dispatches "
          f"(token-by-token would have used 8); decoding {args.steps} "
          "steps...")
    for step in range(args.steps):
        out = eng.step()   # on-device greedy: one int32 per slot back
        if step % 4 == 0:
            # the typed per-request stream (StepResult.outputs): one
            # RequestOutput per live request, with finish reasons
            print(f"  step {step}: " + ", ".join(
                f"slot {o.slot}: {o.tokens}" for o in out.outputs))
    print("generated:", {s: eng.tokens[s][-8:] for s in (s0, s1)})

    rep = energy_report(arch, device=args.device)   # traced from the model
    print(f"CIM energy: {rep['fj_per_op']:.1f} fJ/Op -> "
          f"{rep['pj_per_token']/1e3:.2f} nJ/token decoded "
          f"(conventional CIM: {rep['conventional_fj_per_op']:.1f} fJ/Op)")
    for site, s in rep["sites"].items():
        print(f"  {site:10s} {s['granularity']:5s} "
              f"{s['pj_per_token']:10.1f} pJ/token")
    return eng


if __name__ == "__main__":
    main()
