"""Serving launcher: initializes params and serves batched requests
through the slot engine (bucketed chunked prefill by default;
``--prefill-mode token`` runs one dispatch a prompt token); the port's
counterpart of ``repro.launch.serve``, printing the same lines. Runs on
the card unless ``--device cpu``.

``--traffic N`` switches to open-loop serving: N seeded Poisson arrivals
at ``--rate`` requests/s go through the continuous-batching ``Scheduler``
on the wall clock, printing each request's stream summary as it finishes
and the TTFT/TPOT percentiles and goodput at the end.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --reduced --tokens 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-cim-120m \
        --slots 8 --ctx 512 --traffic 16
"""
import argparse
import time
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving.engine import Engine, ServeConfig, energy_report
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           run_open_loop, synth_traffic)


def _serve_traffic(arch, params, args) -> dict:
    eng = Engine(arch, params, ServeConfig(batch_slots=args.slots,
                                           max_ctx=args.ctx),
                 device=args.device)
    spec = None
    if args.spec_k > 1:
        from repro_torch.serving.speculative import SpecConfig
        spec = SpecConfig(k=args.spec_k, draft=args.spec_draft)
    sched = Scheduler(
        eng, SchedulerConfig(prefill_token_budget=args.prefill_budget),
        spec=spec)
    traffic = synth_traffic(args.traffic, args.rate, seed=args.seed,
                            vocab_size=arch.vocab_size,
                            prompt_len=(8, 48),
                            out_len=(4, args.tokens))
    t0 = time.perf_counter()
    run_open_loop(sched, traffic)
    wall = time.perf_counter() - t0
    for r in sorted(sched.finished, key=lambda r: r.rid):
        print(f"req {r.rid:3d}: prompt={len(r.prompt):3d} tok, "
              f"generated={r.n_generated:3d} ({r.finish_reason}), "
              f"ttft={1e3 * (r.ttft_wall or 0.0):7.1f} ms, "
              f"tpot={1e3 * (r.tpot_wall or 0.0):6.2f} ms"
              + (f", preempted x{r.preemptions}" if r.preemptions else ""))
    m = sched.metrics(slo_ttft=None)
    print(f"\ntraffic: {m['completed']} completed / {m['rejected']} rejected "
          f"in {wall:.2f} s at {args.rate:g} req/s "
          f"({m['decode_steps']} decode steps, "
          f"{m['prefill_dispatches']} prefill dispatches, "
          f"queue depth max {m['queue_depth_max']})")
    print(f"TTFT p50/p99: {m['ttft_p50_ms']:.1f}/{m['ttft_p99_ms']:.1f} ms | "
          f"TPOT p50/p99: {m['tpot_p50_ms']:.2f}/{m['tpot_p99_ms']:.2f} ms | "
          f"goodput {m['goodput_tok_s']:.1f} tok/s")
    if m["spec_steps"]:
        print(f"spec: {m['accepted_tokens_per_step']:.2f} accepted "
              f"tok/step over {m['spec_steps']} steps "
              f"({m['draft_dispatches']} draft / "
              f"{m['verify_dispatches']} verify / "
              f"{m['repair_dispatches']} repair dispatches)")
    if arch.cim.enabled:
        print(f"energy: {m['pj_per_token']:.1f} pJ/token "
              f"({m['energy_pj'] / 1e6:.2f} uJ total decode)")
    return {"mode": "traffic", "metrics": m, "wall_s": wall,
            "streams": {r.rid: list(r.generated) for r in sched.finished},
            "engine_stats": dict(eng.stats),
            "engine_graph_stats": dict(eng.graph_stats)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--cim", default="off")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=256)
    ap.add_argument("--prefill-mode", default="bucketed",
                    choices=["bucketed", "token"])
    ap.add_argument("--traffic", type=int, default=0, metavar="N",
                    help="serve N open-loop Poisson arrivals through the "
                         "continuous-batching scheduler instead of the "
                         "fixed two-prompt demo")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="--traffic arrival rate, requests per second")
    ap.add_argument("--prefill-budget", type=int, default=16,
                    help="--traffic prefill tokens interleaved per step")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="speculative lookahead for --traffic serving "
                         "(1 = sequential decode; k >= 2 drafts k-1 "
                         "tokens per iteration and verifies them in one "
                         "chunked dispatch)")
    ap.add_argument("--spec-draft", default="digital",
                    choices=["digital", "self"],
                    help="draft policy for --spec-k: 'digital' drafts "
                         "with the CIM path off, 'self' with the target "
                         "config itself")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         params: Optional[dict] = None) -> dict:
    """Run the launcher; returns what it served (the demo's step results
    or the traffic's metrics and streams). ``params`` replaces the seeded
    ``init_params(arch, 0)`` weights (a parity run passes the
    reference's)."""
    args = parse_args(argv)
    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.cim != "off":
        arch = arch.replace(cim=arch.cim.with_mode(args.cim))
    if params is None:
        params = init_params(arch, 0, device=args.device)
    if args.traffic:
        return _serve_traffic(arch, params, args)
    eng = Engine(arch, params, ServeConfig(batch_slots=args.slots,
                                           max_ctx=args.ctx,
                                           prefill_mode=args.prefill_mode),
                 device=args.device)
    t0 = time.perf_counter()
    eng.add_request(list(range(1, 9)))
    eng.add_request(list(range(20, 24)))
    out = eng.step()
    print(f"TTFT (2 prompts, incl. compile): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"({eng.stats['prefill_dispatches']} prefill dispatches, "
          f"mode={args.prefill_mode})")

    def fmt(res):   # the typed per-request stream, not the raw dict
        return ", ".join(f"slot {o.slot}: {o.tokens}"
                         + (f" <{o.finish_reason}>" if o.finished else "")
                         for o in res.outputs)

    print(f"step 0: {fmt(out)}")
    steps = [out]
    for i in range(1, args.tokens):
        out = eng.step()
        steps.append(out)
        if i % 8 == 0:
            print(f"step {i}: {fmt(out)}")
    result = {"mode": "demo", "steps": steps,
              "engine_stats": dict(eng.stats),
              "engine_graph_stats": dict(eng.graph_stats)}
    if arch.cim.enabled:
        # ledger-derived, per phase: the serving deployment metric next to
        # the serving stats (decode aliases at top level)
        rep = energy_report(arch, device=args.device)
        print(f"energy (decode): {rep['pj_per_token']:.1f} pJ/token at "
              f"{rep['fj_per_op']:.1f} fJ/Op "
              f"(conventional {rep['conventional_fj_per_op']:.1f} fJ/Op)")
        for phase, ph in rep["phases"].items():
            print(f"  {phase:8s} {ph['pj_per_token']:12.1f} pJ/token "
                  f"({ph['analog_ops_per_token']:.3g} analog Ops/token)")
        engine_pj = eng.energy_per_token()["pj_per_token"]
        print(f"engine pj/token: {engine_pj:.1f}")
        result.update(energy=rep, engine_pj_per_token=engine_pj)
    return result


if __name__ == "__main__":
    main()
