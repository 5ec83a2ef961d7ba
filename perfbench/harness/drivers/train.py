"""The training driver: one train step of the port (its model, optimizer
state and ``make_train_step`` function), driven from the seed through its
first steps in set-up and then for a measured window, on batches of the
benchmark's own generator.

Set-up runs steps 1-3 through the window's own call and feed; they are
what the reference follows: each step's loss, the gradients as the
optimizer takes them (the first moment after step 1 over 1 - b1), and
the parameters' change over the three. A step is complete when its loss
reaches the host. The window opens before step 4 and closes at the end
of the first step that ends ``seconds`` or more after it opened.
"""
from __future__ import annotations

import sys
import time
import types

import torch

from perfbench.harness import report, roofline, trace, traffic
from perfbench.harness.spec import reference_model, reference_module
from perfbench.reference import optim
from perfbench.reference.weights import clone, leaves

CHECKED_STEPS = 3
SPANS = ("train_step",)


class Run:
    def __init__(self):
        self.losses = []
        self.grad_norms = {}
        self.delta_norms = {}
        self.spans = []              # (t0, t1) of each window step
        self.t0 = self.t1 = 0.0
        self.slice = None
        self.trace = None


def _norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in leaves(tree)}


def _delta_norms(params, p0) -> dict:
    """Per leaf, the norm of the change from ``p0``."""
    return {p: float(torch.linalg.vector_norm(a.float() - b.float()))
            for (p, a), (_, b) in zip(leaves(params), leaves(p0))}


def drive(cell, seed: int, seconds: float, tracing: bool, device, program,
          *, hook=None) -> tuple:
    cfg, mix = cell.config, cell.mix
    vocab = cfg["arch"]["vocab_size"]
    a = program.arch(cfg)
    params = reference_model(cfg).make_params(seed, device)
    opt_state = program.init_opt_state(params, program.optimizer_config(
        mix["optimizer"]))
    step_fn = program.train_step(a, mix["optimizer"])
    if hook is not None:
        step_fn = hook(step_fn)
    run = Run()
    p0 = clone(params)
    b1 = mix["optimizer"]["b1"]
    for k in range(CHECKED_STEPS):
        batch = traffic.train_batch(mix, vocab, seed, k, device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        run.losses.append(float(m["loss"]))
        if k == 0:
            run.grad_norms = {p: float(torch.linalg.vector_norm(t / (1 - b1)))
                              for p, t in leaves(opt_state["m"])}
    run.delta_norms = _delta_norms(params, p0)
    del p0
    _sync(device)
    setup_end = time.perf_counter()

    lead = min(mix.get("trace_lead_s", 2.0), seconds / 4)
    length = mix.get("trace_seconds", 4.0)
    prof, on = None, False
    k = CHECKED_STEPS
    run.t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if tracing and prof is None and now - run.t0 >= lead:
            _sync(device)
            prof = trace.profiler()
            prof.__enter__()
            on = True
            run.slice = (time.perf_counter(), None)
        t0 = time.perf_counter()
        with trace.span("train_step", on):
            batch = traffic.train_batch(mix, vocab, seed, k, device)
            params, opt_state, m = step_fn(params, opt_state, batch)
            float(m["loss"])
        end = time.perf_counter()
        run.spans.append((t0, end))
        k += 1
        if prof is not None and end - run.slice[0] >= length:
            run.slice = (run.slice[0], time.perf_counter())
            prof.__exit__(None, None, None)
            run.t1 = end
            run.trace = trace.Trace(prof, run.slice[1] - run.slice[0],
                                    SPANS)
            break
        if end - run.t0 >= seconds:
            run.t1 = end
            break
    return run, (params, opt_state), setup_end


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def end_to_end(run: Run, mix: dict) -> dict:
    tokens = len(run.spans) * mix["batch"] * mix["seq_len"]
    return {"train_tok_s": tokens / (run.t1 - run.t0),
            "steps": len(run.spans)}


def model_flops_per_step(config: dict, mix: dict) -> float:
    """6 x matmul weights x tokens, and three times a token's other
    forward flops over the whole sequence (forward and backward; for
    attention 12 L H Dh S a token), by the counts of the configuration's
    reference."""
    arch, ref = config["arch"], reference_module(config)
    tokens = mix["batch"] * mix["seq_len"]
    per_token = (6 * roofline.matmul_params(ref.projections(arch))
                 + 3 * ref.token_flops(arch, mix["seq_len"]))
    return float(per_token * tokens)


def readings(cell, seed: int, device, control: str = None) -> dict:
    """The reference's first three steps on the same batches (in the
    control's precision when ``control`` is given): each step's loss, the
    per-leaf norms of the gradients as the update takes them at step 1,
    and of the parameters' change over the three."""
    cfg, mix = cell.config, cell.mix
    opt = mix["optimizer"]
    vocab = cfg["arch"]["vocab_size"]
    model = reference_model(cfg, "fp8" if control == "fp8" else "f32")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    try:
        params = model.make_params(seed, device)
        p0 = clone(params)
        state = optim.init_state(params)
        losses, grad_norms = [], None
        for k in range(CHECKED_STEPS):
            batch = traffic.train_batch(mix, vocab, seed, k, device)
            ps = [t.detach().requires_grad_(True) for _, t in leaves(params)]
            loss = model.loss(_rebuild(params, ps), batch)
            grads = torch.autograd.grad(loss, ps)
            losses.append(float(loss.detach()))
            params, state, gclip = optim.step(
                _rebuild(params, [p.detach() for p in ps]),
                _rebuild(params, list(grads)), state, opt)
            if k == 0:
                grad_norms = _norms(gclip)
            del ps, grads, gclip
        delta = _delta_norms(params, p0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": delta}


def gaps(got: dict, ref: dict) -> dict:
    """Each number compared: the worst gap over the steps or the leaves,
    against the larger of the reference's leaf and its median leaf."""
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": _worst(got["grad_norms"], ref["grad_norms"]),
            "delta_gap": _worst(got["delta_norms"], ref["delta_norms"],
                                keep=_moving(ref["grad_norms"]))}


def check(cell, seed: int, run: Run, device) -> dict:
    return gaps({"losses": run.losses, "grad_norms": run.grad_norms,
                 "delta_norms": run.delta_norms},
                readings(cell, seed, device))


def _moving(grad_norms: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = sorted(grad_norms.values())[len(grad_norms) // 2]
    return {p for p, g in grad_norms.items() if g >= 1e-3 * med}


def _worst(prog: dict, ref: dict, keep=None) -> float:
    paths = [p for p in ref if keep is None or p in keep]
    med = sorted(ref[p] for p in paths)[len(paths) // 2]
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in paths)


def _rebuild(like, flat: list):
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)
    return go(like)


def result_line(checked: dict, limits: dict) -> tuple:
    checks, correct = {}, True
    for name in ("loss_gap", "grad_gap", "delta_gap"):
        lim = limits.get(name)
        checks[name] = {"value": checked[name], "limit": lim}
        if lim is not None and not checked[name] <= lim:
            correct = False
    if not any(limits.get(n) is not None for n in checks):
        correct = False
    return correct, checks


FAULTS = {
    # the port trains on half of each batch, the mean taken over it
    "half_batch": lambda fn: lambda p, o, b: fn(p, o, {
        k: v[:v.shape[0] // 2] for k, v in b.items()}),
    # the step returns the parameters and optimizer state it was given
    "unchanged": lambda fn: lambda p, o, b: (p, o, fn(p, o, b)[2]),
}


def measure(cell, args, program, t_start: float) -> report.Result:
    """One run of the cell: set-up with the three checked steps, the
    window, the check."""
    run, state, setup_end = drive(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", program)
    dev = report.device_info(cell.chips)
    extra = {}
    if args.trace:
        ts, te = run.slice
        arch = cell.config["arch"]
        ctx = types.SimpleNamespace(
            kind="train", cell=cell, arch=arch,
            n_r=cell.config["cim"]["n_r"],
            projections=reference_module(cell.config).projections(arch),
            run=run, trace=run.trace, slice=run.slice, seconds=te - ts,
            steps=sum(ts <= a and b <= te for a, b in run.spans),
            flops_per_step=model_flops_per_step(cell.config, cell.mix))
        metrics = report.per_layer(cell, ctx)
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        extra["breakdown"] = run.trace.breakdown()
    else:
        metrics = report.end_to_end(cell, end_to_end(run, cell.mix),
                                    setup_end - t_start)
    del state
    report.free_memory()
    t = time.perf_counter()
    correct, checks = result_line(check(cell, args.seed, run, "cuda"),
                                  cell.limits)
    print(f"timing set-up {setup_end - t_start:.3f} s, window "
          f"{run.t1 - run.t0:.3f} s, {len(run.spans)} steps, reference "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return report.Result(correct, len(run.spans) + CHECKED_STEPS, 0,
                         metrics, dev, checks, extra)


def calibrate(cell, seed: int, seconds: float, program, control=None,
              fault=None) -> dict:
    """The program's readings on one seed (the lower), with ``fault``
    ("half_batch" or "unchanged") planted in its step, and with
    ``control`` ("tf32" or "fp8") the control's beside them (the upper)."""
    run, state, _ = drive(cell, seed, seconds, False, "cuda", program,
                          hook=FAULTS[fault] if fault else None)
    line = end_to_end(run, cell.mix)
    del state
    report.free_memory()
    t = time.perf_counter()
    ref = readings(cell, seed, "cuda")
    got = {"losses": run.losses, "grad_norms": run.grad_norms,
           "delta_norms": run.delta_norms}
    line.update(program=gaps(got, ref), ref_s=time.perf_counter() - t,
                losses=run.losses, ref_losses=ref["losses"])
    if control:
        line["control"] = gaps(readings(cell, seed, "cuda", control), ref)
    return line
