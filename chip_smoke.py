#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
CUDA PyTorch (no JAX needed). Phases, each printed as JSON lines:

1. env      the card, torch/CUDA versions, TF32 flags (set off);
2. build    the GR-MAC kernel built from ``src/repro_torch/csrc`` (nvcc
            time, registers / shared memory / spills per instance);
3. parity   the kernel against its plain version on the card at the
            main path's shapes, ragged shapes and other formats: bitwise
            at FP6_E3M2 x FP4_E2M1, within rtol = atol = 1e-5 elsewhere;
4. timing   kernel and plain-version times (CUDA events) at the row
            main-path shapes, beside the least time the card could take;
5. serve    ``Engine`` serving paper-cim-120m at full width from seeded
            random weights: 8 requests, 32 greedy steps; every launch of
            the run is a kernel launch of the main path (85 per forward);
6. profile  three more decode steps under ``torch.profiler``: the
            device's idle share and the top kernels and host operators;
7. oracle   the same run with ``cim_backend="ref"`` (plain version on the
            card): its token streams must be identical, a forward's
            logits must be finite and equal between the two, and a small
            model's logits on the card must match the CPU's.

Then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` prints them, and a last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; so does a machine without a CUDA card, or a directory without
the port's sources.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
SEED = 0

# H100 SXM data sheet (dense): HBM rate, bf16 tensor-core and f32 peaks.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
# f32 operations of one (row, block, col) epilogue in row granularity:
# scale, divide, 1/delta, rint, *delta, max, min, renorm scale, product,
# accumulate (an IEEE division counted as one).
EPILOGUE_OPS = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel instance from nvcc's -Xptxas -v."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"grmac_kernelI((?:Li-?\d+E)+)E", line)
        if "Compiling entry function" in line and m:
            name = "<" + ",".join(re.findall(r"Li(-?\d+)E", m.group(1))) + ">"
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"grmac_kernel{name} (n_r,gran,BM,BN,TM,TN): "
                       f"{regs} regs, {smem.group(1) if smem else 0} B smem, "
                       f"{spills}")
            name = None
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(m: int, k: int, n: int, n_r: int):
    """The least time the card could take for one (m, k) @ (k, n) GR-MAC
    call: each input read once and the output written once at the HBM
    rate, against the values dot on the bf16 tensor cores (exact for these
    formats) and the per-(row, block, col) epilogue on the f32 pipe."""
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_S
    t_ops = max(2 * m * k * n / BF16_TC_FLOPS,
                EPILOGUE_OPS * m * (k // n_r) * n / F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.device import require_full_f32
    from repro_torch.core.formats import (FP4_E2M1, FP6_E2M3, FP6_E3M2,
                                          FP8_E4M3, quantize)
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import build, grmac_matmul_cuda
    from repro_torch.kernels.ref import grmac_matmul_ref
    from repro_torch.models import forward, init_params
    from repro_torch.serving import Engine, ServeConfig

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]

    # ---------------------------------------------------------------- env
    require_full_f32()
    emit({"phase": "env", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    # -------------------------------------------------------------- build
    info = build()
    emit({"phase": "build", "seconds": info.seconds, "library": info.path,
          "ptxas": ptxas_summary(info.ptxas)})

    # ------------------------------------------------------------- parity
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operands(m, k, n, fmt_w):
        x = torch.rand((m, k), generator=gen, device=dev) * 2 - 1
        w = torch.rand((k, n), generator=gen, device=dev) * 2 - 1
        return x, quantize(w, fmt_w)

    main_fmt = (FP6_E3M2, FP4_E2M1)
    cases = []
    for gran in ("row", "conv", "unit"):
        for m in (8, 512):
            for k, n in ((768, 3072), (3072, 768), (768, 32000)):
                cases.append((gran, m, k, n, 32, main_fmt))
        cases.append((gran, 5, 100, 100, 32, main_fmt))
        for n_r in (16, 64, 128):
            cases.append((gran, 64, 768, 768, n_r, main_fmt))
        cases.append((gran, 64, 768, 768, 32, (FP8_E4M3, FP4_E2M1)))
        cases.append((gran, 37, 200, 300, 32, (FP6_E2M3, FP6_E2M3)))
    max_abs_err = 0.0
    bad = []
    for gran, m, k, n, n_r, (fx, fw) in cases:
        x, w = operands(m, k, n, fw)
        kw = dict(fmt_x=fx, fmt_w=fw, n_r=n_r, enob=8.0, granularity=gran)
        got = grmac_matmul(x, w, **kw)           # the kernel (K padded)
        torch.cuda.synchronize()
        want = grmac_matmul(x, w, backend="ref", **kw)
        diff = (got - want).abs()
        mism = int((got != want).sum())
        mad = float(diff.max())
        bitwise = (fx, fw) == main_fmt
        ok = (mism == 0) if bitwise else bool(
            torch.all(diff <= TOL + TOL * want.abs()))
        max_abs_err = max(max_abs_err, mad)
        emit({"phase": "parity", "granularity": gran, "m": m, "k": k, "n": n,
              "n_r": n_r, "fmt_x": fx.name, "fmt_w": fw.name,
              "mismatches": mism, "max_abs_diff": mad,
              "bitwise_required": bitwise, "ok": ok})
        if not ok:
            bad.append((gran, m, k, n, n_r, fx.name, fw.name))
        del x, w, got, want, diff
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ------------------------------------------------------------- timing
    arch = get_config("paper-cim-120m")
    d, f, v, n_layers = arch.d_model, arch.d_ff, arch.vocab_size, arch.n_layers
    # (name, K, N, launches per forward) of the row main path
    projections = [("wq/wk/wv/wo", d, d, 4 * n_layers),
                   ("mlp wi/wg", d, f, 2 * n_layers),
                   ("mlp wo", f, d, n_layers),
                   ("lm head", d, v, 1)]
    if sum(p[3] for p in projections) != 85:
        fail("paper-cim-120m no longer has 85 projections per forward")
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity="row")
    shapes = []
    totals = {}
    for phase_name, m in (("decode", 8), ("prefill", 512)):
        # bound_ms split by the term that sets each launch's bound
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bytes_bound_ms": 0.0, "operations_bound_ms": 0.0}
        for name, k, n, per_fwd in projections:
            # rotate over copies so that every launch finds its weights cold
            # in the 50 MB L2, as one forward over 551 MB of weights does
            copies = max(1, math.ceil(2 * 50e6 / (4 * k * n)))
            xs = [operands(m, k, n, FP4_E2M1)[0] for _ in range(min(copies, 4))]
            ws = [operands(1, k, n, FP4_E2M1)[1] for _ in range(copies)]
            t_kernel = cuda_ms(lambda i: grmac_matmul_cuda(
                xs[i % len(xs)], ws[i % copies], **kw), 50)
            t_plain = cuda_ms(lambda i: grmac_matmul_ref(
                xs[i % len(xs)], ws[i % copies], **kw),
                5 if m * n >= 512 * 32000 else 20)
            b_ms, b_by = bound_ms(m, k, n, 32)
            rec = {"phase": "timing", "path": phase_name, "projection": name,
                   "m": m, "k": k, "n": n, "launches_per_forward": per_fwd,
                   "ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None, "card": card}
            emit(rec)
            shapes.append(rec)
            tot["ms"] += per_fwd * t_kernel
            tot["plain_ms"] += per_fwd * t_plain
            tot["bound_ms"] += per_fwd * b_ms
            tot[f"{b_by}_bound_ms"] += per_fwd * b_ms
            del xs, ws
        totals[phase_name] = tot
        emit({"phase": "timing", "path": phase_name,
              "per_forward_85_launches": tot, "card": card})
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- serve
    params = init_params(arch, SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, v, n)]
               for n in (5, 8, 12, 17, 24, 33, 40, 60)]
    n_steps = 32

    def serve(backend):
        engine = Engine(arch, params,
                        ServeConfig(batch_slots=8, max_ctx=512,
                                    cim_backend=backend), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_ms, decode_ms = [], []
        for p in prompts:
            t0 = time.perf_counter()
            engine.add_request(p)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
        for _ in range(n_steps):
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        return engine, prefill_ms, decode_ms, torch.cuda.max_memory_allocated()

    grmac_matmul_cuda.launches = 0
    engine, prefill_ms, decode_ms, peak = serve(None)
    launches = grmac_matmul_cuda.launches
    dispatches = (engine.stats["prefill_dispatches"]
                  + engine.stats["decode_steps"])
    streams = [list(t) for t in engine.tokens]
    emit({"phase": "serve", "arch": arch.name, "batch_slots": 8,
          "max_ctx": 512, "prompt_lens": [len(p) for p in prompts],
          "stats": engine.stats, "kernel_launches": launches,
          "expected_launches": 85 * dispatches,
          "prefill_ms": prefill_ms, "decode_ms": decode_ms,
          "decode_ms_median": float(np.median(decode_ms)),
          "decode_tok_s_median": 8e3 / float(np.median(decode_ms)),
          "peak_mem_bytes": peak, "card": card})
    if launches != 85 * dispatches:
        fail(f"{launches} kernel launches for {dispatches} dispatches "
             f"(expected 85 each)")
    if any(len(s) != len(p) + 1 + n_steps for s, p in zip(streams, prompts)):
        fail("a request did not emit 1 + n_steps tokens")
    if not all(0 <= t < v for s in streams for t in s):
        fail("a token id outside the vocabulary")

    # ------------------------------------------------------------ profile
    # three more decode steps of the same engine under torch.profiler: the
    # device's busy share of the wall time and the top kernels by time
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side entries only: an operator's own row repeats its kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    emit({"phase": "profile", "decode_steps": 3, "wall_us": wall_us,
          "device_busy_us": busy_us,
          "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
          "top_device": [(e.key, e.count, dev_us(e)) for e in top_dev],
          "top_cpu_self": [(e.key, e.count, e.self_cpu_time_total)
                           for e in top_cpu],
          "card": card})

    # ------------------------------------------------------------- oracle
    grmac_matmul_cuda.launches = 0
    oracle, o_prefill_ms, o_decode_ms, o_peak = serve("ref")
    if grmac_matmul_cuda.launches != 0:
        fail("the ref run launched the kernel")
    same = [list(t) for t in oracle.tokens] == streams
    toks = torch.tensor([p[:5] for p in prompts], device=dev)
    logits_k, _, _ = forward(params, toks, arch)
    logits_r, _, _ = forward(params, toks, arch.replace(
        cim=arch.cim.with_backend("ref")))
    finite = bool(torch.isfinite(logits_k).all())
    logits_equal = bool(torch.equal(logits_k, logits_r))
    # the same small model on the CPU (plain version) and on the card
    # (kernel): equal greedy ids, logits within 1e-5 (the devices' torch
    # kernels sum norms, softmax and attention in different orders)
    small = arch.reduced()
    sp_cpu = init_params(small, SEED, device="cpu")
    sp_dev = init_params(small, SEED, device=dev)
    stoks = torch.tensor(rng.integers(0, small.vocab_size, (4, 24)))
    small_cpu = forward(sp_cpu, stoks, small)[0]
    small_dev = forward(sp_dev, stoks.to(dev), small)[0].cpu()
    small_diff = float((small_cpu - small_dev).abs().max())
    small_ids_equal = bool(torch.equal(small_cpu.argmax(-1),
                                       small_dev.argmax(-1)))
    emit({"phase": "oracle", "streams_equal": same,
          "prefill_ms": o_prefill_ms,
          "decode_ms_median": float(np.median(o_decode_ms)),
          "peak_mem_bytes": o_peak,
          "forward_logits_shape": list(logits_k.shape),
          "forward_logits_finite": finite,
          "forward_logits_equal": logits_equal,
          "small_cpu_vs_card_max_abs_diff": small_diff,
          "small_cpu_vs_card_ids_equal": small_ids_equal})
    if not same:
        fail("token streams differ from the plain version's on the card")
    if not finite or tuple(logits_k.shape) != (8, 5, v) or not logits_equal:
        fail("forward logits are not finite, of shape (8, 5, V) and equal "
             "to the plain version's")
    if small_diff > TOL or not small_ids_equal:
        fail(f"the card disagrees with the CPU on a small input "
             f"(max |diff| {small_diff}, ids equal {small_ids_equal})")

    dec = totals["decode"]
    emit({"kernels": [{
        "name": "grmac_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grmac_matmul.cu",
        "replaces": "src/repro/kernels/grmac_matmul.py:169",
        "tpu_source": "src/repro/kernels/grmac_matmul.py:169",
        "port_source": "src/repro_torch/csrc/grmac_matmul.cu",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "checked_vs_plain": True,
        # times of the 85 row launches of one decode forward (M = 8)
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": ("bytes" if dec["bytes_bound_ms"]
                     >= dec["operations_bound_ms"] else "operations"),
        "library_ms": None,
        "prefill_forward": totals["prefill"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
