#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
CUDA PyTorch (no JAX needed). Phases, each printed as JSON lines with its
seconds:

1. env      the card, torch/CUDA versions, TF32 flags (set off);
1b. energy  the energy model (``energy_phase``): the paper's ADC and
            energy claims C2, C3, C6 and C8 solved by a generator on the
            card and by one on the CPU (the card's ENOBs within ``MC_TOL``
            of the CPU's), and the cost ledgers of all 11 configs at full
            width traced on ``meta`` (decode, a 64-token prefill, the train
            forward), each phase's ops per token equal to
            ``experiments/bench/e2e_energy_smoke.json``; the RG-LRU and SSM
            configs' train phase waits for the training slice;
2. build    the GR-MAC kernel built from ``src/repro_torch/csrc`` (one
            nvcc per source, in parallel; registers / shared memory /
            spills per instance);
3. parity   each of the kernel's designs (decode, prefill) against its
            plain version on the card at the served models' shapes
            (paper-cim-120m's, and gemma3-1b's, mamba2-1.3b's and
            recurrentgemma-9b's new ones: N = 64 and 256, K = 1152, 4096
            and 6912, the 262 144-wide tied head), ragged shapes, the n_r
            ladder and other formats (an fmt_x bf16 cannot hold goes
            through the decode design, its only route): bitwise at
            FP6_E3M2 x FP4_E2M1, within rtol = atol = 1e-5 elsewhere; the
            shapes of the MoE and other dense configs (the routers, N = 8
            and 128 at K = 6144 and 7168; attention and FFNs at K up to
            22 016; every head, up to 151 936 columns) at M = 8 and 40,
            each through the design the kernel picks, bitwise; and
            ``cim_matmul`` with prepared (packed) weights against the
            per-call path, bitwise, the routers' with f32 weights;
4. timing   kernel (packed weights, fused pre/post-scale; CUDA-graph
            replay, and an eager loop that also pays the host's cost per
            call) and plain-version times (CUDA events) at the row
            projections of paper-cim-120m (M = 8, 512, and 64 in both
            designs), gemma3-1b (M = 8 and 128) and grok-1-314b (M = 8 and
            64: attention, router, head), beside the least time
            the card could take with the weights at their stored bits and,
            for comparison, as f32;
5. serve    one path per model, each from seeded random weights with every
            projection through GR-MAC row (FP6_E3M2 x FP4_E2M1, n_r 32,
            ENOB 8), 8 slots of greedy traffic, the launch counts set to 0
            just before and read just after (they must be the model's
            projections per forward times its dispatches):
              serve              paper-cim-120m, full width and depth,
                                 32 decode steps (85 launches a forward);
              serve_gemma3       gemma3-1b, full width and depth (183),
                                 max_ctx 1024, prompts past the 512-token
                                 window: the rings wrap inside a chunked
                                 prefill and in decode;
              serve_mamba2       mamba2-1.3b, full width and depth (193);
              serve_recurrentgemma  recurrentgemma-9b at full width, depth
                                 cut from 38 layers to one super-block
                                 (rglru, rglru, local; 22);
              serve_grok         grok-1-314b (MoE, 8 experts top-2) at full
                                 width, depth cut from 64 layers to the
                                 deepest that fits beside the plain-version
                                 oracle (5 launches a layer + 1: attention
                                 and the router; the experts are digital);
                                 decode must drop assignments past an
                                 expert's capacity, and the kernel and the
                                 plain version must drop the same number;
            then, for each path: a profile of three more decode steps
            (device idle share, CUDA launches per step, which must equal
            ``STEP_LAUNCHES``, top kernels and host operators); the same traffic through the plain version
            on the card (``cim_backend="ref"``), whose token streams must
            be identical; and the model's reduced config (drawn on the
            CPU, moved to the card) on the CPU and on the card, whose
            logits must agree within 1e-5 (5e-5 for recurrentgemma, whose
            RG-LRU amplifies an ulp of exp); arctic-480b's reduced config
            with grok's; for paper-cim-120m, the last step result's
            ``pj_per_token`` (priced on that first read), which must equal
            ``energy_report``'s and lie within ``MC_TOL`` of the committed
            ``experiments/bench/e2e_energy.json``, its fJ/Op too;
6. forward_musicgen  musicgen-medium (embedding inputs, GELU MLP) at full
            width and depth: seeded (8, S, 1536) embeddings through
            ``prefill_step`` and decode steps, through the kernel and
            through the plain version: equal ids, finite logits; and its
            reduced config on the CPU and on the card.

Full-width weights are drawn by a generator on the card (``init_params``
on the card), so a 10 GB grok layer takes no host time.

Then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` prints them, and a last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; so does a machine without a CUDA card, or a directory without
the port's sources.
"""
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
SEED = 0
SLOTS = 8
# The CPU-against-card bound of a reduced config where 1e-5 cannot hold:
# RG-LRU takes sqrt(1 - a^2) at a = exp(log a) up to 0.999, where one ulp
# of a moves the factor by 3e-5 of its value, so the two devices' exp, an
# ulp apart, part the reduced recurrentgemma's logits by up to 1.8e-5
# (measured on an H100 against its host's CPU).
SMALL_ATOL = {"recurrentgemma-9b": 5e-5}
# memory kept free beside grok's weights and its oracle's head temporaries
GROK_MARGIN = 4e9
# Monte-Carlo tolerances of the energy phase: twice the spread (max - min)
# that the JAX package's own estimates show over seeds 0-7 at the same
# n_cols, rounded up to three digits (tests/test_torch_energy.py
# recomputes each spread from the JAX package and holds these to it):
#   enob_uniform_16384   ENOB bits, required_enob at 2**14 columns, uniform
#                        input, FPFormat(ne, 2), ne 2-4, conv and gr_unit
#                        (claims C2 and C8)
#   enob_outliers_16384  ENOB bits, the same under gaussian_outliers at
#                        FPFormat(3, 2) (claim C3)
#   enob_narrowest_4096  ENOB bits, solve_required_enob at 2**12 columns,
#                        FP6_E3M2, conv / gr_row / gr_unit (claim C6)
#   pj_per_token_2048    pJ, paper-cim-120m's decode pJ/token at 2**11
#                        columns (the engine's default)
#   fj_per_op_2048       fJ/Op, the same report's GR fJ/Op
MC_TOL = {"enob_uniform_16384": 0.0782, "enob_outliers_16384": 0.260,
          "enob_narrowest_4096": 0.0879, "pj_per_token_2048": 711000.0,
          "fj_per_op_2048": 2.58}

# CUDA launches a decode step of each serve path (grok's at its cut of 4
# layers) as counted before the energy model's hooks: they must add none
STEP_LAUNCHES = {"serve": 1011, "serve_gemma3": 3008, "serve_mamba2": 3383,
                 "serve_recurrentgemma": 298, "serve_grok": 608}

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
        m = re.search(r"(decode|prefill)_kernelI((?:Li-?\d+E)+)E", line)
        if "Compiling entry function" in line and m:
            name = m.group(1) + "<" + ",".join(
                re.findall(r"Li(-?\d+)E", m.group(2))) + ">"
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} regs, "
                       f"{smem.group(1) if smem else 0} B static smem, "
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


def graph_ms(fn, iters: int, reps: int = 5):
    """Mean ms per call of ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times (CUDA events around the replays): the device's
    time for back-to-back launches, without the host's cost of issuing
    each call, which a loop of eager calls would measure instead."""
    import torch

    fn(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def bound_ms(m: int, k: int, n: int, n_r: int, w_bits: float = 32):
    """The least time the card could take for one (m, k) @ (k, n) GR-MAC
    call: each input read once (x f32, the weights at ``w_bits`` each) and
    the output written once at the HBM rate, against the values dot on the
    bf16 tensor cores (exact for these formats) and the per-(row, block,
    col) epilogue on the f32 pipe."""
    t_bytes = (4 * (m * k + m * n) + k * n * w_bits / 8) / HBM_BYTES_S
    t_ops = max(2 * m * k * n / BF16_TC_FLOPS,
                EPILOGUE_OPS * m * (k // n_r) * n / F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def projections(arch) -> list:
    """(name, K, N, launches per forward) of every CIM projection of one
    forward, the LM head last: the kernel's launches per dispatch."""
    d, f = arch.d_model, arch.d_ff
    ffn = 3 if arch.gated_mlp else 2
    count = {k: arch.blocks().count(k) for k in ("attn", "local", "rglru",
                                                 "ssm")}
    n_att = count["attn"] + count["local"]
    w, di = arch.rnn_width, arch.d_inner
    qd, kvd = arch.n_heads * arch.d_head, arch.n_kv_heads * arch.d_head
    out = []
    if n_att:
        out += [("attn wq", d, qd, n_att), ("attn wk/wv", d, kvd, 2 * n_att),
                ("attn wo", qd, d, n_att)]
    if count["rglru"]:
        out += [("rglru in/gate_r/gate_i", d, w, 3 * count["rglru"]),
                ("rglru out_proj", w, d, count["rglru"])]
    if count["ssm"]:
        n = count["ssm"]
        out += [("ssm in_proj", d, 2 * di, n),
                ("ssm bc_proj", d, 2 * arch.ssm_state, n),
                ("ssm dt_proj", d, arch.ssm_heads, n),
                ("ssm out_proj", di, d, n)]
    n_ffn = n_att + count["rglru"]
    if n_ffn and arch.is_moe:
        # the router; arctic's dense residual MLP; the experts are digital
        out += [("moe router", d, arch.n_experts, n_ffn)]
        if arch.moe_dense_residual:
            out += [("dense residual wi/wg", d, f, (ffn - 1) * n_ffn),
                    ("dense residual wo", f, d, n_ffn)]
    elif n_ffn:
        out += [("mlp wi/wg", d, f, (ffn - 1) * n_ffn),
                ("mlp wo", f, d, n_ffn)]
    return out + [("lm head", d, arch.padded_vocab, 1)]


def per_forward(arch) -> int:
    return sum(p[3] for p in projections(arch))


def grok_depth(arch) -> int:
    """The deepest cut of grok-1-314b whose bf16 weights fit on the card
    beside the plain-version oracle's largest moment, its LM head at M = 64
    (8 slots x chunks of 8): the head weight three times as f32 (the
    per-call path's copy, its pre-scaled copy and their quantized grid)
    and four (K / n_r, M, N) f32 block temporaries; with GROK_MARGIN
    bytes to spare."""
    import torch

    d, e, f, v = arch.d_model, arch.n_experts, arch.expert_d_ff, \
        arch.padded_vocab
    qd, kvd = arch.n_heads * arch.d_head, arch.n_kv_heads * arch.d_head
    layer = 2 * (3 * e * d * f + d * (qd + 2 * kvd) + qd * d + 2 * d) \
        + 4 * d * e
    fixed = 2 * 2 * v * d + 3 * 4 * d * v + 4 * 4 * (d // 32) * 64 * v
    free = torch.cuda.mem_get_info()[0]
    return max(2, min(arch.n_layers,
                      int((free - GROK_MARGIN - fixed) // layer)))


def energy_phase(dev, card: str) -> None:
    """The energy model on ``dev`` against the CPU, and the ledgers.

    The paper's ADC claims, each solve drawn by a generator on ``dev`` and
    by one on the CPU from the same seed (different streams): C2 (conv -
    gr_unit >= 1.3 b at FPFormat(ne, 2), ne 2-4, uniform input), C3 (> 6 b
    at FPFormat(3, 2) under gaussian_outliers), C8 (gr_unit below the
    thermal crossover, itself 9.5-10.5 b) and C6 (evaluate_point at
    FP6_E3M2, 2**12 columns: GR < 40 fJ/Op, conv > 100). Each must hold on
    both, and every ENOB of ``dev`` lie within ``MC_TOL`` of the CPU's.
    Then the ledgers of all 11 configs at full width, traced on ``meta``:
    decode (batch 1, ctx 128), a 64-token prefill and the train forward;
    each phase's ops per token must equal the committed energy smoke
    record exactly. The RG-LRU and SSM configs' train forward is not
    ported: their train phase is reported as waiting, not passed."""
    import torch

    from repro_torch.configs import get_config, list_configs
    from repro_torch.core import adc, costs, dse
    from repro_torch.core import distributions as D
    from repro_torch.core.energy import TechParams
    from repro_torch.core.formats import FP6_E3M2, FPFormat

    def claims(device):
        gen = torch.Generator(device=device).manual_seed(SEED)
        t0 = time.perf_counter()
        enob = {}
        for ne in (2, 3, 4):
            for arch in ("conv", "gr_unit"):
                enob[f"uniform/{arch}/E{ne}M2"] = adc.required_enob(
                    gen, arch, D.uniform(), FPFormat(ne, 2)).enob
        for arch in ("conv", "gr_unit"):
            enob[f"outliers/{arch}/E3M2"] = adc.required_enob(
                gen, arch, D.gaussian_outliers(), FPFormat(3, 2)).enob
        pt = dse.evaluate_point(torch.Generator(device=device).manual_seed(2),
                                FP6_E3M2, n_cols=1 << 12)
        enob["narrowest/conv/E3M2"] = pt.enob_conv
        enob["narrowest/gr/E3M2"] = pt.enob_gr
        if device.type == "cuda":
            torch.cuda.synchronize()
        return {"enob": enob, "c6_gr_fj_per_op": pt.gr.total,
                "c6_gr_arch": pt.gr_arch,
                "c6_conv_fj_per_op": pt.conv.total,
                "seconds": time.perf_counter() - t0}

    ncross = TechParams().n_cross()
    runs = {"on_card": claims(dev), "on_cpu": claims(torch.device("cpu"))}
    failed = []
    for where, r in runs.items():
        e = r["enob"]
        c2 = min(e[f"uniform/conv/E{ne}M2"] - e[f"uniform/gr_unit/E{ne}M2"]
                 for ne in (2, 3, 4))
        c3 = e["outliers/conv/E3M2"] - e["outliers/gr_unit/E3M2"]
        c8 = max(e[f"uniform/gr_unit/E{ne}M2"] for ne in (2, 3, 4))
        r["claims"] = {
            "C2_min_conv_minus_gr_unit_bits": c2, "C2_holds": c2 >= 1.3,
            "C3_conv_minus_gr_unit_bits": c3, "C3_holds": c3 > 6.0,
            "C8_max_gr_unit_bits": c8, "n_cross_bits": ncross,
            "C8_holds": bool(c8 < ncross and 9.5 < ncross < 10.5),
            "C6_holds": bool(r["c6_gr_fj_per_op"] < 40.0
                             and r["c6_conv_fj_per_op"] > 100.0)}
        failed += [f"{where} {k}" for k, v in r["claims"].items()
                   if k.endswith("_holds") and not v]
    tol = {"uniform": MC_TOL["enob_uniform_16384"],
           "outliers": MC_TOL["enob_outliers_16384"],
           "narrowest": MC_TOL["enob_narrowest_4096"]}
    diff = {k: runs["on_card"]["enob"][k] - runs["on_cpu"]["enob"][k]
            for k in runs["on_cpu"]["enob"]}
    far = [k for k, d in diff.items() if abs(d) > tol[k.split("/")[0]]]
    emit({"phase": "energy_claims", "device": str(dev), **runs,
          "card_minus_cpu_enob": diff, "tolerance_bits": tol,
          "outside_tolerance": far, "card": card})
    if failed or far:
        fail(f"energy: claims failed {failed}, card against CPU outside the "
             f"Monte-Carlo tolerance {far}")

    smoke = json.loads((ROOT / "experiments" / "bench"
                        / "e2e_energy_smoke.json").read_text())
    traces = (("decode", lambda a: costs.trace_decode(a, batch=1, ctx=128),
               lambda a: 1),
              ("prefill", lambda a: costs.trace_prefill(a, bucket=64),
               lambda a: 64),
              ("train", costs.trace_train, costs.default_train_seq))
    bad, waiting = [], []
    for name in list_configs():
        arch = get_config(name)
        if not arch.cim.enabled:
            arch = arch.replace(cim=arch.cim.with_mode("grmac"))
        row = {"phase": "energy_ledger", "arch": name, "card": card}
        for phase, trace, tokens in traces:
            t0 = time.perf_counter()
            try:
                ledger = trace(arch)
            except NotImplementedError as e:
                if phase != "train" or "training slice" not in str(e):
                    raise
                row[phase] = "waits for item 9 (the RG-LRU / SSM train forms)"
                waiting.append(name)
                continue
            got = 2 * ledger.macs() / tokens(arch)
            want = smoke[name]["phases"][phase]["ops_per_token"]
            row[phase] = {"ops_per_token": got, "record": want,
                          "equal": got == want, "entries": len(ledger),
                          "trace_seconds": time.perf_counter() - t0}
            if got != want:
                bad.append((name, phase, got, want))
        emit(row)
    emit({"phase": "energy_ledgers", "configs": len(list_configs()),
          "phases_equal": 3 * len(list_configs()) - len(waiting) - len(bad),
          "waiting": waiting, "mismatched": bad})
    if bad or sorted(waiting) != ["mamba2-1.3b", "recurrentgemma-9b"]:
        fail(f"energy: ledger op counts differ from the record {bad}, or "
             f"unexpected phases wait {waiting}")


def main() -> int:
    # The plain-version oracles allocate and free (K / n_r, M, N) block
    # temporaries of several GB between small ones; expandable segments
    # keep the allocator's cache from fragmenting around them (grok's
    # oracle ran out with 11 GiB reserved but unallocated without).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
                                          FP8_E4M3, FPFormat, quantize)
    from repro_torch.core.cim_config import CIMConfig
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import (DESIGNS, build,
                                                  grmac_matmul_cuda)
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.kernels.packed import pack_weight, unpack_weight
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, pack_params, prefill_step,
                                    to_device)
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import Engine, ServeConfig, energy_report

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    t_start = time.perf_counter()
    t_phase = [t_start]

    def seconds(name):
        now = time.perf_counter()
        emit({"phase": "seconds", "of": name, "seconds": now - t_phase[0],
              "since_start": now - t_start, "card": card})
        t_phase[0] = now

    def reset_counts():
        grmac_matmul_cuda.launches = 0
        grmac_matmul_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)

    # ---------------------------------------------------------------- env
    require_full_f32()
    emit({"phase": "env", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    archs = {name: get_config(name) for name in (
        "paper-cim-120m", "gemma3-1b", "mamba2-1.3b", "recurrentgemma-9b",
        "grok-1-314b", "musicgen-medium")}
    archs["recurrentgemma-9b"] = archs["recurrentgemma-9b"].replace(
        n_layers=3)
    grok_layers = grok_depth(archs["grok-1-314b"])
    archs["grok-1-314b"] = archs["grok-1-314b"].replace(n_layers=grok_layers)
    for name, want in (("paper-cim-120m", 85), ("gemma3-1b", 183),
                       ("mamba2-1.3b", 193), ("recurrentgemma-9b", 22),
                       ("grok-1-314b", 5 * grok_layers + 1),
                       ("musicgen-medium", 289)):
        if per_forward(archs[name]) != want:
            fail(f"{name} no longer has {want} projections per forward")

    # ------------------------------------------------------------- energy
    energy_phase(dev, card)
    seconds("energy")

    # -------------------------------------------------------------- build
    info = build()
    emit({"phase": "build", "seconds": info.seconds, "library": info.path,
          "ptxas": ptxas_summary(info.ptxas)})
    seconds("build")

    # ------------------------------------------------------------- parity
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operands(m, k, n, fmt_w):
        x = torch.rand((m, k), generator=gen, device=dev) * 2 - 1
        w = torch.rand((k, n), generator=gen, device=dev) * 2 - 1
        return x, quantize(w, fmt_w)

    main_fmt = (FP6_E3M2, FP4_E2M1)
    wide = (FPFormat(3, 10), FP4_E2M1)   # bf16 would round fmt_x's values
    cases = []
    for gran in ("row", "conv", "unit"):
        for m in (8, 64, 512):
            for k, n in ((768, 768), (768, 3072), (3072, 768), (768, 32000)):
                cases.append((gran, m, k, n, 32, main_fmt))
        # the new block kinds' shapes: mamba2's dt_proj (N 64) and bc_proj
        # (N 256), gemma3's d_model 1152 and d_ff 6912, recurrentgemma's
        # 4096; M 8 and 40 on either side of the designs' switch
        for m in (8, 40):
            for k, n in ((2048, 64), (2048, 256), (1152, 6912), (6912, 1152),
                         (4096, 4096)):
                cases.append((gran, m, k, n, 32, main_fmt))
        cases.append((gran, 5, 100, 100, 32, main_fmt))
        cases.append((gran, 300, 200, 70, 16, main_fmt))
        for n_r in (16, 64, 128):
            cases.append((gran, 64, 768, 768, n_r, main_fmt))
        cases.append((gran, 64, 768, 768, 32, (FP8_E4M3, FP4_E2M1)))
        cases.append((gran, 37, 200, 300, 32, (FP6_E2M3, FP6_E2M3)))
        cases.append((gran, 8, 768, 3072, 32, wide))
        cases.append((gran, 512, 768, 768, 32, wide))
    # gemma3's tied head, 262 144 columns, in row granularity
    cases += [("row", m, 1152, 262144, 32, main_fmt) for m in (8, 40)]
    # the MoE and other dense configs' projections, (K, N), each at M = 8
    # and 40 through the design the kernel picks (chameleon's K = 22 016 is
    # past the decode design's staging: the tensor cores at every M)
    new_shapes = (
        (6144, 8), (7168, 128),                       # grok's, arctic's router
        (6144, 6144), (6144, 1024),                   # grok attention
        (7168, 7168), (7168, 1024), (7168, 4864), (4864, 7168),   # arctic
        (8192, 8192), (8192, 1024), (8192, 22016), (22016, 8192),  # chameleon
        (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),  # granite
        (1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),     # qwen2
        (2560, 2560), (2560, 6912), (6912, 2560),     # stablelm (d_head 80)
        (1536, 6144), (6144, 1536),                   # musicgen
        (6144, 131072), (7168, 32000), (8192, 65536),  # heads: grok, arctic,
        (4096, 49152), (1536, 151936), (2560, 50304),  # chameleon, granite,
        (1536, 2048))                             # qwen2, stablelm, musicgen
    cases += [("row", m, k, n, 32, main_fmt, "auto") for k, n in new_shapes
              for m in (8, 40)]
    max_abs_err = 0.0
    bad = []
    for gran, m, k, n, n_r, (fx, fw), *auto in cases:
        x, w = operands(m, k, n, fw)
        kw = dict(fmt_x=fx, fmt_w=fw, n_r=n_r, enob=8.0, granularity=gran)
        want = grmac_matmul(x, w, backend="ref", **kw)
        bitwise = (fx, fw) == main_fmt
        designs = ((None,) if auto else ("decode",) if (fx, fw) == wide
                   else DESIGNS)
        for design in designs:
            before = dict(grmac_matmul_cuda.launches_by_design)
            got = grmac_matmul(x, w, design=design, **kw)   # the kernel
            torch.cuda.synchronize()
            ran = [d for d, c in grmac_matmul_cuda.launches_by_design.items()
                   if c != before[d]]
            diff = (got - want).abs()
            mism = int((got != want).sum())
            mad = float(diff.max())
            ok = (mism == 0) if bitwise else bool(
                torch.all(diff <= TOL + TOL * want.abs()))
            max_abs_err = max(max_abs_err, mad)
            emit({"phase": "parity", "design": ran[0] if auto else design,
                  "design_chosen_by_kernel": bool(auto),
                  "granularity": gran, "m": m, "k": k, "n": n, "n_r": n_r,
                  "fmt_x": fx.name, "fmt_w": fw.name, "mismatches": mism,
                  "max_abs_diff": mad, "bitwise_required": bitwise,
                  "ok": ok})
            if not ok:
                bad.append((design, gran, m, k, n, n_r, fx.name, fw.name))
            del got, diff
        del x, w, want
    # cim_matmul with prepared weights against the per-call path (the weight
    # pre-scaled and quantized on every call) and the plain version, at the
    # main path's projections; the head's weight as a tied model's embed.T;
    # the MoE routers (row only) with their f32 weights, at decode and
    # prefill M
    rows = [(gran, m, k, n) for gran in ("row", "conv", "unit")
            for m, k, n in ((8, 768, 3072), (8, 3072, 768), (512, 768, 32000))]
    rows += [("row", m, k, n) for m in (8, 64)
             for k, n in ((6144, 8), (7168, 128))]
    for gran, m, k, n in rows:
        cfg = CIMConfig(mode="grmac", granularity=gran)
        x = torch.randn((m, k), generator=gen, device=dev) * 3
        w = torch.randn((n, k), generator=gen, device=dev).T * 0.02
        want = cim_matmul(x, w, cfg, backend="ref")
        raw = cim_matmul(x, w, cfg)
        got = cim_matmul(x, pack_weight(w, cfg.fmt_w, cfg.n_r), cfg)
        torch.cuda.synchronize()
        mism = int((got != want).sum()) + int((raw != want).sum())
        emit({"phase": "parity", "cim_matmul": "packed and per-call vs "
              "plain", "granularity": gran, "m": m, "k": k, "n": n,
              "w_contiguous": w.is_contiguous(), "mismatches": mism,
              "ok": mism == 0})
        if mism:
            bad.append(("cim_matmul", gran, m, k, n))
        del x, w, want, raw, got
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    torch.cuda.empty_cache()
    seconds("parity")

    # ------------------------------------------------------------- timing
    fmt_x, fmt_w, n_r, enob = FP6_E3M2, FP4_E2M1, 32, 8.0
    kw = dict(fmt_x=fmt_x, enob=enob, granularity="row")

    def plain(x, pw, amax):
        """What the kernel computes, in plain torch: the codes decoded, the
        pre-scale, the plain GR-MAC, the post-scale."""
        sx = torch.clamp(amax, min=1e-12)
        return grmac_matmul(x / sx, unpack_weight(pw), fmt_x=fmt_x,
                            fmt_w=fmt_w, n_r=n_r, enob=enob,
                            granularity="row", backend="ref") * (sx * pw.sw)

    def time_forward(path, arch, m, design):
        """Times of one forward's row launches at M = m: each projection
        shape, then the forward's sum weighted by launches per forward."""
        # bound_ms split by the term that sets each launch's bound
        tot = {"ms": 0.0, "eager_loop_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_bound_ms": 0.0,
               "operations_bound_ms": 0.0, "f32_weight_bound_ms": 0.0}
        shapes = {}               # projections of one shape timed once
        for name, k, n, per_fwd in projections(arch):
            names, count = shapes.get((k, n), ([], 0))
            shapes[(k, n)] = (names + [name], count + per_fwd)
        for (k, n), (names, per_fwd) in shapes.items():
            name = " + ".join(names)
            # rotate over copies so that every launch finds its weights
            # cold in the 50 MB L2, as in a forward over all the codes
            copies = max(1, math.ceil(2 * 50e6 / (k * n / 2)))
            xs = [operands(m, k, n, fmt_w)[0] for _ in range(4)]
            amaxs = [torch.amax(torch.abs(x)) for x in xs]
            ws = [pack_weight(torch.randn((k, n), generator=gen, device=dev),
                              fmt_w, n_r) for _ in range(copies)]

            def call(i):
                return grmac_matmul_cuda(xs[i % 4], ws[i % copies],
                                         amaxs[i % 4], design=design, **kw)

            before = dict(grmac_matmul_cuda.launches_by_design)
            t_kernel = graph_ms(call, 20)
            t_eager = cuda_ms(call, 50)
            chosen = [d for d, c in grmac_matmul_cuda.launches_by_design
                      .items() if c != before[d]]
            t_plain = None
            if design is None:
                t_plain = cuda_ms(lambda i: plain(
                    xs[i % 4], ws[i % copies], amaxs[i % 4]),
                    3 if m * n >= 512 * 32000 else 10)
            b_ms, b_by = bound_ms(m, k, n, n_r, w_bits=fmt_w.bits)
            f32_ms, _ = bound_ms(m, k, n, n_r)
            emit({"phase": "timing", "path": path, "arch": arch.name,
                  "design": chosen, "projection": name, "m": m, "k": k,
                  "n": n, "launches_per_forward": per_fwd,
                  "ms": t_kernel, "eager_loop_ms": t_eager,
                  "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
                  "f32_weight_bound_ms": f32_ms, "library_ms": None,
                  "card": card})
            tot["ms"] += per_fwd * t_kernel
            tot["eager_loop_ms"] += per_fwd * t_eager
            tot["plain_ms"] = (None if t_plain is None or tot["plain_ms"]
                               is None else tot["plain_ms"]
                               + per_fwd * t_plain)
            tot["bound_ms"] += per_fwd * b_ms
            tot[f"{b_by}_bound_ms"] += per_fwd * b_ms
            tot["f32_weight_bound_ms"] += per_fwd * f32_ms
            del xs, ws, amaxs
            torch.cuda.empty_cache()
        emit({"phase": "timing", "path": path, "arch": arch.name,
              "per_forward": tot, "launches_per_forward": per_forward(arch),
              "card": card})
        return tot

    totals = {}
    paper = archs["paper-cim-120m"]
    for key, arch, m, design in (
            ("decode", paper, 8, None), ("prefill", paper, 512, None),
            ("m64_decode", paper, 64, "decode"),
            ("m64_prefill", paper, 64, "prefill"),
            # gemma3-1b served: 8 slots, prefill chunks of 16 tokens
            ("gemma3_decode", archs["gemma3-1b"], 8, None),
            ("gemma3_prefill", archs["gemma3-1b"], 128, None),
            # grok-1-314b served: 8 slots, prefill chunks of 8 tokens
            ("grok_decode", archs["grok-1-314b"], 8, None),
            ("grok_prefill", archs["grok-1-314b"], 64, None)):
        totals[key] = time_forward(key, arch, m, design)
    seconds("timing")

    # -------------------------------------------------------------- serve
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def profiled(path, what, fn, count):
        """``fn`` under torch.profiler: the device's busy share of the wall
        time, CUDA launches per ``count`` (steps or dispatches) and the
        top kernels and host operators."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = prof.key_averages()
        # device-side entries only: an operator's own row repeats its kernels
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(dev_us(e) for e in kernels)
        launch_calls = sum(e.count for e in events
                           if e.key.startswith(("cudaLaunchKernel",
                                                "cuLaunchKernel")))
        top_dev = sorted(kernels, key=dev_us, reverse=True)[:12]
        top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]
        want = (STEP_LAUNCHES[path] if path != "serve_grok"
                or grok_layers == 4 else None)
        if what == "decode_step" and want is not None \
                and launch_calls != want * count:
            fail(f"{path}: {launch_calls / count} CUDA launches a decode "
                 f"step, {want} before the energy model")
        emit({"phase": "profile", "path": path, "of": what, "count": count,
              "wall_us": wall_us, "device_busy_us": busy_us,
              "device_idle_share": (1 - busy_us / wall_us) if busy_us
              else None,
              "cuda_launches_per": launch_calls / count,
              "expected_launches_per": want if what == "decode_step"
              else None,
              "device_ops_per": sum(e.count for e in kernels) / count,
              "top_device": [(e.key, e.count, dev_us(e)) for e in top_dev],
              "top_cpu_self": [(e.key, e.count, e.self_cpu_time_total)
                               for e in top_cpu],
              "card": card})

    def profile_path(path, engine, arch, bucket):
        """Three more decode steps, then one full-bucket prefill dispatch
        into a freed slot (the recurrences' per-token loop shows there)."""
        def steps():
            for _ in range(3):
                engine.step()

        def prefill():
            engine.release_slot(0)
            engine.add_request([int(t) for t in
                                rng.integers(0, arch.vocab_size, bucket)])

        profiled(path, "decode_step", steps, 3)
        profiled(path, f"prefill_dispatch_of_{bucket}_tokens", prefill, 1)

    def run_engine(arch, params, prompts, n_steps, serve_kw, backend):
        engine = Engine(arch, params, ServeConfig(
            batch_slots=SLOTS, cim_backend=backend, **serve_kw), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_ms, decode_ms = [], []
        for p in prompts:
            t0 = time.perf_counter()
            engine.add_request(p)
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
        last = None
        for _ in range(n_steps):
            t0 = time.perf_counter()
            last = engine.step()
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
        return (engine, prefill_ms, decode_ms,
                torch.cuda.max_memory_allocated(), last)

    launches_by_path = {}
    by_design_total = dict.fromkeys(DESIGNS, 0)

    # MoE assignments dropped past an expert's capacity, counted on the
    # device (no sync) per kind of dispatch: a decode routes SLOTS tokens
    drops = {}
    real_dispatch = moe_mod.dispatch

    def counting_dispatch(xf, expert_idx, valid, e, cap):
        buf, slot, keep = real_dispatch(xf, expert_idx, valid, e, cap)
        kind = "decode" if xf.shape[0] == SLOTS else "prefill"
        lost = (valid.repeat_interleave(expert_idx.shape[-1]) & ~keep).sum()
        drops[kind] = drops.get(kind, 0) + lost
        return buf, slot, keep

    moe_mod.dispatch = counting_dispatch

    def take_drops():
        out = {kind: int(n) for kind, n in drops.items()}
        drops.clear()
        return out

    def serve_path(path, arch, params, prompts, n_steps, serve_kw,
                   extra=None, keep_engine=False):
        """Serve ``prompts`` and ``n_steps`` greedy steps through the
        kernel with the counts set to 0 just before and read just after,
        profile, then the same traffic through the plain version: the
        streams must be identical. Returns the kernel's engine and its last
        step result if asked (else Nones)."""
        v = arch.vocab_size
        fwd = per_forward(arch)
        reset_counts()
        take_drops()
        engine, prefill_ms, decode_ms, peak, last = run_engine(
            arch, params, prompts, n_steps, serve_kw, None)
        launches = grmac_matmul_cuda.launches
        dropped = take_drops()
        by_design = dict(grmac_matmul_cuda.launches_by_design)
        launches_by_path[path] = launches
        for d in DESIGNS:
            by_design_total[d] += by_design[d]
        dispatches = (engine.stats["prefill_dispatches"]
                      + engine.stats["decode_steps"])
        streams = [list(t) for t in engine.tokens]
        emit({"phase": path, "arch": arch.name, "batch_slots": SLOTS,
              **serve_kw, **(extra or {}),
              "prompt_lens": [len(p) for p in prompts],
              "stats": engine.stats, "kernel_launches": launches,
              "kernel_launches_by_design": by_design,
              "launches_per_forward": fwd,
              "expected_launches": fwd * dispatches,
              "prefill_ms": prefill_ms, "decode_ms": decode_ms,
              "decode_ms_median": float(np.median(decode_ms)),
              "decode_tok_s_median": SLOTS * 1e3 / float(np.median(
                  decode_ms)),
              "peak_mem_bytes": peak, "moe_dropped_assignments": dropped,
              "card": card})
        if launches != fwd * dispatches:
            fail(f"{path}: {launches} kernel launches for {dispatches} "
                 f"dispatches (expected {fwd} each)")
        if any(len(s) != len(p) + 1 + n_steps
               for s, p in zip(streams, prompts)):
            fail(f"{path}: a request did not emit 1 + n_steps tokens")
        if not all(0 <= t < v for s in streams for t in s):
            fail(f"{path}: a token id outside the vocabulary")
        if arch.is_moe and not dropped.get("decode"):
            fail(f"{path}: no decode step overflowed an expert's capacity")
        # the profile counts the path's own operations, not the drop count
        moe_mod.dispatch = real_dispatch
        profile_path(path, engine, arch,
                     min(64, serve_kw.get("prefill_bucket_max", 64)))
        moe_mod.dispatch = counting_dispatch
        if not keep_engine:
            # the last step result's energy thunk holds the engine too
            del engine, last
            gc.collect()
            torch.cuda.empty_cache()
            engine = last = None
        reset_counts()
        take_drops()
        oracle, o_prefill_ms, o_decode_ms, o_peak, o_last = run_engine(
            arch, params, prompts, n_steps, serve_kw, "ref")
        if grmac_matmul_cuda.launches != 0:
            fail(f"{path}: the ref run launched the kernel")
        o_dropped = take_drops()
        same = [list(t) for t in oracle.tokens] == streams
        emit({"phase": f"{path}_oracle", "streams_equal": same,
              "prefill_ms": o_prefill_ms,
              "decode_ms_median": float(np.median(o_decode_ms)),
              "peak_mem_bytes": o_peak,
              "moe_dropped_assignments": o_dropped, "card": card})
        if not same or o_dropped != dropped:
            fail(f"{path}: token streams or dropped assignments differ from "
                 "the plain version's on the card")
        del oracle, o_last
        gc.collect()
        torch.cuda.empty_cache()
        return engine, last

    def small_cpu_vs_card(path, name):
        """The model's reduced config (its own CIM setting), its weights
        drawn on the CPU and moved, on the CPU and on the card: a bucketed
        prefill with a frozen lane, then a decode step past the cache's
        end (seeded embeddings for an embedding-input model). Greedy ids
        equal at the valid positions; logits within 1e-5 + 1e-5 |logit|
        (the devices sum norms, softmax, attention and the MoE experts'
        products in different orders), 5e-5 + 1e-5 |logit| for
        recurrentgemma (``SMALL_ATOL``)."""
        small = get_config(name).reduced()
        rng = np.random.default_rng(SEED)
        if small.input_mode == "tokens":
            toks = torch.tensor(rng.integers(0, small.vocab_size, (4, 16)))
            tok = torch.tensor(rng.integers(0, small.vocab_size, (4, 1)))
        else:
            toks = torch.tensor(rng.standard_normal(
                (4, 16, small.d_model), dtype=np.float32))
            tok = torch.tensor(rng.standard_normal(
                (4, 1, small.d_model), dtype=np.float32))
        idx, lens = torch.tensor([0, 3, 0, 5]), torch.tensor([16, 7, 0, 12])
        at = torch.tensor([16, 10, 63, 64])
        out = {}
        p_cpu = init_params(small, SEED, device="cpu")
        for d in ("cpu", dev):
            p = to_device(p_cpu, d)
            c = init_cache(small, 4, 64, torch.float32, d)
            last, ids, c = prefill_step(p, toks.to(d), small, c, idx.to(d),
                                        lens.to(d))
            logits, c = decode_step(p, tok.to(d), small, c, at.to(d))
            out[d] = [t.cpu() for t in (last, ids, logits)]
        cpu, card_ = out["cpu"], out[dev]
        diff = max(float((a - b).abs().max()) for a, b in
                   ((cpu[0], card_[0]), (cpu[2], card_[2])))
        atol = SMALL_ATOL.get(name, TOL)
        within = all(bool(torch.all((a - b).abs() <= atol + TOL * a.abs()))
                     for a, b in ((cpu[0], card_[0]), (cpu[2], card_[2])))
        valid = torch.arange(16)[None, :] < lens[:, None]
        ids_equal = bool(torch.equal(cpu[1][valid], card_[1][valid])
                         and torch.equal(cpu[2].argmax(-1),
                                         card_[2].argmax(-1)))
        emit({"phase": f"{path}_cpu_vs_card", "arch": small.name,
              "cim_mode": small.cim.mode, "max_abs_diff": diff,
              "atol": atol, "rtol": TOL, "within_tol": within,
              "ids_equal": ids_equal})
        if not within or not ids_equal:
            fail(f"{path}: the card disagrees with the CPU on the reduced "
                 f"config (max |diff| {diff}, ids equal {ids_equal})")

    rng = np.random.default_rng(SEED)

    def prompts_of(arch, lens):
        return [[int(t) for t in rng.integers(0, arch.vocab_size, n)]
                for n in lens]

    # paper-cim-120m, the first slice's path, as before
    params = init_params(paper, SEED, device=dev)
    prompts = prompts_of(paper, (5, 8, 12, 17, 24, 33, 40, 60))
    engine, last = serve_path("serve", paper, params, prompts, 32,
                              dict(max_ctx=512), keep_engine=True)
    toks = torch.tensor([p[:5] for p in prompts], device=dev)
    logits_k, _, _ = forward(params, toks, paper)
    logits_r, _, _ = forward(params, toks, paper.replace(
        cim=paper.cim.with_backend("ref")))
    logits_p, _, _ = forward(engine.params, toks, paper)   # packed weights
    finite = bool(torch.isfinite(logits_k).all())
    logits_equal = bool(torch.equal(logits_k, logits_r)
                        and torch.equal(logits_p, logits_r))
    # the same small model on the CPU (plain version) and on the card
    # (kernel): equal greedy ids, logits within 1e-5 (the devices' torch
    # kernels sum norms, softmax and attention in different orders)
    small = paper.reduced()
    sp_cpu = init_params(small, SEED, device="cpu")
    sp_dev = to_device(sp_cpu, dev)
    stoks = torch.tensor(rng.integers(0, small.vocab_size, (4, 24)))
    small_cpu = forward(sp_cpu, stoks, small)[0]
    small_dev = forward(sp_dev, stoks.to(dev), small)[0].cpu()
    small_diff = float((small_cpu - small_dev).abs().max())
    small_ids_equal = bool(torch.equal(small_cpu.argmax(-1),
                                       small_dev.argmax(-1)))
    emit({"phase": "serve_forward_checks",
          "forward_logits_shape": list(logits_k.shape),
          "forward_logits_finite": finite,
          "forward_logits_equal": logits_equal,
          "small_cpu_vs_card_max_abs_diff": small_diff,
          "small_cpu_vs_card_ids_equal": small_ids_equal})
    if not finite or tuple(logits_k.shape) != (8, 5, paper.vocab_size) \
            or not logits_equal:
        fail("forward logits are not finite, of shape (8, 5, V) and equal "
             "to the plain version's")
    if small_diff > TOL or not small_ids_equal:
        fail(f"the card disagrees with the CPU on a small input "
             f"(max |diff| {small_diff}, ids equal {small_ids_equal})")
    # the served engine's decode-phase energy: priced on this first read
    # (a meta trace and the Monte-Carlo solve on the card), equal to the
    # energy report's, within MC_TOL of the committed record
    t0 = time.perf_counter()
    pj = last.pj_per_token
    pj_seconds = time.perf_counter() - t0
    rep = energy_report(paper)
    record = json.loads((ROOT / "experiments" / "bench"
                         / "e2e_energy.json").read_text())[paper.name]
    pj_ok = (pj == rep["pj_per_token"] and abs(pj - record["pj_per_token"])
             <= MC_TOL["pj_per_token_2048"] and abs(
                 rep["fj_per_op"] - record["fj_per_op"])
             <= MC_TOL["fj_per_op_2048"])
    emit({"phase": "serve_energy", "arch": paper.name,
          "step_pj_per_token": pj, "first_read_seconds": pj_seconds,
          "report_pj_per_token": rep["pj_per_token"],
          "fj_per_op": rep["fj_per_op"],
          "conventional_fj_per_op": rep["conventional_fj_per_op"],
          "conventional_pj_per_token":
              rep["phases"]["decode"]["conventional_pj_per_token"],
          "ops_per_token": rep["ops_per_token"],
          "record_pj_per_token": record["pj_per_token"],
          "record_fj_per_op": record["fj_per_op"],
          "record_conventional_fj_per_op": record["conventional_fj_per_op"],
          "tolerance": {k: MC_TOL[k] for k in ("pj_per_token_2048",
                                               "fj_per_op_2048")},
          "sites": {site: {k: v[k] for k in ("pj_per_token", "fj_per_op",
                                               "enob")}
                    for site, v in rep["sites"].items()},
          "ok": pj_ok, "card": card})
    if not pj_ok:
        fail("serve: the engine's pJ/token differs from energy_report's or "
             "lies outside the Monte-Carlo tolerance of the record")
    del engine, last, params, logits_k, logits_r, logits_p
    gc.collect()
    torch.cuda.empty_cache()
    seconds("serve")

    def with_grmac(arch):
        # the default design: row, FP6_E3M2 x FP4_E2M1, n_r 32, ENOB 8
        return arch.replace(cim=arch.cim.with_mode("grmac"))

    def head_temporary(arch, bucket):
        """The plain version's largest temporary, (K / n_r, M, N) f32 for
        the LM head at M = slots x bucket."""
        k_blocks = math.ceil(arch.d_model / 32)
        return {"prefill_bucket_max": bucket, "head_m": SLOTS * bucket,
                "oracle_head_temporary_bytes":
                    4 * k_blocks * SLOTS * bucket * arch.padded_vocab}

    families = (
        # gemma3-1b: one prompt wraps its 512-slot rings inside a chunked
        # prefill, another first in decode
        ("serve_gemma3", "gemma3-1b", (5, 12, 33, 60, 100, 200, 505, 600),
         16, dict(max_ctx=1024, prefill_bucket_max=16), None),
        # mamba2-1.3b: short prompts, the recurrence loops over each chunk
        ("serve_mamba2", "mamba2-1.3b", (3, 5, 8, 12, 17, 24, 33, 40), 16,
         dict(max_ctx=512, prefill_bucket_max=32), None),
        # recurrentgemma-9b, one super-block: the plain version's head
        # temporaries (128 x M x 256 000 f32) already fill most of the
        # card beside 3 layers, and every layer is drawn on the host
        ("serve_recurrentgemma", "recurrentgemma-9b",
         (5, 8, 12, 17, 24, 33, 40, 60), 16,
         dict(max_ctx=512, prefill_bucket_max=8),
         {"reduced": {"n_layers": [38, 3]}}),
        # grok-1-314b at full width, depth cut to what fits beside the
        # oracle (``grok_depth``): ~9.8 GB of bf16 weights a layer
        ("serve_grok", "grok-1-314b", (5, 8, 12, 17, 24, 33, 40, 60), 16,
         dict(max_ctx=512, prefill_bucket_max=8),
         {"reduced": {"n_layers": [64, grok_layers]}}),
    )
    for path, name, lens, n_steps, serve_kw, extra in families:
        arch = with_grmac(archs[name])
        info_kw = dict(head_temporary(arch, serve_kw["prefill_bucket_max"]),
                       **(extra or {}))
        t0 = time.perf_counter()
        params = init_params(arch, SEED, device=dev)
        leaves = list(_leaves(params))
        emit({"phase": f"{path}_setup", "arch": arch.name,
              "n_layers": arch.n_layers, "d_model": arch.d_model,
              "n_heads": arch.n_heads, "n_kv_heads": arch.n_kv_heads,
              "n_experts": arch.n_experts, "top_k": arch.top_k,
              "expert_d_ff": arch.expert_d_ff if arch.is_moe else None,
              "vocab_size": arch.vocab_size, "dtype": arch.dtype,
              "params": sum(t.numel() for t in leaves),
              "bytes": sum(t.numel() * t.element_size() for t in leaves),
              "init_seconds": time.perf_counter() - t0, **info_kw})
        serve_path(path, arch, params, prompts_of(arch, lens), n_steps,
                   serve_kw, extra=info_kw)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        small_cpu_vs_card(path, name)
        if arch.is_moe:
            small_cpu_vs_card(path, "arctic-480b")   # the dense residual
        seconds(path)

    # ----------------------------------------------------- forward_musicgen
    # an embedding-input model (the engine serves token models): seeded
    # frame embeddings through prefill_step and decode_step, through the
    # kernel (packed weights) and through the plain version
    arch = with_grmac(archs["musicgen-medium"])
    t0 = time.perf_counter()
    params = init_params(arch, SEED, device=dev)
    leaves = list(_leaves(params))
    emit({"phase": "forward_musicgen_setup", "arch": arch.name,
          "n_layers": arch.n_layers, "d_model": arch.d_model,
          "dtype": arch.dtype, "params": sum(t.numel() for t in leaves),
          "init_seconds": time.perf_counter() - t0})
    egen = torch.Generator(device=dev).manual_seed(SEED)
    n_dec, s_len = 4, 32
    frames = torch.randn((SLOTS, s_len + n_dec, arch.d_model),
                         generator=egen, device=dev)
    lens = torch.tensor([32, 17, 5, 32, 9, 24, 1, 30], device=dev)
    valid = torch.arange(s_len, device=dev)[None, :] < lens[:, None]
    runs = {}
    for backend in (None, "ref"):
        a = arch if backend is None else arch.replace(
            cim=arch.cim.with_backend("ref"))
        p = pack_params(params, a) if backend is None else params
        cache = init_cache(a, SLOTS, 64, torch.float32, dev)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, ids, cache = prefill_step(p, frames[:, :s_len], a, cache, 0,
                                        lens)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        logits, step_ids, decode_ms = [last], [ids[valid]], []
        for i in range(n_dec):
            t0 = time.perf_counter()
            lg, cache = decode_step(p, frames[:, s_len + i:s_len + i + 1], a,
                                    cache, lens + i)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg)
            step_ids.append(lg.argmax(-1))
        runs[backend] = dict(
            launches=grmac_matmul_cuda.launches,
            by_design=dict(grmac_matmul_cuda.launches_by_design),
            logits=torch.stack(logits), ids=torch.cat(step_ids),
            prefill_ms=prefill_ms, decode_ms=decode_ms,
            peak=torch.cuda.max_memory_allocated())
        del p, cache
    k_run, r_run = runs[None], runs["ref"]
    launches_by_path["forward_musicgen"] = k_run["launches"]
    for d in DESIGNS:
        by_design_total[d] += k_run["by_design"][d]
    fwd = per_forward(arch)
    ids_equal = bool(torch.equal(k_run["ids"], r_run["ids"]))
    finite = bool(torch.isfinite(k_run["logits"]).all())
    emit({"phase": "forward_musicgen", "arch": arch.name,
          "batch_slots": SLOTS, "prefill_tokens": s_len,
          "lengths": lens.tolist(), "decode_steps": n_dec,
          "kernel_launches": k_run["launches"],
          "kernel_launches_by_design": k_run["by_design"],
          "launches_per_forward": fwd,
          "expected_launches": fwd * (1 + n_dec),
          "ids_equal": ids_equal, "logits_finite": finite,
          "logits_equal": bool(torch.equal(k_run["logits"],
                                           r_run["logits"])),
          "logits_shape": list(k_run["logits"].shape),
          "prefill_ms": k_run["prefill_ms"], "decode_ms": k_run["decode_ms"],
          "oracle_prefill_ms": r_run["prefill_ms"],
          "oracle_decode_ms": r_run["decode_ms"],
          "peak_mem_bytes": k_run["peak"], "oracle_peak_mem_bytes":
          r_run["peak"], "card": card})
    if k_run["launches"] != fwd * (1 + n_dec) or r_run["launches"] != 0:
        fail(f"forward_musicgen: {k_run['launches']} kernel launches for "
             f"{1 + n_dec} forwards (expected {fwd} each), "
             f"{r_run['launches']} in the ref run")
    if not ids_equal or not finite:
        fail("forward_musicgen: ids differ from the plain version's or the "
             "logits are not finite")
    del params, runs, k_run, r_run, frames
    gc.collect()
    torch.cuda.empty_cache()
    small_cpu_vs_card("forward_musicgen", "musicgen-medium")
    seconds("forward_musicgen")

    dec = totals["decode"]
    emit({"kernels": [{
        "name": "grmac_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grmac_matmul.cu",
        "replaces": "src/repro/kernels/grmac_matmul.py:169",
        "tpu_source": "src/repro/kernels/grmac_matmul.py:169",
        "port_source": "src/repro_torch/csrc/grmac_matmul.cu",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max_abs_err,
        "checked_vs_plain": True,
        "launches_by_design": by_design_total,
        # times of the 85 row launches of one paper-cim-120m decode forward
        # (M = 8), the weights packed in 4 bits; the bound at their stored
        # bits. "ms" is device time by CUDA-graph replay; "eager_loop_ms"
        # the same launches timed as an eager loop (also the host's cost
        # per call)
        "ms": dec["ms"],
        "eager_loop_ms": dec["eager_loop_ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": ("bytes" if dec["bytes_bound_ms"]
                     >= dec["operations_bound_ms"] else "operations"),
        "library_ms": None,
        "prefill_forward": totals["prefill"],
        "m64_forward_by_design": {d: totals[f"m64_{d}"]["ms"]
                                  for d in ("decode", "prefill")},
        "gemma3_decode_forward": totals["gemma3_decode"],
        "gemma3_prefill_forward": totals["gemma3_prefill"],
        "grok_decode_forward": totals["grok_decode"],
        "grok_prefill_forward": totals["grok_prefill"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    """The tensors of a nested dict of parameters."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
