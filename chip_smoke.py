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
            ``experiments/bench/e2e_energy_smoke.json``, all 33 phases;
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
            for comparison, as f32; and paper-cim-120m's train forward (M
            = 8 x 256), where the kernel's per-call route also packs every
            weight on every call (``pack_ms``); ``ssm_scan_check``: the
            SSD scan (``kernels.ssm_scan``) against the SSM block's
            per-step loop on the same tensors, 8 lanes, mamba2-1.3b at
            full width and reduced, S 1, 16, 24 and 32 (past the scan's
            16-step tile), lengths 0, 1, S - 3 and S mixed: state, conv
            window and y bitwise; at full width the scan's graph ms, the
            loop's ms and the bound of its bytes at 3.35 TB/s;
5. serve    one path per model, each from seeded random weights with every
            projection through GR-MAC row (FP6_E3M2 x FP4_E2M1, n_r 32,
            ENOB 8), 8 slots of greedy traffic, the launch counts set to 0
            just before the engine is built and read just after (they
            must be the model's projections per forward times its eager
            dispatches and its graphs' warm-ups and captures; a dispatch
            replayed from a CUDA graph launches nothing from the host,
            ``host_launches``):
              serve              paper-cim-120m, full width and depth,
                                 32 decode steps (85 launches a forward);
              serve_gemma3       gemma3-1b, full width and depth (183),
                                 max_ctx 1024, prompts past the 512-token
                                 window: the rings wrap inside a chunked
                                 prefill and in decode;
              serve_mamba2       mamba2-1.3b, full width and depth (193;
                                 and one launch of the SSD scan a layer a
                                 dispatch, counted from 0 as the kernel's);
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
            and a prefill dispatch (device idle share, CUDA launches per
            step, which must equal ``STEP_LAUNCHES``, the GR-MAC kernels
            run on the card, which must be the projections per forward
            times the dispatches, replayed or eager, top kernels and host
            operators); the same traffic through the plain version
            on the card (``cim_backend="ref"``, and the SSM block's
            per-step loop in place of the scan), whose token streams must
            be identical; and the model's reduced config (drawn on the
            CPU, moved to the card) on the CPU and on the card, whose
            logits must agree within 1e-5 (5e-5 for recurrentgemma, whose
            RG-LRU amplifies an ulp of exp); arctic-480b's reduced config
            with grok's; for paper-cim-120m, the last step result's
            ``pj_per_token`` (priced on that first read), which must equal
            ``energy_report``'s and lie within ``MC_TOL`` of the committed
            ``experiments/bench/e2e_energy.json``, its fJ/Op too;
5b. serve_scheduler  paper-cim-120m's weights under the ``Scheduler``
            (8 slots, max_ctx 512, prefill budget 16, preemption at age
            80, prefix cache on), the counts set to 0 before each run: run
            1 open-loop greedy traffic (48 requests, 16 on shared system
            prompts, at 1.5x capacity), run 2 closed-loop at 8 clients,
            sampled (seeded, keyed and two greedy lanes); each through the
            kernel and the plain version, whose streams and policy-clock
            metrics must be equal, with 85 launches an eager dispatch
            (none a replayed one) and one fetch a decode step and a first
            token; run 1 must preempt and
            hit the prefix cache; pJ/token equal to ``serve_energy``'s;
            then a profile of three sampled decode steps
            (``serve_sampled`` in ``STEP_LAUNCHES``, 85 GR-MAC kernels a
            step on the card);
5c. serve_spec  paper-cim-120m's weights under speculative decode
            (``SpecDecoder``, k 4, the digital drafter; ``serve``'s 8
            prompts, 6 greedy lanes and 2 seeded sampled ones), through
            the kernel and the plain version: equal streams and counters
            (spec steps and tokens, draft / verify / repair dispatches,
            fetches), the kernel launched 85 times an eager prefill,
            verify or repair (none a replayed one);
            accepted tokens, wall ms and launches per spec step (the
            latter equal to ``STEP_LAUNCHES``), and ``price_speculation``;
            with the CIM path off, greedy speculative streams equal to
            sequential decode's (``serve_spec_cim_off``);
            in ``serve_mamba2``, the ``serve_mamba2_spec`` lines: the
            ``Scheduler(spec=...)`` at full width with the served drafter
            (``"self"``) and a site override (the SSM projections
            digital), which forces partial acceptance, rollbacks and
            repairs, each through the kernel and the scan and through the
            plain version and the loop, equal streams, counters and policy
            metrics;
5d. train   paper-cim-120m trained at full width and depth (remat as
            configured, batch 8 x 256, AdamW, warmup 1): step 0's loss and
            gradients through the kernel (its per-call route) and through
            the plain version (loss equal, gradients within
            ``GRAD_RTOL``, deterministic algorithms on), then 4 steps
            through the kernel with a falling loss, its time split
            (forward, backward, optimizer), tokens/s, peak memory and a
            profiled step; ``train_mamba2`` and ``train_recurrentgemma``:
            one step each, kernel against plain version, in their serve
            phases (mamba2 at full width and depth, batch 1 x 256;
            recurrentgemma cut to 3 layers, batch 1 x 64). Lines
            ``*_prefix_hit``: for paper-cim-120m here, and gemma3-1b (a
            shared prefix past its 512-slot rings) and mamba2-1.3b in their
            serve phases, at full width, one request at a time: a prefix
            hit's stream equal to a cold prefill's (mamba2's cold run
            through the loop, its hit through the scan), the prefix
            adopted;
5e. analysis  after ``train``: ``analysis_audit``, the ledger audit
            (``analysis.op_audit``) of all 11 configs x {prefill, decode,
            train} at full width on ``meta``: no untagged contraction, no
            ledger mismatch, ``contracts`` / ``calls`` / ``macs`` equal to
            ``experiments/audit/audit_report.json``, seconds per trace;
            ``analysis_sanitize``, ``serve``'s traffic with REPRO_SANITIZE=1
            through the kernel's sanitizing instantiation (prefill
            dispatches on the tensor-core design, decode steps on the
            split-K one) and through the plain version: streams equal to
            the unsanitized ``serve`` run's, the records of the two equal
            (kind, tag, count, worst, in order), no nonfinite voltage, the
            totals per kind and site, a NaN seeded into an ``mlp``
            projection's input caught there by both, step ms and launches
            a step with the sanitizer on; ``analysis_invariants``, the four
            invariant drives on the reduced qwen2 / recurrentgemma / mamba2
            in GR-MAC mode (weights drawn on the CPU, moved) and
            ``InstrumentedEngine`` over ``serve``'s traffic at full width:
            one fetch a step and a first token, device->host crossings
            equal to the fetches, one signature per dispatch key, every
            dispatch replayed from its graph (no GR-MAC launch from the
            host). The ``timing`` phase also times one paper-cim
            forward's launches through the plain and the sanitizing
            instantiation in turns (``timing_sanitizing``, M = 8 and 512);
5f. train_drill  after the analysis: ``python -m repro_torch.launch.train
            --arch paper-cim-120m --steps 12 --drill`` driven through its
            ``main``: the supervised fault drill at full width and depth
            (batch 8 x 128, ``make_fault_plan(0, 12)``: a device loss, a
            kill and a straggler; local tier every 2 steps, durable every
            6, in the temporary directory), its state DTensors on a 1 x 1
            NCCL mesh after every restore: the counters equal to
            ``DRILL_COUNTERS`` (the JAX package's for that plan), 169
            kernel launches a step run (85 + 84 recomputed by remat), step
            0's loss equal to the plain version's on the same weights, and
            all 12 losses equal to an uninterrupted run's (a recomputed
            step's loss is held to its first run inside the drill); the
            GoodPut buckets, the checkpoint seconds, the step ms and pJ per
            useful token;
    launch_serve  ``python -m repro_torch.launch.serve --arch paper-cim-120m
            --slots 8 --ctx 512`` through its ``main``, as the two-prompt
            demo and with ``--traffic 16``: 85 kernel launches an eager
            dispatch and a graph's warm-up and capture (``host_launches``),
            pJ/token within ``MC_TOL`` of ``serve_energy``'s;
5g. spmd_serve  after the analysis: ``serve``'s traffic under
            ``local_mesh()`` (a 1 x 1 NCCL mesh), the SPMD serving program
            of ``prefill_step`` / ``decode_step``: streams bitwise equal to
            ``serve``'s, 85 kernel launches a dispatch; ``serve``'s path
            with no mesh just before and after it, as its time's baseline;
    spmd_split  the SPMD program split over "model" on the one card: two
            processes, a gloo group with CUDA tensors (NCCL refuses two
            ranks on one device), a 1 x 2 ("data", "model") mesh, paper-
            cim-120m's params placed by ``param_specs``; ``serve``'s
            traffic through the engine with the KV by rows only (streams
            bitwise equal to ``serve``'s, 85 launches a dispatch a rank,
            each at half the projection's N), and with its context split
            over "model" (tokens differing, |logit differences|, finite);
            the kernel against its plain version at the chunks;
    roofline_card  ``launch.roofline`` on a 1 x 1 mesh of the ``fake``
            group for the shapes this run measures (paper-cim-120m decode
            at 8 slots / ctx 512, the no-cache prefill forward at 8 x 64,
            the train step at 8 x 256), beside the measured ms (``serve``'s
            step median, a timed forward, ``train``'s step median); the
            CIM flops must equal twice the energy ledger's MACs for those
            shapes (the train step's with remat's recomputation);
    dryrun  after ``launch_serve``: ``launch.dryrun`` over the 10 archs x 4
            shapes on the 16 x 16 mesh (256 ranks of the ``fake`` group,
            ``meta`` tensors, 6 worker processes), and on the 2 x 16 x 16
            mesh when the first sweep took under a minute: 0 errors and
            exactly 7 skipped cells a mesh, one ``dryrun_cell`` line a cell
            (H100 data-sheet model outputs);
    examples  the five ``repro_torch.examples`` through their ``main`` on
            the card with short arguments: ``serve_decode`` (paper-cim-120m
            at full width) 85 kernel launches as ``host_launches`` counts
            them, ``train_lm``
            (``--cim grmac``, 8 x 256, 2 steps) 169 a step;
6. forward_musicgen  musicgen-medium (embedding inputs, GELU MLP) at full
            width and depth: seeded (8, S, 1536) embeddings through
            ``prefill_step`` and decode steps, through the kernel and
            through the plain version: equal ids, finite logits; and its
            reduced config on the CPU and on the card.

Full-width weights are drawn by a generator on the card (``init_params``
on the card), so a 10 GB grok layer takes no host time.

Then the ``kernels`` summary line (the GR-MAC kernel's entry and the
SSD scan's), the card's name and power limit as
``nvidia-smi`` prints them, and a last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; so does a machine without a CUDA card, or a directory without
the port's sources.
"""
import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# layers) as counted before the energy model's hooks: they must add none.
# serve and serve_gemma3 replay their decode forward from a CUDA graph
# (``serving.graphs``; one cudaGraphLaunch, not a kernel launch): the step
# launches the argmax and its cast (2); eager, they launched 1011 and 3008.
# The same profile counts the GR-MAC kernels the replay ran on the card.
# serve_sampled: paper-cim-120m's replayed step with 6 of 8 lanes
# sampling, the sampler's 41: 29 for the counter hash over the (8, 32 000)
# tile, 12 for the Gumbel-max and the per-lane choice (eager: 1050).
# mamba2, recurrentgemma and grok stay eager (recurrent blocks, MoE);
# mamba2's step runs each layer's recurrence as one launch of the SSD scan
# (``kernels.ssm_scan``): 2375, where its per-step loop launched 3383
# (48 layers x 22 launches became 48 x 1).
# serve_spec: a speculative step of paper-cim-120m (k 4, the digital
# drafter, 2 of 8 lanes sampled), eager: three draft dispatches of 1009 (a
# decode step of another arch, whose 85 projections are cuBLAS GEMMs, not
# an absmax reduction and a GR-MAC launch each) and one sampled verify of
# 1144 (the chunked prefill over the 8-token bucket and the rejection rule
# on the device); 3 x 1009 + 1144 = 4171, each part profiled alone
STEP_LAUNCHES = {"serve": 2, "serve_gemma3": 2, "serve_mamba2": 2375,
                 "serve_recurrentgemma": 298, "serve_grok": 608,
                 "serve_sampled": 41, "serve_spec": 4171}
# Profiles of one count of GR-MAC kernels on the card at most
# (``grmac_on_card_of``): the profiler drops a device record now and then
# (4 of 9207 in one of six profiles of three replayed gemma3-1b decode
# steps, H100 80GB HBM3 at 700 W)
PROFILE_TRIES = 3
# Gradients of one train step through the kernel against the plain version:
# their forwards are bitwise equal, the backward is the same plain torch, so
# any difference is the card's summation order; bound per tensor, relative
# to its largest entry.
GRAD_RTOL = 1e-5
# The sharded-vs-unsharded rtol of the reference (tests/test_dryrun.py):
# spmd_split holds the split KV's decode to it with the CIM path off.
LOSS_RTOL = 2e-4
# The supervised drill of train_drill: make_fault_plan(0, 12) under the
# default DrillConfig (4 hosts, 8 chips, local tier every 2 steps, durable
# every 6). Its counters are pure functions of (plan, config); these are
# the JAX package's for that plan (tests/test_torch_supervisor.py holds
# them to it and to the port's drill on the CPU).
DRILL_PLAN = [(3, "device_loss"), (5, "kill"), (10, "straggler")]
DRILL_COUNTERS = {"final_step": 12, "attempts": 3, "faults_injected": 3,
                  "faults_detected": 3, "fault_kill": 1,
                  "fault_device_loss": 1, "fault_straggler": 1,
                  "steps_recomputed": 4, "ckpt_local": 7, "ckpt_durable": 4,
                  "restore_local": 1, "restore_durable": 1,
                  "remesh_events": 1, "dp_width_initial": 8,
                  "dp_width_final": 6}

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
        m = re.search(r"(decode|prefill)_kernelI((?:L[ib]-?\d+E)+)E", line)
        if "Compiling entry function" in line and m:
            name = m.group(1) + "<" + ",".join(
                re.findall(r"L[ib](-?\d+)E", m.group(2))) + ">"
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


def _site(projection: str) -> str:
    """The CIM site of a ``projections`` entry."""
    for prefix, site in (("attn wo", "attn_o"), ("attn", "attn_qkv"),
                         ("rglru", "rglru"), ("ssm", "ssm"),
                         ("moe router", "moe_router"), ("lm head", "head")):
        if projection.startswith(prefix):
            return site
    return "mlp"


def grmac_per_forward(arch) -> int:
    """Launches of the kernel in one forward of ``arch``: its projections
    at the sites that resolve to GR-MAC (a speculative drafter may turn
    some off)."""
    return sum(p[3] for p in projections(arch)
               if arch.cim.for_site(_site(p[0])).mode == "grmac")


def host_launches(fwd: int, dispatches: int, graph_stats: dict,
                  built: bool = True) -> int:
    """The kernel's launches the host counts for ``dispatches`` forwards
    of an engine's served arch, ``fwd`` launches each. A dispatch replayed
    from a CUDA graph launches none: ``profiled`` counts its kernels on
    the card. Counted from before the engine was built (``built``), each
    graph's warm-ups and capture launch ``WARMUP + 1`` forwards."""
    from repro_torch.serving.graphs import WARMUP

    eager = dispatches - graph_stats["replays"]
    return fwd * (eager + (WARMUP + 1) * graph_stats["captures"] * built)


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
    record exactly, all 33 of them."""
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
    bad = []
    for name in list_configs():
        arch = get_config(name)
        if not arch.cim.enabled:
            arch = arch.replace(cim=arch.cim.with_mode("grmac"))
        row = {"phase": "energy_ledger", "arch": name, "card": card}
        for phase, trace, tokens in traces:
            t0 = time.perf_counter()
            ledger = trace(arch)
            got = 2 * ledger.macs() / tokens(arch)
            want = smoke[name]["phases"][phase]["ops_per_token"]
            row[phase] = {"ops_per_token": got, "record": want,
                          "equal": got == want, "entries": len(ledger),
                          "trace_seconds": time.perf_counter() - t0}
            if got != want:
                bad.append((name, phase, got, want))
        emit(row)
    emit({"phase": "energy_ledgers", "configs": len(list_configs()),
          "phases_equal": 3 * len(list_configs()) - len(bad),
          "waiting": [], "mismatched": bad})
    if bad:
        fail(f"energy: ledger op counts differ from the record {bad}")


AUDIT_WORKERS = 6      # processes of the audit (the card's host has 8 cores)


def audit_one(name: str, phase: str) -> dict:
    """One (config, phase) audit against the golden, in a worker process
    (it runs on ``meta``, on the host's CPU alone)."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis.op_audit import audit_phase
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    res = audit_phase(get_config(name), phase)
    want = json.loads((ROOT / "experiments" / "audit" / "audit_report.json")
                      .read_text())["configs"][name]["phases"][phase]
    ok = (res["untagged"] == 0 and res["ledger_mismatches"] == 0
          and all(res[k] == want[k] for k in ("contracts", "calls", "macs")))
    return {"config": name, "phase": phase,
            "seconds": time.perf_counter() - t0,
            "calls": res["calls"], "macs": res["macs"],
            "contractions": res["dot_generals"],
            "tagged_values": res["tagged_values"],
            "declared_digital": res["declared_digital"],
            "transposes": res["transposes"], "ok": ok,
            "details": None if ok else (res["untagged_details"][:2],
                                        res["ledger_mismatch_details"][:2])}


def analysis_audit(card: str) -> None:
    """The ledger audit (``analysis.op_audit``) of all 11 configs x
    {prefill, decode, train} at full width, traced on ``meta``, in
    ``AUDIT_WORKERS`` spawned processes (the recurrent prefills first:
    their per-token loops are the longest traces): every contraction
    tagged or declared digital (``untagged == 0``), every contract traced
    as often as the ledger records it (``ledger_mismatches == 0``), and
    ``contracts``, ``calls`` and ``macs`` equal to the JAX package's
    committed ``experiments/audit/audit_report.json``."""
    import multiprocessing

    from repro_torch.configs import list_configs

    slow = ("mamba2-1.3b", "recurrentgemma-9b")
    cases = sorted(((name, phase) for name in list_configs()
                    for phase in ("prefill", "decode", "train")),
                   key=lambda c: (c != (slow[0], "prefill"),
                                  c != (slow[1], "prefill"), c[1] != "train"))
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(AUDIT_WORKERS) as pool:
        rows = pool.starmap(audit_one, cases)
    wall = time.perf_counter() - t0
    bad = [(r["config"], r["phase"], r["details"]) for r in rows
           if not r["ok"]]
    emit({"phase": "analysis_audit", "audits": len(rows),
          "workers": AUDIT_WORKERS, "wall_seconds": wall,
          "equal_to_golden": sum(r["ok"] for r in rows),
          "seconds_per_trace": {f"{r['config']}/{r['phase']}": r["seconds"]
                                for r in rows},
          "rows": rows, "card": card})
    if bad:
        fail(f"analysis_audit: {len(bad)} audits differ from the golden or "
             f"leak: {bad}")


DRYRUN_WORKERS = 6     # processes of the dry-run sweep (8 host cores)
DRYRUN_SKIPPED = 7     # long_500k cells of the full-attention archs
DRYRUN_SINGLE_POD_S = 60   # the multi-pod sweep runs if one pod took less


def dryrun_one(arch: str, multi_pod: bool, out_dir: str) -> list:
    """The dry run's four shapes of one arch on one production mesh, in a
    worker process (``meta`` tensors on the ``fake`` group: the host's
    CPU alone)."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import SHAPES

    rows = dryrun.sweep([arch], list(SHAPES), [multi_pod], out_dir=out_dir,
                        verbose=False)
    keep = ("arch", "shape", "mesh", "status", "reason", "error", "trace_s",
            "fits", "bytes_per_device", "cost", "roofline")
    return [{k: r[k] for k in keep if k in r} for r in rows]


def dryrun_phase(card: str) -> None:
    """``launch.dryrun`` over the 10 ``ARCHS`` x 4 shapes on the 16 x 16
    mesh (256 ranks of the ``fake`` group), in ``DRYRUN_WORKERS`` spawned
    processes, and on the 2 x 16 x 16 mesh too when the first sweep took
    under ``DRYRUN_SINGLE_POD_S``: 0 errors and exactly
    ``DRYRUN_SKIPPED`` skipped cells a mesh. One ``dryrun_cell`` line a
    cell (per-device GB, fits, flops, collective GB, dominant term,
    roofline fraction: H100 data-sheet model outputs, not measurements)."""
    import multiprocessing

    from repro_torch.launch.dryrun import ARCHS

    # the trains of the largest archs are the longest traces
    order = sorted(ARCHS, key=lambda a: a not in (
        "grok-1-314b", "arctic-480b", "recurrentgemma-9b", "chameleon-34b"))
    sweeps, rows = [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, \
            multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        for multi_pod in (False, True):
            if multi_pod and time.perf_counter() - t0 >= DRYRUN_SINGLE_POD_S:
                break
            t1 = time.perf_counter()
            for got in pool.starmap(dryrun_one, [(a, multi_pod, out)
                                                 for a in order]):
                rows.extend(got)
            sweeps.append({"mesh": "2x16x16" if multi_pod else "16x16",
                           "seconds": time.perf_counter() - t1})
    bad = []
    for sweep in sweeps:
        mine = [r for r in rows if r["mesh"] == sweep["mesh"]]
        sweep.update({st: sum(r["status"] == st for r in mine)
                      for st in ("ok", "skipped", "error")})
        if sweep["error"] or sweep["skipped"] != DRYRUN_SKIPPED \
                or sweep["ok"] + sweep["skipped"] != 40:
            bad.append(sweep)
    for r in rows:
        if r["status"] != "ok":
            emit({"phase": "dryrun_cell", **{k: r.get(k) for k in (
                "arch", "shape", "mesh", "status", "reason", "error")}})
            continue
        b, c, f = r["bytes_per_device"], r["cost"], r["roofline"]
        emit({"phase": "dryrun_cell", "arch": r["arch"], "shape": r["shape"],
              "mesh": r["mesh"], "status": "ok", "trace_s": r["trace_s"],
              "peak_est_gb": b["peak_est"] / 1e9, "fits": r["fits"],
              "flops_per_device": c["flops_per_device"],
              "collective_gb_per_device":
                  c["collective_bytes_per_device"] / 1e9,
              "dominant": f["dominant"], "hlo_per_model": f["hlo/model"],
              "roofline_fraction": f["roofline_fraction"]})
    emit({"phase": "dryrun", "sweeps": sweeps, "workers": DRYRUN_WORKERS,
          "wall_seconds": time.perf_counter() - t0,
          "fit": sum(bool(r.get("fits")) for r in rows),
          "model_outputs_of": "H100 SXM data-sheet figures (launch.mesh.HW)",
          "host_card": card})
    if bad:
        fail(f"dryrun: errors or skips other than {DRYRUN_SKIPPED}: {bad}")


def roofline_card_phase(arch, card: str, measured_ms: dict) -> None:
    """The port's roofline of the shapes this run measures, on a 1 x 1
    mesh of the ``fake`` group: paper-cim-120m decode at 8 slots / ctx
    512, the no-cache prefill forward at 8 x 64 and the train step at 8 x
    256, each beside its measured ms; the CIM flops must equal twice the
    energy ledger's MACs for those shapes (the train step's: the forward's
    and remat's recomputation of every super-block's projections)."""
    import torch

    from repro_torch.core import costs
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import roofline_from_trace

    cases = {"decode": specs.ShapeCase("decode_8x512", 512, 8, "decode"),
             "prefill": specs.ShapeCase("prefill_8x64", 64, 8, "prefill"),
             "train": specs.ShapeCase("train_8x256", 256, 8, "train")}
    ledgers = {"decode": costs.trace_decode(arch, batch=8, ctx=512),
               "prefill": costs.trace_prefill(arch, bucket=64, batch=8,
                                              ctx=512),
               "train": costs.trace_train(arch, batch=8, seq_len=256)}
    bad = []
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        for kind, case in cases.items():
            t0 = time.perf_counter()
            cell = specs.make_cell(arch, case, mesh,
                                   cache_dtype=getattr(torch, arch.dtype))
            rep, mem, cost = roofline_from_trace(
                arch.name, case.name, "1x1", 1, cell.fn, cell.args, arch,
                case)
            del cell
            led = ledgers[kind]
            want = 2 * led.macs()
            if kind == "train" and arch.remat:
                want += 2 * (led.macs() - led.macs("head"))
            bound = 1e3 * max(rep.t_compute, rep.t_memory, rep.t_collective)
            emit({"phase": "roofline_card", "arch": arch.name, "of": kind,
                  "shape": [case.global_batch, case.seq_len],
                  "flops": cost["flops_per_device"],
                  "cim_flops": cost["cim_flops_per_device"],
                  "ledger_ops": want, "bytes": cost["bytes_per_device"],
                  "collective_bytes": cost["collective_bytes_per_device"],
                  "t_compute_ms": 1e3 * rep.t_compute,
                  "t_memory_ms": 1e3 * rep.t_memory,
                  "dominant": rep.dominant, "bound_ms": bound,
                  "measured_ms": measured_ms[kind],
                  "measured_over_bound": measured_ms[kind] / bound,
                  "peak_est_gb": mem["peak_est"] / 1e9,
                  "trace_s": time.perf_counter() - t0, "card": card})
            if cost["cim_flops_per_device"] != want:
                bad.append((kind, cost["cim_flops_per_device"], want))
    if bad:
        fail(f"roofline_card: CIM flops differ from the ledger's: {bad}")


def examples_phase(card: str, reset_counts) -> dict:
    """The five examples through their ``main`` on the card, short
    arguments, their output captured, the counts set to 0 before each:
    ``serve_decode`` (paper-cim-120m at full width) 85 GR-MAC launches an
    eager dispatch and a graph's warm-up and capture, ``train_lm``
    (``--cim grmac``, 8 x 256) 169 a step. Returns the launches by
    example."""
    import shutil

    from repro_torch.examples import (design_explorer, quickstart,
                                      serve_decode, site_pareto, train_lm)
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    runs = (("quickstart", quickstart.main, []),
            ("design_explorer", design_explorer.main, []),
            ("site_pareto", site_pareto.main, []),
            ("serve_decode", serve_decode.main, ["--steps", "8"]),
            ("train_lm", train_lm.main, ["--cim", "grmac", "--steps", "2",
                                         "--ckpt", ckpt]))
    launches, bad = {}, []
    try:
        for name, fn, argv in runs:
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = fn(argv)
            secs = time.perf_counter() - t0
            n = grmac_matmul_cuda.launches
            launches[name] = n
            want = None
            if name == "serve_decode":
                want = host_launches(85, res.stats["prefill_dispatches"]
                                     + res.stats["decode_steps"],
                                     res.graph_stats)
            elif name == "train_lm":
                want = 169 * 2
            emit({"phase": "examples", "example": name, "argv": argv,
                  "seconds": secs, "kernel_launches": n,
                  "expected_launches": want,
                  "tail": buf.getvalue().strip().splitlines()[-3:],
                  "card": card})
            if want is not None and n != want:
                bad.append((name, n, want))
            del res
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if bad:
        fail(f"examples: GR-MAC launches differ: {bad}")
    return launches


SPLIT_RANKS = 2      # spmd_split: ranks on the one card ("model" of 1 x 2)
# spmd_split's runs of serve's traffic: (label, max_ctx, KV context split
# over "model", CIM mode, decode steps). max_ctx 128 splits the context in
# chunks of 64 slots, which the longer prompts' decode crosses; each split
# run is compared with the rows-only run of its mode at the same max_ctx
SPLIT_RUNS = (("kv_rows", 512, False, "grmac", 32),
              ("kv_rows_128", 128, False, "grmac", 32),
              ("kv_split", 128, True, "grmac", 32),
              ("off_rows", 128, False, "off", 8),
              ("off_split", 128, True, "off", 8))
SPLIT_PAIRS = (("grmac", "kv_rows_128", "kv_split"),
               ("off", "off_rows", "off_split"))
SPLIT_CHECKS = (("wq", 8), ("wi", 8), ("head", 8), ("wq", 64), ("wi", 64),
                ("head", 64))   # spmd_split's kernel-vs-plain calls (site, M)


def spmd_split_worker(rank: int, world: int, store: str, out_dir: str,
                      prompts: list, device: str, reduced: bool) -> None:
    """One rank of ``spmd_split``: paper-cim-120m (``reduced``: its
    reduced config, for a rehearsal on the CPU) on a 1 x ``world`` ("data",
    "model") mesh of a gloo group on ``device``, its params placed by
    ``param_specs``; ``serve``'s traffic through the engine in each of
    ``SPLIT_RUNS`` (the KV by rows only or with its context split over
    "model", GR-MAC or the CIM path off), the kernel's launches counted
    from 0 for each run and the N of every launch kept; in each mode of
    ``SPLIT_PAIRS``, the split run's tokens and decode logits against the
    rows-only run's at the same max_ctx, the logits while their tokens
    agree (the split's merge alone between them); the no-cache forward at
    8 x 64 on the placed raw params (each projection packed per call from
    its chunk, ``wo`` exchanged by an all-to-all) against the served
    params'; the kernel against its plain version at this rank's chunks.
    Writes ``rank<r>.json`` to ``out_dir``."""
    import faulthandler

    faulthandler.enable()
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.grmac_matmul import DESIGNS, grmac_matmul_cuda
    from repro_torch.launch import specs
    from repro_torch.models import forward, init_params
    from repro_torch.parallel import sharding
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tree import tree_map

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    launch_n = []
    real_cuda = ops.grmac_matmul_cuda

    def counted(x, w, *a, **k):
        launch_n.append(w.n)
        return real_cuda(x, w, *a, **k)

    ops.grmac_matmul_cuda = counted

    def sync():
        if on_card:
            torch.cuda.synchronize()

    try:
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(1, world),
                          mesh_dim_names=("data", "model"))

        def place(tree, spec_tree):
            # every rank holds the same tree: each takes its shards
            return tree_map(lambda t, sp: distribute_tensor(
                t, mesh, sharding.placements(
                    tuple(sp) + (None,) * (t.dim() - len(sp)), mesh),
                src_data_rank=None), tree, spec_tree)

        arch = get_config("paper-cim-120m")
        arch = arch.reduced() if reduced else arch
        params = init_params(arch, SEED, device=dev)
        placed = place(params, sharding.param_specs(params, mesh))
        out = {"rank": rank, "mesh": list(mesh.shape), "runs": {}}
        logits = {}
        for label, ctx, split_kv, mode, n_steps in SPLIT_RUNS:
            run_arch = arch.replace(cim=arch.cim.with_mode(mode))
            with sharding.use_mesh(mesh):
                engine = Engine(run_arch, placed, ServeConfig(
                    batch_slots=SLOTS, max_ctx=ctx), device=dev)
                if split_kv:
                    case = specs.ShapeCase("serve", ctx, SLOTS, "decode")
                    engine.cache = place(engine.cache, specs.cache_spec_tree(
                        run_arch, case, mesh, engine.cache))
                steps = []
                decode = engine._decode

                def kept(*a, _decode=decode, _steps=steps, **k):
                    got = _decode(*a, **k)
                    _steps.append(got.float().cpu())
                    return got

                engine._decode = kept
                sync()
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                grmac_matmul_cuda.launches = 0
                grmac_matmul_cuda.launches_by_design = dict.fromkeys(
                    DESIGNS, 0)
                launch_n.clear()
                t0 = time.perf_counter()
                for prompt in prompts:
                    engine.add_request(prompt)
                sync()
                prefill_s = time.perf_counter() - t0
                step_ms = []
                for _ in range(n_steps):
                    t0 = time.perf_counter()
                    engine.step()
                    sync()
                    step_ms.append(1e3 * (time.perf_counter() - t0))
            out["runs"][label] = {
                "max_ctx": ctx, "cim": mode,
                "kv_leaves_split": sum(
                    sharding.is_dtensor(t) and "Shard(dim=1)" in str(
                        t.placements) for c in engine.cache["layers"]
                    for t in c.values()),
                "streams": [list(t) for t in engine.tokens],
                "kernel_launches": grmac_matmul_cuda.launches,
                "launches_by_design": dict(
                    grmac_matmul_cuda.launches_by_design),
                "launch_n": sorted(set(launch_n)),
                "dispatches": (engine.stats["prefill_dispatches"]
                               + engine.stats["decode_steps"]),
                "prefill_s": prefill_s,
                "decode_ms_median": float(np.median(step_ms)),
                "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                   if on_card else None)}
            logits[label] = torch.stack(steps)
            if label == "kv_rows":
                served = engine.params
            del engine
        # each split KV's decode logits against the rows-only run's at the
        # same max_ctx, over the steps before the first token that differs
        # (decode step j feeds lane i its token len(prompt) + j): the
        # split's merge alone between them
        for mode, base_label, split_label in SPLIT_PAIRS:
            rows, split = (out["runs"][k]["streams"]
                           for k in (base_label, split_label))
            agree = min(len(logits[base_label]), min(
                next((i for i, (a, b) in enumerate(zip(r, t)) if a != b),
                     len(r)) - len(p)
                for r, t, p in zip(rows, split, prompts)))
            base = logits[base_label]
            d = (logits[split_label][:agree] - base[:agree]).abs()
            scale = float(base.abs().max())
            out[f"{mode}_tokens_differing"] = sum(
                a != b for r, t in zip(rows, split) for a, b in zip(r, t))
            out[f"{mode}_steps_compared"] = agree
            out[f"{mode}_first_decode_max_abs_dlogit"] = (
                float(d[0].max()) if agree > 0 else None)
            out[f"{mode}_decode_max_abs_dlogit"] = (
                float(d.max()) if agree > 0 else None)
            for k in (f"{mode}_first_decode", f"{mode}_decode"):
                v = out[f"{k}_max_abs_dlogit"]
                out[f"{k}_rel_dlogit"] = None if v is None else v / scale
        out["kv_split_finite"] = bool(all(
            torch.isfinite(logits[k]).all() for k in ("kv_split",
                                                      "off_split")))
        # the no-cache forward: the placed raw params (per-call packing of
        # each chunk) against the served params, under the mesh
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        toks = torch.randint(0, arch.vocab_size, (SLOTS, 64), device=dev,
                             generator=gen)
        with torch.no_grad(), sharding.use_mesh(mesh):
            raw_logits = forward(placed, toks, arch)[0]
            packed_logits = forward(served, toks, arch)[0]
        out["forward_raw_equals_served"] = bool(
            torch.equal(raw_logits, packed_logits))
        out["forward_finite"] = bool(torch.isfinite(raw_logits).all())
        # the kernel against its plain version at this rank's chunks
        cfg = arch.cim.for_site("mlp")
        layer, served_layer = params["layers"][0], served["layers"][0]
        weights = {"wq": (layer["attn"]["wq"]["w"],
                          served_layer["attn"]["wq"]["w"], "attn_qkv"),
                   "wi": (layer["ffn"]["wi"]["w"],
                          served_layer["ffn"]["wi"]["w"], "mlp"),
                   "head": (params["lm_head"]["w"] if "lm_head" in params
                            else params["embed"].T,
                            served["lm_head"]["w"], "head")}
        errs = {}
        with torch.no_grad(), sharding.use_mesh(mesh), sharding.spmd():
            for name, m in SPLIT_CHECKS:
                raw, packed, site = weights[name]
                x = torch.randn((m, raw.shape[0]), device=dev, generator=gen)
                got = ops.cim_matmul(x, sharding.split_model(packed),
                                     cfg, site=site)
                want = ops.cim_matmul(x, sharding.split_model(raw), cfg,
                                      site=site, backend="ref")
                errs[f"{name}_m{m}"] = {
                    "n": got.shape[-1],
                    "max_abs_err": float((got - want).abs().max()),
                    "bitwise": bool(torch.equal(got, want))}
        out["kernel_vs_plain"] = errs
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        ops.grmac_matmul_cuda = real_cuda
        dist.destroy_process_group()


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
    from repro_torch.analysis import sanitize
    from repro_torch.kernels.grmac_matmul import (DESIGNS, INSTANTIATIONS,
                                                  build, grmac_matmul_cuda)
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.kernels.packed import pack_weight, unpack_weight
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, pack_params, prefill_step,
                                    to_device, train_loss)
    from repro_torch.kernels import ssm_scan as scan_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serving import Engine, ServeConfig, energy_report
    from repro_torch.tree import tree_leaves, tree_map

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
        scan_mod.ssm_scan.launches = 0

    @contextlib.contextmanager
    def plain_recurrence(on=True):
        """With ``on``, the SSM block's recurrence runs its plain version,
        the per-step loop, on the card too: the oracle's side of a
        comparison. The CIM backend ``ref`` leaves the recurrence alone
        (it is digital), and the block takes the scan by device."""
        real = scan_mod.applies
        if on:
            scan_mod.applies = lambda device: False
        try:
            yield
        finally:
            scan_mod.applies = real

    def scan_layers(arch) -> int:
        """The SSM blocks of ``arch``: one scan launch each a dispatch."""
        return sum(kind == "ssm" for kind in arch.blocks())

    # the scan's launches in the paths that count them, and its check
    scan_by_path = {}
    scan_check = {}

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

    def time_forward(path, arch, m, design, pack=False):
        """Times of one forward's row launches at M = m: each projection
        shape, then the forward's sum weighted by launches per forward.
        With ``pack``, also the per-call route's packing of each raw weight
        (``pack_weight``: pre-scale, quantize, codes), which training pays
        on every call."""
        # bound_ms split by the term that sets each launch's bound
        tot = {"ms": 0.0, "eager_loop_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_bound_ms": 0.0,
               "operations_bound_ms": 0.0, "f32_weight_bound_ms": 0.0,
               "pack_ms": 0.0 if pack else None}
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
            raws = [torch.randn((k, n), generator=gen, device=dev)
                    for _ in range(copies)]
            ws = [pack_weight(w, fmt_w, n_r) for w in raws]
            t_pack = None
            if pack:
                t_pack = cuda_ms(lambda i: pack_weight(
                    raws[i % copies], fmt_w, n_r), 10)
                tot["pack_ms"] += per_fwd * t_pack
            del raws

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
                  "pack_ms": t_pack, "card": card})
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
    # paper-cim-120m's train forward: batch 8 x seq 256 rows per projection
    totals["train_forward"] = time_forward("train_forward", paper, 8 * 256,
                                           None, pack=True)

    def time_sanitizing(path, arch, m):
        """Graph ms of one forward's row launches at M = m through the plain
        and the sanitizing instantiation, in turns (plain, sanitizing,
        sanitizing, plain; each the mean of its two), summed over the
        forward's launches."""
        tot = dict.fromkeys(INSTANTIATIONS, 0.0)
        shapes = {}
        for name, k, n, per_fwd in projections(arch):
            shapes[(k, n)] = shapes.get((k, n), 0) + per_fwd
        for (k, n), per_fwd in shapes.items():
            copies = max(1, math.ceil(2 * 50e6 / (k * n / 2)))
            xs = [operands(m, k, n, fmt_w)[0] for _ in range(4)]
            amaxs = [torch.amax(torch.abs(x)) for x in xs]
            ws = [pack_weight(torch.randn((k, n), generator=gen, device=dev),
                              fmt_w, n_r) for _ in range(copies)]

            def call(i):
                return grmac_matmul_cuda(xs[i % 4], ws[i % copies],
                                         amaxs[i % 4], tag="timing", **kw)

            t = {inst: [] for inst in INSTANTIATIONS}
            for inst in ("plain", "sanitizing", "sanitizing", "plain"):
                if inst == "sanitizing":
                    os.environ[sanitize.ENV_VAR] = "1"
                try:
                    t[inst].append(graph_ms(call, 20))
                finally:
                    os.environ.pop(sanitize.ENV_VAR, None)
                    sanitize.clear()
            for inst in INSTANTIATIONS:
                tot[inst] += per_fwd * float(np.mean(t[inst]))
            del xs, ws, amaxs
            torch.cuda.empty_cache()
        emit({"phase": "timing_sanitizing", "path": path, "arch": arch.name,
              "m": m, "per_forward_graph_ms": tot,
              "launches_per_forward": per_forward(arch), "card": card})
        return tot

    totals["sanitizing"] = {key: time_sanitizing(key, paper, m)
                            for key, m in (("decode", 8), ("prefill", 512))}

    def scan_operands(arch, s, lengths):
        """The SSD scan's operands at ``arch``'s SSM widths, all its heads,
        ``SLOTS`` lanes, ``s`` steps, drawn on the card: x in the arch's
        dtype and B / C as slices of wider projections (as the block hands
        them over), the decay rate, D and the conv taps as the block makes
        them, a state far from zero. ``lengths`` None: every step
        commits, as in decode."""
        nh, n, hd, w = (arch.ssm_heads, arch.ssm_state, arch.ssm_headdim,
                        arch.conv_width)
        chans = nh * hd
        g = torch.Generator(device=dev).manual_seed(SEED + s)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)

        bc = randn(SLOTS, s, 2 * n)
        return dict(
            x=randn(SLOTS, s, 2 * chans).to(getattr(torch, arch.dtype))[
                ..., chans:],
            bmat=bc[..., :n], cmat=bc[..., n:],
            dt=torch.nn.functional.softplus(randn(SLOTS, s, nh) - 1.0),
            rate=torch.linspace(1.0, 16.0, nh, device=dev)[None, :],
            d_skip=1.0 + 0.1 * randn(nh),
            kernel=(0.1 * randn(w, chans)).to(
                getattr(torch, arch.dtype)).float(),
            h=randn(SLOTS, nh, n, hd), win=randn(SLOTS, w - 1, chans),
            length=None if lengths is None else torch.tensor(
                lengths, dtype=torch.int64, device=dev))

    def scan_bytes(arch, s) -> int:
        """Bytes the scan must move once at ``SLOTS`` lanes and ``s`` steps:
        the state and the conv window read and written, x, B, C and dt
        read, y written."""
        nh, n, hd, w = (arch.ssm_heads, arch.ssm_state, arch.ssm_headdim,
                        arch.conv_width)
        xb = torch.finfo(getattr(torch, arch.dtype)).bits // 8
        per_lane = (2 * 4 * (nh * n * hd + (w - 1) * nh * hd)
                    + s * (xb * nh * hd + 4 * (2 * n + nh) + 4 * nh * hd))
        return SLOTS * per_lane

    def check_scan():
        """The SSD scan against the SSM block's per-step loop, its plain
        version, on the same tensors at ``SLOTS`` lanes: mamba2-1.3b at
        full width (bf16 x, N 128, P 64) and reduced (N 16, P 32), S 1
        (decode's no lengths, and lengths), 16 and 32 (a second 16-step
        tile), 24 (a partial second tile), lengths 0, 1, S - 3 and S mixed
        over the lanes. State, conv window and y bitwise. At full width
        the scan's device time by CUDA-graph replay against the bytes it
        must move at 3.35 TB/s, and the loop's time eagerly."""
        for name in ("mamba2-1.3b", "mamba2-1.3b-reduced"):
            arch = archs["mamba2-1.3b"]
            arch = arch.reduced() if name.endswith("reduced") else arch
            for s in (1, 16, 24, 32):
                cases = [[max(0, v) for v in
                          (0, 1, s - 3, s, s, s - 3, 1, 0)]]
                cases += [None] if s == 1 else []
                for lengths in cases:
                    ops = scan_operands(arch, s, lengths)
                    loop_len = (torch.full((SLOTS,), s, device=dev)
                                if lengths is None else ops["length"])
                    y_l, h_l, w_l = ssm_mod._loop(
                        ops["d_skip"], arch.ssm_headdim, ops["kernel"],
                        ops["rate"], ops["h"], ops["win"], ops["x"],
                        ops["bmat"], ops["cmat"], ops["dt"], loop_len)
                    before = scan_mod.ssm_scan.launches
                    y_s, h_s, w_s = scan_mod.ssm_scan(**ops)
                    torch.cuda.synchronize()
                    err = float((y_s - y_l).abs().max())
                    line = {"phase": "ssm_scan_check", "arch": name,
                            "lanes": SLOTS, "steps": s, "lengths": lengths,
                            "launches": scan_mod.ssm_scan.launches - before,
                            "state_equal": bool(torch.equal(h_s, h_l)),
                            "window_equal": bool(torch.equal(w_s, w_l)),
                            "y_equal": bool(torch.equal(y_s, y_l)),
                            "y_max_abs_err": err}
                    scan_check["max_abs_err"] = max(
                        err, scan_check.get("max_abs_err", 0.0))
                    if name == "mamba2-1.3b" and lengths is not None:
                        b_ms = scan_bytes(arch, s) / 3.35e12 * 1e3
                        line.update(
                            ms=graph_ms(lambda i: scan_mod.ssm_scan(**ops),
                                        20),
                            plain_ms=cuda_ms(lambda i: ssm_mod._loop(
                                ops["d_skip"], arch.ssm_headdim,
                                ops["kernel"], ops["rate"], ops["h"],
                                ops["win"], ops["x"], ops["bmat"],
                                ops["cmat"], ops["dt"], loop_len), 3),
                            bytes=scan_bytes(arch, s), bound_ms=b_ms)
                        scan_check.setdefault("by_steps", {})[s] = {
                            k: line[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bytes")}
                    emit({**line, "card": card})
                    if not (line["launches"] == 1 and line["state_equal"]
                            and line["window_equal"] and line["y_equal"]):
                        fail(f"ssm_scan_check: {name} S {s} lengths "
                             f"{lengths}: the scan differs from the loop "
                             f"({line})")
                    del ops, y_l, h_l, w_l, y_s, h_s, w_s
        scan_by_path["ssm_scan_check"] = scan_mod.ssm_scan.launches
        torch.cuda.empty_cache()

    scan_mod.ssm_scan.launches = 0
    check_scan()
    seconds("timing")

    # -------------------------------------------------------------- serve
    from torch.profiler import ProfilerActivity, profile, record_function

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def grmac_on_card_of(fn, grmac):
        """(GR-MAC kernels that ``fn``'s dispatches ran on the card, as the
        profiler sees them, replays of CUDA graphs included; the rise of
        ``grmac``, a reading of the kernels the dispatches so far should
        have run, across ``fn``; profiles taken). In one profiling session
        ``fn`` runs twice and only the second run counts: the profiler
        can miss the first records of a graph's first replay in a session
        (3 of gemma3-1b's 183 GR-MAC kernels, each session, late in the
        run). A count below is profiled again, up to ``PROFILE_TRIES``
        times: the profiler drops a record now and then, never adds
        one."""
        cuda = torch.autograd.DeviceType.CUDA
        for tries in range(1, PROFILE_TRIES + 1):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
                time.sleep(0.01)
                before = grmac()
                with record_function("chip_smoke.counted"):
                    fn()
                torch.cuda.synchronize()
            want = grmac() - before
            events = prof.events()
            mark = min(e.time_range.start for e in events
                       if e.name == "chip_smoke.counted"
                       and e.device_type != cuda)
            ran = sum(1 for e in events if e.device_type == cuda
                      and not e.is_user_annotation and "grmac" in e.name
                      and e.time_range.start >= mark)
            if ran >= want:
                break
        return ran, want, tries

    def profiled(path, what, fn, count, grmac=None):
        """``fn`` under torch.profiler: the device's busy share of the wall
        time, CUDA launches per ``count`` (steps or dispatches) and the
        top kernels and host operators; a decode or speculative step's
        launches must equal ``STEP_LAUNCHES[path]``. Where ``grmac`` is
        given (``grmac_on_card_of``), the GR-MAC kernels that ``fn``'s
        dispatches ran on the card must be the ones they should have run,
        replayed or eager. Returns the line."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = prof.key_averages()
        # device-side entries only: an operator's own row repeats its kernels,
        # and the program's scopes are listed on the device's side too
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_us = sum(dev_us(e) for e in kernels)
        launch_calls = sum(e.count for e in events
                           if e.key.startswith(("cudaLaunchKernel",
                                                "cuLaunchKernel")))
        grmac_ran = grmac_want = tries = None
        if grmac is not None:
            grmac_ran, grmac_want, tries = grmac_on_card_of(fn, grmac)
            grmac_on_card[path] = grmac_on_card.get(path, 0) + grmac_ran
            if grmac_ran != grmac_want:
                fail(f"{path}: {grmac_ran} GR-MAC kernels ran on the card "
                     f"in {count} x {what}, not {grmac_want} ({tries} "
                     "profiles)")
        top_dev = sorted(kernels, key=dev_us, reverse=True)[:12]
        top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:12]
        checked = what in ("decode_step", "spec_step")
        want = (STEP_LAUNCHES.get(path) if checked and (
            path != "serve_grok" or grok_layers == 4) else None)
        if want is not None and launch_calls != want * count:
            fail(f"{path}: {launch_calls / count} CUDA launches a {what}, "
                 f"not {want}")
        line = {"phase": "profile", "path": path, "of": what, "count": count,
              "wall_us": wall_us, "device_busy_us": busy_us,
              "device_idle_share": (1 - busy_us / wall_us) if busy_us
              else None,
              "cuda_launches_per": launch_calls / count,
              "expected_launches_per": want,
              "grmac_kernels": grmac_ran,
              "expected_grmac_kernels": grmac_want, "profiles": tries,
              "device_ops_per": sum(e.count for e in kernels) / count,
              "top_device": [(e.key, e.count, dev_us(e)) for e in top_dev],
              "top_cpu_self": [(e.key, e.count, e.self_cpu_time_total)
                               for e in top_cpu],
              "card": card}
        emit(line)
        return line

    def profile_path(path, engine, arch, bucket):
        """Three more decode steps, then one full-bucket prefill dispatch
        into a freed slot (RG-LRU's per-token loop, mamba2's scan show
        there);
        each forward ran ``per_forward`` GR-MAC kernels on the card,
        replayed or eager."""
        def dispatches():
            return (engine.stats["prefill_dispatches"]
                    + engine.stats["decode_steps"])

        def steps():
            for _ in range(3):
                engine.step()

        # one prompt, drawn once: ``profiled`` may run ``prefill`` again,
        # and the later phases' draws from ``rng`` stay where they were
        prompt = [int(t) for t in rng.integers(0, arch.vocab_size, bucket)]

        def prefill():
            engine.release_slot(0)
            engine.add_request(prompt)

        profiled(path, "decode_step", steps, 3,
                 grmac=lambda: per_forward(arch) * dispatches())
        profiled(path, f"prefill_dispatch_of_{bucket}_tokens", prefill, 1,
                 grmac=lambda: per_forward(arch) * dispatches())

    def run_engine(arch, params, prompts, n_steps, serve_kw, backend):
        """Serve through the kernel (``backend`` None) or the plain version
        (``"ref"``: the GR-MAC oracle and the SSM block's per-step loop)."""
        prefill_ms, decode_ms = [], []
        last = None
        with plain_recurrence(backend == "ref"):
            engine = Engine(arch, params, ServeConfig(
                batch_slots=SLOTS, cim_backend=backend, **serve_kw),
                device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for p in prompts:
                t0 = time.perf_counter()
                engine.add_request(p)
                torch.cuda.synchronize()
                prefill_ms.append(1e3 * (time.perf_counter() - t0))
            for _ in range(n_steps):
                t0 = time.perf_counter()
                last = engine.step()
                torch.cuda.synchronize()
                decode_ms.append(1e3 * (time.perf_counter() - t0))
        return (engine, prefill_ms, decode_ms,
                torch.cuda.max_memory_allocated(), last)

    launches_by_path = {}
    # GR-MAC kernels run on the card in each path's profiles, counted by
    # the profiler (a graph replay's too, which the host does not launch)
    grmac_on_card = {}
    served_streams = {}       # each serve path's streams, before its profile
    by_design_total = dict.fromkeys(DESIGNS, 0)
    step_median = {}          # decode step median ms of each serve path

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
        kernel with the counts set to 0 just before the engine is built
        and read just after (``host_launches``), profile, then the same
        traffic through the plain version: the streams must be identical.
        Returns the kernel's engine and its last step result if asked
        (else Nones)."""
        v = arch.vocab_size
        fwd = per_forward(arch)
        reset_counts()
        take_drops()
        engine, prefill_ms, decode_ms, peak, last = run_engine(
            arch, params, prompts, n_steps, serve_kw, None)
        launches = grmac_matmul_cuda.launches
        scans = scan_mod.ssm_scan.launches
        dropped = take_drops()
        by_design = dict(grmac_matmul_cuda.launches_by_design)
        launches_by_path[path] = launches
        step_median[path] = float(np.median(decode_ms))
        for d in DESIGNS:
            by_design_total[d] += by_design[d]
        dispatches = (engine.stats["prefill_dispatches"]
                      + engine.stats["decode_steps"])
        want = host_launches(fwd, dispatches, engine.graph_stats)
        scan_want = scan_layers(arch) * dispatches
        if scan_want:
            scan_by_path[path] = scans
        streams = [list(t) for t in engine.tokens]
        served_streams[path] = streams
        emit({"phase": path, "arch": arch.name, "batch_slots": SLOTS,
              **serve_kw, **(extra or {}),
              "prompt_lens": [len(p) for p in prompts],
              "stats": engine.stats, "graph_stats": engine.graph_stats,
              "kernel_launches": launches,
              "kernel_launches_by_design": by_design,
              "launches_per_forward": fwd,
              "expected_launches": want,
              "scan_launches": scans, "expected_scan_launches": scan_want,
              "prefill_ms": prefill_ms, "decode_ms": decode_ms,
              "decode_ms_median": float(np.median(decode_ms)),
              "decode_tok_s_median": SLOTS * 1e3 / float(np.median(
                  decode_ms)),
              "peak_mem_bytes": peak, "moe_dropped_assignments": dropped,
              "card": card})
        if launches != want:
            fail(f"{path}: {launches} kernel launches for {dispatches} "
                 f"dispatches and {engine.graph_stats} (expected {want})")
        if scans != scan_want:
            fail(f"{path}: {scans} launches of the SSD scan for "
                 f"{dispatches} dispatches (expected {scan_want})")
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
        if grmac_matmul_cuda.launches or scan_mod.ssm_scan.launches:
            fail(f"{path}: the ref run launched the kernel or the scan")
        o_dropped = take_drops()
        same = [list(t) for t in oracle.tokens] == streams
        emit({"phase": f"{path}_oracle", "streams_equal": same,
              "recurrence": "loop" if scan_want else None,
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

    # ------------------------------------------------------ serve_scheduler
    from repro_torch.serving import sampling
    from repro_torch.serving.params import SamplingParams
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               StepClock, run_open_loop,
                                               synth_shared_prefix_traffic,
                                               synth_traffic)

    def capacity(out_len):
        """Saturation rate of ``SLOTS`` lanes (requests per dispatch unit),
        as the reference's benchmarks/traffic_bench.py estimates it: a
        request holds a slot for its mean output plus ~2 prefill chunks."""
        return SLOTS / ((out_len[0] + out_len[1]) / 2.0 + 2.0)

    def policy(m):
        """The metrics read off the policy clock (the wall-clock ones
        left out): equal between the kernel and the plain version."""
        return {k: v for k, v in m.items()
                if not k.endswith(("_ms", "_s"))}

    def fetch_counted(engine):
        """Count every device-to-host fetch of ``engine``."""
        seen = {"fetch": 0}
        real_fetch = engine._fetch

        def fetch(ids):
            seen["fetch"] += 1
            return real_fetch(ids)

        engine._fetch = fetch
        return seen

    def scheduled_run(arch, params, backend, drive):
        """One scheduler run on a new engine (8 slots, max_ctx 512, prefix
        cache on) through ``drive(sched, clock)``, the kernel's launches
        counted from 0 just before and read just after, and every fetch
        and first-token selection counted."""
        engine = Engine(arch, params, ServeConfig(
            batch_slots=SLOTS, max_ctx=512, cim_backend=backend,
            prefix_cache_bytes=1 << 28), device=dev)
        seen = fetch_counted(engine)
        seen["first"] = 0
        real_finish = engine.finish_prefill

        def finish(slot, key=None):
            seen["first"] += 1
            return real_finish(slot, key=key)

        engine.finish_prefill = finish
        clock = StepClock()
        sched = Scheduler(engine, SchedulerConfig(prefill_token_budget=16,
                                                  preempt_age=80.0),
                          clock=clock.now)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = drive(sched, clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = grmac_matmul_cuda.launches
        return sched, engine, dict(seen, steps=steps, wall_s=wall,
                                   launches=launches)

    def open_loop(arch):
        """Run 1: open-loop greedy traffic, uniform prompts then Zipf-shared
        system prompts, each at 1.5x its capacity (the reference's
        traffic_bench full-run and shared-prefix smoke settings), merged
        in arrival order."""
        v = arch.vocab_size
        traffic = sorted(
            synth_traffic(32, 1.5 * capacity((4, 32)), seed=0, vocab_size=v,
                          prompt_len=(8, 48), out_len=(4, 32))
            + synth_shared_prefix_traffic(
                16, 1.5 * capacity((4, 16)), seed=1, vocab_size=v,
                n_prefixes=4, prefix_len=24, user_len=(3, 10),
                out_len=(4, 16)),
            key=lambda t: t.arrival)

        def drive(sched, clock):
            return run_open_loop(sched, traffic, tick=clock.tick)
        return drive

    # run 2's requests that decode greedily inside the sampled batch
    GREEDY = (3, 8)

    def closed_loop(arch):
        """Run 2: 8 clients closed-loop over a seeded trace, sampled at
        T = 0.8: even requests seeded by their index, odd ones from the
        caller's key (``SEED``), requests ``GREEDY`` at T = 0."""
        trace = synth_traffic(24, 1.0, seed=2, vocab_size=arch.vocab_size,
                              prompt_len=(8, 48), out_len=(4, 32))

        def params_of(i, t):
            temp = 0.0 if i in GREEDY else 0.8
            return SamplingParams(max_tokens=t.max_new_tokens,
                                  temperature=temp,
                                  seed=i if i % 2 == 0 else None)

        def drive(sched, clock):
            eng = sched.engine
            key, i, steps = sampling.key(SEED), 0, 0
            while True:
                while i < len(trace) and i - len(sched.finished) < SLOTS:
                    sched.submit(trace[i].prompt, params=params_of(
                        i, trace[i]))
                    i += 1
                if i >= len(trace) and sched.idle():
                    return steps
                key, sub = sampling.split(key)
                before = (eng.stats["prefill_dispatches"]
                          + eng.stats["decode_steps"])
                sched.step(sub)
                steps += 1
                clock.tick(max(1.0, eng.stats["prefill_dispatches"]
                               + eng.stats["decode_steps"] - before))
        return drive

    def serve_scheduler(arch, params, pj):
        """Both runs through the kernel and through the plain version: the
        streams and every policy-clock metric equal, the kernel launched
        85 times a dispatch, one fetch a decode step and a first token;
        run 1 preempts and hits the prefix cache; the kernel runs' pJ/token
        is ``serve_energy``'s. Then three sampled decode steps profiled."""
        fwd = per_forward(arch)
        launches_by_path["serve_scheduler"] = 0
        for run, make in (("open_loop_greedy", open_loop),
                          ("closed_loop_sampled", closed_loop)):
            drive = make(arch)
            out = {}
            for backend in (None, "ref"):
                sched, eng, seen = scheduled_run(arch, params, backend, drive)
                m = sched.metrics(slo_ttft=80.0)
                dispatches = (eng.stats["prefill_dispatches"]
                              + eng.stats["decode_steps"])
                # counted from after the engine was built
                want = (host_launches(fwd, dispatches, eng.graph_stats,
                                      built=False)
                        if backend is None else 0)
                out[backend] = (sched, eng, seen, m, dispatches)
                emit({"phase": "serve_scheduler", "run": run,
                      "backend": backend or "kernel", "arch": arch.name,
                      "batch_slots": SLOTS, "max_ctx": 512,
                      "prefill_token_budget": 16, "preempt_age": 80.0,
                      "prefix_cache_bytes": 1 << 28,
                      "requests": len(sched.requests),
                      "scheduler_steps": seen["steps"],
                      "dispatches": dispatches,
                      "engine_stats": eng.stats,
                      "graph_stats": eng.graph_stats,
                      "kernel_launches": seen["launches"],
                      "expected_launches": want,
                      "fetches": seen["fetch"],
                      "first_token_selections": seen["first"],
                      "wall_s": seen["wall_s"],
                      "wall_ms_per_dispatch":
                          1e3 * seen["wall_s"] / dispatches,
                      "metrics_slo_ttft_80": m, "card": card})
                if seen["launches"] != want:
                    fail(f"serve_scheduler {run}: {seen['launches']} kernel "
                         f"launches for {dispatches} dispatches")
                if seen["fetch"] != (eng.stats["decode_steps"]
                                     + seen["first"]):
                    fail(f"serve_scheduler {run}: {seen['fetch']} fetches for "
                         f"{eng.stats['decode_steps']} decode steps and "
                         f"{seen['first']} first tokens")
            k_sched, k_eng, k_seen, k_m, _ = out[None]
            r_sched, _, _, r_m, _ = out["ref"]
            launches_by_path["serve_scheduler"] += k_seen["launches"]
            streams = [r.generated for r in k_sched.requests]
            same = streams == [r.generated for r in r_sched.requests]
            same_m = policy(k_m) == policy(r_m)
            greedy_lanes = [streams[i] for i in GREEDY] if \
                run == "closed_loop_sampled" else None
            emit({"phase": "serve_scheduler_oracle", "run": run,
                  "streams_equal": same, "policy_metrics_equal": same_m,
                  "differing_metrics": sorted(
                      k for k in policy(k_m)
                      if policy(k_m)[k] != policy(r_m).get(k)),
                  "pj_per_token": k_m["pj_per_token"],
                  "serve_energy_pj_per_token": pj,
                  "greedy_lane_streams": greedy_lanes, "card": card})
            if not same or not same_m:
                fail(f"serve_scheduler {run}: streams or policy metrics "
                     "differ from the plain version's on the card")
            if k_m["pj_per_token"] != pj:
                fail(f"serve_scheduler {run}: pJ/token {k_m['pj_per_token']} "
                     f"is not serve_energy's {pj}")
            if run == "open_loop_greedy" and (k_m["preempted"] < 1
                                              or k_m["prefix_hits"] < 1):
                fail("serve_scheduler: run 1 neither preempted nor hit the "
                     "prefix cache")
            if run == "closed_loop_sampled":
                # three sampled decode steps of a full batch: 4 seeded and
                # 2 keyed lanes at T = 0.8, 2 greedy
                eng = k_eng
                prompts = prompts_of(arch, (5, 8, 12, 17, 24, 33, 40, 60))
                for i, p in enumerate(prompts):
                    eng.add_request(p, key=sampling.key(i), params=(
                        SamplingParams(temperature=0.8 * (i < 6),
                                       seed=i if i < 4 else None)))
                profiled("serve_sampled", "decode_step", lambda: [
                    eng.step(sampling.key(100 + s)) for s in range(3)], 3,
                    grmac=lambda: fwd * eng.stats["decode_steps"])
            del out, k_sched, k_eng, r_sched
            gc.collect()
            torch.cuda.empty_cache()

    def prefix_hit_vs_cold(path, arch, params, serve_kw, shared, chunk):
        """Two prompts sharing ``shared`` tokens (a multiple of the
        buckets' least, 8), one request at a time in slot 0, chunks of
        ``chunk`` tokens: with the prefix cache the second adopts the
        shared prefix, and both streams equal those of an engine without
        the cache, whose SSM blocks run the per-step loop (the hit's run
        the scan). Through the kernel, its launches counted."""
        v = arch.vocab_size
        head = [int(t) for t in rng.integers(0, v, shared)]
        prompts = [head + [int(t) for t in rng.integers(0, v, n)]
                   for n in (5, 3)]
        fwd = per_forward(arch)
        reset_counts()
        runs, dispatches, want = {}, 0, 0
        for cache in (None, 1 << 28):
            # the cold run's recurrence through its plain version, the loop
            with plain_recurrence(cache is None):
                eng = Engine(arch, params, ServeConfig(
                    batch_slots=SLOTS, prefix_cache_bytes=cache, **serve_kw),
                    device=dev)
                streams, adopted, prefill_ms = [], [], []
                for p in prompts:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    slot = eng.begin_request(p)
                    adopted.append(eng.adopted_prefix(slot))
                    while eng.prefill_remaining(slot):
                        eng.advance_prefill(slot, max_tokens=chunk)
                    eng.finish_prefill(slot)
                    torch.cuda.synchronize()
                    prefill_ms.append(1e3 * (time.perf_counter() - t0))
                    for _ in range(7):
                        eng.step()
                    streams.append(eng.tokens[slot][len(p):])
                    eng.release_slot(slot)
            n = eng.stats["prefill_dispatches"] + eng.stats["decode_steps"]
            dispatches += n
            want += host_launches(fwd, n, eng.graph_stats)
            if cache:             # the hit's run takes the scan
                scan_want = scan_layers(arch) * n
            runs[cache] = dict(streams=streams, adopted=adopted,
                               prefill_ms=prefill_ms,
                               prefill_tokens=eng.stats["prefill_tokens"],
                               cache_stats=(eng.prefix_cache.stats
                                            if eng.prefix_cache else None))
            del eng
        launches = grmac_matmul_cuda.launches
        scans = scan_mod.ssm_scan.launches
        launches_by_path[f"{path}_prefix_hit"] = launches
        if scan_want:
            scan_by_path[f"{path}_prefix_hit"] = scans
        cold, warm = runs[None], runs[1 << 28]
        same = cold["streams"] == warm["streams"]
        emit({"phase": f"{path}_prefix_hit", "arch": arch.name,
              "shared_tokens": shared, "chunk": chunk,
              "prompt_lens": [len(p) for p in prompts],
              "streams_equal": same, "adopted": warm["adopted"],
              "cold_prefill_ms": cold["prefill_ms"],
              "hit_prefill_ms": warm["prefill_ms"],
              "cold_prefill_tokens": cold["prefill_tokens"],
              "hit_prefill_tokens": warm["prefill_tokens"],
              "cache_stats": warm["cache_stats"],
              "kernel_launches": launches,
              "expected_launches": want, "scan_launches": scans,
              "expected_scan_launches": scan_want, "card": card})
        if not same or warm["adopted"] != [0, shared]:
            fail(f"{path}: a prefix hit's stream differs from a cold "
                 f"prefill's, or it adopted {warm['adopted']} tokens, not "
                 f"[0, {shared}]")
        if launches != want or scans != scan_want:
            fail(f"{path}_prefix_hit: {launches} kernel launches and "
                 f"{scans} scan launches for {dispatches} dispatches")
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------- serve_spec and train
    from repro_torch.serving.speculative import (SpecConfig, SpecDecoder,
                                                 price_speculation)
    from repro_torch.training import OptimizerConfig, TrainConfig
    from repro_torch.training import make_train_step
    from repro_torch.training.optimizer import apply_updates, init_opt_state

    # serve_spec's lanes that sample (T 0.8, seeded by their index); the
    # others are greedy
    SPEC_SAMPLED = (2, 5)

    def serve_spec(arch, params):
        """``serve``'s prompts under ``SpecDecoder`` (k 4, the digital
        drafter: the raw weights beside the packed ones), 16 speculative
        steps, through the kernel and through the plain version: equal
        streams and counters, the kernel launched once a projection for
        each prefill and verify dispatch (the drafts are digital), one
        fetch a first token, a draft and a verify. Then three spec steps
        profiled (launches per step against ``STEP_LAUNCHES``), one draft
        and one verify dispatch profiled alone, and the energy account."""
        fwd = per_forward(arch)
        prompts = prompts_of(arch, (5, 8, 12, 17, 24, 33, 40, 60))
        reqs = [SamplingParams(temperature=0.8, seed=i) if i in SPEC_SAMPLED
                else SamplingParams() for i in range(SLOTS)]
        n_steps = 16
        runs = {}
        for backend in (None, "ref"):
            reset_counts()
            eng = Engine(arch, params, ServeConfig(
                batch_slots=SLOTS, max_ctx=512, cim_backend=backend),
                device=dev)
            # peak from here, as serve's: the weights are packed already
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seen = fetch_counted(eng)
            for p, sp in zip(prompts, reqs):
                eng.add_request(p, params=sp)
            dec = SpecDecoder(eng, SpecConfig(k=4, draft="digital"))
            step_ms = []
            spec_launches = grmac_matmul_cuda.launches
            for _ in range(n_steps):
                t0 = time.perf_counter()
                dec.step()
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            spec_launches = grmac_matmul_cuda.launches - spec_launches
            st = dict(eng.stats)
            runs[backend] = dict(
                eng=eng, dec=dec, stats=st, fetches=seen["fetch"],
                launches=grmac_matmul_cuda.launches,
                spec_launches=spec_launches, step_ms=step_ms,
                peak=torch.cuda.max_memory_allocated(),
                streams=[list(t) for t in eng.tokens])
            # replays (the prefills, greedy repairs) launch nothing on the
            # host; the drafter's arch and the sampled verify run eagerly
            want = (host_launches(fwd, st["prefill_dispatches"]
                                  + st["decode_steps"]
                                  + st["verify_dispatches"]
                                  + st["repair_dispatches"], eng.graph_stats)
                    + grmac_per_forward(dec.draft_arch)
                    * st["draft_dispatches"]) if backend is None else 0
            fetch_want = (SLOTS + st["draft_dispatches"]
                          + st["verify_dispatches"] + st["decode_steps"])
            emit({"phase": "serve_spec", "backend": backend or "kernel",
                  "arch": arch.name, "batch_slots": SLOTS, "k": 4,
                  "draft": "digital", "sampled_lanes": list(SPEC_SAMPLED),
                  "spec_steps_run": n_steps, "stats": st,
                  "accepted_tokens_per_step":
                      st["spec_tokens"] / st["spec_steps"],
                  "accepted_tokens_per_lane_step":
                      st["spec_tokens"] / st["spec_steps"] / SLOTS,
                  "graph_stats": eng.graph_stats,
                  "fetches": seen["fetch"], "expected_fetches": fetch_want,
                  "kernel_launches": grmac_matmul_cuda.launches,
                  "expected_launches": want,
                  "spec_step_ms": step_ms,
                  "spec_step_ms_median": float(np.median(step_ms)),
                  "serve_decode_step_ms_median": step_median.get("serve"),
                  "peak_mem_bytes": runs[backend]["peak"], "card": card})
            if grmac_matmul_cuda.launches != want or seen["fetch"] != \
                    fetch_want or st["spec_steps"] != n_steps:
                fail(f"serve_spec ({backend or 'kernel'}): "
                     f"{grmac_matmul_cuda.launches} kernel launches (want "
                     f"{want}), {seen['fetch']} fetches (want {fetch_want})")
        k, r = runs[None], runs["ref"]
        launches_by_path["serve_spec"] = k["launches"]
        same = k["streams"] == r["streams"] and k["stats"] == r["stats"] \
            and k["fetches"] == r["fetches"]
        eng, dec = k["eng"], k["dec"]
        price = price_speculation(arch, dec.draft_arch, k["stats"],
                                  eng._bucket(4), device=dev)
        verify_launches = k["spec_launches"] / k["stats"]["spec_steps"]
        emit({"phase": "serve_spec_oracle", "streams_equal":
              k["streams"] == r["streams"], "counters_equal":
              k["stats"] == r["stats"] and k["fetches"] == r["fetches"],
              "oracle_spec_step_ms_median": float(np.median(r["step_ms"])),
              "kernel_launches_per_spec_step": verify_launches,
              "price_speculation": price, "card": card})
        if not same:
            fail("serve_spec: streams or counters differ from the plain "
                 "version's on the card")
        del runs, r
        gc.collect()
        torch.cuda.empty_cache()
        profiled("serve_spec", "spec_step",
                 lambda: [dec.step() for _ in range(3)], 3)
        # the parts of a spec step: a draft dispatch (all lanes drafting)
        # and a sampled verify dispatch of 4 tokens a lane
        profiled("serve_spec", "draft_dispatch", lambda: eng.draft_step(
            dec.draft_arch, eng._last_host.copy(), eng.active.copy(),
            eng.lengths.copy()), 1)
        chunk = np.zeros((SLOTS, 4), np.int32)
        chunk[:, 0] = eng._last_host
        profiled("serve_spec", "verify_dispatch",
                 lambda: eng.verify_chunk_sampled(
                     chunk, np.full(SLOTS, 4, np.int32), None), 1)
        del eng, dec, k
        gc.collect()
        torch.cuda.empty_cache()
        spec_vs_sequential_off(arch, params, prompts)

    def spec_vs_sequential_off(arch, params, prompts, n=33):
        """With the CIM path off, greedy speculative streams (k 4; the
        drafter is then the served arch) against sequential decode's, the
        first ``n`` generated tokens of each of ``serve``'s lanes: they
        must be equal. cuBLAS could reduce a verify chunk's M = 64 rows in
        another order than a decode step's 8 and flip an argmax near a
        tie; on the H100 they came out bitwise equal, so the check is a
        gate (in GR-MAC mode the streams differ by design, ROADMAP
        section C)."""
        off = arch.replace(cim=arch.cim.with_mode("off"))
        streams = {}
        for mode in ("sequential", "speculative"):
            eng = Engine(off, params, ServeConfig(batch_slots=SLOTS,
                                                  max_ctx=512), device=dev)
            for p in prompts:
                eng.add_request(p)
            dec = SpecDecoder(eng, SpecConfig(k=4)) if mode != \
                "sequential" else None
            while min(len(t) - len(p) for t, p in
                      zip(eng.tokens, prompts)) < n:
                (dec or eng).step()
            streams[mode] = [t[len(p):len(p) + n]
                             for t, p in zip(eng.tokens, prompts)]
            del eng, dec
        seq, spec = streams["sequential"], streams["speculative"]
        prefix = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                       n) for x, y in zip(seq, spec)]
        emit({"phase": "serve_spec_cim_off", "arch": arch.name,
              "tokens_per_lane": n, "lanes_equal": sum(
                  p == n for p in prefix),
              "matching_prefix_share": sum(prefix) / (n * len(prefix)),
              "matching_token_share": sum(a == b for x, y in zip(seq, spec)
                                          for a, b in zip(x, y))
              / (n * len(prefix)),
              "bitwise": seq == spec, "card": card})
        if seq != spec:
            fail("serve_spec_cim_off: greedy speculative streams differ "
                 "from sequential decode's with the CIM path off")
        gc.collect()
        torch.cuda.empty_cache()

    # (drafter label, SpecConfig.draft) of the rollback family's runs: the
    # served arch itself, and one whose SSM projections run digital, which
    # forces partial acceptance and so rollbacks and repairs
    SPEC_ROLLBACK = {"serve_mamba2": (("self", "self"),
                                      ("site_override", {"ssm": "off"}))}

    def spec_rollback(path, arch, params, serve_kw, drafters):
        """The ``Scheduler(spec=...)`` over a rollback family (SSM states
        and conv windows), 4 requests of 8 tokens, for each drafter
        through the kernel and the scan and through the plain version (the
        GR-MAC oracle and the per-step loop): equal streams, counters and
        policy metrics; the site-override drafter must repair."""
        fwd = per_forward(arch)
        prompts = prompts_of(arch, (3, 5, 8, 12))
        launches_by_path[f"{path}_spec"] = 0
        scan_by_path[f"{path}_spec"] = 0
        for label, draft in drafters:
            out = {}
            for backend in (None, "ref"):
                with plain_recurrence(backend == "ref"):
                    eng = Engine(arch, params, ServeConfig(
                        batch_slots=SLOTS, cim_backend=backend, **serve_kw),
                        device=dev)
                    seen = fetch_counted(eng)
                    clock = StepClock()
                    sched = Scheduler(eng, SchedulerConfig(), clock=clock.now,
                                      spec=SpecConfig(k=4, draft=draft))
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for p in prompts:
                        sched.submit(p, params=SamplingParams(max_tokens=8))
                    steps = 0
                    while not sched.idle():
                        sched.step()
                        clock.tick()
                        steps += 1
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                st = dict(eng.stats)
                want = (fwd * (st["prefill_dispatches"]
                               + st["decode_steps"]
                               + st["verify_dispatches"]
                               + st["repair_dispatches"])
                        + grmac_per_forward(sched._spec.draft_arch)
                        * st["draft_dispatches"]) if backend is None else 0
                fetch_want = (len(prompts) + st["draft_dispatches"]
                              + st["verify_dispatches"] + st["decode_steps"])
                launches = grmac_matmul_cuda.launches
                scans = scan_mod.ssm_scan.launches
                scan_want = (scan_layers(arch) * (
                    st["prefill_dispatches"] + st["decode_steps"]
                    + st["verify_dispatches"] + st["repair_dispatches"])
                    + scan_layers(sched._spec.draft_arch)
                    * st["draft_dispatches"]) if backend is None else 0
                if backend is None:
                    launches_by_path[f"{path}_spec"] += launches
                    scan_by_path[f"{path}_spec"] += scans
                m = policy(sched.metrics())
                out[backend] = ([r.generated for r in sched.requests], st,
                                m, seen["fetch"])
                emit({"phase": f"{path}_spec", "drafter": label,
                      "backend": backend or "kernel", "arch": arch.name,
                      "requests": len(prompts), "scheduler_steps": steps,
                      "stats": st, "fetches": seen["fetch"],
                      "expected_fetches": fetch_want,
                      "kernel_launches": launches, "expected_launches": want,
                      "scan_launches": scans,
                      "expected_scan_launches": scan_want,
                      "accepted_tokens_per_step":
                          st["spec_tokens"] / max(1, st["spec_steps"]),
                      "wall_s": wall, "card": card})
                if (launches != want or seen["fetch"] != fetch_want
                        or scans != scan_want):
                    fail(f"{path}_spec {label}: {launches} kernel launches "
                         f"(want {want}), {scans} scan launches (want "
                         f"{scan_want}), {seen['fetch']} fetches (want "
                         f"{fetch_want})")
                del eng, sched
                gc.collect()
                torch.cuda.empty_cache()
            same = out[None] == out["ref"]
            emit({"phase": f"{path}_spec_oracle", "drafter": label,
                  "streams_equal": out[None][0] == out["ref"][0],
                  "counters_and_metrics_equal": out[None][1:]
                  == out["ref"][1:], "card": card})
            if not same:
                fail(f"{path}_spec {label}: streams, counters or metrics "
                     "differ from the plain version's on the card")
            if label == "site_override" and not out[None][1][
                    "repair_dispatches"]:
                fail(f"{path}_spec: the site-override drafter repaired "
                     "nothing")

    def loss_and_grads(arch, params, batch):
        """``train_loss`` and the gradients of every parameter."""
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        _, metrics = train_loss(leaves, batch, arch)
        grads = torch.autograd.grad(metrics["total"], tree_leaves(leaves),
                                    materialize_grads=True)
        return metrics, grads

    def train_launches(arch) -> int:
        """Kernel launches of one train step: the forward's, and under
        remat every layer's again in the backward (the head is not
        recomputed; these configs have no tail layers)."""
        fwd = per_forward(arch)
        if arch.n_layers % arch.pattern_period():
            fail(f"{arch.name}: a tail layer outside the remat super-blocks")
        return fwd + (fwd - 1 if arch.remat else 0)

    def train_vs_plain(path, arch, params, batch, extra=None):
        """One step's loss and gradients through the kernel (the per-call
        route: every raw weight packed on every call) and through the plain
        version, deterministic algorithms on (the embedding's backward
        accumulates by index): the loss equal, each gradient within
        ``GRAD_RTOL`` of its largest entry."""
        want = train_launches(arch)
        runs = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for backend in (None, "ref"):
                a = arch if backend is None else arch.replace(
                    cim=arch.cim.with_backend("ref"))
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                metrics, grads = loss_and_grads(a, params, batch)
                torch.cuda.synchronize()
                runs[backend] = dict(
                    loss=float(metrics["loss"].detach()), grads=grads,
                    launches=grmac_matmul_cuda.launches,
                    ms=1e3 * (time.perf_counter() - t0),
                    peak=torch.cuda.max_memory_allocated())
        finally:
            torch.use_deterministic_algorithms(False)
        k, r = runs[None], runs["ref"]
        worst_abs = worst_rel = 0.0
        bitwise = 0
        for gk, gr in zip(k["grads"], r["grads"]):
            d = float((gk.float() - gr.float()).abs().max())
            scale = float(gr.float().abs().max())
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel, d / scale if scale else
                            (0.0 if d == 0 else math.inf))
            bitwise += bool(torch.equal(gk, gr))
        launches_by_path[path] = launches_by_path.get(path, 0) + k["launches"]
        ok = (k["loss"] == r["loss"] and math.isfinite(k["loss"])
              and worst_rel <= GRAD_RTOL and k["launches"] == want
              and r["launches"] == 0)
        emit({"phase": path, "vs": "plain version", "arch": arch.name,
              "n_layers": arch.n_layers, "remat": arch.remat,
              "remat_policy": arch.remat_policy,
              "batch": list(batch["inputs"].shape), "rows_per_projection":
              batch["inputs"].numel(), **(extra or {}),
              "loss": k["loss"], "plain_loss": r["loss"],
              "loss_equal": k["loss"] == r["loss"],
              "grad_tensors": len(k["grads"]), "grad_tensors_bitwise": bitwise,
              "grad_max_abs_diff": worst_abs,
              "grad_max_rel_diff": worst_rel, "grad_rtol": GRAD_RTOL,
              "kernel_launches": k["launches"], "expected_launches": want,
              "fwd_bwd_ms": k["ms"], "plain_fwd_bwd_ms": r["ms"],
              "peak_mem_bytes": k["peak"], "plain_peak_mem_bytes": r["peak"],
              "ok": ok, "card": card})
        if not ok:
            fail(f"{path}: loss {k['loss']} vs {r['loss']}, gradients within "
                 f"{worst_rel} (bound {GRAD_RTOL}), {k['launches']} kernel "
                 f"launches (want {want})")
        loss = k["loss"]
        del runs, k, r
        gc.collect()
        torch.cuda.empty_cache()
        return loss

    # (path, batch, seq) of one train step in a family's serve phase
    TRAIN_ONE_STEP = {"serve_mamba2": ("train_mamba2", 1, 256),
                      "serve_recurrentgemma": ("train_recurrentgemma", 1, 64)}

    def train_paper(arch, params):
        """paper-cim-120m at full width and depth, batch 8 x 256, AdamW at
        lr 3e-5, warmup 1: step 0 against the plain version, then 4 steps
        through the kernel (the loss must fall), the step's time split,
        and a profiled step. On the H100 the first step takes the loss
        from 9.70 to 4.4-4.6 at lr 1e-3 and 3e-4 alike, and the next ones
        oscillate more the larger lr is (9.70, 4.61, 17.32, 9.82 at
        AdamW's default 3e-4)."""
        data = SyntheticLM(DataConfig(global_batch=8, seq_len=256,
                                      vocab_size=arch.vocab_size, seed=SEED),
                           device=dev)
        loss0 = train_vs_plain("train", arch, params, data.batch_at(0))
        tcfg = TrainConfig(opt=OptimizerConfig(lr=3e-5, warmup_steps=1,
                                               total_steps=5))
        step_fn = make_train_step(arch, tcfg)
        p, o = params, init_opt_state(params, tcfg.opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_ms = [], []
        for step in range(4):
            t0 = time.perf_counter()
            p, o, m = step_fn(p, o, data.batch_at(step))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = grmac_matmul_cuda.launches
        launches_by_path["train"] += launches
        peak = torch.cuda.max_memory_allocated()
        want = 4 * train_launches(arch)
        # the step's split: the forward alone, forward and backward, and the
        # rest (the optimizer) from the step's median
        batch = data.batch_at(4)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        fwd_ms = timed(lambda: train_loss(leaves, batch, arch))
        got = []
        fb_ms = timed(lambda: got.append(loss_and_grads(arch, p, batch)))
        it = iter(got[0][1])
        grads = tree_map(lambda _: next(it), p)
        opt_ms = timed(lambda: apply_updates(p, grads, o, tcfg.opt))
        del leaves, got, grads
        prof = profiled("train", "train_step",
                        lambda: step_fn(p, o, batch), 1)
        med = float(np.median(step_ms))
        step_median["train"] = med
        emit({"phase": "train", "arch": arch.name, "batch": [8, 256],
              "rows_per_projection": 8 * 256, "remat": arch.remat,
              "remat_policy": arch.remat_policy, "optimizer": "adamw",
              "lr": tcfg.opt.lr, "warmup_steps": 1, "losses": losses,
              "monotone": all(b < a for a, b in zip(losses, losses[1:])),
              "step0_loss_vs_plain_run": loss0, "step_ms": step_ms,
              "step_ms_median": med, "tokens_per_s": 8 * 256 * 1e3 / med,
              "forward_ms": fwd_ms, "backward_ms": fb_ms - fwd_ms,
              "optimizer_ms": opt_ms,
              "kernel_launches": launches, "expected_launches": want,
              "kernel_launches_per_step": launches / 4,
              "cuda_launches_per_step": prof["cuda_launches_per"],
              "device_idle_share": prof["device_idle_share"],
              "peak_mem_bytes": peak, "card": card})
        if launches != want or losses[0] != loss0 or not \
                losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
            fail(f"train: losses {losses} (step 0 {loss0} through the "
                 f"comparison), {launches} kernel launches (want {want})")
        del p, o, step_fn
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------- drill and launchers
    from repro_torch.launch import serve as launch_serve_mod
    from repro_torch.launch import train as launch_train_mod
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.training import supervisor as supervisor_mod
    from repro_torch.training.checkpoint import snapshot_tree, write_snapshot
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.training.fault import make_fault_plan, reshard_tree
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    def train_drill(arch):
        """``python -m repro_torch.launch.train --arch paper-cim-120m
        --steps 12 --drill``: the supervised drill at full width and depth
        (batch 8 x 128, 3 faults, drill seed 0, local tier every 2 steps,
        durable every 6), its state DTensors on a 1 x 1 NCCL mesh after
        every restore. The counters must equal ``DRILL_COUNTERS``, every
        step launch the kernel 169 times (85 + 84 recomputed by remat),
        step 0's loss equal the plain version's on the same weights, and
        every loss equal an uninterrupted run's (a recomputed step's is
        also held to its first run inside the drill)."""
        plan = make_fault_plan(0, 12, n_faults=3)
        if [(e.step, e.kind) for e in plan.events] != DRILL_PLAN:
            fail(f"train_drill: the plan is {plan.events}, not {DRILL_PLAN}")
        data = SyntheticLM(DataConfig(global_batch=8, seq_len=128,
                                      vocab_size=arch.vocab_size),
                           device=dev)
        # the plain version's step 0 on the weights the drill starts from
        params = init_params(arch, 0, device=dev)
        with torch.no_grad():
            _, m = train_loss(params, data.batch_at(0), arch.replace(
                cim=arch.cim.with_backend("ref")))
        plain_loss0 = float(m["loss"])
        del params, m
        gc.collect()
        torch.cuda.empty_cache()

        # every restore's placement, seen at the supervisor's reshard_tree
        placed = []

        def watched_reshard(tree, mesh, specs):
            out = reshard_tree(tree, mesh, specs)
            leaves = tree_leaves(out)
            placed.append({
                "leaves": len(leaves),
                "dtensor_leaves": sum(isinstance(t, DTensor) for t in leaves),
                "mesh": [list(mesh.shape), list(mesh.mesh_dim_names),
                         mesh.device_type],
                "backend": dist.get_backend(), "world": dist.get_world_size(),
                "on_card": all(t.to_local().is_cuda for t in leaves)})
            return out

        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        supervisor_mod.reshard_tree = watched_reshard
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                rep = launch_train_mod.main([
                    "--arch", arch.name, "--steps", "12", "--batch", "8",
                    "--seq", "128", "--drill", "--drill-faults", "3",
                    "--drill-seed", "0"])
        finally:
            supervisor_mod.reshard_tree = reshard_tree
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        # the launcher's printed report (indented JSON), on one line here
        emit({"phase": "train_drill_report", "printed": json.loads(
            printed.getvalue()), "card": card})
        launches = grmac_matmul_cuda.launches
        by_design = dict(grmac_matmul_cuda.launches_by_design)
        peak = torch.cuda.max_memory_allocated()
        launches_by_path["train_drill"] = launches
        for d in DESIGNS:
            by_design_total[d] += by_design[d]
        steps_run = rep["final_step"] + rep["steps_recomputed"]
        want = steps_run * train_launches(arch)

        # an uninterrupted run of the same 12 steps (no checkpoints), on
        # plain tensors, under the drill's deterministic algorithms
        tcfg = TrainConfig(steps=12, opt=OptimizerConfig(
            lr=3e-4, warmup_steps=5, total_steps=12))
        step_fn = make_train_step(arch, tcfg)
        p = init_params(arch, 0, device=dev)
        o = init_opt_state(p, tcfg.opt)
        base, base_ms = [], []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with local_mesh(dev) as mesh, use_mesh(mesh):
                for step in range(12):
                    t1 = time.perf_counter()
                    p, o, m = step_fn(p, o, data.batch_at(step))
                    base.append(float(m["loss"]))
                    base_ms.append(1e3 * (time.perf_counter() - t1))
        finally:
            torch.use_deterministic_algorithms(False)
        # the same step on the state placed as DTensors (as after a
        # restore), with no checkpoint writer beside it
        state = {"params": p, "opt": o}
        dtensor_ms = []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with local_mesh(dev) as mesh, use_mesh(mesh):
                placed_state = reshard_tree(state, mesh, {
                    k: param_specs(v, mesh) for k, v in state.items()})
                dp, do = placed_state["params"], placed_state["opt"]
                for step in range(12, 15):
                    t1 = time.perf_counter()
                    dp, do, m = step_fn(dp, do, data.batch_at(step))
                    float(m["loss"])
                    dtensor_ms.append(1e3 * (time.perf_counter() - t1))
                del placed_state, dp, do
        finally:
            torch.use_deterministic_algorithms(False)
        # the checkpoint's parts: the training thread's host snapshot of
        # the state, and one tier's write (files, sha256, publish) that the
        # background thread does and a drain waits for
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(state))
        t1 = time.perf_counter()
        snap = snapshot_tree(state)
        snapshot_s = time.perf_counter() - t1
        with tempfile.TemporaryDirectory() as wd:
            t1 = time.perf_counter()
            write_snapshot(wd, 1, snap)
            write_s = time.perf_counter() - t1
        del p, o, m, step_fn, state, snap
        gc.collect()
        torch.cuda.empty_cache()

        counters = {k: rep[k] for k in DRILL_COUNTERS}
        g = rep["goodput"]
        first_steps = rep["final_step"]
        energy = rep["energy"]
        as_dtensors = [r["dtensor_leaves"] == r["leaves"] and r["on_card"]
                       and r["backend"] == "nccl" and r["world"] == 1
                       and r["mesh"][0] == [1, 1] for r in placed]
        ok = (counters == DRILL_COUNTERS and launches == want
              and len(placed) == rep["attempts"] - 1 and all(as_dtensors)
              and rep["losses"][0] == plain_loss0 and rep["losses"] == base
              and all(map(math.isfinite, rep["losses"]))
              and abs(sum(g["buckets_s"].values()) - g["wall_s"])
              <= 1e-6 * g["wall_s"])
        emit({"phase": "train_drill", "arch": arch.name,
              "n_layers": arch.n_layers, "batch": [8, 128],
              "mesh": "1 x 1 (data, model), world-1 NCCL group",
              "plan": DRILL_PLAN, "counters": counters,
              "counters_equal": counters == DRILL_COUNTERS,
              "losses": rep["losses"], "uninterrupted_losses": base,
              "losses_equal_uninterrupted": rep["losses"] == base,
              "step0_loss": rep["losses"][0],
              "plain_step0_loss": plain_loss0,
              "step0_equal_plain": rep["losses"][0] == plain_loss0,
              "kernel_launches": launches, "expected_launches": want,
              "kernel_launches_per_step": launches / steps_run,
              "kernel_launches_by_design": by_design,
              "goodput_pct": g["goodput_pct"], "wall_s": g["wall_s"],
              "buckets_s": g["buckets_s"],
              "checkpoint_stall_s": g["buckets_s"]["checkpoint_stall"],
              "restores": placed, "restored_as_dtensors": all(as_dtensors),
              "productive_step_ms": 1e3 * g["buckets_s"]["productive"]
              / first_steps,
              "uninterrupted_step_ms": base_ms,
              "uninterrupted_step_ms_median": float(np.median(base_ms)),
              "dtensor_step_ms": dtensor_ms,
              "state_bytes": state_bytes, "snapshot_s": snapshot_s,
              "tier_write_s": write_s,
              "recompute_step_ms": 1e3 * g["buckets_s"]["recompute"]
              / max(rep["steps_recomputed"], 1),
              "pj_per_token": energy["pj_per_token"],
              "pj_per_useful_token": energy["pj_per_useful_token"],
              "badput_energy_overhead": energy["badput_energy_overhead"],
              "drill_with_pricing_s": drill_s, "peak_mem_bytes": peak,
              "ok": ok, "card": card})
        if not ok:
            fail(f"train_drill: counters {counters} (want {DRILL_COUNTERS}),"
                 f" restores {placed}, {launches} kernel launches (want "
                 f"{want}), step 0 "
                 f"{rep['losses'][0]} vs plain {plain_loss0}, losses "
                 f"{rep['losses']} vs uninterrupted {base}")

    def launch_serve(serve_pj):
        """``python -m repro_torch.launch.serve --arch paper-cim-120m
        --slots 8 --ctx 512``, as the two-prompt demo and with
        ``--traffic 16``: a kernel launch per projection of a forward (85)
        a dispatch, pJ/token within ``MC_TOL`` of ``serve_energy``'s."""
        fwd = per_forward(paper)
        argv = ["--arch", "paper-cim-120m", "--slots", "8", "--ctx", "512"]
        rows = {}
        for mode, extra in (("demo", []), ("traffic", ["--traffic", "16"])):
            reset_counts()
            t0 = time.perf_counter()
            res = launch_serve_mod.main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = grmac_matmul_cuda.launches
            for d in DESIGNS:
                by_design_total[d] += grmac_matmul_cuda.launches_by_design[d]
            launches_by_path[f"launch_serve_{mode}"] = launches
            st = res["engine_stats"]
            dispatches = sum(st.get(k, 0) for k in (
                "prefill_dispatches", "decode_steps", "draft_dispatches",
                "verify_dispatches", "repair_dispatches"))
            pj_got = (res["engine_pj_per_token"] if mode == "demo"
                      else res["metrics"]["pj_per_token"])
            graph_stats = res["engine_graph_stats"]
            want = host_launches(fwd, dispatches, graph_stats)
            row = {"phase": "launch_serve", "mode": mode,
                   "kernel_launches": launches, "dispatches": dispatches,
                   "graph_stats": graph_stats, "expected_launches": want,
                   "launches_per_dispatch": launches / max(dispatches, 1),
                   "pj_per_token": pj_got, "serve_energy_pj_per_token":
                   serve_pj, "pj_tolerance": MC_TOL["pj_per_token_2048"],
                   "wall_s": wall, "card": card}
            if mode == "traffic":
                m = res["metrics"]
                row.update({k: m[k] for k in (
                    "completed", "rejected", "decode_steps",
                    "prefill_dispatches", "ttft_p50_ms", "ttft_p99_ms",
                    "tpot_p50_ms", "tpot_p99_ms", "goodput_tok_s")})
            else:
                toks = [list(r.values()) for r in res["steps"]]
                row["tokens_in_vocab"] = all(
                    0 <= int(t) < paper.vocab_size for ts in toks for t in ts)
            row["ok"] = (launches == want and dispatches > 0
                         and abs(pj_got - serve_pj)
                         <= MC_TOL["pj_per_token_2048"]
                         and row.get("tokens_in_vocab", True)
                         and (mode == "demo" or row["completed"] == 16))
            emit(row)
            rows[mode] = row
            if not row["ok"]:
                fail(f"launch_serve ({mode}): {launches} kernel launches "
                     f"for {dispatches} dispatches and {graph_stats} (want "
                     f"{want}), pJ/token "
                     f"{pj_got} against serve_energy's {serve_pj}")
            del res
            gc.collect()
            torch.cuda.empty_cache()
        return rows

    # ------------------------------------------ spmd_serve, roofline_card
    def spmd_serve(arch, params, prompts):
        """``serve``'s traffic under ``local_mesh()`` (a 1 x 1 NCCL mesh):
        the SPMD program's serving path, every collective over one rank
        skipped; the streams must equal ``serve``'s bitwise, 85 kernel
        launches a dispatch. ``serve``'s path with no mesh runs just
        before and just after it (its launches not counted): a baseline
        for the step time at the same point of the run."""
        def no_mesh_ms():
            engine, _, ms, _, _ = run_engine(arch, params, prompts, 32,
                                             dict(max_ctx=512), None)
            del engine
            return ms

        base_ms = no_mesh_ms()
        reset_counts()
        with local_mesh() as mesh, use_mesh(mesh):
            engine, prefill_ms, decode_ms, peak, last = run_engine(
                arch, params, prompts, 32, dict(max_ctx=512), None)
            streams = [list(t) for t in engine.tokens]
            dispatches = (engine.stats["prefill_dispatches"]
                          + engine.stats["decode_steps"])
            mesh_shape = list(mesh.shape)
        launches = grmac_matmul_cuda.launches
        launches_by_path["spmd_serve"] = launches
        base_ms += no_mesh_ms()
        same = streams == served_streams["serve"]
        emit({"phase": "spmd_serve", "arch": arch.name, "mesh": mesh_shape,
              "streams_equal_to_serve": same, "kernel_launches": launches,
              "expected_launches": per_forward(arch) * dispatches,
              "decode_ms_median": float(np.median(decode_ms)),
              "serve_decode_ms_median": step_median["serve"],
              "no_mesh_decode_ms_median_beside": float(np.median(base_ms)),
              "prefill_ms": prefill_ms, "peak_mem_bytes": peak,
              "card": card})
        if not same or launches != per_forward(arch) * dispatches:
            fail("spmd_serve: the streams under a 1 x 1 mesh differ from "
                 f"serve's, or {launches} kernel launches for {dispatches} "
                 "dispatches")
        del engine, last
        gc.collect()
        torch.cuda.empty_cache()

    def spmd_split(arch, prompts):
        """``serve``'s traffic through the SPMD program split over
        "model": ``SPLIT_RANKS`` processes on the one card, a gloo group
        (NCCL refuses two ranks on one device) with CUDA tensors, a 1 x 2
        mesh, the params placed by ``param_specs`` (``spmd_split_worker``).
        With the KV placed by rows only the streams must equal ``serve``'s
        bitwise, with 85 kernel launches a dispatch on each rank, every
        one at half the projection's N; with the KV's context split over
        "model" (max_ctx 128) the tokens that differ from ``serve``'s and
        from the rows-only run at max_ctx 128, and the first decode step's
        largest |logit difference| from the latter, are printed and finite
        logits are the check (in GR-MAC mode a last-ulp difference may
        flip an input code); with the CIM path off, the split KV's decode
        logits must lie within ``LOSS_RTOL`` (the reference's
        sharded-vs-unsharded rtol) of the rows-only run's, the largest
        |logit difference| printed. The kernel is held to its
        plain version at the chunks, and the raw DTensor params' forward
        to the served params'."""
        import torch.multiprocessing as mp

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(spmd_split_worker, args=(
                SPLIT_RANKS, os.path.join(tmp, "store"), tmp, prompts,
                "cuda", False), nprocs=SPLIT_RANKS, join=True)
            ranks = []
            for r in range(SPLIT_RANKS):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        wall = time.perf_counter() - t0
        fwd = per_forward(arch)
        halves = sorted({n // SPLIT_RANKS for n in (
            [arch.n_heads * arch.d_head, arch.n_kv_heads * arch.d_head,
             arch.d_model, arch.d_ff, arch.padded_vocab])})
        serve_streams = served_streams["serve"]
        rows = ranks[0]["runs"]["kv_rows"]

        def differ(label):
            return sum(a != b for s1, s2 in zip(
                ranks[0]["runs"][label]["streams"], serve_streams)
                for a, b in zip(s1, s2))
        grmac = [run for r in ranks for run in r["runs"].values()
                 if run["cim"] == "grmac"]
        launches = sum(run["kernel_launches"] for r in ranks
                       for run in r["runs"].values())
        launches_by_path["spmd_split"] = launches
        for d in DESIGNS:
            by_design_total[d] += sum(run["launches_by_design"][d]
                                      for r in ranks
                                      for run in r["runs"].values())
        checks = {
            "kv_rows_streams_equal_to_serve": rows["streams"] == serve_streams,
            "ranks_agree": all(r["runs"][k]["streams"] == run["streams"]
                               for r in ranks for k, run in
                               ranks[0]["runs"].items()),
            "launches_per_dispatch": all(
                run["kernel_launches"] == (fwd * run["dispatches"]
                                           if run["cim"] == "grmac" else 0)
                for r in ranks for run in r["runs"].values()),
            "launch_n_halved": all(run["launch_n"] == halves
                                   for run in grmac),
            "kv_split_over_model": all(
                run["kv_leaves_split"] == (2 * arch.n_layers
                                           if label.endswith("split") else 0)
                for r in ranks for label, run in r["runs"].items()),
            "kv_split_finite": all(r["kv_split_finite"]
                                   and r["forward_finite"] for r in ranks),
            "off_split_within_rtol": all(
                r["off_steps_compared"] > 0
                and r["off_decode_rel_dlogit"] <= LOSS_RTOL for r in ranks),
            "forward_raw_equals_served": all(
                r["forward_raw_equals_served"] for r in ranks),
        }
        err = max(e["max_abs_err"] for r in ranks
                  for e in r["kernel_vs_plain"].values())
        emit({"phase": "spmd_split", "arch": arch.name,
              "ranks": SPLIT_RANKS, "mesh": ranks[0]["mesh"],
              "backend": "gloo", "checks": checks,
              "tokens": sum(len(t) for t in serve_streams),
              "tokens_differing_from_serve": {
                  label: differ(label) for label in (
                      "kv_rows", "kv_rows_128", "kv_split")},
              **{f"{mode}_{k}": ranks[0][f"{mode}_{k}"]
                 for mode, _, _ in SPLIT_PAIRS for k in (
                     "tokens_differing", "steps_compared",
                     "first_decode_max_abs_dlogit",
                     "first_decode_rel_dlogit", "decode_max_abs_dlogit",
                     "decode_rel_dlogit")},
              "per_rank": [{
                  "rank": r["rank"], **{label: {k: run[k] for k in (
                      "max_ctx", "cim", "kv_leaves_split",
                      "kernel_launches", "dispatches", "launch_n",
                      "decode_ms_median", "prefill_s", "peak_mem_bytes")}
                      for label, run in r["runs"].items()},
                  "kernel_vs_plain": r["kernel_vs_plain"]} for r in ranks],
              "kernel_launches": launches, "max_abs_err": err,
              "serve_decode_ms_median": step_median["serve"],
              "wall_seconds": wall, "card": card})
        if not all(checks.values()) or err != 0.0:
            fail(f"spmd_split: {checks}, kernel against plain at the chunks "
                 f"max abs err {err}")

    def prefill_forward_ms(arch, params):
        """Median ms of the no-cache forward at 8 x 64 on the served
        (packed) weights, the dry run's prefill cell at this run's shape."""
        packed = pack_params(params, arch)
        toks = torch.tensor(rng.integers(0, arch.vocab_size, (8, 64)),
                            device=dev)
        ms = []
        with torch.no_grad():
            forward(packed, toks, arch)
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward(packed, toks, arch)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ms))

    # ----------------------------------------------------------- analysis
    from repro_torch.analysis import invariants as inv

    def pending_calls():
        """Each pending sanitized GR-MAC call's five numbers (nonfinite,
        overflow, worst |v|, gain count, worst span) with its tag, read
        before the records are: a kernel call leaves one buffer, a plain
        call a values record and (row, unit) a span record."""
        out = []
        for tag, kinds, stats, from_kernel in sanitize._PENDING:
            row = stats.cpu().numpy()
            if from_kernel:
                worst = float(np.array([row[2]], np.int64).astype(
                    np.uint32).view(np.float32)[0])
                out.append((tag, int(row[0]), int(row[1]), worst,
                            int(row[3]), int(row[4])))
            elif "nonfinite" in kinds:
                out.append((tag, int(row[0]), int(row[1]), float(row[2]),
                            0, 0))
            else:               # the span record of the call before
                out[-1] = out[-1][:4] + (int(row[3]), int(row[4]))
        return out

    def analysis_sanitize(arch, params, prompts, streams):
        """``serve``'s traffic with REPRO_SANITIZE=1 through the kernel (its
        sanitizing instantiation, both designs) and through the plain
        version: token streams equal to the unsanitized run's, the records
        of the two equal (kind, tag, count, worst, in order), no nonfinite
        voltage; a NaN seeded into one projection's input caught at that
        site by both; step ms with the sanitizer on."""
        runs = {}
        os.environ[sanitize.ENV_VAR] = "1"
        try:
            for backend in (None, "ref"):
                sanitize.clear()
                reset_counts()
                engine, prefill_ms, decode_ms, _, last = run_engine(
                    arch, params, prompts, 32, dict(max_ctx=512), backend)
                # a sanitizing launch leaves one kernel buffer, a plain one
                # none
                kernel_buffers = sum(p[3] for p in sanitize._PENDING)
                calls = pending_calls()
                runs[backend] = dict(
                    streams=[list(t) for t in engine.tokens],
                    calls=calls,
                    records=[dict(r) for r in sanitize.VIOLATIONS],
                    launches=grmac_matmul_cuda.launches,
                    kernel_buffers=kernel_buffers,
                    by_design=dict(grmac_matmul_cuda.launches_by_design),
                    prefill_ms=prefill_ms,
                    decode_ms_median=float(np.median(decode_ms)))
                if backend is None:
                    launches_by_path["analysis_sanitize"] = \
                        grmac_matmul_cuda.launches
                    for d in DESIGNS:
                        by_design_total[d] += \
                            grmac_matmul_cuda.launches_by_design[d]
                    prof = profiled("serve_sanitize", "decode_step",
                                    lambda: [engine.step() for _ in range(3)],
                                    3)
                del engine, last
                gc.collect()
                torch.cuda.empty_cache()
            # a NaN in one projection's input, the engine's shapes (M = 8)
            cfg = arch.cim.for_site("mlp")
            x = torch.randn((SLOTS, arch.d_model), generator=gen, device=dev)
            x[3, 100] = float("nan")
            w = params["layers"][0]["ffn"]["wi"]["w"]
            nan_recs = {}
            for backend in (None, "ref"):
                sanitize.clear()
                cim_matmul(x, pack_weight(w, cfg.fmt_w, cfg.n_r)
                           if backend is None else w, cfg, site="mlp",
                           backend=backend)
                nan_recs[backend] = [dict(r) for r in sanitize.VIOLATIONS]
        finally:
            os.environ.pop(sanitize.ENV_VAR, None)
            sanitize.clear()
        k_run, r_run = runs[None], runs["ref"]
        recs = k_run["records"]
        totals_ = {}
        for r in recs:
            kind = totals_.setdefault(r["kind"], {"records": 0, "count": 0,
                                                  "worst": 0.0, "sites": {}})
            kind["records"] += 1
            kind["count"] += r["count"]
            kind["worst"] = max(kind["worst"], r["worst"])
            kind["sites"][r["tag"]] = kind["sites"].get(r["tag"], 0) \
                + r["count"]
        nonfinite = sum(r["count"] for r in recs if r["kind"] == "nonfinite")
        calls = k_run["calls"]
        spans = [c[5] for c in calls]
        checks = {
            "per_call_numbers_equal": calls == r_run["calls"]
            and len(calls) == per_forward(arch) * (len(prompts) + 32),
            "kernel_streams_equal_unsanitized": k_run["streams"] == streams,
            "plain_streams_equal_unsanitized": r_run["streams"] == streams,
            "records_equal": recs == r_run["records"],
            "all_sanitizing": 0 < k_run["launches"]
            == k_run["kernel_buffers"],
            "both_designs": all(k_run["by_design"][d] > 0 for d in DESIGNS),
            "nonfinite_zero": nonfinite == 0,
            "nan_caught_by_both": bool(
                nan_recs[None] and nan_recs[None] == nan_recs["ref"]
                and nan_recs[None][0]["kind"] == "nonfinite"
                and nan_recs[None][0]["tag"] == "mlp"),
        }
        emit({"phase": "analysis_sanitize", "arch": arch.name,
              "batch_slots": SLOTS, "decode_steps": 32,
              "records": len(recs), "totals": totals_,
              "calls": len(calls),
              "worst_abs_v": max(c[3] for c in calls),
              "worst_span": max(spans),
              "calls_by_worst_span": {str(v): spans.count(v)
                                      for v in sorted(set(spans))},
              "first_records": recs[:6], "nan_records": nan_recs[None][:3],
              "kernel_launches": k_run["launches"],
              "kernel_launches_by_design": k_run["by_design"],
              "step_ms_median_sanitize_on": k_run["decode_ms_median"],
              "step_ms_median_sanitize_off": step_median["serve"],
              "plain_step_ms_median_sanitize_on": r_run["decode_ms_median"],
              "cuda_launches_per_step_sanitize_on":
                  prof["cuda_launches_per"],
              "cuda_launches_per_step_sanitize_off": STEP_LAUNCHES["serve"],
              "checks": checks, "card": card})
        if not all(checks.values()):
            fail("analysis_sanitize: "
                 f"{[k for k, v in checks.items() if not v]}")

    def analysis_invariants(arch, params, prompts):
        """The four invariant drives on the reduced INVARIANT_CONFIGS in
        GR-MAC mode (weights drawn on the CPU, moved to the card; every
        projection through the kernel), then ``InstrumentedEngine`` over
        ``serve``'s traffic at full width: one fetch a step, device->host
        crossings equal to the fetches, one signature per dispatch key."""
        drives = {}
        t0 = time.perf_counter()
        for fn in ("run_invariants", "run_scheduler_invariants",
                   "run_prefix_invariants", "run_spec_invariants"):
            res = getattr(inv, fn)(device=dev, mode="grmac")
            drives[fn] = {name: ({k: rep[k] for k in ("fetches", "d2h",
                                                      "steps", "compiles",
                                                      "signatures")}
                                 if "error" not in rep else rep)
                          for name, rep in res["configs"].items()}
            if res["violations"]:
                fail(f"analysis_invariants: {fn}: {res['configs']}")
        drives_s = time.perf_counter() - t0
        reset_counts()
        eng = inv.InstrumentedEngine(arch, params, ServeConfig(
            batch_slots=SLOTS, max_ctx=512), device=dev)
        for p in prompts:
            eng.add_request(p)
        step_ms = []
        for _ in range(32):
            t1 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
        rep = eng.check()
        # a dispatch replayed from its graph launches no GR-MAC kernel
        # from the host; at these shapes every dispatch replays
        calls = 0 if eng.graph_stats["captures"] else per_forward(arch)
        ok = (rep["fetches"] == len(prompts) + 32
              and rep["d2h"] == rep["fetches"]
              and eng.graph_stats["replays"] == (
                  sum(rep["traces"].values()) if calls == 0 else 0)
              and all(sig[0] == calls for sig in rep["signatures"].values()))
        emit({"phase": "analysis_invariants", "drives": drives,
              "drives_seconds": drives_s, "full_width": {
                  "arch": arch.name, **rep, "graph_stats": eng.graph_stats,
                  "step_ms_median_instrumented": float(np.median(step_ms))},
              "ok": ok, "card": card})
        if not ok:
            fail(f"analysis_invariants: full width {rep}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

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
    del engine, last, logits_k, logits_r, logits_p
    gc.collect()
    torch.cuda.empty_cache()
    seconds("serve")

    serve_scheduler(paper, params, pj)
    prefix_hit_vs_cold("serve", paper, params, dict(max_ctx=512), 64, 16)
    seconds("serve_scheduler")
    serve_spec(paper, params)
    seconds("serve_spec")
    train_paper(paper, params)
    seconds("train")
    analysis_audit(card)
    analysis_sanitize(paper, params, prompts, served_streams["serve"])
    analysis_invariants(paper, params, prompts)
    seconds("analysis")
    spmd_serve(paper, params, prompts)
    seconds("spmd_serve")
    spmd_split(paper, prompts)
    seconds("spmd_split")
    roofline_card_phase(paper, card, {
        "decode": step_median["serve"],
        "prefill": prefill_forward_ms(paper, params),
        "train": step_median["train"]})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    seconds("roofline_card")

    # -------------------------------------------- train_drill, launch_serve
    train_drill(get_config("paper-cim-120m"))
    seconds("train_drill")
    launch_serve(pj)
    seconds("launch_serve")
    dryrun_phase(card)
    seconds("dryrun")
    for name, n in examples_phase(card, reset_counts).items():
        if n:
            launches_by_path[f"examples_{name}"] = n
    seconds("examples")

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
        # mamba2-1.3b: short prompts, one scan a layer over each chunk
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
    # (shared tokens, chunk) of the prefix-hit check, with the weights on
    # the card: gemma3's shared prefix wraps its 512-slot rings
    PREFIX_HIT = {"serve_gemma3": (528, 16), "serve_mamba2": (32, 32)}
    for path, name, lens, n_steps, serve_kw, extra in families:
        arch = with_grmac(archs[name])
        info_kw = dict(head_temporary(arch, serve_kw["prefill_bucket_max"]),
                       **(extra or {}))
        t0 = time.perf_counter()
        params = init_params(arch, SEED, device=dev)
        leaves = tree_leaves(params)
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
        if path in PREFIX_HIT:
            prefix_hit_vs_cold(path, arch, params, serve_kw,
                               *PREFIX_HIT[path])
        if path in SPEC_ROLLBACK:
            spec_rollback(path, arch, params, serve_kw, SPEC_ROLLBACK[path])
        if path in TRAIN_ONE_STEP:
            train_path, b, s_len = TRAIN_ONE_STEP[path]
            data = SyntheticLM(DataConfig(global_batch=b, seq_len=s_len,
                                          vocab_size=arch.vocab_size,
                                          seed=SEED), device=dev)
            train_vs_plain(train_path, arch, params, data.batch_at(0),
                           extra)
            del data
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
    leaves = tree_leaves(params)
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
        # the host's launches (a CUDA graph's warm-ups and capture, never
        # its replays); the kernels that ran on the card in each path's
        # profiles, replays included, as the profiler counts them
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "profiled_on_card_by_path": grmac_on_card,
        "max_abs_err": max_abs_err,
        "checked_vs_plain": True,
        "launches_by_design": by_design_total,
        # the sanitizing instantiation on analysis_sanitize, the plain one
        # on every other path
        "sanitizing_launches": launches_by_path.get("analysis_sanitize", 0),
        "sanitizing_graph_ms_per_forward": totals["sanitizing"],
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
        # paper-cim-120m's train forward at M = 8 x 256, with the per-call
        # route's packing of every weight (pack_ms)
        "train_forward": totals["train_forward"],
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        # no TPU kernel: the JAX package runs the serving recurrence as a
        # lax.scan of plain steps; the port's plain version is the loop
        "replaces": None,
        "tpu_source": None,
        "port_source": "src/repro_torch/csrc/ssm_scan.cu",
        "plain_version": "src/repro_torch/models/ssm.py (_loop)",
        "launches": sum(scan_by_path.values()),
        "launches_by_path": scan_by_path,
        "max_abs_err": scan_check["max_abs_err"],
        "checked_vs_plain": True,
        # one layer's scan at mamba2-1.3b's full width and SLOTS lanes, by
        # the number of steps: "ms" device time by CUDA-graph replay,
        # "plain_ms" the loop on the same tensors, "bound_ms" the bytes
        # moved once at 3.35 TB/s
        "by_steps": scan_check["by_steps"],
        "ms": scan_check["by_steps"][16]["ms"],
        "plain_ms": scan_check["by_steps"][16]["plain_ms"],
        "bound_ms": scan_check["by_steps"][16]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
