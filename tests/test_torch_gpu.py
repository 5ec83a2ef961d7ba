"""Tests of the port that need the CUDA card: the hand-written GR-MAC kernel
(each of its designs, and its row-chunked launch past 2**31 elements)
against its plain version, prepared weights against the per-call path,
the engine's streams through the kernel against the plain version's on
the card (every block kind, MoE FFNs), and the cached paths on the card
against the CPU (weights drawn on the CPU and moved: the two devices'
generators draw different streams), and the energy model with a card
present (the paper's ADC claims on a CUDA generator, the ledger's ``meta``
trace, the engine's pJ/token, ``grmac_matmul`` refusing ``meta``), the
sampler on the card against the CPU, prefix-cache snapshots on the card,
the scheduler's streams through the kernel against the plain version's,
speculative decode's snapshots (copies) and its streams through the
kernel against the plain version's, one train step's loss and
gradients through the kernel (its per-call route, under remat) against
the plain version's, and the kernel's sanitizing instantiation (both
designs, every granularity, NaN and ragged shapes) counting exactly what
the plain version's checks count, its output bitwise the plain
instantiation's, a profiled train step's scopes on autograd's device
thread, and the SSD scan (``kernels.ssm_scan``) against the SSM block's
per-step loop: state and conv window bitwise, y bitwise at 8 lanes (within
its reordered sum at others), an engine's tokens equal.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. This file imports no JAX, so it also runs on the
machine with the card, which has none: ``python -m pytest -m gpu
tests/test_torch_gpu.py`` there.

Tolerances: bitwise at FP6_E3M2 x FP4_E2M1 (every partial sum is exact in
f32 in any order); rtol = atol = 1e-5 for wider formats, whose sums round
in the kernel's order, not the plain version's.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

DESIGNS = ["decode", "prefill"]
GRANULARITIES = ["row", "conv", "unit"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.device import require_full_f32

    require_full_f32()


def _grmac_run(fn):
    """``fn()`` under the profiler: (its result, the GR-MAC kernels that
    ran on the card, replays of CUDA graphs included, and the launches the
    host counted, ``grmac_matmul_cuda.launches``, which a replay adds
    none to)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    host = grmac_matmul_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ran = sum(e.count for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation and "grmac" in e.key)
    return out, ran, grmac_matmul_cuda.launches - host


def _operands(gen, m, k, n, fmt_w):
    from repro_torch.core.formats import quantize

    x = torch.rand((m, k), generator=gen, device="cuda") * 2 - 1
    w = quantize(torch.rand((k, n), generator=gen, device="cuda") * 2 - 1,
                 fmt_w)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", ["row", "conv", "unit"])
def test_kernel_matches_plain_version_bitwise(granularity):
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity=granularity)
    for m, k, n in ((8, 768, 3072), (300, 200, 70), (5, 100, 100)):
        x, w = _operands(gen, m, k, n, FP4_E2M1)
        before = grmac_matmul_cuda.launches
        got = grmac_matmul(x, w, **kw)
        torch.cuda.synchronize()
        assert grmac_matmul_cuda.launches == before + 1
        want = grmac_matmul(x, w, backend="ref", **kw)
        assert got.shape == (m, n)
        assert torch.equal(got, want), (m, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("design", DESIGNS)
def test_each_design_matches_plain_version_bitwise(design, granularity):
    """Every design at the main formats, at decode and prefill M, ragged K
    (padded to the analog columns in the codes) and ragged N, across the
    n_r ladder."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul

    gen = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n, n_r in ((5, 100, 100, 32), (8, 768, 768, 32),
                         (64, 200, 70, 16), (300, 3072, 130, 32),
                         (8, 300, 77, 64), (64, 512, 96, 128)):
        x, w = _operands(gen, m, k, n, FP4_E2M1)
        kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=n_r, enob=8.0,
                  granularity=granularity)
        got = grmac_matmul(x, w, design=design, **kw)
        torch.cuda.synchronize()
        want = grmac_matmul(x, w, backend="ref", **kw)
        assert torch.equal(got, want), (design, m, k, n, n_r)


@pytest.mark.gpu
@pytest.mark.parametrize("design", DESIGNS)
def test_each_design_on_other_formats(design):
    """8-bit weight codes (FP6_E2M3) and FP8_E4M3 inputs: within 1e-5."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E2M3, FP8_E4M3
    from repro_torch.kernels.dispatch import grmac_matmul

    gen = torch.Generator(device="cuda").manual_seed(2)
    for fx, fw in ((FP8_E4M3, FP4_E2M1), (FP6_E2M3, FP6_E2M3)):
        for gran in GRANULARITIES:
            x, w = _operands(gen, 37, 200, 300, fw)
            kw = dict(fmt_x=fx, fmt_w=fw, n_r=32, enob=8.0, granularity=gran)
            got = grmac_matmul(x, w, design=design, **kw)
            want = grmac_matmul(x, w, backend="ref", **kw)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_designs_are_routed_and_counted():
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2, FPFormat
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import (DECODE_MAX_M,
                                                  grmac_matmul_cuda)

    gen = torch.Generator(device="cuda").manual_seed(3)
    wide = FPFormat(3, 10)      # 10 mantissa bits: bf16 would round them
    for m, fx, design in ((8, FP6_E3M2, "decode"),
                          (DECODE_MAX_M, wide, "decode"),
                          (DECODE_MAX_M + 1, FP6_E3M2, "prefill"),
                          (DECODE_MAX_M + 1, wide, "decode"),
                          (300, wide, "decode")):
        x, w = _operands(gen, m, 96, 40, FP4_E2M1)
        before = dict(grmac_matmul_cuda.launches_by_design)
        grmac_matmul(x, w, fmt_x=fx, fmt_w=FP4_E2M1)
        after = grmac_matmul_cuda.launches_by_design
        assert {d: after[d] - before[d] for d in after} == {
            d: int(d == design) for d in after}
    x, w = _operands(gen, 64, 96, 40, FP4_E2M1)
    with pytest.raises(ValueError, match="bf16"):
        grmac_matmul(x, w, fmt_x=wide, fmt_w=FP4_E2M1, design="prefill")


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_wide_formats_through_the_decode_design(granularity):
    """fmt_x with 10 mantissa bits (bf16 would round it) takes the decode
    design's f32-FMA body at every M: within 1e-5 of the plain version at
    decode and prefill M, ragged K and N."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FPFormat
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(5)
    wide = FPFormat(3, 10)
    for m, k, n, n_r in ((8, 768, 768, 32), (64, 200, 70, 16),
                         (300, 3072, 130, 32), (512, 768, 3072, 64)):
        x, w = _operands(gen, m, k, n, FP4_E2M1)
        kw = dict(fmt_x=wide, fmt_w=FP4_E2M1, n_r=n_r, enob=8.0,
                  granularity=granularity)
        before = grmac_matmul_cuda.launches_by_design["decode"]
        got = grmac_matmul(x, w, **kw)
        assert grmac_matmul_cuda.launches_by_design["decode"] == before + 1
        want = grmac_matmul(x, w, backend="ref", **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_refuses_unsupported_n_r():
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul

    x = torch.zeros((4, 48), device="cuda")
    w = torch.zeros((48, 4), device="cuda")
    with pytest.raises(ValueError, match="n_r"):
        grmac_matmul(x, w, fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=24)


@pytest.mark.gpu
def test_packed_weights_equal_the_per_call_path_on_the_card():
    """cim_matmul with a prepared weight equals the per-call path (the
    weight quantized on every call, the plain version) bit for bit, also
    for a tied LM head's non-contiguous ``embed.T``, which goes through the
    kernel."""
    _need_card()
    from repro_torch.core.cim_config import CIMConfig
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.kernels.packed import pack_weight

    gen = torch.Generator(device="cuda").manual_seed(4)
    embed = torch.randn((512, 128), generator=gen, device="cuda") * 0.02
    for gran in GRANULARITIES:
        cfg = CIMConfig(mode="grmac", granularity=gran)
        for m in (8, 64):
            x = torch.randn((m, 128), generator=gen, device="cuda") * 3
            want = cim_matmul(x, embed.T, cfg, backend="ref")
            raw = cim_matmul(x, embed.T, cfg)          # packed per call
            before = grmac_matmul_cuda.launches
            packed = cim_matmul(x, pack_weight(embed.T, cfg.fmt_w, cfg.n_r),
                                cfg)
            assert grmac_matmul_cuda.launches == before + 1
            assert torch.equal(raw, want) and torch.equal(packed, want)


@pytest.mark.gpu
def test_tied_head_runs_through_the_kernel_and_matches_the_cpu():
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.models import forward, init_params, pack_params

    arch = get_config("paper-cim-120m").reduced().replace(tie_embeddings=True)
    toks = torch.randint(0, arch.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(0))
    from repro_torch.models import to_device

    params = init_params(arch, 0, device="cpu")
    cpu = forward(pack_params(params, arch), toks, arch)[0]
    served = pack_params(to_device(params, "cuda"), arch)
    assert served["lm_head"]["w"].codes.is_contiguous()
    before = grmac_matmul_cuda.launches
    card = forward(served, toks.cuda(), arch)[0].cpu()
    assert grmac_matmul_cuda.launches - before == 7 * arch.n_layers + 1
    assert float((card - cpu).abs().max()) <= 1e-5
    assert torch.equal(card.argmax(-1), cpu.argmax(-1))


@pytest.mark.gpu
def test_engine_streams_through_the_kernel_equal_the_plain_version():
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config("paper-cim-120m").reduced()
    params = init_params(arch, seed=0)
    streams = []
    for backend in (None, "ref"):
        eng = Engine(arch, params, ServeConfig(batch_slots=4, max_ctx=64,
                                               cim_backend=backend))

        def serve():
            for n in (5, 12, 33):
                eng.add_request(list(range(1, n + 1)))
            for _ in range(6):
                eng.step()
        _, ran, launches = _grmac_run(serve)
        dispatches = (eng.stats["prefill_dispatches"]
                      + eng.stats["decode_steps"])
        eager = dispatches - eng.graph_stats["replays"]
        per_forward = 7 * arch.n_layers + 1
        assert ran == (per_forward * dispatches if backend is None else 0)
        assert launches == (per_forward * eager if backend is None else 0)
        streams.append([list(t) for t in eng.tokens])
    assert streams[0] == streams[1]


@pytest.mark.gpu
def test_cached_paths_on_the_card_agree_with_the_cpu():
    """Prefill (with a frozen lane) and a decode step whose index runs past
    the cache (the clamped write) give the CPU's greedy ids on the card,
    and logits within 1e-5 (the devices sum norms, softmax and attention
    in different orders)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, to_device)

    arch = get_config("paper-cim-120m").reduced()
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, arch.vocab_size, (4, 16), generator=gen)
    tok = torch.randint(0, arch.vocab_size, (4, 1), generator=gen)
    idx = torch.tensor([0, 3, 0, 5])
    lens = torch.tensor([16, 7, 0, 12])
    at = torch.tensor([16, 10, 63, 64])
    out = {}
    cpu_params = init_params(arch, seed=0, device="cpu")
    for dev in ("cpu", "cuda"):
        params = to_device(cpu_params, dev)
        cache = init_cache(arch, 4, 64, torch.float32, dev)
        last, ids, cache = prefill_step(params, toks.to(dev), arch, cache,
                                        idx.to(dev), lens.to(dev))
        logits, cache = decode_step(params, tok.to(dev), arch, cache,
                                    at.to(dev))
        out[dev] = [t.cpu() for t in (last, ids, logits,
                                      cache["layers"][1]["k"])]
    for a, b in zip(out["cpu"], out["cuda"]):
        if a.dtype.is_floating_point:
            assert float((a - b).abs().max()) <= 1e-5
        else:
            assert torch.equal(a, b)
    assert torch.equal(out["cpu"][2].argmax(-1), out["cuda"][2].argmax(-1))


# ------------------------------------------------------------ CUDA graphs
def _graph_checked_engine(arch, params, cfg):
    """An engine whose every graph replay is held, bit for bit, to the
    eager ``decode_step`` / ``prefill_step`` of the same host inputs on a
    clone of the cache taken just before: the outputs and the caches
    after. Returns (engine, [(graph replayed, GR-MAC kernels it ran on
    the card, GR-MAC launches the host counted for it)] in order)."""
    from repro_torch.models import decode_step, prefill_step
    from repro_torch.serving import Engine

    eng = Engine(arch, params, cfg)
    names = {id(g): n for n, g in eng._graphs.items()}
    replay, seen = eng._replay, []

    def checked(graph, *host):
        clone = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in eng.cache["layers"]]}
        out, ran, launches = _grmac_run(lambda: replay(graph, *host))
        name = names[id(graph)]
        seen.append((name, ran, launches))
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in host]
        if name == "decode":
            want = decode_step(eng.params, args[0], eng.arch, clone,
                               args[1], active=args[2])[:1]
        else:
            want = prefill_step(eng.params, args[0], eng.arch, clone,
                                *args[1:])[:2]
        assert len(out) == len(want)
        for a, b in zip(out, want):
            assert torch.equal(a, b), name
        for mine, theirs in zip(eng.cache["layers"], clone["layers"]):
            for k in mine:
                assert torch.equal(mine[k], theirs[k]), (name, k)
        return out

    eng._replay = checked
    return eng, seen


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paper-cim-120m", "gemma3-1b"])
def test_graph_replays_equal_the_eager_dispatches_bitwise(name):
    """Admissions, chunked prefills over several buckets (a chunk of
    gemma3's wraps its 64-slot rings), a request that finishes and frees
    its slot, a prefix-cache hit admitted into it: every replayed decode
    and chunk equals the eager dispatch on a clone of the cache, the
    replays are the dispatches, and nothing is captured after
    construction."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import SamplingParams, ServeConfig

    arch = get_config(name).reduced()
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    eng, seen = _graph_checked_engine(
        arch, init_params(arch, seed=0), ServeConfig(
            batch_slots=4, max_ctx=128, prefix_cache_bytes=1 << 26))
    # decode and the buckets 8-128 (a prompt of up to 127 tokens)
    assert list(eng._graphs) == ["decode"] + [
        f"prefill[bucket={b}]" for b in (8, 16, 32, 64, 128)]
    captures = eng.graph_stats["captures"]
    assert captures == 6
    rng = np.random.default_rng(1)
    long = [int(t) for t in rng.integers(1, arch.vocab_size, 75)]
    slot = eng.begin_request(long)
    while eng.prefill_remaining(slot):
        for m in (5, 24, 40):
            if eng.prefill_remaining(slot):
                eng.advance_prefill(slot, max_tokens=m)
    eng.finish_prefill(slot)
    short = eng.add_request([int(t) for t in rng.integers(1, 500, 9)],
                            params=SamplingParams(max_tokens=3))
    freed = []
    for _ in range(4):
        freed += eng.step().finished
    assert short in freed and eng.free_slots() == 3
    hit = eng.add_request(long[:64] + [7, 8, 9])
    assert eng.adopted_prefix(hit) == 64
    for _ in range(3):
        eng.step()
    dispatches = eng.stats["decode_steps"] + eng.stats["prefill_dispatches"]
    assert eng.graph_stats["replays"] == dispatches == len(seen)
    replayed = {n for n, _, _ in seen}
    assert {f"prefill[bucket={b}]" for b in (8, 16, 32, 64)} <= replayed
    assert "decode" in replayed
    assert eng.graph_stats["captures"] == captures
    # each replay runs a forward's kernels on the card, the host
    # launching none of them
    assert {(ran, host) for _, ran, host in seen} == {(_per_forward(arch), 0)}


@pytest.mark.gpu
def test_recurrent_and_moe_engines_stay_eager_on_the_card():
    """mamba2's SSM blocks and grok's MoE: no capture, no replay."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    for name in ("mamba2-1.3b", "grok-1-314b"):
        arch = get_config(name).reduced()
        arch = arch.replace(cim=arch.cim.with_mode("grmac"))
        eng = Engine(arch, init_params(arch, seed=0),
                     ServeConfig(batch_slots=2, max_ctx=64))
        eng.add_request([3, 1, 4, 1, 5])
        eng.step()
        assert eng.graph_stats == {"captures": 0, "replays": 0}, name


# ------------------------------------------------------------ other blocks
FAMILIES = ["gemma3-1b", "recurrentgemma-9b", "mamba2-1.3b", "grok-1-314b",
            "arctic-480b"]


def _per_forward(arch) -> int:
    """GR-MAC launches of one forward: 4 projections per attention, RG-LRU
    or SSM block; after every block but SSM the FFN's, or an MoE FFN's
    router and (arctic) dense residual MLP, its experts being digital; the
    LM head."""
    ffn = 3 if arch.gated_mlp else 2
    moe = 1 + (ffn if arch.moe_dense_residual else 0)
    return 1 + sum(4 + (0 if kind == "ssm" else moe if arch.is_moe else ffn)
                   for kind in arch.blocks())


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES)
def test_family_engine_streams_through_the_kernel_equal_the_plain_version(
        name):
    """Sliding-window, RG-LRU, SSM and MoE models with every projection
    through GR-MAC: the kernel engine's streams equal the plain version's
    on the card, with one launch per projection of every dispatch; a
    70-token prompt wraps the 64-slot rings inside its prefill chunk. The
    MoE experts' batched matmuls repeat bitwise between the two
    engines."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config(name).reduced()
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    params = init_params(arch, seed=0)
    streams = []
    for backend in (None, "ref"):
        eng = Engine(arch, params, ServeConfig(batch_slots=4, max_ctx=128,
                                               cim_backend=backend))

        def serve():
            for n in (5, 12, 70):
                eng.add_request(list(range(1, n + 1)))
            for _ in range(6):
                eng.step()
        _, ran, launches = _grmac_run(serve)
        dispatches = (eng.stats["prefill_dispatches"]
                      + eng.stats["decode_steps"])
        eager = dispatches - eng.graph_stats["replays"]
        assert ran == (_per_forward(arch) * dispatches
                       if backend is None else 0)
        assert launches == (_per_forward(arch) * eager
                            if backend is None else 0)
        streams.append([list(t) for t in eng.tokens])
    assert streams[0] == streams[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", FAMILIES + ["musicgen-medium"])
def test_family_cached_paths_on_the_card_agree_with_the_cpu(name):
    """The reduced config (its own CIM setting: off), its weights drawn on
    the CPU, on the CPU and on the card: prefill with a frozen lane, then
    a decode step past the cache's end. Greedy ids equal at the valid
    positions, logits and every cache within 1e-5 + 1e-5 |value| (the
    devices sum norms, softmax, attention and the MoE experts' products
    in different orders). recurrentgemma gets 5e-5 + 1e-5 |value|: RG-LRU
    takes sqrt(1 - a^2) at a = exp(log a) up to 0.999, where one ulp of a
    moves the factor by 3e-5 of its value, and the devices' exp differ by
    an ulp (measured on the H100: up to 1.8e-5 on the logits). musicgen
    takes seeded embeddings."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, to_device)

    arch = get_config(name).reduced()
    gen = torch.Generator().manual_seed(0)
    if arch.input_mode == "tokens":
        toks = torch.randint(0, arch.vocab_size, (4, 16), generator=gen)
        tok = torch.randint(0, arch.vocab_size, (4, 1), generator=gen)
    else:
        toks = torch.randn((4, 16, arch.d_model), generator=gen)
        tok = torch.randn((4, 1, arch.d_model), generator=gen)
    idx, lens = torch.tensor([0, 3, 0, 5]), torch.tensor([16, 7, 0, 12])
    at = torch.tensor([16, 10, 63, 64])
    out = {}
    cpu_params = init_params(arch, seed=0, device="cpu")
    for dev in ("cpu", "cuda"):
        params = to_device(cpu_params, dev)
        cache = init_cache(arch, 4, 64, torch.float32, dev)
        last, ids, cache = prefill_step(params, toks.to(dev), arch, cache,
                                        idx.to(dev), lens.to(dev))
        logits, cache = decode_step(params, tok.to(dev), arch, cache,
                                    at.to(dev))
        out[dev] = ([last.cpu(), logits.cpu()]
                    + [t.cpu() for c in cache["layers"] for t in c.values()],
                    ids.cpu())
    atol = 5e-5 if name == "recurrentgemma-9b" else 1e-5
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert bool(torch.all((a - b).abs() <= atol + 1e-5 * a.abs()))
    valid = torch.arange(16)[None, :] < lens[:, None]
    assert torch.equal(out["cpu"][1][valid], out["cuda"][1][valid])
    assert torch.equal(out["cpu"][0][1].argmax(-1),
                       out["cuda"][0][1].argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("design", DESIGNS)
def test_each_design_at_the_new_block_shapes(design):
    """Bitwise at FP6_E3M2 x FP4_E2M1 in row granularity at the shapes the
    new paths add: mamba2's N = 64 (dt_proj) and 256 (bc_proj), gemma3's
    K = 1152 and 6912 (the decode design stages 6912 K codes of x), and
    a 1152 x 262 144 tied head."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul

    gen = torch.Generator(device="cuda").manual_seed(6)
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity="row")
    for m, k, n in ((8, 2048, 64), (40, 2048, 64), (8, 2048, 256),
                    (40, 2048, 256), (8, 6912, 1152), (40, 1152, 6912),
                    (8, 1152, 262144)):
        x, w = _operands(gen, m, k, n, FP4_E2M1)
        got = grmac_matmul(x, w, design=design, **kw)
        torch.cuda.synchronize()
        want = grmac_matmul(x, w, backend="ref", **kw)
        assert torch.equal(got, want), (design, m, k, n)
        del x, w, got, want


# the kernel shapes the MoE and dense configs of the fourth slice add, as
# (K, N): grok's router (6144 x 8) and attention (6144 x 6144, 6144 x
# 1024), arctic's router (7168 x 128), attention and dense residual (7168,
# 4864), chameleon's 8192-wide attention and 22 016-deep FFN (past the
# decode design's staging, so the tensor cores take it at every M),
# granite's 14 336, qwen2's 8960 and stablelm's d_head 80 (2560 x 2560)
NEW_SHAPES = ((6144, 8), (7168, 128), (6144, 6144), (6144, 1024),
              (7168, 7168), (7168, 4864), (4864, 7168), (8192, 8192),
              (8192, 22016), (22016, 8192), (4096, 14336), (14336, 4096),
              (1536, 8960), (8960, 1536), (2560, 2560), (2560, 6912),
              (1536, 6144), (6144, 1536))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 40])
def test_kernel_at_the_new_config_shapes(m):
    """Bitwise at FP6_E3M2 x FP4_E2M1 in row granularity at every new
    projection shape, M = 8 (the decode design where K allows) and 40
    (the tensor cores)."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul

    gen = torch.Generator(device="cuda").manual_seed(7)
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity="row")
    for k, n in NEW_SHAPES:
        x, w = _operands(gen, m, k, n, FP4_E2M1)
        got = grmac_matmul(x, w, **kw)
        torch.cuda.synchronize()
        want = grmac_matmul(x, w, backend="ref", **kw)
        assert torch.equal(got, want), (m, k, n)
        del x, w, got, want


@pytest.mark.gpu
def test_row_chunked_launch_past_the_32_bit_limit():
    """gemma3-1b's tied head at 8 slots and ``prefill_bucket_max`` 1024: M =
    8192 rows x N = 262 144 columns is 2**31 output elements, past the
    kernel's 32-bit indices, so the wrapper launches it in two row chunks
    (8128 + 64 rows). Rows on both sides of the chunk boundary, and the
    first and last, equal the plain version's on the same pre-scaled x."""
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(8)
    m, k, n = 8192, 1152, 262144
    x, w = _operands(gen, m, k, n, FP4_E2M1)
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity="row")
    before = grmac_matmul_cuda.launches
    got = grmac_matmul(x, w, **kw)
    torch.cuda.synchronize()
    assert grmac_matmul_cuda.launches == before + 2
    rows = torch.tensor([0, 1, 4097, 8126, 8127, 8128, 8129, 8191],
                        device="cuda")
    want = grmac_matmul(x[rows], w, backend="ref", **kw)
    assert torch.equal(got[rows], want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
def test_embedding_model_through_the_kernel_equals_the_plain_version():
    """musicgen (embedding inputs, GELU MLP) reduced, every projection
    through GR-MAC: prefill and two decode steps through the kernel give
    the plain version's logits bitwise on the card."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    pack_params, prefill_step)

    arch = get_config("musicgen-medium").reduced()
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    params = init_params(arch, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    emb = torch.randn((4, 16, arch.d_model), generator=gen, device="cuda")
    lens = torch.tensor([16, 7, 0, 12], device="cuda")
    out = []
    for a, p in ((arch, pack_params(params, arch)),
                 (arch.replace(cim=arch.cim.with_backend("ref")), params)):
        before = grmac_matmul_cuda.launches
        cache = init_cache(a, 4, 64, torch.float32)
        last, ids, cache = prefill_step(p, emb, a, cache, 0, lens)
        logits = [last]
        for i in range(2):
            lg, cache = decode_step(p, emb[:, i:i + 1], a, cache, lens + i)
            logits.append(lg)
        launches = grmac_matmul_cuda.launches - before
        assert launches == (3 * _per_forward(arch)
                            if a.cim.backend != "ref" else 0)
        out.append(torch.stack(logits))
    assert torch.equal(out[0], out[1])
    assert bool(torch.isfinite(out[0]).all())


# ------------------------------------------------------------------ energy
@pytest.mark.gpu
def test_paper_claims_on_a_card_generator():
    """The paper's ADC claims (C2, C3, C8) drawn by a CUDA generator; the
    samples live on the card, and the solve memo keeps the card's and the
    CPU's streams apart."""
    _need_card()
    from repro_torch.core import adc, distributions as D, energy
    from repro_torch.core.formats import FP6_E3M2, FPFormat

    gen = torch.Generator(device="cuda").manual_seed(0)
    assert D.uniform()(gen, (4, 3)).device.type == "cuda"
    ncross = energy.TechParams().n_cross()
    deltas = []
    for ne in (2, 3, 4):
        fmt = FPFormat(ne, 2)
        rc = adc.required_enob(gen, "conv", D.uniform(), fmt)
        ru = adc.required_enob(gen, "gr_unit", D.uniform(), fmt)
        deltas.append(rc.enob - ru.enob)
        assert ru.enob < ncross
    assert min(deltas) >= 1.3, deltas
    rc = adc.required_enob(gen, "conv", D.gaussian_outliers(), FPFormat(3, 2))
    ru = adc.required_enob(gen, "gr_unit", D.gaussian_outliers(),
                           FPFormat(3, 2))
    assert rc.enob - ru.enob > 6.0
    card = adc.solve_required_enob("gr_row", FP6_E3M2, n_cols=1 << 11)
    cpu = adc.solve_required_enob("gr_row", FP6_E3M2, n_cols=1 << 11,
                                  device="cpu")
    assert card is adc.solve_required_enob("gr_row", FP6_E3M2, n_cols=1 << 11,
                                           device="cuda")
    assert card is not cpu


@pytest.mark.gpu
def test_meta_trace_and_engine_energy_with_a_card():
    """The ledger's trace stays on ``meta`` with a card present (it
    launches nothing); the engine on the card prices it with the card's
    solve, equal to ``energy_report``'s; ``grmac_matmul`` refuses a meta
    tensor."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.core import costs
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig, energy_report

    arch = get_config("paper-cim-120m")
    before = grmac_matmul_cuda.launches
    ledger = costs.trace_decode(arch)
    assert grmac_matmul_cuda.launches == before
    assert 2 * ledger.macs() == 275644416
    small = arch.reduced()
    eng = Engine(small, init_params(small, seed=0),
                 ServeConfig(batch_slots=2, max_ctx=64))
    eng.add_request([1, 2, 3])
    r = eng.step()
    assert r.pj_per_token == energy_report(small)["pj_per_token"] > 0
    with pytest.raises(ValueError, match="meta tensor"):
        dispatch.grmac_matmul(torch.empty((8, 64), device="meta"),
                              torch.empty((64, 16), device="meta"),
                              fmt_x=FP6_E3M2, fmt_w=FP4_E2M1)


# ------------------------------------------------------------- serving
def _chi2_p(counts, probs):
    """Chi-square p-value by the regularized upper incomplete gamma."""
    exp = probs / probs.sum() * counts.sum()
    stat = float(((counts - exp) ** 2 / exp).sum())
    df = torch.tensor((len(counts) - 1) / 2.0, dtype=torch.float64)
    return float(torch.special.gammaincc(df, torch.tensor(
        stat / 2.0, dtype=torch.float64)))


@pytest.mark.gpu
def test_sampler_on_the_card_equals_the_cpu():
    """2**16 draws on fixed logits (V = 64, seeds 0-1023, 64 events each)
    on the card and on the CPU: the uniforms are bitwise equal (an integer
    hash), the ids equal but for ulp ties of log, and both histograms
    pass chi-square against softmax(logits / T) at p >= 0.001."""
    _need_card()
    from repro_torch.serving import sampling

    v, t = 64, 0.8
    logits = torch.linspace(-1.5, 1.5, v).repeat(1024, 1)
    temps = torch.full((1024,), t)
    seeds = list(range(1024))
    ids = {"cpu": [], "cuda": []}
    for event in range(64):
        keys = torch.tensor(sampling.lane_keys(0, seeds, [event] * 1024))
        if event == 0:
            assert torch.equal(sampling.uniform(keys.cuda(), v).cpu(),
                               sampling.uniform(keys, v))
        for dev in ids:
            ids[dev].append(sampling.select(logits.to(dev), temps.to(dev),
                                            keys.to(dev)).cpu())
    cpu, card = torch.cat(ids["cpu"]), torch.cat(ids["cuda"])
    assert float((cpu == card).double().mean()) >= 0.999
    probs = torch.softmax(torch.linspace(-1.5, 1.5, v).double() / t, 0)
    for got in (cpu, card):
        counts = torch.bincount(got.long(), minlength=v).double()
        assert _chi2_p(counts, probs) >= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-1.5b", "recurrentgemma-9b",
                                  "mamba2-1.3b"])
def test_snapshot_round_trip_on_the_card_does_not_alias(name):
    """A snapshot on the card is a copy: the lane's next decode and its
    zeroing leave it unchanged, and a restore into another lane writes
    back exactly the captured rows, rings and states."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.prefix_cache import restore_slot, snapshot_slot

    arch = get_config(name).reduced()
    eng = Engine(arch, init_params(arch, seed=0),
                 ServeConfig(batch_slots=2, max_ctx=64))
    slot = eng.begin_request(list(range(1, 18)))
    while eng.prefill_remaining(slot):
        eng.advance_prefill(slot, max_tokens=8)
    kinds = arch.blocks()
    snap = snapshot_slot(eng.cache, slot, 16, kinds)
    kept = [{k: t.clone() for k, t in layer.items()}
            for layer in snap["layers"]]
    assert all(t.is_cuda for layer in snap["layers"] for t in layer.values())
    eng.finish_prefill(slot)
    eng.step()
    eng._reset_slot_state(slot)
    for layer, was in zip(snap["layers"], kept):
        assert all(torch.equal(t, was[k]) for k, t in layer.items())
    restore_slot(eng.cache, 1, 16, snap)
    back = snapshot_slot(eng.cache, 1, 16, kinds)
    for layer, was in zip(back["layers"], kept):
        assert all(torch.equal(t, was[k]) for k, t in layer.items())


@pytest.mark.gpu
def test_scheduler_streams_through_the_kernel_equal_the_plain_version():
    """The reduced paper config on the card under the scheduler (budget,
    preemption, prefix cache), sampled and greedy lanes: the kernel's run
    and the plain version's give equal streams and policy metrics."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, SamplingParams, Scheduler,
                                     SchedulerConfig, ServeConfig, StepClock,
                                     sampling, synth_traffic)

    arch = get_config("paper-cim-120m").reduced()
    params = init_params(arch, seed=0)
    traffic = synth_traffic(10, 0.8, seed=0, vocab_size=arch.vocab_size,
                            prompt_len=(8, 24), out_len=(3, 8))
    runs = []
    for backend in (None, "ref"):
        clock = StepClock()
        eng = Engine(arch, params, ServeConfig(
            batch_slots=4, max_ctx=64, cim_backend=backend,
            prefix_cache_bytes=1 << 24))
        sched = Scheduler(eng, SchedulerConfig(prefill_token_budget=8,
                                               preempt_age=10.0),
                          clock=clock.now)
        for i, t in enumerate(traffic):
            sched.submit(t.prompt, arrival=0.0, params=SamplingParams(
                max_tokens=t.max_new_tokens, temperature=0.8 * (i % 3 > 0),
                seed=i if i % 3 == 1 else None))
        key = sampling.key(0)
        while not sched.idle():
            key, sub = sampling.split(key)
            sched.step(sub)
            clock.tick()
        m = sched.metrics()
        runs.append(([r.generated for r in sched.requests],
                     {k: v for k, v in m.items()
                      if not k.endswith(("_ms", "_s"))}))
    assert runs[0] == runs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_spec_snapshot_on_the_card_is_a_copy(name):
    """``spec_snapshot`` clones: zeroing a live lane's rings and states
    after it leaves the snapshot unchanged, and ``spec_restore`` writes the
    captured lane back into that lane only."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config(name).reduced()
    eng = Engine(arch, init_params(arch, seed=0),
                 ServeConfig(batch_slots=2, max_ctx=64))
    for prompt in ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]):
        eng.add_request(prompt)
    eng.step()
    snap = eng.spec_snapshot()
    assert snap and all(t.is_cuda for layer in snap.values()
                        for t in layer.values())
    kept = {i: {k: t.clone() for k, t in layer.items()}
            for i, layer in snap.items()}
    other = {i: {k: t[1].clone() for k, t in eng.cache["layers"][i].items()}
             for i in snap}
    eng._reset_slot_state(0)
    for i, layer in snap.items():
        assert all(torch.equal(t, kept[i][k]) for k, t in layer.items())
    eng.step()                                   # lane 1 moves on
    moved = {i: {k: t[1].clone() for k, t in eng.cache["layers"][i].items()}
             for i in snap}
    eng.spec_restore(snap, np.array([True, False]))
    for i in snap:
        for k, t in eng.cache["layers"][i].items():
            assert torch.equal(t[0], kept[i][k][0])
            assert torch.equal(t[1], moved[i][k])
    assert any(not torch.equal(moved[i][k], other[i][k])
               for i in snap for k in moved[i])


@pytest.mark.gpu
@pytest.mark.parametrize("draft", ["digital", "self"])
def test_spec_streams_through_the_kernel_equal_the_plain_version(draft):
    """Speculative decode on the reduced paper config (GR-MAC) and on the
    reduced mamba2 in GR-MAC mode (rollbacks), one sampled seeded lane:
    the kernel's streams and counters equal the plain version's."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, SamplingParams, ServeConfig,
                                     SpecConfig, SpecDecoder)

    for name in ("paper-cim-120m", "mamba2-1.3b"):
        arch = get_config(name).reduced()
        arch = arch.replace(cim=arch.cim.with_mode("grmac"))
        params = init_params(arch, seed=0)
        runs = []
        for backend in (None, "ref"):
            eng = Engine(arch, params, ServeConfig(
                batch_slots=3, max_ctx=64, cim_backend=backend))
            for i, p in enumerate(([3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8],
                                   [9, 9, 8])):
                eng.add_request(p, params=SamplingParams(
                    temperature=0.8 * (i == 2), seed=i))
            dec = SpecDecoder(eng, SpecConfig(k=4, draft=draft))
            for _ in range(5):
                dec.step()
            runs.append(([list(t) for t in eng.tokens], dict(eng.stats)))
        assert runs[0] == runs[1]
        assert runs[0][1]["spec_steps"] == 5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paper-cim-120m", "mamba2-1.3b"])
def test_train_step_through_the_kernel_equals_the_plain_version(name):
    """One train step's loss and gradients of a reduced config in GR-MAC
    mode under remat: the kernel's per-call route and the plain version
    give the same loss (the forwards are bitwise equal) and gradients
    within 1e-5 of each tensor's largest entry (the backward is the same
    plain torch, deterministic algorithms on)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_params, train_loss
    from repro_torch.tree import tree_leaves, tree_map

    arch = get_config(name).reduced().replace(remat=True)
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    params = init_params(arch, seed=0)
    batch = SyntheticLM(DataConfig(global_batch=2, seq_len=32,
                                   vocab_size=arch.vocab_size)).batch_at(0)
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for backend in ("auto", "ref"):
            a = arch.replace(cim=arch.cim.with_backend(backend))
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            total, metrics = train_loss(leaves, batch, a)
            out.append((float(metrics["loss"].detach()), torch.autograd.grad(
                total, tree_leaves(leaves), materialize_grads=True)))
    finally:
        torch.use_deterministic_algorithms(False)
    (lk, gk), (lr, gr) = out
    assert lk == lr
    for a, b in zip(gk, gr):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---------------------------------------------------------------- sanitizer
def _pending_stats(start):
    """The pending sanitizer records since index ``start`` folded into one
    (nonfinite, overflow, worst |v|, gain count, worst span) tuple: a
    kernel call leaves one buffer, a plain call one values and (row, unit)
    one span record."""
    from repro_torch.analysis import sanitize

    out = [0, 0, 0.0, 0, 0]
    for _, kinds, stats, from_kernel in sanitize._PENDING[start:]:
        row = stats.cpu().numpy()
        if from_kernel:
            worst = float(np.array([row[2]], np.int64).astype(
                np.uint32).view(np.float32)[0])
            return (int(row[0]), int(row[1]), worst, int(row[3]),
                    int(row[4]) if "gain_range" in kinds else 0)
        if "nonfinite" in kinds:
            out[:3] = int(row[0]), int(row[1]), float(row[2])
        if "gain_range" in kinds:
            out[3:] = int(row[3]), int(row[4])
    return tuple(out)


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("case", ["main", "e4m3", "nan", "ragged"])
def test_sanitizing_kernel_counts_equal_plain_version(design, granularity,
                                                      case, monkeypatch):
    """The sanitizing instantiation's five numbers (nonfinite, overflow,
    worst |v|, gain count, worst span) equal the plain version's on the
    same inputs, worst |v| bitwise at the main formats, for both designs
    and every granularity: the main formats; FP8_E4M3 activations (gain-range
    violations; the tensor-core design takes only formats exact in bf16,
    so FP8_E4M3 x FP4_E2M1 there); a NaN (its block's v nonfinite in
    every column);
    ragged M, K and N (padding rows and clamped columns counted once).
    The output stays bitwise the unsanitized kernel's."""
    _need_card()
    from repro_torch.analysis import sanitize
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2, FP8_E4M3
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(3)
    m, k, n = (37, 200, 70) if case == "ragged" else (40, 256, 128)
    x, w = _operands(gen, m, k, n, FP4_E2M1)
    if case == "nan":
        x[5, 40] = float("nan")
    if case == "ragged":
        x[:, :17] *= 1e-3
    kw = dict(fmt_x=FP8_E4M3 if case == "e4m3" else FP6_E3M2,
              fmt_w=FP4_E2M1, n_r=32, enob=8.0, granularity=granularity)
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    base = grmac_matmul(x, w, design=design, **kw)
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    sanitize.clear()
    before = grmac_matmul_cuda.launches
    got = grmac_matmul(x, w, design=design, tag="k", **kw)
    # one launch, of the sanitizing instantiation: it left a kernel buffer
    assert grmac_matmul_cuda.launches == before + 1
    assert [p[3] for p in sanitize._PENDING] == [True]
    kern = _pending_stats(0)
    i = len(sanitize._PENDING)
    want = grmac_matmul(x, w, backend="ref", tag="k", **kw)
    plain = _pending_stats(i)
    assert torch.equal(got.isnan(), base.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(base))
    if case == "e4m3":
        # FP8_E4M3 products' block sums round in each design's order:
        # worst |v| within 1e-5, the counts and spans exact
        assert kern[:2] + kern[3:] == plain[:2] + plain[3:]
        assert abs(kern[2] - plain[2]) <= 1e-5 * plain[2]
    else:
        assert kern == plain
    if case != "e4m3":                   # bitwise formats, NaNs where torch's
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if case == "nan":
        assert kern[0] == n                    # row 5's block 1, each column
    if case == "e4m3" and granularity != "conv":
        assert kern[3] > 0 and kern[4] > 6
    sanitize.clear()


@pytest.mark.gpu
def test_sanitizer_through_cim_matmul_on_the_card(monkeypatch):
    """``cim_matmul``'s kernel route (packed weights, the pre-scale in the
    kernel) and its plain route on the card give equal records, tagged
    with the site; a NaN makes sx NaN and every v of the call nonfinite;
    unset, the plain instantiation runs and no record is left."""
    _need_card()
    from repro_torch.analysis import sanitize
    from repro_torch.core.cim_config import CIMConfig
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.kernels.packed import pack_weight

    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = CIMConfig(mode="grmac")
    for m in (8, 96):                         # decode and tensor-core design
        x = torch.randn((m, 768), generator=gen, device="cuda") * 3
        w = torch.randn((768, 320), generator=gen, device="cuda") * 0.02
        pw = pack_weight(w, cfg.fmt_w, cfg.n_r)
        monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
        sanitize.clear()
        before = grmac_matmul_cuda.launches
        clean = cim_matmul(x, pw, cfg, site="mlp")
        # one launch, of the plain instantiation: it left no buffer
        assert grmac_matmul_cuda.launches == before + 1
        assert sanitize._PENDING == []
        monkeypatch.setenv(sanitize.ENV_VAR, "1")
        for xin in (x, x.clone().index_fill_(0, torch.tensor(
                [m // 2], device="cuda"), float("nan"))):
            sanitize.clear()
            out_k = cim_matmul(xin, pw, cfg, site="mlp")
            kern = [dict(r) for r in sanitize.VIOLATIONS]
            sanitize.clear()
            cim_matmul(xin, w, cfg, site="mlp", backend="ref")
            assert kern == [dict(r) for r in sanitize.VIOLATIONS]
            if xin is x:
                assert torch.equal(out_k, clean)
            else:
                assert kern[0] == {"kind": "nonfinite", "tag": "mlp",
                                   "count": m * 24 * 320,
                                   "worst": float("inf")}
    sanitize.clear()


@pytest.mark.gpu
def test_train_step_scopes_on_the_card():
    """A profiled train step on the card (paper-cim-120m reduced, remat):
    the per-call packing is ``cim.pack`` under its site marker, in
    ``train.forward`` on the calling thread and, in remat's recomputation,
    on autograd's device thread with a stack of its own."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import (OptimizerConfig,
                                                init_opt_state)
    from repro_torch.training.trainer import TrainConfig, make_train_step

    arch = get_config("paper-cim-120m").reduced().replace(remat=True)
    params = init_params(arch, 0, device="cuda")
    step = make_train_step(arch, TrainConfig(opt=OptimizerConfig()))
    ids = torch.randint(1, arch.vocab_size, (2, 9), device="cuda")
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
    step(params, init_opt_state(params, OptimizerConfig()), batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, init_opt_state(params, OptimizerConfig()), batch)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    threads = {}              # the outermost scope of each cim.pack
    for e in prof.events():
        if e.device_type == cpu and e.name == "cim.pack":
            chain, p = [], e.cpu_parent
            while p is not None:
                if p.is_user_annotation:
                    chain.insert(0, p.name)
                p = p.cpu_parent
            assert re.fullmatch(r"cim_\w+_m\d+_k\d+_n\d+", chain[-1])
            threads.setdefault(chain[0], set()).add(e.thread)
    assert set(threads) == {"train.forward", "model.layer"}, threads
    assert not threads["train.forward"] & threads["model.layer"]


# ---------------------------------------------------------------- SSD scan
def _scan_operands(name, s, lengths):
    """The scan's operands at ``name``'s SSM widths (all heads, a lane for
    each of ``lengths``, or 8 where it is None: decode, every step
    commits), drawn on the card: x in the config's dtype, B and C as the
    halves of one (B, S, 2N) projection (row strides of a slice), the decay
    rate, D and the f32 conv taps as the block makes them, and a state far
    from zero."""
    from repro_torch.configs import get_config

    arch = get_config("mamba2-1.3b")
    arch = arch.reduced() if name.endswith("reduced") else arch
    b = 8 if lengths is None else len(lengths)
    nh, n, hd, w = (arch.ssm_heads, arch.ssm_state, arch.ssm_headdim,
                    arch.conv_width)
    chans = nh * hd
    dtype = getattr(torch, arch.dtype)
    gen = torch.Generator(device="cuda").manual_seed(27 + s + b)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    bc = randn(b, s, 2 * n)
    ops = dict(
        x=randn(b, s, 2 * chans).to(dtype)[..., chans:],
        bmat=bc[..., :n], cmat=bc[..., n:],
        dt=torch.nn.functional.softplus(randn(b, s, nh) - 1.0),
        rate=torch.linspace(1.0, 16.0, nh, device="cuda")[None, :],
        d_skip=torch.ones(nh, device="cuda") + 0.1 * randn(nh),
        kernel=(0.1 * randn(w, chans)).to(dtype).to(torch.float32),
        h=randn(b, nh, n, hd), win=randn(b, w - 1, chans),
        length=None if lengths is None else torch.tensor(
            lengths, dtype=torch.int64, device="cuda"))
    return arch, ops


def _loop_bound(arch, ops):
    """The loop's per-step sum of |C_t[n] H_t[n, p]| over n, (B, S, C):
    what bounds the reordering of y's N-term sum."""
    from repro_torch.models import ssm

    h, win, out = ops["h"], ops["win"], []
    s = ops["x"].shape[1]
    length = ops["length"]
    for t in range(s):
        h_new, win_new, _ = ssm._recurrence_step(
            ops["d_skip"], arch.ssm_headdim, ops["kernel"], ops["rate"], h,
            win, ops["x"][:, t], ops["bmat"][:, t], ops["cmat"][:, t],
            ops["dt"][:, t])
        out.append(torch.einsum("bn,bhnp->bhp", ops["cmat"][:, t].abs(),
                                h_new.abs()).flatten(1))
        v = (torch.ones_like(ops["dt"][:, 0, 0], dtype=torch.bool)
             if length is None else t < length)
        h = torch.where(v[:, None, None, None], h_new, h)
        win = torch.where(v[:, None, None], win_new, win)
    return torch.stack(out, dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [8, 4])
@pytest.mark.parametrize("s", [1, 8, 16, 24, 32])
@pytest.mark.parametrize("name", ["mamba2-1.3b", "mamba2-1.3b-reduced"])
def test_ssm_scan_equals_the_loop_on_the_card(name, s, lanes):
    """The scan against the per-step loop called on the same CUDA tensors,
    at full width (bf16 x, N 128, P 64) and reduced (f32, N 16, P 32), with
    lengths 0, 1, S - 3 and S mixed over the lanes (and, at S = 1 and 8
    lanes, decode's no lengths); S 24 and 32 run a second 16-step tile, a
    partial one at 24, and lengths 21 and 29 end inside it: the new state
    and conv window bitwise, and
    lanes that commit no step unchanged bitwise. y bitwise at the engine's
    8 lanes, where the scan sums over n in the order cuBLAS's gemv takes
    for the loop's einsum; at 4 lanes cuBLAS splits n otherwise, and y is
    held within the reordering of its N-term f32 sum, N 2**-24 sum_n |c_n
    h_n|, plus one ulp of y for the rounding of the skip term's add after
    it. One launch a call; no kernel of the scan is named like a GR-MAC
    kernel."""
    _need_card()
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import ssm

    cases = [[0, 1, s - 3, s, s, s - 3, 1, 0][:lanes]]
    cases += [None] if s == 1 and lanes == 8 else []
    for lengths in cases:
        arch, ops = _scan_operands(name, s, lengths)
        length = ops["length"]
        loop_len = (torch.full((lanes,), s, device="cuda")
                    if length is None else length)
        y_l, h_l, w_l = ssm._loop(
            ops["d_skip"], arch.ssm_headdim, ops["kernel"], ops["rate"],
            ops["h"], ops["win"], ops["x"], ops["bmat"], ops["cmat"],
            ops["dt"], loop_len)
        before = ssm_scan.launches
        (y_s, h_s, w_s), ran, _ = _grmac_run(lambda: ssm_scan(**ops))
        assert ssm_scan.launches == before + 1 and ran == 0
        assert torch.equal(h_s, h_l), lengths
        assert torch.equal(w_s, w_l), lengths
        for lane in range(lanes):
            if loop_len[lane] <= 0:
                assert torch.equal(h_s[lane], ops["h"][lane])
                assert torch.equal(w_s[lane], ops["win"][lane])
        assert y_s.shape == y_l.shape and y_s.dtype == torch.float32
        if lanes == 8:
            assert torch.equal(y_s, y_l), lengths
        else:
            bound = (arch.ssm_state * 2.0**-24 * _loop_bound(arch, ops)
                     + 2.0**-23 * y_l.abs())
            assert bool(torch.all((y_s - y_l).abs() <= bound)), lengths


@pytest.mark.gpu
def test_ssm_scan_kernel_is_named_apart_from_grmac():
    """The profiler sees the scan's launches as kernels whose name holds
    ``scan_kernel`` and not ``grmac`` (the GR-MAC roofline counts kernels
    by that name). Late in a long process a profile can come back without
    device records (the first ones, or all of them), so the scan runs
    several times after other work, in up to three profiles, and the
    first profile that recorded device kernels is read."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssm_scan import ssm_scan

    _, ops = _scan_operands("mamba2-1.3b", 16, [16] * 8)
    ssm_scan(**ops)
    torch.cuda.synchronize()
    names = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops["h"].sum()
            for _ in range(4):
                ssm_scan(**ops)
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation}
        if names:
            break
    scans = [k for k in names if "scan_kernel" in k]
    assert len(scans) == 1 and 1 <= names[scans[0]] <= 4, names
    assert not any("grmac" in k for k in names), names


# Whether a mamba2 engine in GR-MAC mode serves the loop's tokens through
# the scan, by (config, lanes). At 8 lanes the scan sums y over the state
# in cuBLAS's order for the loop's einsum, so y and the tokens are the
# loop's bit for bit; at other lane counts cuBLAS splits that sum
# otherwise, y is a reordered f32 sum, and one ulp of y can flip a GR-MAC
# code downstream. What the card showed (H100, CUDA 12.8):
SCAN_SERVES_THE_LOOPS_TOKENS = {
    ("mamba2-1.3b-reduced", 4): True, ("mamba2-1.3b-reduced", 8): True,
    ("mamba2-1.3b-reduced", 16): True, ("mamba2-1.3b", 4): False,
    ("mamba2-1.3b", 8): True}


@pytest.mark.gpu
@pytest.mark.parametrize("name,lanes", sorted(SCAN_SERVES_THE_LOOPS_TOKENS))
def test_ssm_engine_serves_the_loops_tokens_through_the_scan(name, lanes,
                                                             monkeypatch):
    """mamba2 in GR-MAC mode (reduced, and at full width), a prompt a lane,
    served 24 engine steps through the scan and through the per-step loop
    on the card (``applies`` false), chunks of up to 32 tokens (the scan's
    second tile): the scan ran once a layer a dispatch, the loop never, and
    the tokens are the loop's at 8 lanes; at other lane counts whether they
    are is held to what the card showed (``SCAN_SERVES_THE_LOOPS_TOKENS``),
    so a change in cuBLAS's order or the scan's shows."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan as scan
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config("mamba2-1.3b")
    arch = arch.reduced() if name.endswith("reduced") else arch
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    params = init_params(arch, seed=0)
    runs = []
    for through in ("scan", "loop"):
        if through == "loop":
            monkeypatch.setattr(scan, "applies", lambda device: False)
        eng = Engine(arch, params, ServeConfig(batch_slots=lanes, max_ctx=128,
                                               prefill_bucket_max=32))
        before = scan.ssm_scan.launches
        for n in (3, 12, 20, 40, 7, 1, 16, 33,
                  5, 9, 27, 2, 14, 38, 11, 24)[:lanes]:
            eng.add_request(list(range(1, n + 1)))
        for _ in range(24):
            eng.step()
        dispatches = (eng.stats["prefill_dispatches"]
                      + eng.stats["decode_steps"])
        launches = scan.ssm_scan.launches - before
        assert launches == (arch.n_layers * dispatches
                            if through == "scan" else 0)
        runs.append([list(t) for t in eng.tokens])
        del eng
    pairs = [(a, b) for x, y in zip(*runs) for a, b in zip(x, y)]
    same = sum(a == b for a, b in pairs)
    assert (runs[0] == runs[1]) == SCAN_SERVES_THE_LOOPS_TOKENS[
        (name, lanes)], (name, lanes, f"{same} of {len(pairs)} tokens equal")
