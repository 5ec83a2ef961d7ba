"""Tests of the port that need the CUDA card: the hand-written GR-MAC kernel
(each of its designs, and its row-chunked launch past 2**31 elements)
against its plain version, prepared weights against the per-call path,
the engine's streams through the kernel against the plain version's on
the card (every block kind, MoE FFNs), and the cached paths on the card
against the CPU (weights drawn on the CPU and moved: the two devices'
generators draw different streams), and the energy model with a card
present (the paper's ADC claims on a CUDA generator, the ledger's ``meta``
trace, the engine's pJ/token, ``grmac_matmul`` refusing ``meta``).

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. This file imports no JAX, so it also runs on the
machine with the card, which has none: ``python -m pytest -m gpu
tests/test_torch_gpu.py`` there.

Tolerances: bitwise at FP6_E3M2 x FP4_E2M1 (every partial sum is exact in
f32 in any order); rtol = atol = 1e-5 for wider formats, whose sums round
in the kernel's order, not the plain version's.
"""
import pytest

torch = pytest.importorskip("torch")

DESIGNS = ["decode", "prefill"]
GRANULARITIES = ["row", "conv", "unit"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.device import require_full_f32

    require_full_f32()


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
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config("paper-cim-120m").reduced()
    params = init_params(arch, seed=0)
    streams = []
    for backend in (None, "ref"):
        eng = Engine(arch, params, ServeConfig(batch_slots=4, max_ctx=64,
                                               cim_backend=backend))
        before = grmac_matmul_cuda.launches
        for n in (5, 12, 33):
            eng.add_request(list(range(1, n + 1)))
        for _ in range(6):
            eng.step()
        launches = grmac_matmul_cuda.launches - before
        dispatches = (eng.stats["prefill_dispatches"]
                      + eng.stats["decode_steps"])
        per_forward = 7 * arch.n_layers + 1
        assert launches == (per_forward * dispatches if backend is None else 0)
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
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    arch = get_config(name).reduced()
    arch = arch.replace(cim=arch.cim.with_mode("grmac"))
    params = init_params(arch, seed=0)
    streams = []
    for backend in (None, "ref"):
        eng = Engine(arch, params, ServeConfig(batch_slots=4, max_ctx=128,
                                               cim_backend=backend))
        before = grmac_matmul_cuda.launches
        for n in (5, 12, 70):
            eng.add_request(list(range(1, n + 1)))
        for _ in range(6):
            eng.step()
        launches = grmac_matmul_cuda.launches - before
        dispatches = (eng.stats["prefill_dispatches"]
                      + eng.stats["decode_steps"])
        assert launches == (_per_forward(arch) * dispatches
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
