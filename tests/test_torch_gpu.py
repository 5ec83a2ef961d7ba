"""Tests of the port that need the CUDA card: the hand-written GR-MAC kernel
(each of its designs) against its plain version, prepared weights against
the per-call path, and the engine's streams through the kernel against the
plain version's, on the card.

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
    cpu = forward(pack_params(init_params(arch, 0, device="cpu"), arch),
                  toks, arch)[0]
    served = pack_params(init_params(arch, 0), arch)
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
                                    prefill_step)

    arch = get_config("paper-cim-120m").reduced()
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, arch.vocab_size, (4, 16), generator=gen)
    tok = torch.randint(0, arch.vocab_size, (4, 1), generator=gen)
    idx = torch.tensor([0, 3, 0, 5])
    lens = torch.tensor([16, 7, 0, 12])
    at = torch.tensor([16, 10, 63, 64])
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(arch, seed=0, device=dev)
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
