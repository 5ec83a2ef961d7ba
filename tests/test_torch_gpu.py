"""Tests of the port that need the CUDA card: the hand-written GR-MAC kernel
against its plain version, and the engine's streams through the kernel
against the plain version's, on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. This file imports no JAX, so it also runs on the
machine with the card, which has none: ``python -m pytest -m gpu
tests/test_torch_gpu.py`` there.
"""
import pytest

torch = pytest.importorskip("torch")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.device import require_full_f32

    require_full_f32()


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", ["row", "conv", "unit"])
def test_kernel_matches_plain_version_bitwise(granularity):
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2, quantize
    from repro_torch.kernels.dispatch import grmac_matmul
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=32, enob=8.0,
              granularity=granularity)
    for m, k, n in ((8, 768, 3072), (300, 200, 70), (5, 100, 100)):
        x = torch.rand((m, k), generator=gen, device="cuda") * 2 - 1
        w = quantize(torch.rand((k, n), generator=gen, device="cuda") * 2 - 1,
                     FP4_E2M1)
        before = grmac_matmul_cuda.launches
        got = grmac_matmul(x, w, **kw)
        torch.cuda.synchronize()
        assert grmac_matmul_cuda.launches == before + 1
        want = grmac_matmul(x, w, backend="ref", **kw)
        assert got.shape == (m, n)
        assert torch.equal(got, want), (m, k, n)


@pytest.mark.gpu
def test_kernel_refuses_unsupported_n_r():
    _need_card()
    from repro_torch.core.formats import FP4_E2M1, FP6_E3M2
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    x = torch.zeros((4, 48), device="cuda")
    w = torch.zeros((48, 4), device="cuda")
    with pytest.raises(ValueError, match="n_r"):
        grmac_matmul_cuda(x, w, fmt_x=FP6_E3M2, fmt_w=FP4_E2M1, n_r=24)


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
