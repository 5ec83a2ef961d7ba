"""The port's cost ledger against the JAX package on the CPU.

The port traces its own model functions on PyTorch's ``meta`` device; the
reference traces its own under ``jax.eval_shape``. The two ledgers must
hold the same entries with the same counts (``as_dict()``), entry by
entry, for all 11 configs at full width: one decode step here, one
64-token prefill dispatch in ``test_torch_costs_prefill.py`` and the train
forward in ``test_torch_costs_train.py`` (the JAX traces take seconds
each: three files share them out over the workers). The energy smoke
record's op counts are held exactly.

Also here: the three repairs the ledger needed (the GR-MAC dispatch routes
by device type and refuses ``meta``; ``init_params`` / ``init_cache`` build
``meta`` trees; the MoE expert stacks record their logical contracts),
``cim_matmul`` on ``meta`` (records, runs nothing), per-site pricing of
``site_overrides`` and an inert hook outside ``recording``.
"""
import json
import math
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (imported beside torch, as in every port test)
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.core import costs as JC  # noqa: E402
from repro.core.cim_config import SiteDesign as JSiteDesign  # noqa: E402
from repro.core.formats import FPFormat as JFPFormat  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import costs as TC  # noqa: E402
from repro_torch.core.cim_config import CIMConfig, SiteDesign  # noqa: E402
from repro_torch.core.formats import FP4_E2M1, FP6_E3M2, FPFormat  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                init_params)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = json.loads((ROOT / "experiments" / "bench"
                    / "e2e_energy_smoke.json").read_text())
BUCKET = 64


def full_width(name):
    """Both packages' config at full width, the CIM path on (grmac at the
    config's design when it serves without it), as the energy benchmark
    records it."""
    j, t = jax_get_config(name), torch_get_config(name)
    if not t.cim.enabled:
        j = j.replace(cim=j.cim.with_mode("grmac"))
        t = t.replace(cim=t.cim.with_mode("grmac"))
    return j, t


TRACES = {"decode": lambda m, a: m.trace_decode(a),
          "prefill": lambda m, a: m.trace_prefill(a, bucket=BUCKET),
          "train": lambda m, a: m.trace_train(a)}
TOKENS = {"decode": lambda a: 1, "prefill": lambda a: BUCKET,
          "train": lambda a: TC.default_train_seq(a)}


def check_ledger(name, phase):
    """Entry-by-entry equality with the reference's ledger, and the smoke
    record's op count per token, exactly."""
    jarch, tarch = full_width(name)
    got = TRACES[phase](TC, tarch)
    assert got.as_dict() == TRACES[phase](JC, jarch).as_dict()
    ops_per_token = 2 * got.macs() / TOKENS[phase](tarch)
    assert ops_per_token == SMOKE[name]["phases"][phase]["ops_per_token"]
    return got


def conventions(name, ledger, arch):
    """The shapes the reference's accounting fixes, in a decode ledger: the
    head at ``vocab_size`` (not the padded vocabulary, tied or untied), the
    MoE router in f32 at (tokens, D, E) and the experts at t * k routed
    rows, arctic's dense residual as ``mlp``."""
    by_site = {}
    for e, c in ledger.entries():
        by_site.setdefault(e.site, []).append((e.m, e.k, e.n, c))
    assert by_site["head"] == [(1, arch.d_model, arch.vocab_size, 1)]
    if arch.is_moe:
        d, f, k, n = arch.d_model, arch.expert_d_ff, arch.top_k, \
            arch.n_layers
        assert by_site["moe_router"] == [(1, d, arch.n_experts, n)]
        assert sorted(by_site["moe_expert"]) == sorted(
            [(k, d, f, (2 if arch.gated_mlp else 1) * n), (k, f, d, n)])
    if arch.moe_dense_residual:
        assert sorted((m, k, n) for m, k, n, _ in by_site["mlp"]) == sorted(
            [(1, arch.d_model, arch.d_ff), (1, arch.d_ff, arch.d_model)])


@pytest.mark.parametrize("name", list_configs())
def test_decode_ledger_matches_jax_at_full_width(name):
    ledger = check_ledger(name, "decode")
    assert "unsited" not in ledger.sites()
    conventions(name, ledger, full_width(name)[1])


def test_conventions_cover_the_special_shapes():
    """The configs that exercise each convention of ``conventions``."""
    archs = {n: torch_get_config(n) for n in list_configs()}
    assert any(a.padded_vocab > a.vocab_size and a.tie_embeddings
               for a in archs.values())
    assert any(a.padded_vocab > a.vocab_size and not a.tie_embeddings
               for a in archs.values())
    assert archs["grok-1-314b"].is_moe
    assert archs["arctic-480b"].moe_dense_residual


# ---------------------------------------------------------------- repairs
@pytest.mark.parametrize("backend", [None, "ref"])
def test_grmac_dispatch_refuses_meta_tensors(backend):
    x = torch.empty((8, 64), device="meta")
    w = torch.empty((64, 16), device="meta")
    with pytest.raises(ValueError, match="meta tensor"):
        dispatch.grmac_matmul(x, w, fmt_x=FP6_E3M2, fmt_w=FP4_E2M1,
                              backend=backend)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["paper-cim-120m", "gemma3-1b",
                                  "recurrentgemma-9b", "mamba2-1.3b",
                                  "grok-1-314b", "musicgen-medium"])
def test_meta_trees_mirror_the_cpu_trees(name):
    """``init_params`` / ``init_cache`` on ``meta`` build the CPU trees'
    structure, shapes and dtypes with no generator; the CPU draw is the
    seeded stream it always was (drawn twice, bitwise the same)."""
    arch = torch_get_config(name).reduced()
    for meta, cpu in (
            (init_params(arch, 0, device="meta"),
             init_params(arch, 0, device="cpu")),
            (init_cache(arch, 2, 32, torch.float32, "meta"),
             init_cache(arch, 2, 32, torch.float32, "cpu"))):
        m, c = dict(_leaves(meta)), dict(_leaves(cpu))
        assert m.keys() == c.keys()
        for path, t in m.items():
            assert t.device.type == "meta", path
            assert (t.shape, t.dtype) == (c[path].shape, c[path].dtype), path
    again = dict(_leaves(init_params(arch, 0, device="cpu")))
    for path, t in _leaves(init_params(arch, 0, device="cpu")):
        assert torch.equal(t, again[path]), path


def test_moe_experts_record_their_routed_contracts():
    """A real (CPU) decode of the reduced grok records each layer's expert
    stacks at t * k rows, three per layer (gated), beside the router."""
    arch = torch_get_config("grok-1-314b").reduced()
    params = init_params(arch, 0, device="cpu")
    cache = init_cache(arch, 3, 16, torch.float32, "cpu")
    ledger = TC.CostLedger()
    with TC.recording(ledger):
        decode_step(params, torch.zeros((3, 1), dtype=torch.int64), arch,
                    cache, 0)
    t, k, d, f = 3, arch.top_k, arch.d_model, arch.expert_d_ff
    want = Counter({(t * k, d, f): 2 * arch.n_layers})
    want[(t * k, f, d)] += arch.n_layers       # one entry when d == f
    assert {(e.m, e.k, e.n): c for e, c in ledger.entries()
            if e.site == "moe_expert"} == dict(want)
    eff = arch.cim.for_site("moe_expert")
    assert all(e.mode == eff.mode for e, _ in ledger.entries()
               if e.site == "moe_expert")


def test_cim_matmul_on_meta_records_and_runs_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("ran on a meta tensor")

    monkeypatch.setattr(ops, "_cim_matmul_2d", boom)
    monkeypatch.setattr(ops, "grmac_matmul", boom)
    cfg = CIMConfig(mode="grmac")
    x = torch.empty((2, 3, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 40), device="meta")
    ledger = TC.CostLedger()
    with TC.recording(ledger):
        out = ops.cim_matmul(x, w, cfg, site="head", logical_n=33)
        dig = ops.cim_matmul(x, w, None)
    assert out.device.type == "meta" and out.shape == (2, 3, 40)
    assert out.dtype == torch.bfloat16 and dig.shape == (2, 3, 40)
    assert [(e.site, e.m, e.k, e.n, e.mode, c) for e, c in
            ledger.entries()] == [("head", 6, 64, 33, "grmac", 1),
                                  ("unsited", 6, 64, 40, "off", 1)]


# ------------------------------------------------------- pricing, overrides
def _tiny(pkg_get_config):
    arch = pkg_get_config("paper-cim-120m").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256, vocab_size=512)
    return arch.replace(cim=arch.cim.with_mode("grmac"))


def _overridden(arch, sd, fmt):
    """head digital, mlp at unit granularity, attn_qkv on FP8_E2M5."""
    return arch.replace(cim=arch.cim.override_site("head", "off")
                        .override_site("mlp", sd(granularity="unit"))
                        .override_site("attn_qkv", sd(fmt_x=fmt(2, 5))))


def test_site_overrides_priced_per_site():
    jarch = _overridden(_tiny(jax_get_config), JSiteDesign, JFPFormat)
    tarch = _overridden(_tiny(torch_get_config), SiteDesign, FPFormat)
    tled = TC.trace_decode(tarch)
    assert tled.as_dict() == JC.trace_decode(jarch).as_dict()
    nc = 1 << 7
    got = TC.price_ledger(tled, 1, n_cols=nc, device="cpu")
    want = JC.price_ledger(JC.trace_decode(jarch), 1, n_cols=nc)
    for key in ("ops_per_token", "analog_ops_per_token", "macs_per_token"):
        assert got[key] == want[key], key
    assert got["sites"]["head"]["mode"] == "off"
    assert got["sites"]["head"]["pj_per_token"] == 0.0
    fj = {}
    for site in ("attn_qkv", "attn_o", "mlp"):
        s, js = got["sites"][site], want["sites"][site]
        eff = tarch.cim.for_site(site)
        pt = TC.design_energy_fj(eff.granularity, eff.fmt_x, eff.fmt_w,
                                 eff.n_r, n_cols=nc, device="cpu")
        assert s["fj_per_op"] == pt["fj_per_op"] and s["design"] == \
            js["design"]
        assert s["ops_per_token"] == js["ops_per_token"]
        fj[site] = s["fj_per_op"]
        # within twice the reference's own spread of this design's fJ/Op
        jeff = jarch.cim.for_site(site)
        spread = np.ptp([JC.design_energy_fj(
            jeff.granularity, jeff.fmt_x, jeff.fmt_w, jeff.n_r, n_cols=nc,
            seed=seed)["fj_per_op"] for seed in range(8)])
        assert abs(s["fj_per_op"] - js["fj_per_op"]) <= 2 * spread, site
    assert len(set(fj.values())) == 3      # three designs, three prices
    assert math.isclose(got["pj_per_token"], sum(
        s["pj_per_token"] for s in got["sites"].values()), rel_tol=1e-12)


def test_recording_is_inert_outside_its_context():
    arch = _tiny(torch_get_config)
    params = init_params(arch, 0, device="cpu")
    toks = torch.ones((1, 4), dtype=torch.int64)
    forward(params, toks, arch)                 # no context active
    ledger = TC.CostLedger()
    with TC.recording(ledger):
        forward(init_params(arch, 0, device="meta"), toks.to("meta"), arch)
    n = len(ledger)
    assert n > 0 and ledger.macs() == TC.trace_train(arch, seq_len=4).macs()
    forward(params, toks, arch)                 # after the context closed
    assert len(ledger) == n and not TC._ACTIVE


def test_prefill_and_train_per_token_consistent():
    arch = torch_get_config("qwen2-1.5b")
    per_tok = TC.trace_decode(arch).macs()
    assert TC.trace_prefill(arch, bucket=32).macs() == 32 * per_tok
    assert TC.trace_train(arch, seq_len=64).macs() == 64 * per_tok
    assert TC.trace_decode(arch, batch=4).macs() == 4 * per_tok
