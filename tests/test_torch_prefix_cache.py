"""The port's prefix cache (``serving.prefix_cache`` and the engine's
seams) against the JAX package's: the trie and LRU on synthetic snapshots,
then engine scenarios run through both packages on the same weights —
streams, adopted prefixes, the engine's and the cache's counters must be
exactly equal, and a hit's stream equal to a cold prefill's — across the
reference's four cache families (attention KV, RG-LRU with local rings,
SSM state, MoE), attention subsumption, recurrent boundaries, and the
wiring rules. Mirrors the reference's tests/test_prefix_cache.py on the
same reduced configs (CIM off, as there), plus the paper's config in
GR-MAC mode, where a hit stays bitwise equal to a cold prefill when one
request is served at a time.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.prefix_cache import (PrefixCache,  # noqa: E402
                                              restore_slot, snapshot_slot)

FAMILIES = [
    ("attn", "qwen2-1.5b"),
    ("rglru", "recurrentgemma-9b"),
    ("ssm", "mamba2-1.3b"),
    ("moe", "grok-1-314b"),
]

_PARAMS = {}


def _setup(name):
    if name not in _PARAMS:
        jarch = jax_get_config(name).reduced()
        tarch = torch_get_config(name).reduced()
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tarch, "cpu")
        _PARAMS[name] = (jarch, tarch, jp, tp)
    return _PARAMS[name]


def _engine(pkg, name="qwen2-1.5b", slots=2, ctx=64, **cfg_kw):
    jarch, tarch, jp, tp = _setup(name)
    cfg = dict(batch_slots=slots, max_ctx=ctx, **cfg_kw)
    if pkg == "jax":
        return jeng.Engine(jarch, jp, jeng.ServeConfig(**cfg))
    return teng.Engine(tarch, tp, teng.ServeConfig(**cfg), device="cpu")


def _serve(eng, prompt, n_new, chunk=8):
    """Chunked prefill (a boundary per cache chunk, as the budgeted
    scheduler drives it) and greedy decode of one request; returns (its
    stream, tokens adopted from the cache)."""
    slot = eng.begin_request(prompt)
    adopted = eng.adopted_prefix(slot)
    while eng.prefill_remaining(slot):
        eng.advance_prefill(slot, max_tokens=chunk)
    eng.finish_prefill(slot)
    for _ in range(n_new - 1):
        eng.step()
    out = eng.tokens[slot][len(prompt):len(prompt) + n_new]
    eng.release_slot(slot)
    return out, adopted


def _counters(eng):
    pc = eng.prefix_cache
    return (dict(eng.stats), None if pc is None else dict(pc.stats),
            None if pc is None else len(pc))


# ------------------------------------------------------------ unit: trie
def _fake_snap(nbytes, kind="ssm"):
    """A one-layer snapshot of ``nbytes`` bytes; a non-attn kind turns
    sliced lookups off, so LRU tests see exact-boundary hits only."""
    return {"kinds": (kind,),
            "layers": [{"h": torch.zeros(nbytes, dtype=torch.uint8)}]}


def test_insert_requires_chunk_multiple():
    pc = PrefixCache(1 << 20, chunk_tokens=4)
    with pytest.raises(ValueError, match="multiple"):
        pc.insert([1, 2, 3, 4, 5, 6], lambda: _fake_snap(16))
    with pytest.raises(ValueError, match="multiple"):
        pc.insert([], lambda: _fake_snap(16))


def test_lookup_leaves_at_least_one_suffix_token():
    pc = PrefixCache(1 << 20, chunk_tokens=4)
    pc.insert([1, 2, 3, 4], lambda: _fake_snap(16))
    assert pc.lookup([1, 2, 3, 4]) is None
    hit = pc.lookup([1, 2, 3, 4, 9])
    assert hit is not None and hit[0] == 4
    assert pc.lookup([1, 2, 3]) is None
    assert pc.stats == {"hits": 1, "misses": 2, "inserts": 1,
                        "evictions": 0, "hit_tokens": 4, "bytes": 16}


def test_partial_chunk_prefix_matches_only_whole_chunks():
    pc = PrefixCache(1 << 20, chunk_tokens=4)
    pc.insert([1, 2, 3, 4], lambda: _fake_snap(16))
    pc.insert([1, 2, 3, 4, 5, 6, 7, 8], lambda: _fake_snap(32))
    hit = pc.lookup([1, 2, 3, 4, 5, 6, 99, 98, 97])
    assert hit is not None and hit[0] == 4
    hit = pc.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9])
    assert hit is not None and hit[0] == 8


def test_insert_dedupes_without_building_snapshot():
    pc = PrefixCache(1 << 20, chunk_tokens=4)
    assert pc.insert([1, 2, 3, 4], lambda: _fake_snap(16)) is True

    def boom():
        raise AssertionError("snapshot rebuilt for a cached boundary")

    assert pc.insert([1, 2, 3, 4], boom) is False
    assert pc.stats["inserts"] == 1 and pc.bytes == 16


def test_lru_eviction_under_byte_budget():
    pc = PrefixCache(256, chunk_tokens=4)
    a, b, c = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    pc.insert(a, lambda: _fake_snap(128))
    pc.insert(b, lambda: _fake_snap(128))
    assert pc.bytes == 256 and len(pc) == 2
    assert pc.lookup(a + [0]) is not None        # A is now the MRU
    pc.insert(c, lambda: _fake_snap(128))        # over budget: evict B
    assert pc.stats["evictions"] == 1
    assert pc.bytes == 256 and len(pc) == 2
    assert pc.lookup(b + [0]) is None
    assert pc.lookup(a + [0]) is not None
    assert pc.lookup(c + [0]) is not None
    assert tuple(b) not in pc._root.children


def test_oversize_snapshot_refused_and_path_pruned():
    pc = PrefixCache(64, chunk_tokens=4)
    assert pc.insert([1, 2, 3, 4], lambda: _fake_snap(128)) is False
    assert pc.stats["inserts"] == 0 and pc.bytes == 0 and len(pc) == 0
    assert not pc._root.children


# --------------------------------------------- engine: both packages
@pytest.mark.parametrize("family,name", FAMILIES)
def test_prefix_hit_stream_equals_cold_and_jax(family, name):
    """Two prompts sharing a 16-token prefix: the second adopts the cached
    boundary and prefills only its suffix; its stream equals a cold
    engine's, and the streams, adoptions and counters equal JAX's."""
    shared = list(range(1, 17))
    p1 = shared + [21, 22, 23, 24, 25]
    p2 = shared + [31, 32, 33]
    n_new = 4
    runs = {}
    for pkg in ("jax", "torch"):
        cold = _engine(pkg, name)
        refs = [_serve(cold, p, n_new)[0] for p in (p1, p2)]
        warm = _engine(pkg, name, prefix_cache_bytes=1 << 24)
        outs = [_serve(warm, p, n_new) for p in (p1, p2)]
        runs[pkg] = (refs, outs, _counters(warm), _counters(cold))
    refs, outs, warm_c, cold_c = runs["torch"]
    assert runs["torch"] == runs["jax"]
    assert [o for o, _ in outs] == refs, f"{family}: hit differs from cold"
    assert [a for _, a in outs] == [0, 16]
    stats, pc, _ = warm_c
    assert pc["hits"] == 1 and pc["misses"] == 1 and pc["hit_tokens"] == 16
    assert stats["prefill_tokens"] == len(p1) + len(p2) - 16
    assert stats["prefix_hit_tokens"] == 16
    assert cold_c[0]["prefill_tokens"] == len(p1) + len(p2)


def test_grmac_hit_stream_equals_cold_and_jax():
    """paper-cim-120m (GR-MAC row, FP6_E3M2 x FP4_E2M1) on 8 slots, one
    request at a time in the same slot: the hit's activations equal the
    cold prefill's, so the streams stay equal through the kernel's
    pre-scale, in both packages."""
    shared = list(range(1, 17))
    prompts = (shared + [21, 22, 23, 24, 25], shared + [31, 32, 33])
    runs = {}
    for pkg in ("jax", "torch"):
        cold = _engine(pkg, "paper-cim-120m", slots=8)
        refs = [_serve(cold, p, 6)[0] for p in prompts]
        warm = _engine(pkg, "paper-cim-120m", slots=8,
                       prefix_cache_bytes=1 << 24)
        runs[pkg] = (refs, [_serve(warm, p, 6) for p in prompts],
                     _counters(warm))
    assert runs["torch"] == runs["jax"]
    refs, outs, _ = runs["torch"]
    assert [o for o, _ in outs] == refs and outs[1][1] == 16


def test_attn_subsumption_slices_longer_snapshot():
    """One stored 24-token snapshot (the only boundary a blocking
    ``add_request`` lands) serves a prompt sharing 16 tokens by slicing
    its K/V rows; the sliced hit's stream equals a cold run's and JAX's."""
    prefix24 = list(range(40, 64))
    p2 = prefix24[:16] + [7, 8, 9]
    runs = {}
    for pkg in ("jax", "torch"):
        ref, _ = _serve(_engine(pkg), p2, 4)
        warm = _engine(pkg, prefix_cache_bytes=1 << 24)
        warm.release_slot(warm.add_request(prefix24))
        inserts = warm.prefix_cache.stats["inserts"]
        runs[pkg] = (ref, inserts, _serve(warm, p2, 4), _counters(warm))
    assert runs["torch"] == runs["jax"]
    ref, inserts, (out, adopted), (_, pc, _) = runs["torch"]
    assert inserts == 1 and adopted == 16 and out == ref
    assert pc["hit_tokens"] == 16


def test_recurrent_hits_only_stored_boundaries():
    prefix24 = list(range(40, 64))
    runs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, "recurrentgemma-9b", prefix_cache_bytes=1 << 24)
        eng.release_slot(eng.add_request(prefix24))
        a16 = _serve(eng, prefix24[:16] + [7, 8, 9], 2)
        a24 = _serve(eng, prefix24 + [7, 8, 9], 2)
        runs[pkg] = (a16, a24, _counters(eng))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0][1] == 0 and runs["torch"][1][1] == 24


def test_chunked_prefill_stores_every_boundary():
    runs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, "mamba2-1.3b", prefix_cache_bytes=1 << 24)
        first = _serve(eng, list(range(1, 25)) + [90, 91], 2)
        inserts = eng.prefix_cache.stats["inserts"]
        runs[pkg] = (first, inserts,
                     _serve(eng, list(range(1, 9)) + [50, 51], 2),
                     _counters(eng))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][1] == 3 and runs["torch"][2][1] == 8


def test_budget_truncated_chunks_align_to_cache_boundaries():
    """A chunk that a further chunk follows ends on a cache boundary: a
    21-token prompt under chunks of at most 12 tokens dispatches 8, 8 and
    5 tokens (3 dispatches, boundaries 8 and 16 stored), as in JAX."""
    runs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, prefix_cache_bytes=1 << 24)
        slot = eng.begin_request(list(range(1, 22)))
        takes = []
        while eng.prefill_remaining(slot):
            takes.append(eng.advance_prefill(slot, max_tokens=12))
        runs[pkg] = (takes, _counters(eng))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == [8, 8, 5]


# ------------------------------------------------- engine: wiring rules
def test_prefix_cache_requires_bucketed_mode():
    with pytest.raises(ValueError, match="bucketed"):
        _engine("torch", slots=1, prefill_mode="token",
                prefix_cache_bytes=1 << 20)


def test_prefix_cache_chunk_must_match_bucket_min():
    _, tarch, _, tp = _setup("qwen2-1.5b")
    with pytest.raises(ValueError, match="bucket"):
        teng.Engine(tarch, tp, teng.ServeConfig(batch_slots=1, max_ctx=64),
                    device="cpu",
                    prefix_cache=PrefixCache(1 << 20, chunk_tokens=4))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_snapshot_is_a_copy_and_restore_writes_it_back(name):
    """A snapshot holds ``length`` K/V rows of an ``attn`` layer and whole
    rings / states otherwise, on the cache's device, each a copy: the
    live lane's later writes and its zeroing leave it unchanged, and a
    restore into another lane reproduces the captured rows."""
    eng = _engine("torch", name, prefix_cache_bytes=1 << 24)
    slot = eng.begin_request(list(range(1, 17)) + [3])
    while eng.prefill_remaining(slot):
        eng.advance_prefill(slot, max_tokens=8)
    kinds = eng.arch.blocks()
    snap = snapshot_slot(eng.cache, slot, 16, kinds)
    kept = [{k: t.clone() for k, t in layer.items()}
            for layer in snap["layers"]]
    for kind, layer, live in zip(kinds, snap["layers"], eng.cache["layers"]):
        for k, t in layer.items():
            assert t.device == live[k].device
            assert t.shape[0] == (16 if kind == "attn"
                                  else live[k].shape[1])
            assert t.untyped_storage().data_ptr() != \
                live[k].untyped_storage().data_ptr()
    eng.finish_prefill(slot)
    eng.step()
    eng._reset_slot_state(slot)
    for layer, was in zip(snap["layers"], kept):
        for k, t in layer.items():
            assert torch.equal(t, was[k])
    restore_slot(eng.cache, 1, 16, snap)
    again = snapshot_slot(eng.cache, 1, 16, kinds)
    for layer, was in zip(again["layers"], kept):
        for k, t in layer.items():
            assert torch.equal(t, was[k])
