"""The SPMD program of the port's serving paths: ``prefill_step``,
``decode_step`` and the no-cache ``forward`` under a 2 x 4 ("data",
"model") mesh of gloo ranks (8 processes spawned by
``torch.multiprocessing``, each joining a ``file://`` store under the
test's tmp dir and destroying its group before it returns), against the
same calls without a mesh.

Sharded: the parameters DTensors placed by ``param_specs``; the cache a
tree of DTensors placed by ``launch.specs.cache_spec_tree`` (8 rows over
"data"; a global KV's 128-slot context, SSM heads, RG-LRU width and conv
channels over "model"; the 64-slot local rings by rows only). A prefill
chunk of 16 tokens (ragged lengths, a length-0 lane) takes plain global
tokens and returns the global logits and ids; three decode steps take
DTensor tokens placed by rows and return DTensor logits. After each call
every cache leaf, gathered, is held to the unsharded cache. Every CIM
projection is split over "model" by N (column-parallel), and each rank's
cost ledger records the no-cache forward's contracts at its rows and
its N-chunk: N / 4 wherever N divides the 4-wide "model" axis.

* ``paper-cim-120m.reduced()`` in GR-MAC mode with the KV placed by rows
  only: bitwise (each output column sees its whole K, the weight's and
  x's absmax over every rank). With the KV's context split over "model",
  decode attends the chunks and merges their softmax partials by two
  all-reduces, an f32 sum in another order, as the reference's sharded
  program reorders the same sums: the prefill stays bitwise, and decode
  is held as the other archs are, within rtol 2e-4 with the CIM path off
  (in GR-MAC mode a last-ulp difference may flip an input code).
* The reduced qwen2 / mamba2 / recurrentgemma / grok with the CIM path
  off: within rtol 2e-4 of each tensor's largest entry (the reference's
  sharded-vs-unsharded rtol, ``tests/test_dryrun.py``). grok's MoE
  dispatches per data shard under a mesh, as the reference's does, so
  sharded and unsharded agree only while no expert overflows a group's
  capacity; grok runs at capacity factor 8, where none does.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

RTOL = 2e-4
B, S, CTX, STEPS = 8, 16, 128, 3
CASES = {"paper-cim-120m": {}, "qwen2-1.5b": {}, "mamba2-1.3b": {},
         "recurrentgemma-9b": {}, "grok-1-314b": {"capacity_factor": 8.0}}
# (label, config, CIM mode, the KV placed by rows only): paper-cim-120m in
# GR-MAC mode by rows, then with its context split over "model" in GR-MAC
# mode and with the CIM path off; the other archs with the CIM path off
RUNS = [(name, name, "grmac" if name == "paper-cim-120m" else "off",
         name == "paper-cim-120m") for name in CASES] + [
    ("paper-cim-120m/kv_split", "paper-cim-120m", "grmac", False),
    ("paper-cim-120m/kv_split_off", "paper-cim-120m", "off", False)]
PREFILL_KEYS = ("forward", "prefill_logits", "prefill_cache")
DECODE_KEYS = ("decode_logits", "decode_cache")


def _entry(rank, world, store, out_path, fn, args):
    import torch.distributed as d
    d.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                         world_size=world)
    try:
        res = fn(rank, world, *args)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        d.destroy_process_group()


def spawn(tmp, fn, world, *args) -> dict:
    import torch.multiprocessing as mp

    name = fn.__name__
    mp.spawn(_entry, args=(world, str(tmp / f"{name}.store"),
                           str(tmp / f"{name}.json"), fn, args),
             nprocs=world, join=True)
    with open(tmp / f"{name}.json") as f:
        return json.load(f)


def _diff(a, b) -> dict:
    a, b = a.to(torch.float32), b.to(torch.float32)
    scale = float(a.abs().max()) or 1.0
    return {"bitwise": bool(torch.equal(a, b)),
            "rel": float((a - b).abs().max()) / scale}


def _worst(diffs: list) -> dict:
    return {"bitwise": all(d["bitwise"] for d in diffs),
            "rel": max(d["rel"] for d in diffs)}


def _ledger_in_chunks(l0, l1, data: int, model: int) -> bool:
    """Whether ledger ``l1`` (one rank's) holds ``l0``'s contracts at
    1/``data`` of the rows and, for every CIM projection whose N divides
    ``model``, N / ``model`` (the MoE experts record their logical
    contract, whose N no rank splits)."""
    import dataclasses

    want = {}
    for e, c in l0.entries():
        n = e.n // model if e.n % model == 0 and e.site != "moe_expert" \
            else e.n
        key = dataclasses.replace(e, m=e.m // data, n=n)
        want[key] = want.get(key, 0) + c
    return dict(l1.entries()) == want


def _serve_worker(rank, world):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.configs import get_config
    from repro_torch.core import costs
    from repro_torch.launch import specs
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, prefill_step)
    from repro_torch.parallel import sharding
    from repro_torch.tree import tree_map, tree_map_with_path, tree_paths
    from repro_torch.training.fault import reshard_tree

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))
    lengths = torch.tensor([16, 9, 16, 3, 12, 0, 7, 16])
    out = {}
    for label, name, mode, rows_only in RUNS:
        rng = np.random.default_rng(0)
        arch = get_config(name).reduced().replace(**CASES[name])
        arch = arch.replace(cim=arch.cim.with_mode(mode))
        params = init_params(arch, 0, device="cpu")
        toks = torch.tensor(rng.integers(0, arch.vocab_size, (B, S)),
                            dtype=torch.int64)
        steps = [torch.tensor(rng.integers(0, arch.vocab_size, (B, 1)),
                              dtype=torch.int64) for _ in range(STEPS)]
        case = specs.ShapeCase("serve", CTX, B, "decode")

        def cache_diff(c0, c1):
            return _worst([_diff(a, b.full_tensor()) for (_, a), (_, b)
                           in zip(tree_paths(c0), tree_paths(c1))])

        with torch.no_grad():
            c0 = init_cache(arch, B, CTX, torch.float32, "cpu")
            cache = init_cache(arch, B, CTX, torch.float32, "cpu")
            c_specs = specs.cache_spec_tree(arch, case, mesh, cache)
            if rows_only:
                c_specs = tree_map_with_path(
                    lambda path, s: (s[0],) + (None,) * (len(s) - 1)
                    if path.endswith(("/k", "/v")) else s, c_specs)
            c1 = tree_map(lambda t, s: distribute_tensor(
                t, mesh, sharding.placements(
                    tuple(s) + (None,) * (t.dim() - len(s)), mesh)),
                cache, c_specs)
            placed = reshard_tree(params, mesh,
                                  sharding.param_specs(params, mesh))
            n_split = sum(any(a == "model" or (isinstance(a, tuple)
                                               and "model" in a) for a in s)
                          for _, s in tree_paths(c_specs))
            l0, l1 = costs.CostLedger(), costs.CostLedger()
            with costs.recording(l0):
                f0 = forward(params, toks, arch)[0]
            p0, i0, c0 = prefill_step(params, toks, arch, c0, 0, lengths)
            with sharding.use_mesh(mesh):
                with costs.recording(l1):
                    f1 = forward(placed, toks, arch)[0]
                p1, i1, c1 = prefill_step(placed, toks, arch, c1, 0, lengths)
            chunks = torch.tensor([int(_ledger_in_chunks(l0, l1, 2, 4))])
            dist.all_reduce(chunks, op=dist.ReduceOp.MIN)
            res = {"forward": _diff(f0, f1), "prefill_logits": _diff(p0, p1),
                   "prefill_ids_equal": bool(torch.equal(i0, i1)),
                   "prefill_cache": cache_diff(c0, c1),
                   "plain_out": not isinstance(p1, DTensor),
                   "cache_leaves_split_over_model": n_split,
                   "ledger_in_chunks_every_rank": bool(chunks.item()),
                   "ledger_entries": len(l0)}
            dec, dcache = [], []
            for t, tok in enumerate(steps):
                idx = lengths + t
                d0, c0 = decode_step(params, tok, arch, c0, idx)
                tok_d = distribute_tensor(tok, mesh, [Shard(0), Replicate()])
                with sharding.use_mesh(mesh):
                    d1, c1 = decode_step(placed, tok_d, arch, c1, idx)
                res["dtensor_out"] = isinstance(d1, DTensor) and tuple(
                    d1.placements) == (Shard(0), Replicate())
                dec.append(_diff(d0, d1.full_tensor()))
                dcache.append(cache_diff(c0, c1))
            res["decode_logits"] = _worst(dec)
            res["decode_cache"] = _worst(dcache)
        out[label] = res
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_serve"), _serve_worker, 8)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_equals_unsharded(served, name):
    r = served[name]
    assert r["plain_out"] and r["dtensor_out"]
    # paper-cim-120m's KV by rows only (its layers are all global)
    assert (r["cache_leaves_split_over_model"] > 0) == (
        name != "paper-cim-120m"), r["cache_leaves_split_over_model"]
    assert r["prefill_ids_equal"]
    keys = PREFILL_KEYS + DECODE_KEYS
    if name == "paper-cim-120m":
        assert all(r[k]["bitwise"] for k in keys), r
    else:
        assert all(r[k]["rel"] <= RTOL for k in keys), r


def test_split_kv_decode_of_the_grmac_model(served):
    """paper-cim-120m with its KV's context split over "model": the
    prefill bitwise in GR-MAC mode (a chunked prefill gathers the split
    KV), decode within rtol 2e-4 with the CIM path off (the split
    softmax's merge reorders f32 sums)."""
    grmac = served["paper-cim-120m/kv_split"]
    off = served["paper-cim-120m/kv_split_off"]
    print("paper-cim-120m, KV split over model: GR-MAC decode",
          {k: grmac[k] for k in DECODE_KEYS}, "CIM off",
          {k: off[k] for k in DECODE_KEYS})
    for r in (grmac, off):
        assert r["cache_leaves_split_over_model"] > 0
        assert r["prefill_ids_equal"] and r["dtensor_out"]
    assert all(grmac[k]["bitwise"] for k in PREFILL_KEYS), grmac
    assert all(off[k]["rel"] <= RTOL for k in PREFILL_KEYS + DECODE_KEYS), off


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_records_its_column_chunk(served, name):
    """Every rank's cost ledger of the sharded no-cache forward holds the
    unsharded ledger's contracts at half the rows and, where N divides
    the 4-wide "model" axis, N / 4: every projection split by N."""
    r = served[name]
    assert r["ledger_entries"] > 0
    assert r["ledger_in_chunks_every_rank"]


def test_split_batch_refuses_a_plain_cache():
    """A batch split over data shards needs a DTensor cache: a plain one
    would keep the other shards' rows stale. One process stands for rank
    0 of a 2 x 1 mesh on the ``fake`` group."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.parallel import sharding

    arch = get_config("qwen2-1.5b").reduced()
    with fake_world(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                          mesh_dim_names=("data", "model"))
        params = init_params(arch, 0, device="meta")
        cache = init_cache(arch, 4, 16, torch.float32, "meta")
        tok = torch.empty((4, 1), dtype=torch.int64, device="meta")
        with sharding.use_mesh(mesh), pytest.raises(ValueError,
                                                    match="DTensors"):
            decode_step(params, tok, arch, cache, 0)
