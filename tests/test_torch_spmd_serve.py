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
every cache leaf, gathered, is held to the unsharded cache.

* ``paper-cim-120m.reduced()`` in GR-MAC mode: bitwise (each projection
  sees the whole weight and the absmax over every rank).
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


def _serve_worker(rank, world):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, prefill_step)
    from repro_torch.parallel import sharding
    from repro_torch.tree import tree_map, tree_paths
    from repro_torch.training.fault import reshard_tree

    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)
    lengths = torch.tensor([16, 9, 16, 3, 12, 0, 7, 16])
    out = {}
    for name, replace in CASES.items():
        arch = get_config(name).reduced().replace(**replace)
        if name != "paper-cim-120m":
            arch = arch.replace(cim=arch.cim.with_mode("off"))
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
            c1 = tree_map(lambda t, s: distribute_tensor(
                t, mesh, sharding.placements(
                    tuple(s) + (None,) * (t.dim() - len(s)), mesh)),
                cache, c_specs)
            placed = reshard_tree(params, mesh,
                                  sharding.param_specs(params, mesh))
            n_split = sum(any(a == "model" or (isinstance(a, tuple)
                                               and "model" in a) for a in s)
                          for _, s in tree_paths(c_specs))
            f0 = forward(params, toks, arch)[0]
            l0, i0, c0 = prefill_step(params, toks, arch, c0, 0, lengths)
            with sharding.use_mesh(mesh):
                f1 = forward(placed, toks, arch)[0]
                l1, i1, c1 = prefill_step(placed, toks, arch, c1, 0, lengths)
            res = {"forward": _diff(f0, f1), "prefill_logits": _diff(l0, l1),
                   "prefill_ids_equal": bool(torch.equal(i0, i1)),
                   "prefill_cache": cache_diff(c0, c1),
                   "plain_out": not isinstance(l1, DTensor),
                   "cache_leaves_split_over_model": n_split}
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
        out[name] = res
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_serve"), _serve_worker, 8)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_equals_unsharded(served, name):
    r = served[name]
    assert r["plain_out"] and r["dtensor_out"]
    assert r["cache_leaves_split_over_model"] > 0
    assert r["prefill_ids_equal"]
    keys = ("forward", "prefill_logits", "prefill_cache", "decode_logits",
            "decode_cache")
    if name == "paper-cim-120m":
        assert all(r[k]["bitwise"] for k in keys), r
    else:
        assert all(r[k]["rel"] <= RTOL for k in keys), r


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
