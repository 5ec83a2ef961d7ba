"""The port's sharding (``parallel.sharding``, ``launch.mesh``, the fault
plans and ``plan_remesh``) against the JAX package's, and its SPMD program
against the unsharded one on gloo process groups.

* ``param_specs`` equals the reference's spec for every leaf of all 11
  configs at full width on the (64, 8), (16, 16) and (2, 16, 16)
  production meshes, with and without FSDP: the port's meshes on torch's
  ``fake`` process group (512 ranks, no data moved), the reference's an
  ``AbstractMesh`` over ``jax.eval_shape``'s tree. The reference stacks a
  super-block's layers along a leading axis, which its rules leave
  unsharded: that leading None is dropped before comparing.
* ``make_fault_plan`` (seeds 0-31) and ``plan_remesh`` (a grid of chip
  counts) equal the reference's.
* On a 2 x 4 gloo group (8 processes spawned by ``torch.multiprocessing``,
  a ``file://`` store under the test's tmp dir): the sharded ``train_loss``
  of ``qwen2-1.5b.reduced()`` with 2 layers (the reference's weights,
  DTensors placed by ``param_specs``) equals the unsharded one within the
  reference's own rtol 2e-4 (``tests/test_dryrun.py``), its gradients
  within 2e-4 of each tensor's largest entry, and so do the reduced
  recurrentgemma (remat on) and mamba2, whose scans and SSD form run per
  data shard; one AdamW step on the DTensors moves the parameters as the
  unsharded step does. The sharded program splits every projection by N
  over "model" and computes the loss on the vocabulary split over
  "model" (each block's log-sum-exp gathered): ``paper-cim-120m.reduced()``
  in GR-MAC mode gives the unsharded loss bitwise (each output element
  sees its whole K and both absmaxes over every rank, and the loss's
  blocks are the unsharded loss's); ``cim_matmul`` on DTensor operands
  equals the plain call bitwise; ``shard`` and ``reshard_tree`` place
  DTensors as their specs say.

The MoE's grouped dispatch and expert parallelism are in
``test_torch_parallel_moe.py``.

Every process group a test starts is destroyed before the test ends.
"""
import json
import pickle
from contextlib import contextmanager

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.training import fault as jfault  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import init_params as torch_init_params  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.training import fault as tfault  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

LOSS_RTOL = 2e-4          # tests/test_dryrun.py's sharded-vs-unsharded rtol
MESHES = {"64x8": (False, 8), "16x16": (False, 16), "2x16x16": (True, 16)}


@contextmanager
def fake_world(n: int = 512):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ specs
_JAX_SPECS = {}


def _jax_specs(name, mesh_key, use_fsdp):
    """The reference's specs by leaf path, with each leaf's rank."""
    key = (name, mesh_key, use_fsdp)
    if key not in _JAX_SPECS:
        from jax.sharding import AbstractMesh
        from jax.sharding import PartitionSpec as P

        multi_pod, mp = MESHES[mesh_key]
        dp = 256 // mp
        amesh = (AbstractMesh((2, dp, mp), ("pod", "data", "model"))
                 if multi_pod else AbstractMesh((dp, mp), ("data", "model")))
        arch = jax_get_config(name)
        shapes = jax.eval_shape(
            lambda: jax_init_params(jax.random.PRNGKey(0), arch))
        specs = jsh.param_specs(shapes, amesh, use_fsdp=use_fsdp)
        flat_s = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, P))[0]
        flat_v = jax.tree_util.tree_flatten_with_path(shapes)[0]

        def path(p):
            return "/".join(str(getattr(k, "key", k)) for k in p)

        ndim = {path(p): len(v.shape) for p, v in flat_v}
        _JAX_SPECS[key] = {path(p): (tuple(s), ndim[path(p)])
                           for p, s in flat_s}
    return _JAX_SPECS[key]


def _norm(spec, ndim):
    """A spec padded to ``ndim``, a one-axis tuple as its axis (JAX's
    ``PartitionSpec`` writes ("data",) as "data")."""
    spec = tuple((a[0] if len(a) == 1 else tuple(a))
                 if isinstance(a, (tuple, list)) else a for a in spec)
    return spec + (None,) * (ndim - len(spec))


def _reference_path(arch, i: int) -> tuple:
    """The reference's path of the port's ``layers/i`` and whether that
    leaf is stacked."""
    period = arch.pattern_period()
    n_super = arch.n_layers // period
    kind = arch.block_pattern[i % period]
    if i < n_super * period:
        return f"superblocks/b{i % period}_{kind}", True
    return f"tail/t{i - n_super * period}_{kind}", False


@pytest.mark.parametrize("use_fsdp", [True, False], ids=["fsdp", "zero1"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_param_specs_match_reference(name, mesh_key, use_fsdp):
    ref = _jax_specs(name, mesh_key, use_fsdp)
    tarch = torch_get_config(name)
    params = torch_init_params(tarch, 0, device="meta")
    multi_pod, mp = MESHES[mesh_key]
    with fake_world():
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                          model_parallel=mp)
        specs = tsh.param_specs(params, mesh, use_fsdp=use_fsdp)
        # every spec is a placement list DTensor accepts on this mesh
        tsh.named_sharding_tree(specs, mesh)
    got = dict(tree_paths(specs))
    leaves = dict(tree_paths(params))
    seen = set()
    for path, spec in got.items():
        if path.startswith("layers/"):
            _, i, rest = path.split("/", 2)
            prefix, stacked = _reference_path(tarch, int(i))
            rpath = f"{prefix}/{rest}"
        else:
            rpath, stacked = path, False
        rspec, rnd = ref[rpath]
        rspec = _norm(rspec, rnd)
        if stacked:
            assert rspec[0] is None, (rpath, rspec)
            rspec = rspec[1:]
        assert _norm(spec, leaves[path].dim()) == rspec, (path, spec, rspec)
        seen.add(rpath)
    assert seen == set(ref)


def test_production_mesh_shapes():
    with fake_world():
        for (multi_pod, mp), want in (
                ((False, 16), ((16, 16), ("data", "model"))),
                ((True, 16), ((2, 16, 16), ("pod", "data", "model"))),
                ((False, 1), ((256, 1), ("data", "model"))),
                ((True, 8), ((2, 32, 8), ("pod", "data", "model")))):
            m = tmesh.make_production_mesh(multi_pod=multi_pod,
                                           model_parallel=mp)
            assert (tuple(m.shape), m.mesh_dim_names) == want
            assert tsh.batch_axes(m) == tuple(
                a for a in ("pod", "data") if a in want[1])
    assert tmesh.HW.HBM_BW == 3.35e12 and "H100" in tmesh.HW.CARD


# ------------------------------------------------------- plans and remesh
@pytest.mark.parametrize("seed", range(32))
def test_fault_plan_matches_reference(seed):
    for steps, n in ((12, 3), (20, 3), (40, 5)):
        ref = jfault.make_fault_plan(seed, steps, n_faults=n)
        got = tfault.make_fault_plan(seed, steps, n_faults=n)
        assert [(e.step, e.kind, e.severity) for e in got.events] == \
            [(e.step, e.kind, e.severity) for e in ref.events]


def test_plan_remesh_matches_reference():
    for n in list(range(1, 70)) + [128, 250, 255, 256, 300, 511, 512, 600,
                                   767, 768, 1024]:
        for mp in (1, 2, 4, 8, 16):
            for pod in (64, 256):
                try:
                    ref = jfault.plan_remesh(n, mp, pod)
                except RuntimeError:
                    with pytest.raises(RuntimeError):
                        tfault.plan_remesh(n, mp, pod)
                    continue
                assert tfault.plan_remesh(n, mp, pod) == ref


def test_fault_event_validation_matches_reference():
    for kw in ({"step": 0, "kind": "kill"}, {"step": 1, "kind": "meteor"},
               {"step": 1, "kind": "straggler", "severity": 0}):
        with pytest.raises(ValueError):
            jfault.FaultEvent(**kw)
        with pytest.raises(ValueError):
            tfault.FaultEvent(**kw)
    with pytest.raises(ValueError):
        tfault.FaultPlan((tfault.FaultEvent(3, "kill"),
                          tfault.FaultEvent(2, "kill")))
    with pytest.raises(ValueError):
        tfault.make_fault_plan(0, 4, n_faults=3)


# ------------------------------------------------------- gloo workers
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
    """Run ``fn(rank, world, *args)`` (a module-level function) on
    ``world`` gloo ranks spawned by ``torch.multiprocessing``, each joining
    through a ``file://`` store under ``tmp`` and leaving its group
    destroyed; rank 0's result."""
    import torch.multiprocessing as mp

    name = fn.__name__
    mp.spawn(_entry, args=(world, str(tmp / f"{name}.store"),
                           str(tmp / f"{name}.json"), fn, args),
             nprocs=world, join=True)
    with open(tmp / f"{name}.json") as f:
        return json.load(f)


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _pl(placements) -> list:
    return [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__
            for p in placements]


def _loss_worker(rank, world, data_path):
    """Unsharded and sharded train_loss (and gradients) on a 2 x 4 mesh."""
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels.ops import cim_matmul
    from repro_torch.models import train_loss
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      make_train_step)
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    mesh = _mesh((2, 4))
    out = {}
    for name, (tree, batch_np, replace) in data.items():
        arch = torch_get_config(name).reduced().replace(**replace)
        params = params_from_jax(tree, arch, "cpu")
        batch = {k: torch.tensor(v) for k, v in batch_np.items()}

        def loss_grads(p):
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
            total, m = train_loss(leaves, batch, arch)
            g = torch.autograd.grad(total, tree_leaves(leaves))
            return float(m["loss"].detach()), g

        l0, g0 = loss_grads(params)
        specs = tsh.param_specs(params, mesh)
        placed = tfault.reshard_tree(params, mesh, specs)
        n_sharded = sum(any(a is not None for a in s)
                        for _, s in tree_paths(specs))
        with tsh.use_mesh(mesh):
            l1, g1 = loss_grads(placed)
        rel = 0.0
        for a, b in zip(g0, g1):
            b = b.full_tensor()
            scale = float(a.abs().max()) or 1.0
            rel = max(rel, float((a - b).abs().max()) / scale)
        out[name] = {"unsharded": l0, "sharded": l1, "grad_rel": rel,
                     "bitwise": l0 == l1, "n_sharded_leaves": n_sharded,
                     "leaves": len(g0)}
        if name != "qwen2-1.5b":
            continue
        # one AdamW step on the DTensors (the global gradient norm reduced
        # over the shards) against the same step unsharded
        tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                               eps=1.0))
        step = make_train_step(arch, tcfg)
        p0, _, m0 = step(params, init_opt_state(params, tcfg.opt), batch)
        with tsh.use_mesh(mesh):
            p1, _, m1 = step(placed, init_opt_state(placed, tcfg.opt), batch)
        out[name]["step_param_max_abs"] = max(
            float((a - b.full_tensor()).abs().max())
            for a, b in zip(tree_leaves(p0), tree_leaves(p1)))
        out[name]["step_grad_norm"] = [float(m0["grad_norm"]),
                                       float(m1["grad_norm"].full_tensor())]

    # cim_matmul on DTensor operands: rows over "data", the weight
    # (fsdp, model)-sharded, x also split on K over "model"
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    arch = torch_get_config("paper-cim-120m").reduced()
    g = torch.Generator().manual_seed(0)
    x = torch.rand((16, 64), generator=g) * 2 - 1
    w = torch.rand((64, 96), generator=g) * 2 - 1
    want = cim_matmul(x, w, arch.cim, site="mlp")
    wd = distribute_tensor(w, mesh, [Shard(0), Shard(1)])
    checks = {}
    for label, pl in (("rows", [Shard(0), Replicate()]),
                      ("rows_and_k", [Shard(0), Shard(1)])):
        xd = distribute_tensor(x, mesh, pl)
        got = cim_matmul(xd, wd, arch.cim, site="mlp")
        checks[label] = bool(torch.equal(got.full_tensor(), want))
        checks[label + "_placements"] = _pl(got.placements)
    # shard(): a DTensor takes the spec's placements, non-dividing dropped
    xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with tsh.use_mesh(mesh):
        s1 = tsh.shard(xd, "data", "model")
        s2 = tsh.shard(distribute_tensor(torch.zeros(3, 8), mesh,
                                         [Replicate(), Replicate()]),
                       "data", "model")
        plain = tsh.shard(x, "data", "model")
    checks["shard"] = _pl(s1.placements)
    checks["shard_nondividing"] = _pl(s2.placements)
    checks["shard_plain_is_noop"] = plain is x
    checks["shard_value"] = bool(torch.equal(s1.full_tensor(), x))
    out["dtensor"] = checks
    return out


@pytest.fixture(scope="module")
def loss_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loss")
    data = {}
    for name, replace in (("qwen2-1.5b", {"n_layers": 2}),
                          ("paper-cim-120m", {}),
                          ("recurrentgemma-9b", {"remat": True}),
                          ("mamba2-1.3b", {})):
        jarch = jax_get_config(name).reduced().replace(**replace)
        jp = jax_init_params(jax.random.PRNGKey(0), jarch)
        pipe = JaxSyntheticLM(JaxDataConfig(global_batch=4, seq_len=64,
                                            vocab_size=jarch.vocab_size))
        batch = {k: np.asarray(v) for k, v in pipe.batch_at(0).items()}
        data[name] = (jax.tree.map(np.asarray, jp), batch, replace)
    path = tmp / "data.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return spawn(tmp, _loss_worker, 8, str(path))


def test_sharded_loss_matches_unsharded(loss_run):
    r = loss_run["qwen2-1.5b"]
    print("qwen2-1.5b reduced, 2 x 4 gloo: sharded", r["sharded"],
          "unsharded", r["unsharded"], "rel diff",
          abs(r["sharded"] - r["unsharded"]) / abs(r["unsharded"]),
          "grad rel", r["grad_rel"])
    assert r["n_sharded_leaves"] > 0
    np.testing.assert_allclose(r["sharded"], r["unsharded"], rtol=LOSS_RTOL)
    assert r["grad_rel"] <= LOSS_RTOL


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_sharded_recurrent_loss_matches_unsharded(loss_run, name):
    """The RG-LRU scan and the local attention (under remat: the
    recomputed forward gathers again), and the SSD form, run per data
    shard; the loss and gradients as the unsharded ones."""
    r = loss_run[name]
    print(name, "reduced, 2 x 4 gloo: sharded", r["sharded"], "unsharded",
          r["unsharded"], "grad rel", r["grad_rel"])
    np.testing.assert_allclose(r["sharded"], r["unsharded"], rtol=LOSS_RTOL)
    assert r["grad_rel"] <= LOSS_RTOL


def test_sharded_optimizer_step_matches_unsharded(loss_run):
    """One AdamW step (lr 1e-3, eps 1) on the DTensors moves every
    parameter as the unsharded step does, within the gradients' rtol
    times lr; the global gradient norm agrees within the same rtol."""
    r = loss_run["qwen2-1.5b"]
    print("one AdamW step, 2 x 4 gloo: max |param diff|",
          r["step_param_max_abs"], "grad norm", r["step_grad_norm"])
    assert r["step_param_max_abs"] <= LOSS_RTOL * 1e-3
    np.testing.assert_allclose(*r["step_grad_norm"], rtol=LOSS_RTOL)


def test_sharded_grmac_loss_is_bitwise(loss_run):
    r = loss_run["paper-cim-120m"]
    print("paper-cim-120m reduced (GR-MAC), 2 x 4 gloo: sharded",
          r["sharded"], "unsharded", r["unsharded"], "grad rel",
          r["grad_rel"])
    assert r["bitwise"], (r["sharded"], r["unsharded"])
    assert r["grad_rel"] <= LOSS_RTOL


def test_cim_matmul_on_dtensors(loss_run):
    c = loss_run["dtensor"]
    assert c["rows"] and c["rows_and_k"]
    assert c["rows_placements"] == ["Shard(0)", "Replicate"]
    assert c["rows_and_k_placements"] == ["Shard(0)", "Replicate"]


def test_shard_redistributes_dtensors_only(loss_run):
    c = loss_run["dtensor"]
    assert c["shard"] == ["Shard(0)", "Shard(1)"]
    # 3 rows over 2 data ranks do not divide: that entry is dropped
    assert c["shard_nondividing"] == ["Replicate", "Shard(1)"]
    assert c["shard_plain_is_noop"] and c["shard_value"]
