"""The port's grouped MoE dispatch and expert parallelism
(``models.moe`` inside ``parallel.sharding``'s SPMD program) against the
JAX package's ``shard_map``.

The grouped dispatch of ``grok-1-314b.reduced()`` on a 2 x 2 gloo group
(4 ranks spawned as in ``test_torch_parallel.py``): expert parallel; and,
with 3 experts, intra-expert tensor parallel at capacity factor 0.5 so
that assignments drop; against the reference's grouped ``shard_map`` on 4
fake CPU devices, run in a subprocess (``--xla_force_host_platform_
device_count`` must be set before JAX starts): outputs and the aux loss
within ``tests/test_torch_moe.py``'s 1e-5, kept and dropped assignments
exactly. And the whole model's sharded ``train_loss`` (2 layers, DTensor
parameters placed by ``param_specs``) within ``tests/test_dryrun.py``'s
rtol 2e-4 of the reference's sharded one.
"""
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.training import fault as tfault  # noqa: E402
from test_torch_parallel import LOSS_RTOL, _mesh, spawn  # noqa: E402

MOE_ATOL = 1e-5           # tests/test_torch_moe.py's ATOL

_MOE_REF = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_config
from repro.models import layers, moe
from repro.parallel.sharding import use_mesh, batch_axes
with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
out = {}
mesh = make_mesh((2, 2), ("data", "model"))
for label, (replace, p, x) in cases.items():
    cfg = get_config("grok-1-314b").reduced().replace(**replace)
    p = jax.tree.map(jnp.asarray, p)
    x = jnp.asarray(x)
    with use_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe.moe(p, x, cfg))(p, x)
    # the grouped dispatch's kept assignments, as moe() computes them
    e, k = cfg.n_experts, cfg.top_k
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    probs = jax.nn.softmax(layers.dense(p["router"], xf, cfg.cim,
                                        "moe_router"), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(4, int(np.ceil(t / 2 * k / e * cfg.capacity_factor)))
    ba = batch_axes(mesh)
    disp = shard_map(
        lambda a, b, c: moe._dispatch_local(a, b, c, e, cap), mesh=mesh,
        in_specs=(P(ba, None), P(ba, None), P(ba)),
        out_specs=(P(None, ba, None), P(ba), P(ba)))
    _, slot, keep = jax.jit(disp)(xf, idx, jnp.ones((t,), bool))
    out[label] = dict(y=np.asarray(y), aux=float(aux), keep=np.asarray(keep),
                      slot=np.asarray(slot), cap=cap)
# the whole model's sharded loss: grok reduced, 2 layers, the same mesh
from jax.sharding import NamedSharding
from repro.models import train_loss
from repro.parallel.sharding import param_specs
with open(sys.argv[3], "rb") as f:
    tree, batch = pickle.load(f)
arch = get_config("grok-1-314b").reduced().replace(n_layers=2)
params = jax.tree.map(jnp.asarray, tree)
specs = param_specs(params, mesh)
with use_mesh(mesh):
    p_sh = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, P)))
    loss, m = jax.jit(lambda pp, bb: train_loss(pp, bb, arch))(p_sh, batch)
out["model"] = dict(loss=float(m["loss"]), aux=float(m["aux_loss"]))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""

MOE_CASES = {"ep": {}, "tp_drops": {"n_experts": 3, "capacity_factor": 0.5}}


def _moe_worker(rank, world, data_path, model_path):
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    with open(data_path, "rb") as f:
        cases = pickle.load(f)
    mesh = _mesh((2, 2))
    out = {}
    for label, (replace, p_np, x_np) in cases.items():
        cfg = torch_get_config("grok-1-314b").reduced().replace(**replace)
        p = tree_map(torch.tensor, p_np)
        x = torch.tensor(x_np)
        b = x.shape[0] // 2
        with tsh.use_mesh(mesh), tsh.spmd():
            i = tsh.data_index(mesh)
            x_l = x[i * b:(i + 1) * b]
            y_l, aux = moe.moe(p, x_l, cfg)
            xf = x_l.reshape(-1, x.shape[-1])
            _, _, idx = moe.route(p, xf, cfg)
            cap = moe.capacity(xf.shape[0], cfg)
            _, slot, keep = moe.dispatch(
                xf, idx, torch.ones(xf.shape[0], dtype=torch.bool),
                cfg.n_experts, cap)
        group = mesh.get_group("data")

        def gather(t):
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts).tolist()

        out[label] = {"y": gather(y_l), "aux": float(aux),
                      "keep": gather(keep.to(torch.int64)),
                      "slot": gather(slot), "cap": cap}
    # the whole model's sharded loss (grouped dispatch, EP, the aux means)
    from repro_torch.convert import params_from_jax
    from repro_torch.models import train_loss
    with open(model_path, "rb") as f:
        tree, batch_np = pickle.load(f)
    arch = torch_get_config("grok-1-314b").reduced().replace(n_layers=2)
    params = params_from_jax(tree, arch, "cpu")
    placed = tfault.reshard_tree(params, mesh,
                                 tsh.param_specs(params, mesh))
    with tsh.use_mesh(mesh):
        _, m = train_loss(placed, {k: torch.tensor(v)
                                   for k, v in batch_np.items()}, arch)
    out["model"] = {"loss": float(m["loss"]), "aux": float(m["aux_loss"])}
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    cases = {}
    for label, replace in MOE_CASES.items():
        jcfg = jax_get_config("grok-1-314b").reduced().replace(**replace)
        jp = jax_moe.init_moe(jax.random.PRNGKey(1), jcfg, jax.numpy.float32)
        x = np.random.default_rng(2).standard_normal(
            (4, 8, jcfg.d_model)).astype(np.float32)
        cases[label] = (replace, jax.tree.map(np.asarray, jp), x)
    path = tmp / "moe.pkl"
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    jarch = jax_get_config("grok-1-314b").reduced().replace(n_layers=2)
    pipe = JaxSyntheticLM(JaxDataConfig(global_batch=4, seq_len=32,
                                        vocab_size=jarch.vocab_size))
    model = (jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jarch)),
        {k: np.asarray(v) for k, v in pipe.batch_at(0).items()})
    model_path = tmp / "model.pkl"
    with open(model_path, "wb") as f:
        pickle.dump(model, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _MOE_REF, str(path),
                        str(tmp / "ref.pkl"), str(model_path)],
                       capture_output=True, text=True, env=env, cwd=".")
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, spawn(tmp, _moe_worker, 4, str(path), str(model_path))


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_grouped_moe_matches_reference(moe_runs, label):
    ref, got = moe_runs[0][label], moe_runs[1][label]
    assert got["cap"] == ref["cap"]
    keep = np.asarray(got["keep"]).astype(bool)
    np.testing.assert_array_equal(keep, ref["keep"])
    np.testing.assert_array_equal(np.asarray(got["slot"])[keep],
                                  ref["slot"][keep])
    if label == "tp_drops":
        assert not keep.all()
    y = np.asarray(got["y"], np.float32).reshape(ref["y"].shape)
    np.testing.assert_allclose(y, ref["y"], rtol=0, atol=MOE_ATOL)
    assert abs(got["aux"] - ref["aux"]) <= MOE_ATOL


def test_sharded_moe_model_loss_matches_reference(moe_runs):
    """grok-1-314b reduced (2 layers) sharded on 2 x 2 in both packages:
    the grouped dispatch per data shard, the experts split over "model"
    and the load-balancing means over every group."""
    ref, got = moe_runs[0]["model"], moe_runs[1]["model"]
    print("grok-1-314b reduced, 2 x 2: port", got, "reference", ref)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=LOSS_RTOL)
