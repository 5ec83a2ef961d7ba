"""The port's dry-run specs (``repro_torch.launch.specs``) and roofline
arithmetic against the JAX package's ``repro.launch.specs`` /
``repro.launch.roofline``.

* ``SHAPES`` and ``cell_is_runnable`` equal the reference's, for every
  config and shape.
* ``model_flops_estimate`` and ``_active_params`` are exactly equal
  (tolerance 0) for all 11 configs x 4 shapes.
* ``cache_spec_tree`` equals the reference's spec for every leaf of every
  config x shape on the (16, 16), (2, 16, 16) and model-parallel-8 (32, 8)
  meshes: the port's cache on ``meta`` and its mesh on torch's ``fake``
  process group (512 ranks, no data moved), the reference's over
  ``jax.eval_shape``'s cache on an ``AbstractMesh``. The reference stacks
  a super-block's layers along a leading axis, which its policy leaves
  unsharded: that leading None is dropped before comparing, and the port's
  ``layers/i`` maps to the reference's ``superblocks/b{j}_{kind}`` or
  ``tail/t{j}_{kind}`` as ``test_torch_parallel.py`` maps ``param_specs``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.models import init_cache as torch_init_cache  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

MESHES = {"16x16": (False, 16), "2x16x16": (True, 16), "32x8": (False, 8)}


def test_shapes_and_runnable_match_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in tspecs.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in jspecs.SHAPES.items()}
    for name in list_configs():
        for shape in jspecs.SHAPES:
            assert tspecs.cell_is_runnable(torch_get_config(name), shape) \
                == jspecs.cell_is_runnable(jax_get_config(name), shape)


@pytest.mark.parametrize("name", list_configs())
def test_model_flops_estimate_matches_reference(name):
    """Exactly equal (tolerance 0), each shape."""
    tc, jc = torch_get_config(name), jax_get_config(name)
    assert troof._active_params(tc) == jroof._active_params(jc)
    for shape in jspecs.SHAPES:
        assert troof.model_flops_estimate(tc, tspecs.SHAPES[shape]) == \
            jroof.model_flops_estimate(jc, jspecs.SHAPES[shape])


def _norm(spec, ndim):
    """A spec padded to ``ndim``, a one-axis tuple as its axis (JAX's
    ``PartitionSpec`` writes ("data",) as "data")."""
    spec = tuple((a[0] if len(a) == 1 else tuple(a))
                 if isinstance(a, (tuple, list)) else a for a in spec)
    return spec + (None,) * (ndim - len(spec))


def _reference_path(arch, i: int) -> tuple:
    period = arch.pattern_period()
    n_super = arch.n_layers // period
    kind = arch.block_pattern[i % period]
    if i < n_super * period:
        return f"superblocks/b{i % period}_{kind}", True
    return f"tail/t{i - n_super * period}_{kind}", False


def _jax_cache_specs(name, shape, mesh_key):
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as P
    import jax.numpy as jnp

    multi_pod, mp = MESHES[mesh_key]
    dp = 256 // mp
    amesh = (AbstractMesh((2, dp, mp), ("pod", "data", "model"))
             if multi_pod else AbstractMesh((dp, mp), ("data", "model")))
    arch = jax_get_config(name)
    case = jspecs.SHAPES[shape]
    shapes = jax.eval_shape(lambda: jax_init_cache(
        arch, case.global_batch, case.seq_len, jnp.bfloat16))
    specs = jspecs.cache_spec_tree(arch, case, amesh, shapes)
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, P))[0]
    flat_v = jax.tree_util.tree_flatten_with_path(shapes)[0]

    def path(p):
        return "/".join(str(getattr(k, "key", k)) for k in p)

    ndim = {path(p): len(v.shape) for p, v in flat_v}
    return {path(p): (tuple(s), ndim[path(p)]) for p, s in flat_s}


@pytest.mark.parametrize("shape", list(jspecs.SHAPES))
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_cache_spec_tree_matches_reference(name, mesh_key, shape):
    ref = _jax_cache_specs(name, shape, mesh_key)
    tarch = torch_get_config(name)
    case = tspecs.SHAPES[shape]
    cache = torch_init_cache(tarch, case.global_batch, case.seq_len,
                             torch.bfloat16, "meta")
    multi_pod, mp = MESHES[mesh_key]
    with fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                          model_parallel=mp)
        specs = tspecs.cache_spec_tree(tarch, case, mesh, cache)
        # every spec places its leaf on this mesh (no data moved)
        tspecs.place(cache["layers"][0], specs["layers"][0], mesh)
    leaves = dict(tree_paths(cache))
    seen = set()
    for path, spec in tree_paths(specs):
        _, i, rest = path.split("/", 2)
        prefix, stacked = _reference_path(tarch, int(i))
        rpath = f"{prefix}/{rest}"
        rspec, rnd = ref[rpath]
        rspec = _norm(rspec, rnd)
        if stacked:
            assert rspec[0] is None, (rpath, rspec)
            rspec = rspec[1:]
        assert _norm(spec, leaves[path].dim()) == rspec, (path, spec, rspec)
        seen.add(rpath)
    assert seen == set(ref)
