"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on torch's ``fake`` process group (no data moved).

* The dry run's trace of a cell (``specs.make_cell`` and
  ``roofline.roofline_from_trace``, as ``run_cell`` runs them) on a 2 x 4
  mesh gives ``bytes_per_device["arguments"]`` for the reduced qwen2's
  train step (AdamW, FSDP), prefill and decode at small shapes. Each equals the reference's
  ``memory_analysis().argument_size_in_bytes`` on 8 forced host devices
  (a subprocess, as ``tests/test_dryrun.py`` runs it), to the byte, once
  the named leaves below are taken out of both: the reference stacks the
  per-layer q/k/v biases into (L, n) tensors, and its right-aligned rules
  shard that stacked layer axis over "data", where the port's (n,) bias
  of one layer is replicated over "data". Those leaves (and their AdamW
  moments) are summed on each side from its own placements.
* The same trace's flops a device are at most twice the reference's
  ``cost_analysis()`` flops of the cell lowered in its roofline mode
  (layers unrolled, attention unchunked), in the same subprocess: the
  work is split over "model" as the reference splits it (a program that
  replicated the projections over the 4-wide "model" axis would do about
  four times the reference's). The reference's ``memory_analysis`` temps
  are printed beside the port's.
* Gathering each super-block's parameters where they are used keeps the
  peak below gathering the whole tree first (qwen2-1.5b's prefill and
  decode on the 16 x 16 mesh).
* A long_500k full-attention cell is skipped with the reference's reason.
* The CLI runs one cell and writes its JSON under ``--out``.
"""
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.roofline import roofline_from_trace  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

SMALL = {"train_4k": ("train_4k", 64, 8, "train"),
         "prefill_32k": ("prefill_32k", 64, 4, "prefill"),
         "decode_32k": ("decode_32k", 128, 8, "decode")}
# leaves the reference stacks and shards along the layer axis
STACK_SHARDED = ("attn/wq/b", "attn/wk/b", "attn/wv/b")

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.compat import make_mesh
from repro.configs import get_config
from repro.launch import specs as S
from repro.parallel.sharding import use_mesh

small = json.loads(sys.argv[1])
named = tuple(json.loads(sys.argv[2]))
S.SHAPES.update({k: S.ShapeCase(*v) for k, v in small.items()})
mesh = make_mesh((2, 4), ("data", "model"))
arch = get_config("qwen2-1.5b").reduced()
unrolled = arch.replace(scan_layers=False, attn_chunk=None)


def compile_cell(arch, shape):
    with use_mesh(mesh):
        cell = S.make_cell(arch, shape, mesh)
        return cell, jax.jit(cell.fn, in_shardings=cell.in_shardings,
                             out_shardings=cell.out_shardings,
                             donate_argnums=cell.donate_argnums
                             ).lower(*cell.in_specs).compile()


out = {}
for shape in small:
    cell, compiled = compile_cell(arch, shape)
    cost = compile_cell(unrolled, shape)[1].cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    leaves = jax.tree_util.tree_flatten_with_path(cell.in_specs)[0]
    shards = jax.tree_util.tree_leaves(
        cell.in_shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
    named_bytes = 0
    for (path, v), sh in zip(leaves, shards):
        p = "/".join(str(getattr(k, "key", k)) for k in path)
        if p.endswith(named):
            named_bytes += int(np.prod(sh.shard_shape(v.shape))) \
                * v.dtype.itemsize
    mem = compiled.memory_analysis()
    out[shape] = [mem.argument_size_in_bytes, named_bytes,
                  float(cost["flops"]), mem.temp_size_in_bytes]
print(json.dumps(out))
"""


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))


def test_argument_bytes_match_reference():
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(SMALL),
                        json.dumps(STACK_SHARDED)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    arch = torch_get_config("qwen2-1.5b").reduced()
    with dryrun.fake_world(8):
        mesh = _mesh((2, 4))
        for shape, small in SMALL.items():
            case = specs.ShapeCase(*small)
            cell = specs.make_cell(arch, case, mesh)
            named = sum(t.to_local().numel() * t.element_size()
                        for p, t in tree_paths(list(cell.args))
                        if p.endswith(STACK_SHARDED))
            _, mem, cost = roofline_from_trace(
                arch.name, shape, "2x4", 8, cell.fn, cell.args, arch, case)
            got = mem["arguments"]
            want, ref_named, ref_flops, ref_temps = ref[shape]
            print(shape, "flops a device: port", cost["flops_per_device"],
                  "reference", ref_flops, "; temps: port", mem["temps"],
                  "reference", ref_temps)
            assert named > ref_named > 0, shape
            assert got - named == want - ref_named, (shape, got, want)
            assert 0 < cost["flops_per_device"] <= 2 * ref_flops, (
                shape, cost["flops_per_device"], ref_flops)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_gather_per_superblock_peak_below_whole_tree(shape):
    arch = torch_get_config("qwen2-1.5b")
    case = specs.SHAPES[shape]
    with dryrun.fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
        cell = specs.make_cell(arch, shape, mesh)

        def whole_tree(params, *rest):
            return cell.fn(sharding.gather_tree(params), *rest)

        _, per_block, _ = roofline_from_trace(
            arch.name, shape, "16x16", 256, cell.fn, cell.args, arch, case)
        cell = specs.make_cell(arch, shape, mesh)
        _, whole, _ = roofline_from_trace(
            arch.name, shape, "16x16", 256, whole_tree, cell.args, arch,
            case)
    assert per_block["arguments"] == whole["arguments"]
    # the whole tree's gather holds every parameter, full-size, at once
    params = arch.param_count() * getattr(torch, arch.dtype).itemsize
    assert whole["peak_est"] - per_block["peak_est"] > params // 2, (
        whole, per_block)


def test_long500k_full_attention_cell_skipped(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", False,
                          out_dir=str(tmp_path), verbose=False)
    _, reason = jspecs.cell_is_runnable(jax_get_config("qwen2-1.5b"),
                                        "long_500k")
    assert rec["status"] == "skipped" and rec["reason"] == reason
    assert json.loads((tmp_path / "qwen2-1.5b_long_500k_16x16.json")
                      .read_text())["status"] == "skipped"


def test_cli_writes_one_cell(tmp_path, capsys):
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert "1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    rec = json.loads((tmp_path / "gemma3-1b_decode_32k_16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and isinstance(rec["fits"], bool)
    mem = rec["bytes_per_device"]
    assert mem["peak_est"] == (mem["arguments"] + mem["outputs"]
                               + mem["temps"] - mem["aliased"])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert not dist.is_initialized()
