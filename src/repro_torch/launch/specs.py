"""Input specs and placements for every (architecture x input shape)
dry-run cell, as ``meta`` tensors and DTensors on them: the port's
counterpart of ``repro.launch.specs``. Nothing here allocates.

Shapes (the reference's):
    train_4k      seq 4096,   global_batch 256   -> train step
    prefill_32k   seq 32768,  global_batch 32    -> prefill (the no-cache
                                                     forward)
    decode_32k    seq 32768,  global_batch 128   -> decode_step (one new
                                                     token)
    long_500k     seq 524288, global_batch 1     -> decode_step; only for
                  sub-quadratic archs (gemma3 / mamba2 / recurrentgemma)

A spec is a tuple with one entry per dimension, in the grammar of
``parallel.sharding`` (a mesh axis name, a tuple of names, or None). A
cell's arguments are DTensors whose local tensors are rank 0's shards on
``meta``: the rank-local program of the SPMD model functions runs on them
under the ``fake`` process group and moves no data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import (batch_axes, mesh_sizes,
                                           param_specs, placements,
                                           use_mesh)
from repro_torch.tree import tree_map, tree_map_with_path

__all__ = ["SHAPES", "ShapeCase", "Cell", "cell_is_runnable", "batch_specs",
           "batch_shardings", "cache_spec_tree", "place", "make_cell"]

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch at 512k context "
                       "(see DESIGN.md §5)")
    return True, ""


def _size(mesh, ax) -> int:
    if ax is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _bspec(mesh, b: int):
    ba = batch_axes(mesh)
    return ba if b % _size(mesh, ba) == 0 else None


# ------------------------------------------------------------------ specs
def batch_specs(cfg: ArchConfig, case: ShapeCase) -> dict:
    """The global batch as ``meta`` tensors: int32 token ids (or f32
    embeddings), int32 labels and an f32 mask, the reference's dtypes."""
    b, s = case.global_batch, case.seq_len
    if cfg.input_mode == "tokens":
        inputs = torch.empty((b, s), dtype=torch.int32, device=META)
    else:
        inputs = torch.empty((b, s, cfg.d_model), dtype=torch.float32,
                             device=META)
    return {"inputs": inputs,
            "labels": torch.empty((b, s), dtype=torch.int32, device=META),
            "mask": torch.empty((b, s), dtype=torch.float32, device=META)}


def batch_shardings(cfg: ArchConfig, case: ShapeCase, mesh) -> dict:
    """Specs of ``batch_specs``: rows over the batch axes when the global
    batch divides over them, else replicated."""
    bspec = _bspec(mesh, case.global_batch)
    return {"inputs": ((bspec, None) if cfg.input_mode == "tokens"
                       else (bspec, None, None)),
            "labels": (bspec, None),
            "mask": (bspec, None)}


def cache_spec_tree(cfg: ArchConfig, case: ShapeCase, mesh, cache) -> dict:
    """A spec for every leaf of the port's cache tree (``init_cache``:
    one dict a layer), the reference's policy: batch over the data axes
    when it divides; the context dimension of a global-attention KV over
    "model" (over the batch axes and "model" together when the batch is
    not split, as for long_500k's one row); SSM heads, RG-LRU width and
    conv channels over "model"; a local-window ring batch-only. A
    dimension is split only where its size divides the axes'."""
    ba = batch_axes(mesh)

    def model_ok(d):
        return d % _size(mesh, "model") == 0

    def spec_for(path: str, leaf) -> tuple:
        dims = tuple(leaf.shape)
        bspec = _bspec(mesh, dims[0])
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            _, s, _, _ = dims
            if s != case.seq_len:          # a local ring
                return (bspec, None, None, None)
            if bspec is None:
                both = (tuple(ba) if ba else ()) + ("model",)
                sspec = both if s % _size(mesh, both) == 0 else (
                    "model" if model_ok(s) else None)
            else:
                sspec = "model" if model_ok(s) else None
            return (bspec, sspec, None, None)
        if name == "conv":
            return (bspec, None, "model" if model_ok(dims[-1]) else None)
        if name == "h" and len(dims) == 4:     # ssm state (B, NH, N, P)
            return (bspec, "model" if model_ok(dims[1]) else None,
                    None, None)
        if name == "h" and len(dims) == 2:     # rglru state (B, W)
            return (bspec, "model" if model_ok(dims[1]) else None)
        return ()

    return tree_map_with_path(spec_for, cache)


# ------------------------------------------------------------------ cells
def place(tree, specs, mesh):
    """Each ``meta`` leaf of ``tree`` as a DTensor placed by its spec
    (``()`` and all-None specs replicate); rank 0's local shard is a
    ``meta`` tensor of its size. No data moves."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return tree_map(one, tree, specs)


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) dry-run cell: the rank-local callable and
    its arguments (DTensors on ``meta``)."""

    fn: Callable
    args: tuple
    kind: str


def make_cell(cfg: ArchConfig, shape, mesh,
              cache_dtype: torch.dtype = torch.bfloat16,
              microbatches: int = 1, grad_compression: bool = False,
              algorithm: str = "adamw", layout: str = "fsdp") -> Cell:
    """The callable and ``meta`` arguments of one cell. train:
    ``make_train_step`` on params placed by ``param_specs`` (FSDP, or
    ZeRO-1 with ``layout="zero1"``) and an optimizer state always sharded
    (ZeRO-1); prefill: the no-cache forward's logits; decode:
    ``decode_step`` on a cache from ``init_cache(..., device="meta")``
    placed by ``cache_spec_tree``. ``shape`` is a ``SHAPES`` key or a
    ``ShapeCase``. Nothing is allocated."""
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params)
    from repro_torch.training.optimizer import (OptimizerConfig,
                                                init_opt_state)
    from repro_torch.training.trainer import TrainConfig, make_train_step

    case = shape if isinstance(shape, ShapeCase) else SHAPES[shape]
    params = init_params(cfg, 0, device=META)

    if case.kind == "train":
        p_specs = param_specs(params, mesh, use_fsdp=(layout == "fsdp"))
        ocfg = OptimizerConfig(grad_compression=grad_compression,
                               algorithm=algorithm)
        opt = init_opt_state(params, ocfg)
        o_specs = param_specs(opt, mesh)     # always sharded (ZeRO-1)
        step = make_train_step(cfg, TrainConfig(opt=ocfg,
                                                microbatches=microbatches))
        batch = place(batch_specs(cfg, case),
                      batch_shardings(cfg, case, mesh), mesh)

        def train_fn(params, opt_state, batch):
            with use_mesh(mesh):
                return step(params, opt_state, batch)

        return Cell(train_fn, (place(params, p_specs, mesh),
                               place(opt, o_specs, mesh), batch), "train")

    p_placed = place(params, param_specs(params, mesh), mesh)
    if case.kind == "prefill":
        inputs = batch_specs(cfg, case)["inputs"]
        spec = batch_shardings(cfg, case, mesh)["inputs"]

        def prefill_fn(params, inputs):
            with use_mesh(mesh), torch.no_grad():
                return forward(params, inputs, cfg)[0]

        return Cell(prefill_fn, (p_placed, place(inputs, spec, mesh)),
                    "prefill")

    b = case.global_batch
    cache = init_cache(cfg, b, case.seq_len, cache_dtype, META)
    c_placed = place(cache, cache_spec_tree(cfg, case, mesh, cache), mesh)
    bspec = _bspec(mesh, b)
    if cfg.input_mode == "tokens":
        tok = torch.empty((b, 1), dtype=torch.int32, device=META)
        tok_spec = (bspec, None)
    else:
        tok = torch.empty((b, 1, cfg.d_model), dtype=torch.float32,
                          device=META)
        tok_spec = (bspec, None, None)
    idx = torch.empty((), dtype=torch.int32, device=META)

    def decode_fn(params, token, cache, cache_index):
        with use_mesh(mesh), torch.no_grad():
            return decode_step(params, token, cfg, cache, cache_index)

    return Cell(decode_fn, (p_placed, place(tok, tok_spec, mesh), c_placed,
                            idx), "decode")
