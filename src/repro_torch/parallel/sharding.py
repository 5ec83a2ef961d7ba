"""Mesh-aware sharding on ``torch.distributed``: the active mesh, parameter
partition rules as DTensor placements, and the collectives of the model's
SPMD program; the port's counterpart of ``repro.parallel.sharding``.

The production mesh axes are ("pod", "data", "model") (multi-pod) or
("data", "model") (one pod), a ``DeviceMesh`` with those dimension names.
Parameters are 2D-sharded: FSDP over the ("pod", "data") axes and tensor
parallel over "model", with the reference's *best-effort* divisibility (a
dimension is sharded only where its size divides the axes' size), so one
rule set serves every architecture. A spec is a tuple with one entry per
tensor dimension: a mesh axis name, a tuple of names, or None.

The port keeps one tensor per layer where the reference stacks its
super-blocks along a leading axis, so the spec of a layer's leaf here is
the reference's spec of the stacked leaf without its leading None.

The SPMD program (``spmd``). Under ``models.train_loss``,
``prefill_step``, ``decode_step`` or the no-cache ``forward`` with a mesh
active, each rank holds its data shard of the batch (rows over the
batch axes, the same rows on every "model" rank) as plain tensors; the
parameters may be DTensors placed by ``param_specs``, and every use
gathers one to its full size (``gather_full``: an all-gather, whose
backward reduce-scatters the gradient, summed over the batch axes). The
quantities the reference computes over the whole batch are reduced
explicitly: a CIM op's pre-scale absmax (``all_reduce_max``), the loss
and the MoE load-balancing means (``all_reduce_sum``). Query positions
of the train attention (``layers._train_attention``) and the MoE's
expert buffers are split over "model" (``chunk`` / ``all_gather``, the
counterparts of the reference's ``shard_map`` specs). Every rank
backpropagates the global loss with seed 1: a replicated computation
receives its whole gradient on every rank, a split one its part.
Collectives over a group of one rank are skipped, so a 1 x 1 mesh runs
the same operations as no mesh.

``shard(x, *spec)`` is the reference's sharding constraint: a no-op
without a mesh or on a plain tensor, and a ``redistribute`` of a DTensor
otherwise. The model's activations are the plain per-rank tensors above,
whose layout the SPMD program fixes, so at the model's ``shard`` sites it
changes nothing.
"""
from __future__ import annotations

import math
import re
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "set_mesh", "get_mesh", "use_mesh", "shard", "batch_axes",
    "axis_divides", "param_specs", "named_sharding_tree", "placements",
    "mesh_sizes", "spmd", "in_spmd", "data_shards", "data_index",
    "gather_full", "gather_tree", "gather_rows", "local_rows",
    "all_reduce_max",
    "all_reduce_sum",
    "chunk", "all_gather", "copy_to_model", "model_shards", "is_dtensor",
]

_ACTIVE_MESH = None
_SPMD = threading.local()


def set_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    return _ACTIVE_MESH


@contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, kept on the mesh after the
    first call: the SPMD program asks on every CIM call, and a
    ``DeviceMesh`` computes its shape anew each time. Read it, do not
    change it."""
    sizes = getattr(mesh, "_repro_sizes", None)
    if sizes is None:
        sizes = mesh._repro_sizes = dict(zip(mesh.mesh_dim_names,
                                             tuple(mesh.shape)))
    return sizes


def batch_axes(mesh=None) -> Optional[Tuple[str, ...]]:
    """Mesh axes that shard the batch dim: ("pod", "data") when present."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return None
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return axes or None


def axis_divides(n: int, axis: str) -> bool:
    """True when ``n`` divides the active mesh's ``axis`` size (True with
    no active mesh)."""
    mesh = _ACTIVE_MESH
    if mesh is None or axis not in mesh.mesh_dim_names:
        return True
    return n % mesh_sizes(mesh)[axis] == 0


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of a spec on ``mesh``: Shard(d) on each mesh
    dimension named by the spec's entry d (a tuple entry shards d over
    its axes, the first outermost, as the reference's ``P(("pod",
    "data"))``), Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, (tuple, list))
                                  and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _resolve(shape, spec, mesh) -> tuple:
    """The reference's ``shard`` spec resolution: "data" -> the batch axes,
    "all" -> every axis, entries that do not divide dropped."""
    sizes = mesh_sizes(mesh)
    resolved = []
    for dim, ax in zip(shape, spec):
        if ax == "data":
            ax = batch_axes(mesh)
        elif ax == "all":
            ax = tuple(mesh.mesh_dim_names)
        if ax is not None and dim % _axis_size(sizes, ax) != 0:
            ax = None
        resolved.append(ax)
    return tuple(resolved)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """Best-effort sharding constraint: a no-op without an active mesh or
    on a plain tensor; a DTensor is redistributed to ``spec`` (entries
    "data", "all", "model", None; those that do not divide dropped)."""
    from torch.distributed.tensor import DTensor

    mesh = _ACTIVE_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(_resolve(x.shape, spec, mesh),
                                     x.device_mesh))


# ------------------------------------------------------------------ params
# (path regex, preferred spec per dim): "model" the TP axis, "fsdp" the
# ("pod", "data") product; dims that do not divide stay replicated.
_RULES = [
    (r"embed", ("model", "fsdp")),
    (r"lm_head", ("fsdp", "model")),
    (r"router", (None, "model")),
    # MoE experts (E, D, F): the expert dim over "model" when it divides,
    # else F over "model" (intra-expert TP), in ``_spec_for``
    (r"experts.*w[ig]$", ("model", "fsdp", None)),
    (r"experts.*wo$", ("model", None, "fsdp")),
    (r"\bwq\b|\bwk\b|\bwv\b|\bwi\b|\bwg\b", ("fsdp", "model")),
    (r"\bwo\b", ("model", "fsdp")),
    # ssm / rglru projections
    (r"in_proj|x_proj|gate", ("fsdp", "model")),
    (r"out_proj", ("model", "fsdp")),
    (r"conv", (None, None, None)),
]


def _spec_for(path: str, shape, sizes: dict, fsdp) -> tuple:
    if re.search(r"experts", path) and len(shape) >= 3:
        # EP over "model" when the expert count divides it, else
        # intra-expert TP on the hidden dim (grok's 8 experts at 16-way)
        if shape[-3] % _axis_size(sizes, "model") == 0:
            pref = (("model", "fsdp", None) if path.endswith(("wi", "wg"))
                    else ("model", None, "fsdp"))
        else:
            pref = ((None, "fsdp", "model") if path.endswith(("wi", "wg"))
                    else (None, "model", "fsdp"))
        return _align(pref, shape, sizes, fsdp)
    for pat, pref in _RULES:
        if re.search(pat, path):
            return _align(pref, shape, sizes, fsdp)
    return (None,) * len(shape)  # replicate (norms, biases, scalars)


def _align(pref, shape, sizes: dict, fsdp) -> tuple:
    """Right-align the preferences to the trailing dims; an axis is used
    once, and only where it divides the dim."""
    pad = max(0, len(shape) - len(pref))
    aligned = (None,) * pad + tuple(pref[-len(shape):] if shape else ())
    spec, used = [], set()
    for dim, ax in zip(shape, aligned):
        ax = fsdp if ax == "fsdp" else ax
        key = tuple(ax) if isinstance(ax, (tuple, list)) else ax
        if ax is None or key in used or dim % _axis_size(sizes, ax) != 0:
            spec.append(None)
        else:
            used.add(key)
            spec.append(ax)
    return tuple(spec)


def param_specs(params, mesh, use_fsdp: bool = True):
    """A spec tree for a params tree (tensors of any device, ``meta``
    included; only shapes are read), by the reference's rules on the leaf
    paths (``layers/0/attn/wq/w``).

    ``use_fsdp=False`` gives the ZeRO-1 layout: tensors keep only their
    "model" (TP) sharding and are replicated over the data axes."""
    from repro_torch.tree import tree_map_with_path

    sizes = mesh_sizes(mesh)
    fsdp = batch_axes(mesh) if use_fsdp else None
    return tree_map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), sizes, fsdp),
        params)


def named_sharding_tree(spec_tree, mesh):
    """The placements of every spec of a tree (``placements``)."""
    if isinstance(spec_tree, dict):
        return {k: named_sharding_tree(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named_sharding_tree(v, mesh) for v in spec_tree]
    return placements(spec_tree, mesh)


# ------------------------------------------------------------------- SPMD
def in_spmd() -> bool:
    """True inside ``spmd()``: the tensors are this rank's data shard."""
    return getattr(_SPMD, "on", False)


@contextmanager
def spmd():
    """Mark the block as the SPMD program's (module docstring)."""
    prev = in_spmd()
    _SPMD.on = True
    try:
        yield
    finally:
        _SPMD.on = prev


def _groups(mesh, axes) -> list:
    """The process groups of ``axes`` of size > 1 (none: nothing to do)."""
    sizes = mesh_sizes(mesh)
    return [mesh.get_group(a) for a in axes if sizes[a] > 1]


def data_shards(mesh=None) -> int:
    """How many data shards the batch axes make (1 without a mesh)."""
    mesh = mesh or _ACTIVE_MESH
    ba = batch_axes(mesh)
    return _axis_size(mesh_sizes(mesh), ba) if ba else 1


def data_index(mesh=None) -> int:
    """This rank's data shard, the batch axes' coordinates major first."""
    mesh = mesh or _ACTIVE_MESH
    idx = 0
    for a in batch_axes(mesh) or ():
        idx = idx * mesh_sizes(mesh)[a] + mesh.get_local_rank(a)
    return idx


def _model_group(mesh):
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return mesh.get_group("model") if mesh_sizes(mesh)["model"] > 1 else None


_DTENSOR = []


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (the class imported once, on first use:
    the CIM op asks on every call)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def gather_full(t):
    """A DTensor parameter as its full local tensor (all-gathered); its
    gradient comes back summed over the batch axes and placed as the
    parameter is (reduce-scattered). Plain tensors pass through. On a
    mesh of one rank the local tensor is the full one, taken as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    mesh = t.device_mesh
    if mesh.size() == 1:
        return t.to_local()
    ba = batch_axes(mesh) or ()
    full = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return full.to_local(grad_placements=[
        Partial() if a in ba else Replicate() for a in mesh.mesh_dim_names])


def gather_tree(tree):
    """``gather_full`` over a params tree."""
    from repro_torch.tree import tree_map

    return tree_map(gather_full, tree)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The max of ``t`` over every rank of the active mesh inside
    ``spmd()`` (no gradient: a pre-scale's absmax); else ``t``."""
    mesh = _ACTIVE_MESH
    if mesh is None or not in_spmd():
        return t
    groups = _groups(mesh, mesh.mesh_dim_names)
    if not groups:
        return t
    t = t.detach().clone()
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the groups; the gradient passes through (each rank's
    summand gets the whole upstream gradient, which every rank holds)."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(t: torch.Tensor, axes=None) -> torch.Tensor:
    """The sum of ``t`` over the batch axes (or ``axes``) inside
    ``spmd()``, differentiable; else ``t``."""
    mesh = _ACTIVE_MESH
    if mesh is None or not in_spmd():
        return t
    groups = _groups(mesh, axes if axes is not None
                     else (batch_axes(mesh) or ()))
    return _AllReduceSum.apply(t, groups) if groups else t


class _Chunk(torch.autograd.Function):
    """This rank's chunk of ``dim``; the gradient is all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    """The chunks of every rank concatenated along ``dim``; the gradient
    is this rank's chunk of the (replicated) upstream gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """Identity whose gradient is summed over the group: a replicated
    tensor feeding a computation split over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every data shard's rows of ``x`` concatenated along dim 0, in the
    order of ``data_index`` (the innermost batch axis gathered first); no
    gradient (the serving path's outputs)."""
    mesh = mesh or _ACTIVE_MESH
    sizes = mesh_sizes(mesh)
    for a in reversed(batch_axes(mesh) or ()):
        if sizes[a] > 1:
            x = _gather(x, 0, mesh.get_group(a))
    return x


def local_rows(t, mesh=None):
    """This rank's rows of a global batch tensor ``t`` for the SPMD
    program: a DTensor redistributed to rows over the batch axes
    (replicated over the others) and taken local, a plain tensor sliced
    by ``data_index``. Non-tensors and 0-d tensors pass through; the rows
    must divide over the batch axes."""
    if not torch.is_tensor(t) or t.dim() == 0:
        return t
    mesh = mesh or _ACTIVE_MESH
    if is_dtensor(t) and t.device_mesh.size() == 1:
        return t.to_local()
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        ba = batch_axes(mesh) or ()
        return t.redistribute(t.device_mesh, [
            Shard(0) if a in ba else Replicate()
            for a in mesh.mesh_dim_names]).to_local()
    nb = data_shards(mesh)
    if nb == 1:
        return t
    b = t.shape[0] // nb
    i = data_index(mesh)
    return t[i * b:(i + 1) * b]


def chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This "model" rank's chunk of ``dim`` inside ``spmd()`` (else x)."""
    g = _model_group(_ACTIVE_MESH) if in_spmd() else None
    return x if g is None else _Chunk.apply(x, dim, g)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The "model" ranks' chunks concatenated along ``dim`` inside
    ``spmd()`` (else x)."""
    g = _model_group(_ACTIVE_MESH) if in_spmd() else None
    return x if g is None else _AllGather.apply(x, dim, g)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its gradient summed over "model" inside ``spmd()``."""
    g = _model_group(_ACTIVE_MESH) if in_spmd() else None
    return x if g is None else _CopyToModel.apply(x, g)


def model_shards() -> int:
    """The active mesh's "model" size inside ``spmd()`` (else 1)."""
    mesh = _ACTIVE_MESH
    if mesh is None or not in_spmd() or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh_sizes(mesh)["model"]
