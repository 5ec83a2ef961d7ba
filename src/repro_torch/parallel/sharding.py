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
active, each rank holds its data shard of the batch (rows over the batch
axes) as plain tensors, and the work is split over "model" as the
reference's sharding constraints split it:

* every CIM projection is column-parallel: a rank computes the N-chunk of
  its "model" coordinate (``split_model``: a DTensor parameter gathered
  over the batch axes and left split over "model", whose gradient is
  reduce-scattered as the parameter is placed; a plain tensor or a
  ``PackedWeight`` sliced), with K whole. GR-MAC digitizes each n_r-deep
  K sub-block per output element, so with both pre-scales taken over
  every rank (``all_reduce_max``) each output element is the one computed
  without a mesh. A dimension that does not divide "model" stays whole;
* per-channel work (the MLP hidden, RG-LRU's width, SSM heads) runs on
  this rank's channels, and whatever needs whole rows is gathered
  (``all_gather``); the LM head's logits stay split over the vocabulary;
* a global KV split over "model" is attended chunk by chunk in decode
  and combined by two all-reduces (``models.layers``).

Other parameters are gathered to their full size where they are used
(``gather_full``). The quantities the reference computes over the whole
batch are reduced explicitly: the pre-scales, the loss and the MoE
load-balancing means (``all_reduce_sum``). Query positions of the train
attention (``layers._train_attention``) and the MoE's expert buffers are
split over "model" (``chunk`` / ``all_gather``, the counterparts of the
reference's ``shard_map`` specs). Every rank backpropagates the global
loss with seed 1: a replicated computation receives its whole gradient on
every rank, a split one its part, and a replicated input feeding a split
computation sums its gradient over "model" (``copy_to_model``).
Collectives over a group of one rank are skipped, so a 1 x 1 mesh runs
the same operations as no mesh.

``shard(x, *spec)`` is the reference's sharding constraint: a DTensor is
redistributed to the spec; inside ``spmd()`` a plain tensor whose spec
names "model" at a dimension that divides it is cut to this rank's chunk
there (the residual stream between super-blocks); otherwise it is a
no-op.
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
import weakref
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "set_mesh", "get_mesh", "use_mesh", "shard", "batch_axes",
    "axis_divides", "param_specs", "named_sharding_tree", "placements",
    "mesh_sizes", "spmd", "in_spmd", "data_shards", "data_index",
    "gather_full", "gather_tree", "gather_rows", "local_rows",
    "all_reduce_max", "all_reduce_sum",
    "chunk", "all_gather", "copy_to_model", "model_shards", "model_rank",
    "splits", "split_model", "gather_dim", "is_dtensor",
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
    """Best-effort sharding constraint: a DTensor is redistributed to
    ``spec`` (entries "data", "all", "model", None; those that do not
    divide dropped). Inside ``spmd()`` a plain tensor is this rank's rows
    already, and is cut to its "model" chunk of the dimension whose entry
    is "model" when that dimension divides (``chunk``). Otherwise, and
    without an active mesh, a no-op."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    if is_dtensor(x):
        return x.redistribute(x.device_mesh,
                              placements(_resolve(x.shape, spec, mesh),
                                         x.device_mesh))
    if "model" in spec and splits(x.shape[spec.index("model")]):
        return chunk(x, spec.index("model"))
    return x


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
    return [mesh.get_group(a) for a in axes if sizes.get(a, 1) > 1]


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
    return _param_local(t, keep_model=False) if is_dtensor(t) else t


def _param_local(t, keep_model: bool) -> torch.Tensor:
    """A DTensor parameter's local tensor gathered over every mesh
    dimension that shards it, "model" kept split when ``keep_model``:
    plain all-gathers, the innermost mesh dimension first (so ("pod",
    "data") on one dimension comes back in order), not DTensor's
    redistribution. The gradient is summed over the batch axes (each
    rank's rows add their part: reduce-scattered where the parameter is
    sharded, all-reduced where it is replicated) and cut to this rank's
    chunk over "model", then placed as the parameter is."""
    mesh = t.device_mesh
    sizes, ba = mesh_sizes(mesh), batch_axes(mesh) or ()
    local = t.to_local()
    for i in reversed(range(mesh.ndim)):
        a, p = mesh.mesh_dim_names[i], t.placements[i]
        if sizes[a] == 1:
            continue
        if p.is_shard() and not (keep_model and a == "model"):
            local = _GatherDim.apply(local, p.dim, mesh.get_group(a),
                                     a in ba)
        elif a in ba and not p.is_shard():
            local = _CopyToModel.apply(local, mesh.get_group(a))
    return local


# one all-gather / reduce-scatter into a single tensor (torch 2.13 renames
# them, the older names stay)
_GATHER_SINGLE = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER_SINGLE = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` concatenated along ``dim`` in rank
    order, by one all-gather into a single tensor (no gradient)."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    _GATHER_SINGLE(out, xm, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


class _GatherDim(torch.autograd.Function):
    """The group's chunks of ``dim`` concatenated in rank order
    (``gather_dim``); the gradient reduce-scattered (``summed``: each
    rank's gradient is a part of the sum, as a split consumer's or a
    parameter's) or cut to this rank's chunk (a replicated consumer: every
    rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, dim = dist.get_world_size(ctx.group), ctx.dim
        if not ctx.summed:
            return (g.chunk(n, dim=dim)[dist.get_rank(ctx.group)]
                    .contiguous(), None, None, None)
        gm = g.movedim(dim, 0).contiguous()
        out = gm.new_empty((gm.shape[0] // n, *gm.shape[1:]))
        _SCATTER_SINGLE(out, gm, group=ctx.group)
        return (out if dim == 0 else out.movedim(0, dim).contiguous(),
                None, None, None)


def gather_tree(tree):
    """``gather_full`` over a params tree."""
    from repro_torch.tree import tree_map

    return tree_map(gather_full, tree)


def all_reduce_max(t: torch.Tensor, axes=None) -> torch.Tensor:
    """The max of ``t`` over every rank of the active mesh (or over
    ``axes``) inside ``spmd()``, without a gradient (a pre-scale's
    absmax, a softmax's running max); else ``t``."""
    mesh = _ACTIVE_MESH
    if mesh is None or not in_spmd():
        return t
    groups = _groups(mesh, mesh.mesh_dim_names if axes is None else axes)
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


def _local_chunk(x: torch.Tensor, dim: int, group, groups: int):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if groups == 1:
        return x.chunk(n, dim=dim)[r].contiguous()
    return torch.cat([part.chunk(n, dim=dim)[r] for part
                      in x.chunk(groups, dim=dim)], dim=dim)


class _Chunk(torch.autograd.Function):
    """This rank's chunk of ``dim``, of each of ``groups`` equal groups
    along it (concatenated); the gradient is all-gathered and put back in
    place."""

    @staticmethod
    def forward(ctx, x, dim, group, groups):
        ctx.dim, ctx.group, ctx.groups = dim, group, groups
        return _local_chunk(x, dim, group, groups)

    @staticmethod
    def backward(ctx, g):
        full = gather_dim(g, ctx.dim, ctx.group)
        if ctx.groups > 1:
            # rank-major chunks of group-major parts -> group-major
            n = dist.get_world_size(ctx.group)
            parts = [c.chunk(ctx.groups, dim=ctx.dim)
                     for c in full.chunk(n, dim=ctx.dim)]
            full = torch.cat([parts[r][i] for i in range(ctx.groups)
                              for r in range(n)], dim=ctx.dim)
        return full, None, None, None


class _CopyToModel(torch.autograd.Function):
    """Identity whose gradient is summed over the group: a replicated
    tensor feeding a computation split over it (over "model"), or a
    parameter replicated over the batch axes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every data shard's rows of ``x`` concatenated along dim 0, in the
    order of ``data_index`` (the innermost batch axis gathered first); no
    gradient (the serving path's outputs)."""
    mesh = mesh or _ACTIVE_MESH
    sizes = mesh_sizes(mesh)
    for a in reversed(batch_axes(mesh) or ()):
        if sizes[a] > 1:
            x = gather_dim(x, 0, mesh.get_group(a))
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
    return x if g is None else _Chunk.apply(x, dim, g, 1)


def all_gather(x: torch.Tensor, dim: int, summed: bool = False
               ) -> torch.Tensor:
    """The "model" ranks' chunks concatenated along ``dim`` inside
    ``spmd()`` (else x). Its gradient is this rank's chunk of the upstream
    gradient, which every rank holds whole (a replicated consumer); with
    ``summed``, the consumer is split over "model" and each rank holds a
    part: the parts are reduce-scattered."""
    g = _model_group(_ACTIVE_MESH) if in_spmd() else None
    return x if g is None else _GatherDim.apply(x, dim % x.dim(), g, summed)


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


def model_rank() -> int:
    """This rank's coordinate on "model" inside ``spmd()`` (else 0)."""
    return (_ACTIVE_MESH.get_local_rank("model") if model_shards() > 1
            else 0)


def splits(n: int) -> bool:
    """Whether the SPMD program splits a dimension of size ``n`` over
    "model": inside ``spmd()``, "model" wider than one rank, and ``n`` a
    multiple of it."""
    nm = model_shards()
    return nm > 1 and n % nm == 0


# packed weights' chunks, made once per (weight, rank, width, groups)
_PACKED_CHUNKS = weakref.WeakKeyDictionary()


def split_model(t, dim: int = -1, groups: int = 1):
    """This "model" rank's chunk of ``dim`` of a parameter, for a
    computation split over "model" (the caller checks ``splits``): of
    each of ``groups`` equal groups along ``dim`` when ``groups > 1`` (the
    columns of an SSM input projection, z and x side by side).

    A DTensor is gathered over the batch axes and left split over "model"
    (``_param_local``; a K split exchanged for an N split by one
    all-to-all); its local gradient is this rank's chunk, summed over the
    batch axes when it is placed back. A plain tensor is sliced,
    its gradient gathered over "model" (``chunk``). A ``PackedWeight`` is
    cut along N, keeping the whole weight's scale ``sw``, once (the chunk
    is kept beside the weight)."""
    if not is_dtensor(t) and not torch.is_tensor(t):
        key = (model_rank(), model_shards(), groups)
        chunks = _PACKED_CHUNKS.setdefault(t, {})
        if key not in chunks:
            codes = _local_chunk(t.codes, 1, _model_group(_ACTIVE_MESH),
                                 groups)
            chunks[key] = dataclasses.replace(t, codes=codes,
                                              n=codes.shape[1])
        return chunks[key]
    dim = dim % t.dim()
    group = _model_group(_ACTIVE_MESH)
    if not is_dtensor(t):
        return _Chunk.apply(t, dim, group, groups)
    mesh = t.device_mesh
    p = t.placements[mesh.mesh_dim_names.index("model")]
    local = _param_local(t, keep_model=True)
    if groups == 1 and p.is_shard(dim):
        return local
    if groups == 1 and p.is_shard(0) and t.dim() == 2 and dim == 1:
        # a (K, N) weight stored with K over "model" (``wo``,
        # ``out_proj``): its blocks exchanged over "model"
        return _RowsToCols.apply(local, group)
    if p.is_shard():
        local = _GatherDim.apply(local, p.dim, group, False)
    return _Chunk.apply(local, dim, group, groups)


def _all_to_all(x: torch.Tensor, split: int, cat: int, group):
    """``x`` cut into the group's count of chunks along ``split``, chunk j
    sent to rank j, the chunks received concatenated along ``cat`` in
    rank order."""
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=cat)


class _RowsToCols(torch.autograd.Function):
    """A (K / n, N) row chunk of a weight to its (K, N / n) column chunk
    over the group (one all-to-all); the gradient goes back the same
    way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, 1, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, 0, 1, ctx.group), None
