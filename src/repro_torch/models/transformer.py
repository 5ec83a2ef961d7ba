"""Model assembly: embeddings + a stack of blocks + LM head.

The port's counterpart of ``repro.models.transformer`` for every block kind
("attn", "local", "rglru", "ssm") with dense or MoE FFNs (an "ssm" block
has none), on token ids or, for ``input_mode == "embeddings"``, on
precomputed (B, S, D) embeddings. Parameters are plain nested dicts of
tensors with one entry per layer (``params["layers"][l]``) where the
reference stacks super-blocks for ``lax.scan``;
``convert.params_from_jax`` maps one tree onto the other. Depth is a
Python loop over the layers.

Three execution paths share the layer code:
  train            full-sequence, no caches (RG-LRU by an associative scan,
                   SSM by the chunked SSD form); under autograd each full
                   super-block of ``len(block_pattern)`` layers is
                   recomputed in the backward when ``cfg.remat`` is set
                   (``torch.utils.checkpoint``, the reference's
                   ``jax.checkpoint``)
  chunked prefill  a prompt chunk against per-layer caches, KV written at
                   per-lane offsets in one pass and recurrent states
                   advanced step by step (``prefill_step``; right padding
                   masked out)
  decode           a single token against per-layer caches
Cached paths update the cache dicts in place (tensors written in place,
recurrent states replaced) and return the same dict.

Under an active mesh (``parallel.sharding.use_mesh``) ``train_loss``,
``prefill_step``, ``decode_step`` and the no-cache ``forward`` run the
SPMD program of ``parallel.sharding``: each rank takes its rows of the
batch (a DTensor's local rows, or its slice of a plain global batch) and
runs them inside ``sharding.spmd()``, with the work split over "model":
every CIM projection column-parallel (``layers.dense``), the embedding
looked up in this rank's vocabulary rows (the others masked, summed over
"model"), the residual stream split over D between remat's super-blocks,
the logits split over the vocabulary. The loss is computed on that split
(``_nll``: each vocabulary block's log-sum-exp, gathered); decode gathers
its (B, V) logits; prefill's greedy ids come from a split argmax. A
parameter is taken where it is used (its "model" chunk, or gathered
whole): inside the checkpointed function under remat, so the backward
takes it again and saves only the DTensor, and a rank never holds the
whole model at once. A cache is a tree of DTensors placed as
``launch.specs.cache_spec_tree`` says (rows over the batch axes; a global
KV's sequence, SSM heads, RG-LRU width and conv channels over "model",
or over every axis for one row): each layer runs on its leaves' chunks
where its work is split the same way (the recurrent states; in decode a
global KV's context, attended chunk by chunk), gathers their other split
dimensions, and writes its chunk back in place. On a 1 x 1 mesh the
program runs the operations of the unmeshed path.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.formats import IntFormat
from repro_torch.core.scopes import named_scope
from repro_torch.kernels.packed import pack_weight
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.rglru import (init_lam, init_rglru_state,
                                      rglru_decode, rglru_prefill,
                                      rglru_train)
from repro_torch.models.ssm import (init_ssm_state, ssm_decode, ssm_prefill,
                                    ssm_train)
from repro_torch.parallel import sharding
from repro_torch.tree import tree_paths

__all__ = [
    "init_params",
    "init_cache",
    "pack_params",
    "to_device",
    "forward",
    "train_loss",
    "decode_step",
    "prefill_step",
    "split_argmax",
]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


_KINDS = ("attn", "local", "rglru", "ssm")
# the CIM site of each projection, by parameter group (nested groups by
# nested dicts); the MoE experts are digital, as in the reference
_FFN_SITES = dict.fromkeys(("wi", "wg", "wo"), "mlp")
_SITES = {"attn": {"wq": "attn_qkv", "wk": "attn_qkv", "wv": "attn_qkv",
                   "wo": "attn_o"},
          "rglru": dict.fromkeys(("in_proj", "gate_r", "gate_i", "out_proj"),
                                 "rglru"),
          "ssm": dict.fromkeys(("in_proj", "bc_proj", "dt_proj", "out_proj"),
                               "ssm"),
          "ffn": _FFN_SITES,
          "moe": {"router": "moe_router", "dense_mlp": _FFN_SITES}}
# sites whose input is f32 whatever the model dtype, so their weight is too
_F32_SITES = ("moe_router",)


def _check_blocks(cfg: ArchConfig) -> None:
    other = sorted(set(cfg.blocks()) - set(_KINDS))
    if other:
        raise ValueError(f"unknown block kinds {other}")
    if cfg.input_mode not in ("tokens", "embeddings"):
        raise ValueError(f"unknown input_mode {cfg.input_mode!r}")


# ------------------------------------------------------------------ init
def init_params(cfg: ArchConfig, seed: int,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random weights from a seeded ``torch.Generator``, with the reference's
    shapes and scales: normal(0, 1/sqrt(d_in)) projections, output
    projections scaled by 1/sqrt(2 * n_layers) more, 0.02-scaled
    embeddings, 0.1-scaled conv kernels, unit norms, the reference's
    fixed RG-LRU ``lam`` and SSM ``A_log`` / ``D`` / ``dt_bias``, and the
    MoE layers of ``models.moe.init_moe`` (an f32 router). An
    embedding-input model has no embedding table.

    Drawn by a generator on ``device`` itself (``device=None`` means the
    card), so a full-width model's billions of normals never pass through
    the host: a seed gives the same weights on every run on one kind of
    device, but the CPU and the card draw different streams. To hold the
    card against the CPU, draw on the CPU and move the tree
    (``to_device``). On ``meta`` (the cost ledger's shape-only tree) no
    generator can live: the draws there take none and hold no values."""
    device = resolve_device(device)
    _check_blocks(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = _dtype(cfg)
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(scale)
        return w.to(dtype)

    def dense(d_in, d_out, scale=None, bias=False, dtype=dt):
        p = {"w": normal((d_in, d_out),
                         1.0 / math.sqrt(d_in) if scale is None else scale,
                         dtype)}
        if bias:
            p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
        return p

    def norm():
        return {"g": torch.ones((d,), dtype=dt, device=device)}

    def attn_layer():
        return {"wq": dense(d, h * dh, bias=cfg.qkv_bias),
                "wk": dense(d, kv * dh, bias=cfg.qkv_bias),
                "wv": dense(d, kv * dh, bias=cfg.qkv_bias),
                "wo": dense(h * dh, d, scale=1.0 / math.sqrt(
                    h * dh * 2 * cfg.n_layers))}

    def conv(width):
        return normal((cfg.conv_width, width), 0.1)

    def rglru_layer():
        w = cfg.rnn_width
        return {"in_proj": dense(d, w), "gate_r": dense(d, w),
                "gate_i": dense(d, w), "conv": conv(w),
                "lam": init_lam(w).to(device),
                "out_proj": dense(w, d, scale=1.0 / math.sqrt(
                    w * 2 * cfg.n_layers))}

    def ssm_layer():
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = dict(dtype=torch.float32, device=device)
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
        return {"in_proj": dense(d, 2 * di), "bc_proj": dense(d, 2 * n),
                "dt_proj": dense(d, nh), "conv": conv(di),
                "A_log": a_log.to(device),
                "D": torch.ones((nh,), **f32),
                "dt_bias": torch.zeros((nh,), **f32),
                "out_norm": {"g": torch.ones((di,), dtype=dt, device=device)},
                "out_proj": dense(di, d, scale=1.0 / math.sqrt(
                    di * 2 * cfg.n_layers))}

    def layer(kind):
        p = {"norm1": norm()}
        if kind == "ssm":
            p["ssm"] = ssm_layer()
            return p                      # a Mamba2 block has no FFN
        if kind == "rglru":
            p["rglru"] = rglru_layer()
        else:
            p["attn"] = attn_layer()
        p["norm2"] = norm()
        if cfg.is_moe:
            p["moe"] = init_moe(cfg, normal, dense, ffn)
        else:
            p["ffn"] = ffn()
        return p

    def ffn():
        p = {"wi": dense(d, f),
             "wo": dense(f, d, scale=1.0 / math.sqrt(f * 2 * cfg.n_layers))}
        if cfg.gated_mlp:
            p["wg"] = dense(d, f)
        return p

    params = {}
    if cfg.input_mode == "tokens":
        params["embed"] = normal((cfg.padded_vocab, d), 0.02)
    params["layers"] = [layer(kind) for kind in cfg.blocks()]
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.padded_vocab)
    return params


def pack_params(params: dict, cfg: ArchConfig) -> dict:
    """Served params: each CIM site's weight packed once
    (``kernels.packed.pack_weight``) under the design ``cfg.cim.for_site``
    resolves there, so no call re-quantizes it. Sites that do not run
    grmac with an FP input and a weight format of at most 8 bits keep
    their tensor, as do the blocks' other tensors (norms, conv kernels,
    RG-LRU ``lam``, SSM ``A_log`` / ``D`` / ``dt_bias``, the digital MoE
    experts). A weight is packed at the dtype the site computes in: the
    model's, or f32 for the MoE router (rounding it to the model dtype
    first would change its scale and every code). A tied head gets its
    own packed ``embed.T`` as ``"lm_head"``; the embedding table stays
    for the lookup. The input is not changed; untouched tensors are
    shared. A DTensor weight (params placed by ``param_specs``) is
    gathered whole and packed on every rank; under a mesh each rank then
    serves its "model" chunk of it (``sharding.split_model``)."""
    dt = _dtype(cfg)

    def pack(w, site):
        eff = cfg.cim.for_site(site)
        if (eff.mode != "grmac" or isinstance(eff.fmt_x, IntFormat)
                or eff.fmt_w.bits > 8):
            return w
        w = sharding.gather_full(w)
        return pack_weight(w.to(torch.float32 if site in _F32_SITES else dt),
                           eff.fmt_w, eff.n_r)

    def packed(group, sites):
        out = dict(group)
        for name, site in sites.items():
            if name not in group:
                continue
            out[name] = (packed(group[name], site) if isinstance(site, dict)
                         else dict(group[name], w=pack(group[name]["w"],
                                                       site)))
        return out

    layers = [packed(p, _SITES) for p in params["layers"]]
    head = (params["lm_head"] if "lm_head" in params
            else {"w": params["embed"].T})
    return dict(params, layers=layers, lm_head=dict(head, w=pack(head["w"],
                                                                  "head")))


def to_device(tree, device: Union[str, torch.device]):
    """A copy of a nested dict (or list) of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------------ caches
def init_cache(cfg: ArchConfig, batch: int, ctx_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """Per-layer caches, ``{"layers": [...]}``: ``{"k", "v": (B, S, KV,
    Dh)}`` of ``dtype`` with S = ``ctx_len`` for "attn" and the ring
    length ``min(window, ctx_len)`` for "local"; f32 recurrent states
    ``{"h", "conv"}`` for "rglru" and "ssm" (conv windows (B, conv_width
    - 1, C))."""
    device = resolve_device(device)
    _check_blocks(cfg)

    def one(kind):
        if kind == "rglru":
            return init_rglru_state(cfg, batch, device)
        if kind == "ssm":
            return init_ssm_state(cfg, batch, device)
        s = ctx_len if kind == "attn" else min(cfg.window, ctx_len)
        shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"layers": [one(kind) for kind in cfg.blocks()]}


# ------------------------------------------------------------------ forward
def _recurrent(kind, p, h, cfg, cache, chunk_lengths, active):
    """An RG-LRU or SSM block: the train form without a cache; else the
    serving path, whose new state replaces the old one in ``cache``,
    except in lanes outside ``active`` (decode), which keep theirs."""
    train, prefill, decode = (
        (rglru_train, rglru_prefill, rglru_decode) if kind == "rglru"
        else (ssm_train, ssm_prefill, ssm_decode))
    if cache is None:
        return train(p, h, cfg)
    if chunk_lengths is not None:
        out, new = prefill(p, h, cfg, cache, chunk_lengths)
    else:
        out, new = decode(p, h, cfg, cache)
        if active is not None:
            new = {name: torch.where(
                active.reshape(-1, *[1] * (t.dim() - 1)), t, cache[name])
                for name, t in new.items()}
    cache.update(new)
    return out


def _apply_layer(kind, p, x, cfg, positions, cache, cache_index,
                 chunk_lengths, active, kv_split=False):
    """Pre-norm residual block of ``kind`` + dense or MoE FFN (none after
    "ssm"); returns (x, the MoE's aux loss or None). In a chunked prefill
    the MoE routes only each lane's valid steps; in decode every lane
    routes, inactive ones too, as in the reference (``active`` only
    freezes caches)."""
    h = L.rmsnorm(p["norm1"], x)
    if kind in ("attn", "local"):
        out, _ = L.attention(
            p["attn"], h, cfg, local=(kind == "local"), positions=positions,
            cache=cache, cache_index=cache_index,
            chunk_lengths=chunk_lengths, active=active, kv_split=kv_split)
    else:
        out = _recurrent(kind, p[kind], h, cfg, cache, chunk_lengths, active)
    x = x + out
    if kind == "ssm":
        return x, None
    h = L.rmsnorm(p["norm2"], x)
    if not cfg.is_moe:
        return x + L.mlp(p["ffn"], h, cfg), None
    valid = (None if chunk_lengths is None else
             torch.arange(x.shape[1], device=x.device)[None, :]
             < chunk_lengths[:, None])
    out, aux = moe(p["moe"], h, cfg, valid=valid)
    return x + out, aux


def _lanes(value, b: int, device) -> torch.Tensor:
    """A scalar or (B,) int index as a (B,) int64 tensor on ``device``."""
    return torch.as_tensor(value, dtype=torch.int64, device=device).expand(b)


def forward(
    params: dict,
    inputs: torch.Tensor,
    cfg: ArchConfig,
    *,
    cache: Optional[dict] = None,
    cache_index=None,
    positions: Optional[torch.Tensor] = None,
    chunk_lengths: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
):
    """Returns (logits, aux_loss, cache); aux_loss sums the MoE layers'
    load-balancing losses (0 without MoE).

    ``inputs``: token ids (B, S), or (B, S, D) embeddings when
    ``cfg.input_mode == "embeddings"``. ``cache_index`` (scalar or (B,))
    is the per-lane write offset of a cached call; ``chunk_lengths`` (B,)
    turns a cached call into a chunked prefill over the whole S axis;
    ``active`` (B,) bool freezes the caches of the other lanes in a
    decode. Without a cache and under autograd, ``cfg.remat`` recomputes
    each full super-block in the backward (``_superblock_fn``).
    """
    _check_blocks(cfg)
    mesh = sharding.get_mesh()
    if mesh is not None and not sharding.in_spmd():
        as_dtensor = sharding.is_dtensor(inputs)

        def run(inputs, lanes, cache):
            logits, aux, cache = forward(params, inputs, cfg, cache=cache,
                                         **lanes)
            # DTensor inputs get their logits back split as they are
            return (logits if as_dtensor else _whole_vocab(logits, cfg),
                    aux, cache)
        vocab = sharding.mesh_sizes(mesh).get("model", 1)
        split = {0: 2} if as_dtensor and vocab > 1 and \
            cfg.padded_vocab % vocab == 0 else {}
        return _spmd_serve(
            mesh, run, inputs, cache, model_dims=split,
            cache_index=cache_index, positions=positions,
            chunk_lengths=chunk_lengths, active=active)
    with named_scope("model.embed"):
        if cfg.input_mode == "tokens":
            x = _embed(params["embed"], inputs).to(_dtype(cfg))
        else:
            x = inputs.to(_dtype(cfg))
    x = sharding.shard(x, "data", None, None)
    b, s = x.shape[:2]
    dev = x.device
    if cache is not None:
        cache_index = _lanes(cache_index, b, dev)
    if positions is None:
        steps = torch.arange(s, device=dev)[None, :]
        positions = (steps.expand(b, s) if cache is None
                     else cache_index[:, None] + steps)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    if cache is None and cfg.remat and torch.is_grad_enabled():
        # the reference checkpoints its scanned super-blocks, not the tail
        period = cfg.pattern_period()
        n_full = cfg.n_layers // period * period
        block = _superblock_fn(cfg)
        for i in range(0, n_full, period):
            x, aux = _checkpoint(cfg, block, x, positions,
                                 params["layers"][i:i + period])
            # remat saves 1/"model" of the residual between super-blocks
            x = sharding.shard(x, "data", None, "model")
            aux_total = aux_total + aux
        x = L.whole(x, cfg.d_model)
        layers = range(n_full, cfg.n_layers)
    else:
        layers = range(cfg.n_layers)
    kinds = cfg.blocks()
    for i in layers:
        with named_scope("model.layer"):
            c, put_back, kv_split = _layer_cache(
                cache["layers"][i] if cache is not None else None, kinds[i],
                cfg, decode=chunk_lengths is None)
            x, aux = _apply_layer(kinds[i], params["layers"][i], x, cfg,
                                  positions, c, cache_index, chunk_lengths,
                                  active, kv_split)
            if put_back is not None:
                put_back(c)
        if aux is not None:
            aux_total = aux_total + aux
    with named_scope("model.head"):
        x = L.rmsnorm(params["final_norm"], x)
        # the LM head is a CIM site in both tied and untied form (served
        # params carry a tied head's packed embed.T as "lm_head"); its
        # logits stay split over the vocabulary where it divides "model"
        head = (params["lm_head"] if "lm_head" in params
                else {"w": params["embed"].T})
        logits = L.dense(head, x, cfg.cim, "head", logical_n=cfg.vocab_size,
                         gather=False)
        if cfg.padded_vocab != cfg.vocab_size:
            cols = torch.arange(logits.shape[-1], device=dev)
            off = _vocab_offset(logits, cfg)
            if off:
                cols = cols + off
            logits = torch.where(cols >= cfg.vocab_size,
                                 torch.tensor(-1e30, dtype=logits.dtype,
                                              device=dev), logits)
    return logits, aux_total, cache


def _vocab_offset(logits: torch.Tensor, cfg: ArchConfig) -> int:
    """The first vocabulary column of this rank's logits (0 unless split)."""
    return (sharding.model_rank() * logits.shape[-1]
            if logits.shape[-1] != cfg.padded_vocab else 0)


def _whole_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits split over the vocabulary gathered over "model"."""
    return L.whole(logits, cfg.padded_vocab)


def _embed(table, ids: torch.Tensor) -> torch.Tensor:
    """The embedding lookup. Inside the SPMD program with the vocabulary
    split over "model", each rank looks ids up in its own rows, the others
    masked to zero, and the lookups are summed over "model": one rank adds
    a nonzero row, so the sum is exact."""
    v = table.shape[0]
    if not sharding.splits(v):
        return sharding.gather_full(table)[ids]
    rows = sharding.split_model(table, 0)
    c = rows.shape[0]
    local = ids - sharding.model_rank() * c
    mine = (local >= 0) & (local < c)
    x = torch.where(mine[..., None], rows[local.clamp(0, c - 1)],
                    torch.zeros((), dtype=rows.dtype, device=rows.device))
    return sharding.all_reduce_sum(x, axes=("model",))


def _cache_splits(c: dict, kind: str, cfg: ArchConfig, decode: bool) -> dict:
    """{leaf: dimension} of a layer's cache that its work splits over
    "model" inside the SPMD program: RG-LRU's width and SSM heads (the
    state and the conv window's channels), and in decode a global KV's
    context where the cache splits it over "model" already."""
    if kind == "rglru" and sharding.splits(cfg.rnn_width):
        return {"h": 1, "conv": 2}
    if kind == "ssm" and sharding.splits(cfg.ssm_heads):
        return {"h": 1, "conv": 2}
    if kind == "attn" and decode and sharding.is_dtensor(c["k"]):
        from torch.distributed.tensor import Shard

        k = c["k"]
        at = k.device_mesh.mesh_dim_names.index("model")
        if k.placements[at] == Shard(1) and sharding.model_shards() > 1:
            return {"k": 1, "v": 1}
    return {}


def _layer_cache(c: Optional[dict], kind: str, cfg: ArchConfig,
                 decode: bool):
    """One layer's cache as the layer runs on it inside the SPMD program.
    A DTensor leaf becomes its local rows: every other dimension that the
    mesh splits is gathered by plain all-gathers, the innermost mesh
    dimension first (``_leaf_gathers``), and its dimension in
    ``_cache_splits`` is then cut to this rank's "model" chunk, unless
    "model" alone splits it already; a plain leaf is whole, or cut to
    that chunk. Returns (the local cache, ``put_back``, whether a KV's
    context is split): ``put_back(c)`` writes each leaf's part of the
    layer's result back in place (the chunk gathered over "model", then
    this rank's shards cut out, the outermost mesh dimension first);
    (c, None, False) when nothing is split and no leaf is a DTensor."""
    if c is None:
        return c, None, False
    splits = _cache_splits(c, kind, cfg, decode)
    if not splits and not any(sharding.is_dtensor(t) for t in c.values()):
        return c, None, False
    local, views, gathers, cut = {}, {}, {}, set()
    for name, t in c.items():
        dim = splits.get(name)
        if sharding.is_dtensor(t):
            views[name] = out = t.to_local()
            gathers[name], kept = _leaf_gathers(t, dim)
            for i, d in gathers[name]:
                out = sharding.gather_dim(out, d,
                                          t.device_mesh.get_group(i))
        else:
            views[name] = out = t
            kept = False
        if dim is not None and not kept:
            out = sharding.chunk(out, dim)
            cut.add(name)
        local[name] = out

    def put_back(new: dict) -> None:
        for name, t in c.items():
            out = new[name]
            if name in cut:
                out = sharding.all_gather(out, splits[name])
            for i, d in reversed(gathers.get(name, ())):
                mesh = t.device_mesh
                out = out.chunk(mesh.shape[i], dim=d)[mesh.get_local_rank(i)]
            if out is not views[name]:
                views[name].copy_(out)

    return local, put_back, "k" in splits


def _leaf_gathers(t, dim: Optional[int]):
    """([(mesh dimension, tensor dimension), ...], kept): the all-gathers,
    innermost mesh dimension first, that take a cache DTensor ``t``'s
    local tensor to its rows over the batch axes, whole in every other
    dimension; ``kept`` where "model" alone splits ``dim``, whose shard
    is then left as it is (it is the layer's "model" chunk)."""
    mesh = t.device_mesh
    names, sizes = mesh.mesh_dim_names, tuple(mesh.shape)
    ba = sharding.batch_axes(mesh) or ()
    sharded = [(i, p.dim) for i, p in enumerate(t.placements)
               if sizes[i] > 1 and p.is_shard()
               and not (names[i] in ba and p.dim == 0)]
    kept = (dim is not None and [d for _, d in sharded].count(dim) == 1
            and (names.index("model"), dim) in sharded)
    return [(i, d) for i, d in reversed(sharded)
            if not (kept and names[i] == "model")], kept


def _spmd_serve(mesh, run, inputs, cache, model_dims=None, **lanes):
    """``run(inputs, lanes, cache) -> (*outputs, cache)`` as the SPMD
    program: each rank runs its rows of ``inputs`` and of the per-lane
    ``lanes`` (``sharding.local_rows``) inside ``sharding.spmd()``. The
    batch is split when it divides over the batch axes, else every rank
    runs all of it. Outputs with a
    batch dimension come back as DTensors placed by rows when ``inputs``
    was a DTensor (output i split over "model" along dimension
    ``model_dims[i]`` when given), else gathered to the global batch. A
    split batch needs a cache of DTensors
    (``launch.specs.cache_spec_tree``): a plain cache there would hold
    stale rows of the others."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b = inputs.shape[0]
    nb = sharding.data_shards(mesh)
    split = nb > 1 and b % nb == 0
    if split and cache is not None and not any(
            sharding.is_dtensor(t) for _, t in tree_paths(cache)):
        raise ValueError(
            f"a batch split over {nb} data shards needs a cache of "
            "DTensors (place it by launch.specs.cache_spec_tree)")

    def local(t):
        if b % nb == 0:
            return sharding.local_rows(t, mesh)
        return t.full_tensor() if sharding.is_dtensor(t) else t

    as_dtensor = sharding.is_dtensor(inputs)
    with sharding.spmd():
        *outs, cache = run(local(inputs),
                           {k: local(v) for k, v in lanes.items()}, cache)
    ba = sharding.batch_axes(mesh) or ()
    model_dims = model_dims or {}

    def wrap(i, t):
        if t.dim() == 0:
            return t
        if as_dtensor:
            placements = [
                Shard(0) if split and a in ba
                else Shard(model_dims[i]) if a == "model" and i in model_dims
                else Replicate() for a in mesh.mesh_dim_names]
            return DTensor.from_local(t, mesh, placements, run_check=False)
        return sharding.gather_rows(t) if split else t

    return (*[wrap(i, t) for i, t in enumerate(outs)], cache)


def _superblock_fn(cfg: ArchConfig):
    """The train forward of one super-block (``block_pattern``'s layers in
    order): (x, positions, layer params) -> (x, the MoE aux loss). x may
    be the residual's "model" chunk (between super-blocks), gathered
    first; each layer takes its parameters inside, so that a checkpointed
    call takes them again in its recomputation."""
    def run(x, positions, layer_params):
        x = L.whole(x, cfg.d_model)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p_l in zip(cfg.block_pattern, layer_params):
            with named_scope("model.layer"):
                x, aux = _apply_layer(kind, p_l, x, cfg, positions, None,
                                      None, None, None)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total
    return run


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the matmul outputs, recompute the rest
    (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(cfg: ArchConfig, fn, *args):
    """``fn(*args)`` recomputed in the backward: everything under
    ``remat_policy="full"``, all but the matmul outputs under "dots".
    Inside the SPMD program the recomputation runs in it too (the backward
    runs after ``train_loss`` has left it), on the same mesh."""
    if sharding.in_spmd():
        mesh, body = sharding.get_mesh(), fn

        def fn(*a):
            with sharding.use_mesh(mesh), sharding.spmd():
                return body(*a)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def train_loss(params, batch: dict, cfg: ArchConfig, aux_weight: float = 0.01):
    """Mean next-token cross-entropy (masked when ``batch`` has a "mask")
    plus ``aux_weight`` times the MoE aux loss. ``batch``: {"inputs": (B, S)
    ids or (B, S, D) embeddings, "labels": (B, S) ids[, "mask": (B, S)]}.
    Returns (total, {"loss", "aux_loss", "total"}).

    Under an active mesh the batch is the global one: plain tensors (the
    same on every rank) or DTensors placed by rows over the batch axes; B
    must divide over the batch axes. Each rank runs its rows inside
    ``sharding.spmd()``; the loss is the mean over every rank's rows."""
    mesh = sharding.get_mesh()
    if mesh is None:
        return _loss(params, batch, cfg, aux_weight)
    nb = sharding.data_shards(mesh)
    b = batch["inputs"].shape[0]
    if b % nb:
        raise ValueError(f"batch {b} does not divide over {nb} data shards")
    batch = {k: sharding.local_rows(v, mesh) for k, v in batch.items()}
    with sharding.spmd():
        return _loss(params, batch, cfg, aux_weight, nb)


def _loss(params, batch, cfg, aux_weight, shards: int = 1):
    logits, aux, _ = forward(params, batch["inputs"], cfg)
    nll = _nll(logits, batch["labels"], cfg)
    mask = batch.get("mask")
    if shards > 1:
        # the sums of every rank's rows (their gradients pass through)
        if mask is None:
            loss = sharding.all_reduce_sum(torch.sum(nll)) / (nll.numel()
                                                              * shards)
        else:
            loss = sharding.all_reduce_sum(torch.sum(nll * mask)) \
                / torch.clamp(sharding.all_reduce_sum(torch.sum(mask)),
                              min=1.0)
    elif mask is None:
        loss = torch.mean(nll)
    else:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "total": total}


# the log-sum-exp of a row of logits runs over this many equal vocabulary
# blocks (fewer when the vocabulary has fewer powers of two), each block's
# first, then across the blocks: the same operations whether the blocks
# lie on one rank or are split over "model" (up to this many ranks)
LSE_BLOCKS = 16


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross-entropy per position, lse(logits) - logits[label]
    in f32, from logits that may be this rank's vocabulary chunk: the
    blocks' log-sum-exps are gathered over "model" and the label's logit
    is taken by the rank that holds it and summed over "model". The whole
    logits are never built; the f32 copy of the chunk is the one tensor of
    their size that autograd keeps."""
    v = logits.shape[-1]
    blocks = math.gcd(cfg.padded_vocab, LSE_BLOCKS)
    if v != cfg.padded_vocab:
        nm = cfg.padded_vocab // v
        blocks = blocks // nm if blocks % nm == 0 else 1
    x32 = logits.to(torch.float32)
    lse = torch.logsumexp(x32.reshape(*x32.shape[:-1], blocks, v // blocks),
                          dim=-1)
    lse = torch.logsumexp(L.whole(lse, lse.shape[-1] * (
        cfg.padded_vocab // v)), dim=-1)
    local = labels.to(torch.int64) - _vocab_offset(logits, cfg)
    picked = torch.gather(x32, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    if v != cfg.padded_vocab:
        picked = sharding.all_reduce_sum(
            torch.where((local >= 0) & (local < v), picked,
                        torch.zeros((), device=picked.device)),
            axes=("model",))
    return lse - picked


def _argmax_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The greedy id of every position, int32: ``torch.argmax``'s first
    occurrence, from logits that may be this rank's vocabulary chunk."""
    if logits.shape[-1] == cfg.padded_vocab:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return split_argmax(logits, _vocab_offset(logits, cfg),
                        lambda t: sharding.all_reduce_max(t, axes=("model",))
                        ).to(torch.int32)


def split_argmax(chunk: torch.Tensor, offset: int, reduce_max):
    """``argmax`` over a last dimension split into chunks, this one
    starting at column ``offset``: the chunk's max and first index, the
    max over the chunks (``reduce_max``), then the lowest global index
    among the chunks that reach it, so ties go to the first occurrence
    as ``torch.argmax``'s do. int64."""
    best = torch.amax(chunk, dim=-1)
    top = reduce_max(best)
    idx = torch.argmax(chunk, dim=-1) + offset
    miss = torch.iinfo(torch.int64).max
    return -reduce_max(-torch.where(best == top, idx, miss))


def decode_step(params, token, cfg: ArchConfig, cache, cache_index,
                active: Optional[torch.Tensor] = None):
    """One decode step: token (B, 1), or (B, 1, D) embeddings -> (logits
    (B, V), cache).

    ``cache_index`` is a scalar or per-lane (B,) write position; ``active``
    (B,) bool, when given, leaves the other lanes' caches (KV rows, rings,
    recurrent states and conv windows) unchanged. Under an active mesh,
    the SPMD program (module docstring)."""
    mesh = sharding.get_mesh()
    if mesh is not None and not sharding.in_spmd():
        def run(token, lanes, cache):
            return decode_step(params, token, cfg, cache, **lanes)
        return _spmd_serve(mesh, run, token, cache, cache_index=cache_index,
                           active=active)
    logits, _, cache = forward(params, token, cfg, cache=cache,
                               cache_index=cache_index, active=active)
    return _whole_vocab(logits[:, -1, :], cfg), cache


def prefill_step(params, tokens, cfg: ArchConfig, cache, cache_index, length):
    """Chunked prefill: tokens (B, S), or (B, S, D) embeddings -> the logits
    at each lane's last valid token (B, V), the greedy ids at *every*
    chunk position (B, S) int32, and the cache.

    ``cache_index`` (scalar or (B,)) is each lane's write offset; ``length``
    (B,) counts the valid leading tokens of this chunk per lane (the S axis
    may be right-padded to a bucket). A lane with ``length == 0`` keeps its
    cache unchanged, recurrent states and conv windows included. Under an
    active mesh, the SPMD program (module docstring).
    """
    mesh = sharding.get_mesh()
    if mesh is not None and not sharding.in_spmd():
        def run(tokens, lanes, cache):
            return prefill_step(params, tokens, cfg, cache, **lanes)
        return _spmd_serve(mesh, run, tokens, cache, cache_index=cache_index,
                           length=length)
    b, s = tokens.shape[0], tokens.shape[1]
    dev = tokens.device
    idx = _lanes(cache_index, b, dev)
    length = _lanes(length, b, dev)
    positions = idx[:, None] + torch.arange(s, device=dev)[None, :]
    logits, _, cache = forward(params, tokens, cfg, cache=cache,
                               cache_index=idx, positions=positions,
                               chunk_lengths=length)
    last = torch.clamp(length - 1, 0, s - 1)
    last_logits = _whole_vocab(logits[torch.arange(b, device=dev), last], cfg)
    return last_logits, _argmax_vocab(logits, cfg), cache
