"""Transformer layers of the port: RMSNorm, rotary embeddings, GQA
attention, full and sliding-window (train, single-token decode and
chunked-prefill paths), and MLPs.

Every projection goes through ``kernels.ops.cim_matmul`` with a site
label, so the GR-CIM numerics apply per site as in
``repro.models.layers``. Inside the SPMD program of ``parallel.sharding``
a projection whose N divides "model" is column-parallel (``dense``): this
rank computes its N-chunk, gathered over "model" where whole rows are
needed (q/k/v before RoPE, the MLP hidden before ``wo``, every output
projection) and kept split where the work is per channel. The train
path's attention splits query positions over "model"
(``_train_attention``); single-token decode over a global KV whose
context is split over "model" attends this rank's chunk and combines the
chunks' softmax partials (``softmax_partial`` / ``merge_partials``).
Attention's score and value einsums are digital by design and run under
the ``dig_attn`` scope (``core.scopes``; the audit's declaration).
Layouts stay the reference's: (B, S, H, Dh) for q/k/v and
(B, S_ctx, KV, Dh) for the KV cache; a sliding-window ("local") layer's
cache is a ring of ``min(window, ctx)`` slots, token ``p`` at slot
``p mod S_ctx``. Cached paths update the cache tensors in place (the
reference returns a new cache) and return the same dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.scopes import named_scope
from repro_torch.kernels.ops import cim_matmul
from repro_torch.kernels.packed import PackedWeight
from repro_torch.parallel import sharding

__all__ = ["dense", "dense_many", "whole", "dense_gathered", "rmsnorm", "rope", "silu", "attention", "mlp",
           "softmax_partial", "merge_partials"]

_NEG_INF = -1e30


def dense(p, x, cim: Optional[CIMConfig] = None, site: str = "mlp",
          logical_n: Optional[int] = None, *, gather: bool = True,
          split: Optional[bool] = None, groups: int = 1):
    """x @ W (+ b), through the CIM simulation resolved for this site.
    ``W`` is a tensor, a DTensor parameter or, in served params, a
    ``PackedWeight``.

    Inside the SPMD program the projection is column-parallel when
    ``split`` (default: when its N divides "model"): this rank computes its
    N-chunk (of each of ``groups`` column groups), the bias's chunk added,
    and the chunks are gathered over "model" unless ``gather`` is False;
    x's gradient is then summed over "model". ``logical_n`` (the head's
    real vocabulary) becomes the real columns of this rank's chunk. A
    weight that does not split is gathered whole."""
    return dense_many(x, cim, site, (p, dict(
        logical_n=logical_n, gather=gather, split=split, groups=groups)))[0]


def dense_many(x, cim: Optional[CIMConfig], site: str, *projections,
               **shared) -> list:
    """``dense(p, x, cim, site, **shared, **kw)`` of one input ``x`` for
    each projection, given as ``p`` or ``(p, kw)``. x's gradient is summed
    over "model" once for all the column-parallel ones (every rank's
    gradient of x is a part: its chunk's), not once each."""
    xm = sharding.copy_to_model(x)
    out = []
    for proj in projections:
        p, kw = proj if isinstance(proj, tuple) else (proj, {})
        out.append(_dense(p, x, xm, cim, site, **{**shared, **kw}))
    return out


def _dense(p, x, xm, cim, site, logical_n=None, gather=True, split=None,
           groups=1):
    """``dense``, a column-parallel projection reading ``xm``: x whose
    gradient is summed over "model" (``sharding.copy_to_model``, or a
    gather whose backward reduce-scatters)."""
    w, b = p["w"], p.get("b")
    n = w.shape[-1]
    if split is None:
        split = sharding.splits(n // groups)
    if split:
        if gather and groups > 1:
            raise ValueError("column groups stay split: gather=False")
        x = xm
        w = sharding.split_model(w, -1, groups)
        b = None if b is None else sharding.split_model(b, 0, groups)
        if logical_n is not None:
            c = n // sharding.model_shards()
            logical_n = min(max(logical_n - sharding.model_rank() * c, 0), c)
    else:
        w = sharding.gather_full(w)
        b = None if b is None else sharding.gather_full(b)
    y = cim_matmul(x, w if isinstance(w, PackedWeight) else w.to(x.dtype),
                   cim, site=site, logical_n=logical_n)
    if b is not None:
        y = y + b.to(x.dtype)
    return sharding.all_gather(y, -1) if split and gather else y


def whole(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t``'s last dimension gathered over "model" when it is a chunk of
    ``n`` (a column-parallel output kept split); else ``t``."""
    return sharding.all_gather(t, -1) if t.shape[-1] != n else t


def dense_gathered(p, t: torch.Tensor, n: int, cim, site: str):
    """``dense(p, ·)`` of ``t``'s chunks gathered whole over "model" (its
    last dimension a chunk of ``n``, or ``t`` itself when whole). Where
    the projection is column-parallel too, every rank's gradient of the
    gathered input is a part, so the gather's backward reduce-scatters
    them (no separate sum over "model")."""
    if t.shape[-1] == n or not sharding.splits(p["w"].shape[-1]):
        return dense(p, whole(t, n), cim, site)
    x = sharding.all_gather(t, -1, summed=True)
    return _dense(p, x, x, cim, site)


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    g = sharding.gather_full(p["g"])
    return ((x32 / rms) * g.to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, the reference's formula (``F.silu`` divides by
    ``1 + exp(-x)`` instead and rounds differently)."""
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding. x: (B, S, H, Dh); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
def _attn_mask(q_pos, k_pos, window: int, local: bool):
    """(.., S_q, S_k) boolean mask from positions: causal, and banded to
    ``window`` keys for a local layer."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    if local:
        mask &= q_pos[..., :, None] - k_pos[..., None, :] < window
    return mask


def _attend_chunked(q, kk, vv, pos_q, pos_k, cfg: ArchConfig, local: bool):
    """Query-chunked masked attention against full keys.

    q: (B, Sq, H, Dh); kk/vv: (B, Sk, KV, Dh); positions give causality.
    Bounds score materialization to (B, H, chunk, Sk).
    """
    b, sq, h, dh = q.shape
    kv = kk.shape[2]
    groups = h // kv

    def attend(q_c, pos_c):
        c = q_c.shape[1]
        qg = q_c.reshape(b, c, kv, groups, dh)
        with named_scope("dig_attn"):
            scores = torch.einsum("bskgd,btkd->bkgst", qg, kk)
        scores = scores.to(torch.float32)
        scores = scores / math.sqrt(dh)
        mask = _attn_mask(pos_c, pos_k, cfg.window, local)     # (B, C, Sk)
        scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        with named_scope("dig_attn"):
            o = torch.einsum("bkgst,btkd->bskgd", probs, vv)
        return o.reshape(b, c, h, dh)

    ck = cfg.attn_chunk or sq
    while sq % ck:
        ck //= 2
    if ck >= sq:
        return attend(q, pos_q)
    outs = [attend(q[:, i * ck:(i + 1) * ck], pos_q[:, i * ck:(i + 1) * ck])
            for i in range(sq // ck)]
    return torch.cat(outs, dim=1)


def _train_attention(q, k, v, positions, cfg: ArchConfig, local: bool):
    """Full-sequence attention with explicit sequence parallelism: inside
    the SPMD program (``parallel.sharding.spmd``) with a "model" axis whose
    size divides S, each "model" rank attends its block of query positions
    against all keys (queries split over "model", K/V replicated, their
    gradients summed over "model"), and the blocks are gathered; the
    reference's ``shard_map``. Otherwise chunked attention on one device.
    Each query's scores and output are computed as without a mesh."""
    s = q.shape[1]
    nm = sharding.model_shards()
    if nm > 1 and s % nm == 0:
        q_l = sharding.chunk(q, 1)
        pos_l = sharding.chunk(positions, 1)
        out = _attend_chunked(q_l, sharding.copy_to_model(k),
                              sharding.copy_to_model(v), pos_l, positions,
                              cfg, local)
        return sharding.all_gather(out, 1)
    return _attend_chunked(q, k, v, positions, positions, cfg, local)


def _chunk_prefill_attention(q, k, v, x, cache, cache_index, chunk_lengths,
                             cfg: ArchConfig, local: bool):
    """Multi-token cached attention for bucketed prefill.

    Writes the chunk's K/V at per-lane offsets ``cache_index + t`` (modulo
    the ring's length for a local layer) and attends each query causally.
    Steps with ``t >= chunk_lengths[b]`` (right padding, lanes not being
    prefilled) and steps past the cache's end write nothing, so those
    lanes' caches pass through unchanged, as the reference's out-of-bounds
    scatter drops them. The write is one masked select over the cache
    (each slot gathers the step that writes it), so no index count has to
    reach the host.

    A ring slot ``j`` takes the *latest* valid step ``t`` with
    ``(idx + t) mod S_ctx == j``: only the last ``min(len, S_ctx)`` valid
    steps write, each to its own slot, as the reference lets them. Queries
    of a local layer are scored against the *pre-write* ring plus the
    chunk's own keys, because a chunk longer than the ring overwrites
    slots its early queries still see; never-written slots carry a
    position past every query, so the causal mask drops them.
    """
    b, s = q.shape[0], q.shape[1]
    s_ctx = cache["k"].shape[1]
    dev = q.device
    steps = torch.arange(s, device=dev)
    q_pos = cache_index[:, None] + steps[None, :]                # (B, S)
    slot = torch.arange(s_ctx, device=dev)[None, :]              # (1, S_ctx)
    lengths = chunk_lengths.clamp(max=s)
    if local:
        last = lengths - 1
        t_of_slot = last[:, None] - torch.remainder(
            (cache_index + last)[:, None] - slot, s_ctx)         # (B, S_ctx)
        writes = (t_of_slot >= 0) & (t_of_slot
                                     >= (chunk_lengths - s_ctx)[:, None])
        # positions the ring holds before the chunk (last write idx - 1)
        last_old = cache_index - 1
        age = torch.remainder(
            torch.remainder(last_old, s_ctx)[:, None] - slot, s_ctx)
        k_pos_old = last_old[:, None] - age
        k_pos_old = torch.where(k_pos_old >= 0, k_pos_old, q_pos[:, -1:] + 1)
        keys = torch.cat([cache["k"], k.to(cache["k"].dtype)], 1).to(x.dtype)
        vals = torch.cat([cache["v"], v.to(cache["v"].dtype)], 1).to(x.dtype)
        pos_k = torch.cat([k_pos_old, q_pos], dim=1)
    else:
        t_of_slot = slot - cache_index[:, None]                  # (B, S_ctx)
        writes = (t_of_slot >= 0) & (t_of_slot < lengths[:, None])
    src = t_of_slot.clamp(0, s - 1)[:, :, None, None]
    with named_scope("attn.cache_write"):
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            upd = torch.gather(new.to(c.dtype), 1,
                               src.expand(-1, -1, *c.shape[2:]))
            torch.where(writes[:, :, None, None], upd, c, out=c)
    if not local:
        # linear slots' positions are their indices: slots above a query's
        # position (later steps, dropped padding, stale tail) are masked
        keys, vals = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        pos_k = slot.expand(b, s_ctx)
    out = _attend_chunked(q, keys, vals, q_pos, pos_k, cfg, local)
    return out, cache


def softmax_partial(scores, vals, dtype):
    """One chunk of keys' share of ``softmax(scores) @ vals``: (m, l, o),
    the chunk's max score, its sum of exp(s - m) and its exp-weighted sum
    of values (unnormalized). scores (B, KV, G, S, T) f32 over the chunk's
    T keys (masked ones at ``_NEG_INF``); vals (B, T, KV, Dh); o (B, S,
    KV, G, Dh) in ``dtype``."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1, keepdim=True)
    with named_scope("dig_attn"):
        o = torch.einsum("bkgst,btkd->bskgd", e.to(dtype), vals.to(dtype))
    return m, l, o


def merge_partials(m, l, o, reduce_max, reduce_sum):
    """``softmax(scores) @ vals`` over every rank's chunk of keys from this
    rank's ``softmax_partial``: the max M over the chunks
    (``reduce_max``), then the sums of l·e^(m-M) and o·e^(m-M), packed into
    one tensor for one ``reduce_sum``, their quotient in o's dtype."""
    w = torch.exp(m - reduce_max(m))
    lw = l * w                                     # (B, KV, G, S, 1)
    ow = o.to(torch.float32) * w.movedim(-2, -4)   # (B, S, KV, G, Dh)
    both = reduce_sum(torch.cat([lw.flatten(), ow.flatten()]))
    lsum = both[:lw.numel()].view(lw.shape)
    osum = both[lw.numel():].view(ow.shape)
    return (osum / lsum.movedim(-2, -4)).to(o.dtype)


def _decode_attention(q, k, v, x, cache, cache_index, active,
                      cfg: ArchConfig, local: bool, kv_split: bool = False):
    """Single-token decode: write the token's K/V at ``cache_index`` (the
    ring slot ``cache_index mod S_ctx`` for a local layer; clamped to the
    last slot otherwise, as the reference's ``dynamic_update_slice``
    clamps its start), attend over the valid keys. Lanes where ``active``
    is False compute exactly as the others and get their written row
    restored afterwards, which is what the reference engine's per-lane
    cache merge leaves them.

    ``kv_split``: the cache holds this "model" rank's chunk of a global
    KV's context (inside the SPMD program). The rank writes the slots it
    owns, scores its chunk under the same mask and the chunks' softmax
    partials are merged by two all-reduces over "model" (an f32 sum in
    another order than one softmax's)."""
    b = q.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_ctx = cache["k"].shape[1]
    lane = torch.arange(b, device=q.device)
    slot = torch.arange(s_ctx, device=q.device)[None, :]
    if kv_split:
        off = sharding.model_rank() * s_ctx
        write_at = cache_index.clamp(max=s_ctx * sharding.model_shards() - 1)
        own = ((write_at >= off) & (write_at < off + s_ctx))[:, None, None]
        write_at = (write_at - off).clamp(0, s_ctx - 1)
        slot = slot + off
    else:
        write_at = (torch.remainder(cache_index, s_ctx) if local
                    else cache_index.clamp(max=s_ctx - 1))
    kk, vv = cache["k"], cache["v"]
    with named_scope("attn.cache_write"):
        if active is not None or kv_split:
            old_k = kk[lane, write_at].clone()
            old_v = vv[lane, write_at].clone()
        new_k, new_v = k[:, 0].to(kk.dtype), v[:, 0].to(vv.dtype)
        if kv_split:
            new_k = torch.where(own, new_k, old_k)
            new_v = torch.where(own, new_v, old_v)
        kk[lane, write_at] = new_k
        vv[lane, write_at] = new_v
    qg = q.reshape(b, 1, kv, h // kv, dh)
    with named_scope("dig_attn"):
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kk.to(x.dtype))
    scores = scores.to(torch.float32) / math.sqrt(dh)
    if local:
        k_pos = cache_index[:, None] - torch.remainder(
            write_at[:, None] - slot, s_ctx)
        valid = (k_pos >= 0) & (k_pos >= (cache_index
                                          - cfg.window + 1)[:, None])
    else:
        valid = slot <= cache_index[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG_INF)
    if kv_split:
        out = merge_partials(
            *softmax_partial(scores, vv, x.dtype),
            lambda t: sharding.all_reduce_max(t, axes=("model",)),
            lambda t: sharding.all_reduce_sum(t, axes=("model",)))
    else:
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        with named_scope("dig_attn"):
            out = torch.einsum("bkgst,btkd->bskgd", probs, vv.to(x.dtype))
    if active is not None:
        keep = active[:, None, None]
        with named_scope("attn.cache_write"):
            kk[lane, write_at] = torch.where(keep, kk[lane, write_at], old_k)
            vv[lane, write_at] = torch.where(keep, vv[lane, write_at], old_v)
    return out, cache


def attention(
    p,
    x: torch.Tensor,
    cfg: ArchConfig,
    *,
    local: bool,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,
    chunk_lengths: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    kv_split: bool = False,
):
    """GQA attention, full or (``local``) over the last ``cfg.window``
    positions; returns (out, cache).

    Train path: ``cache is None``, causal attention over S.
    Decode path: ``cache`` = {"k", "v": (B, S_ctx, KV, Dh)} (a ring for a
    local layer), S == 1,
    ``cache_index`` (B,) is each lane's write position; ``active`` (B,)
    bool, when given, freezes the caches of the other lanes.
    Chunked-prefill path: ``cache`` plus ``chunk_lengths`` (B,) — S prompt
    tokens written at per-lane offsets ``cache_index + t`` and attended
    causally in one pass; steps at ``t >= chunk_lengths`` never reach the
    cache. ``kv_split``: a decode cache holding this "model" rank's chunk
    of the context (``_decode_attention``).
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cim = cfg.cim
    q, k, v = dense_many(x, cim, "attn_qkv", p["wq"], p["wk"], p["wv"])
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _train_attention(q, k, v, positions, cfg, local)
    elif chunk_lengths is not None:
        out, cache = _chunk_prefill_attention(
            q, k, v, x, cache, cache_index, chunk_lengths, cfg, local)
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per lane, got S={s}")
        out, cache = _decode_attention(q, k, v, x, cache, cache_index,
                                       active, cfg, local, kv_split)
    out = out.reshape(b, s, h * dh)
    return dense(p["wo"], out, cim, "attn_o"), cache


# ------------------------------------------------------------------ MLP
def mlp(p, x, cfg: ArchConfig):
    """The (gated) MLP; inside the SPMD program its hidden stays split over
    "model" through the activation and is gathered before ``wo``."""
    cim = cfg.cim
    if cfg.gated_mlp:
        hidden, gate = dense_many(x, cim, "mlp", p["wi"], p["wg"],
                                  gather=False)
        hidden = silu(gate) * hidden
    else:
        hidden = F.gelu(dense(p["wi"], x, cim, "mlp", gather=False),
                        approximate="tanh")
    return dense_gathered(p["wo"], hidden, p["wi"]["w"].shape[-1], cim, "mlp")
