"""Transformer layers of the port: RMSNorm, rotary embeddings, GQA
attention, full and sliding-window (train, single-token decode and
chunked-prefill paths), and MLPs.

Every projection goes through ``kernels.ops.cim_matmul`` with a site label,
so the GR-CIM numerics apply per site as in ``repro.models.layers``.
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
from repro_torch.kernels.ops import cim_matmul
from repro_torch.kernels.packed import PackedWeight

__all__ = ["dense", "rmsnorm", "rope", "silu", "attention", "mlp"]

_NEG_INF = -1e30


def dense(p, x, cim: Optional[CIMConfig] = None, site: str = "mlp",
          logical_n: Optional[int] = None):
    """x @ W (+ b), through the CIM simulation resolved for this site.
    ``W`` is a tensor or, in served params, a ``PackedWeight``."""
    w = p["w"]
    y = cim_matmul(x, w if isinstance(w, PackedWeight) else w.to(x.dtype),
                   cim, site=site, logical_n=logical_n)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return ((x32 / rms) * p["g"].to(torch.float32)).to(x.dtype)


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
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kk).to(torch.float32)
        scores = scores / math.sqrt(dh)
        mask = _attn_mask(pos_c, pos_k, cfg.window, local)     # (B, C, Sk)
        scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
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
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        upd = torch.gather(new.to(c.dtype), 1, src.expand(-1, -1, *c.shape[2:]))
        torch.where(writes[:, :, None, None], upd, c, out=c)
    if not local:
        # linear slots' positions are their indices: slots above a query's
        # position (later steps, dropped padding, stale tail) are masked
        keys, vals = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        pos_k = slot.expand(b, s_ctx)
    out = _attend_chunked(q, keys, vals, q_pos, pos_k, cfg, local)
    return out, cache


def _decode_attention(q, k, v, x, cache, cache_index, active,
                      cfg: ArchConfig, local: bool):
    """Single-token decode: write the token's K/V at ``cache_index`` (the
    ring slot ``cache_index mod S_ctx`` for a local layer; clamped to the
    last slot otherwise, as the reference's ``dynamic_update_slice``
    clamps its start), attend over the valid keys. Lanes where ``active``
    is False compute exactly as the others and get their written row
    restored afterwards, which is what the reference engine's per-lane
    cache merge leaves them."""
    b = q.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_ctx = cache["k"].shape[1]
    lane = torch.arange(b, device=q.device)
    slot = torch.arange(s_ctx, device=q.device)[None, :]
    write_at = (torch.remainder(cache_index, s_ctx) if local
                else cache_index.clamp(max=s_ctx - 1))
    kk, vv = cache["k"], cache["v"]
    if active is not None:
        old_k, old_v = kk[lane, write_at].clone(), vv[lane, write_at].clone()
    kk[lane, write_at] = k[:, 0].to(kk.dtype)
    vv[lane, write_at] = v[:, 0].to(vv.dtype)
    qg = q.reshape(b, 1, kv, h // kv, dh)
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
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vv.to(x.dtype))
    if active is not None:
        keep = active[:, None, None]
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
    cache.
    """
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cim = cfg.cim
    q = dense(p["wq"], x, cim, "attn_qkv").reshape(b, s, h, dh)
    k = dense(p["wk"], x, cim, "attn_qkv").reshape(b, s, kv, dh)
    v = dense(p["wv"], x, cim, "attn_qkv").reshape(b, s, kv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _attend_chunked(q, k, v, positions, positions, cfg, local)
    elif chunk_lengths is not None:
        out, cache = _chunk_prefill_attention(
            q, k, v, x, cache, cache_index, chunk_lengths, cfg, local)
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per lane, got S={s}")
        out, cache = _decode_attention(q, k, v, x, cache, cache_index,
                                       active, cfg, local)
    out = out.reshape(b, s, h * dh)
    return dense(p["wo"], out, cim, "attn_o"), cache


# ------------------------------------------------------------------ MLP
def mlp(p, x, cfg: ArchConfig):
    cim = cfg.cim
    hidden = dense(p["wi"], x, cim, "mlp")
    if cfg.gated_mlp:
        hidden = silu(dense(p["wg"], x, cim, "mlp")) * hidden
    else:
        hidden = F.gelu(hidden, approximate="tanh")
    return dense(p["wo"], hidden, cim, "mlp")
