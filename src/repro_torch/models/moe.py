"""Mixture-of-Experts FFN: top-k token-choice routing with a fixed expert
capacity, on one device.

The port's counterpart of ``repro.models.moe`` without its grouped
``shard_map`` dispatch (that waits for the parallel slice): every token of
the flattened batch routes into one (E, cap, D) buffer.

Routing runs in f32 whatever the model dtype: the router is a CIM site
(``moe_router``) whose weight is f32, then a softmax, the top-k choice
(ties to the lower expert index, as ``jax.lax.top_k`` breaks them) and the
gates renormalized over the k choices. Assignments fill their expert's
capacity in token-major, k-minor order; those past the capacity, and
every assignment of a token outside ``valid``, are dropped and combine to
zero. The expert products are digital batched matmuls, as in the
reference, and record their logical contracts (t * k routed rows) into the
cost ledger. Arctic's ``moe_dense_residual`` adds a dense MLP (site
``mlp``) in parallel. The aux load-balancing loss is E * sum_e f_e * p_e
over the top-1 choice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costs
from repro_torch.models import layers as L

__all__ = ["init_moe", "moe", "capacity", "route", "dispatch", "combine"]


def init_moe(cfg: ArchConfig, normal, dense, mlp) -> dict:
    """An MoE layer's params with the reference's shapes and scales: the
    router (D, E) in f32 whatever the model dtype; the experts' ``wi`` /
    ``wg`` (E, D, F) at 1/sqrt(D) and ``wo`` (E, F, D) at 1/sqrt(2 F
    n_layers); arctic's dense residual MLP. ``normal(shape, scale)``,
    ``dense(d_in, d_out, dtype=...)`` and ``mlp()`` are the caller's
    seeded draws."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    scale_in = 1.0 / math.sqrt(d)
    p = {"router": dense(d, e, dtype=torch.float32),
         "experts": {"wi": normal((e, d, f), scale_in),
                     "wo": normal((e, f, d), 1.0 / math.sqrt(
                         f * 2 * cfg.n_layers))}}
    if cfg.gated_mlp:
        p["experts"]["wg"] = normal((e, d, f), scale_in)
    if cfg.moe_dense_residual:
        p["dense_mlp"] = mlp()
    return p


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``t`` routed tokens (invalid ones included)."""
    return max(4, int(math.ceil(t * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def route(p, xf: torch.Tensor, cfg: ArchConfig):
    """(T, D) -> router probs (T, E), renormalized gates (T, k) and expert
    ids (T, k), all in f32 but the ids. Among equal probabilities the lower
    expert index comes first (a stable sort), as ``jax.lax.top_k`` orders
    them; ``torch.topk`` promises no order there."""
    logits = L.dense(p["router"], xf.to(torch.float32), cfg.cim,
                     "moe_router")
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :cfg.top_k], expert_idx[:, :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def dispatch(xf: torch.Tensor, expert_idx: torch.Tensor, valid: torch.Tensor,
             e: int, cap: int):
    """(T, D), (T, k) -> buffer (E, cap, D), slot (T*k,), keep (T*k,).

    Each assignment's position in its expert is the count of earlier
    assignments (token-major, k-minor) to the same expert; it is kept when
    that position is below ``cap`` and its token is ``valid``. Kept
    assignments own distinct slots, so they are written without
    accumulation (no atomics: the buffer repeats bitwise); dropped ones go
    to a spare row that is cut off."""
    t, d = xf.shape
    k = expert_idx.shape[-1]
    flat_expert = expert_idx.reshape(-1)                          # (T*k,)
    flat_valid = valid.repeat_interleave(k)                       # (T*k,)
    eq = F.one_hot(flat_expert, e) * flat_valid[:, None]          # (T*k, E)
    position = ((torch.cumsum(eq, dim=0) - eq) * eq).sum(dim=-1)
    keep = (position < cap) & flat_valid
    slot = flat_expert * cap + torch.clamp(position, max=cap - 1)
    src = xf.repeat_interleave(k, dim=0)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((torch.where(keep, slot, e * cap),), src)
    return buf[:e * cap].view(e, cap, d), slot, keep


def combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            gates: torch.Tensor, k: int) -> torch.Tensor:
    """Buffer (E, cap, D) -> tokens (T, D): each kept assignment's row
    times its gate, summed over the token's k choices."""
    e, cap, d = out_buf.shape
    gathered = torch.where(keep[:, None], out_buf.reshape(e * cap, d)[slot],
                           0.0)
    weighted = gathered * gates.reshape(-1, 1).to(out_buf.dtype)
    return weighted.reshape(-1, k, d).sum(dim=1)


def moe(p, x: torch.Tensor, cfg: ArchConfig,
        valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balancing loss, f32).

    ``valid`` (B, S) marks the real tokens; the others take no capacity and
    combine to zero. None means all, as in decode, where the inactive
    slots route and take capacity like the others (the reference's
    decode has no mask either)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    vf = (torch.ones((t,), dtype=torch.bool, device=x.device)
          if valid is None else valid.reshape(t).to(torch.bool))
    probs, gate_vals, expert_idx = route(p, xf, cfg)
    f_e = F.one_hot(expert_idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))

    buf, slot, keep = dispatch(xf, expert_idx, vf, e, capacity(t, cfg))
    # the ledger counts the logical routed compute, t * k assignments
    # through each expert matmul, not the (E, cap) buffer; the products
    # stay digital, priced at the "moe_expert" site's design
    f = cfg.expert_d_ff
    eff = cfg.cim.for_site("moe_expert")
    for _ in range(2 if cfg.gated_mlp else 1):
        costs.record_matmul("moe_expert", t * k, d, f, eff)
    costs.record_matmul("moe_expert", t * k, f, d, eff)
    ex = p["experts"]
    h = torch.bmm(buf, ex["wi"].to(x.dtype))
    if cfg.gated_mlp:
        h = L.silu(torch.bmm(buf, ex["wg"].to(x.dtype))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, ex["wo"].to(x.dtype))
    out = combine(out_buf, slot, keep, gate_vals, k).reshape(b, s, d)
    if cfg.moe_dense_residual:
        out = out + L.mlp(p["dense_mlp"], x, cfg)
    return out, aux
