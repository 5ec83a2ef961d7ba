"""AdamW with linear warmup, a cosine to a tenth of the rate, global-norm
clipping and decoupled weight decay on matrices, on nested dicts of
tensors. The step count, the rate and the bias corrections are float32
tensors on the parameters' device, as everything else."""
from __future__ import annotations

import math

import torch

from perfbench.reference.weights import leaves


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def init_state(params) -> dict:
    dev = next(leaves(params))[1].device
    return {"m": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
            "v": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(value, like):
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def lr_at(opt: dict, count: torch.Tensor) -> torch.Tensor:
    s = count.to(torch.float32)
    warm = torch.clamp(s / max(opt["warmup_steps"], 1), max=1.0)
    prog = torch.clamp((s - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, s) * prog))
    return opt["lr"] * warm * (0.1 + 0.9 * cos)


def step(params, grads, state: dict, opt: dict):
    """(new params, new state, the gradients as the update takes them,
    clipped)."""
    count = state["count"] + 1
    lr = lr_at(opt, count)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for _, g in leaves(grads)))
    clip = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    c = count.to(torch.float32)
    b1, b2 = opt["b1"], opt["b2"]
    bc1 = 1 - _f32(b1, c) ** c
    bc2 = 1 - _f32(b2, c) ** c

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        s = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        if p.dim() >= 2:
            s = s + opt["weight_decay"] * p.to(torch.float32)
        return (p.to(torch.float32) - lr * s).to(p.dtype), m, v, g

    out = _map(upd, params, grads, state["m"], state["v"])
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                            "count": count}, _pick(out, 3))
