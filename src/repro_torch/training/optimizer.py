"""AdamW with a warmup-cosine schedule and global-norm clipping, Adafactor,
and int8 error-feedback gradient compression; the port's counterpart of
``repro.training.optimizer``.

Pure functions on trees of tensors (``repro_torch.tree``), not
``torch.optim``: the state is ``{"m", "v", "count"[, "err"]}`` (AdamW) or
``{"vr", "vc", "count"[, "err"]}`` (Adafactor) mirroring the parameter
tree, so a step maps onto the reference's one to one, the state can be
compared with it, and a checkpoint holds it as it holds the parameters.
Everything is computed in f32 on the parameters' device, the step count
included, so a step never waits for the host.

The port keeps one tensor per layer where the reference stacks its
super-blocks along a leading axis: a per-layer norm or bias is a vector
here (no weight decay, an unfactored Adafactor moment) and a matrix of
stacked vectors there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "init_opt_state", "apply_updates", "schedule",
           "compress_grads", "decompress_grads"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: bool = False     # int8 error-feedback compression
    # "adamw": m and v in f32 (8 B a parameter); "adafactor": a factored
    # second moment (row and column means) for matrices, no first moment
    algorithm: str = "adamw"


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup to
    ``cfg.lr``, then a cosine down to a tenth of it at ``total_steps``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, step) * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments (f32, on each parameter's device, placed as it is when
    it is a DTensor) and a zero count."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    if cfg.algorithm == "adafactor":
        def vrow(p):
            return zeros32(p[..., 0] if p.dim() >= 2 else p)

        def vcol(p):
            if p.dim() >= 2:
                return zeros32(p[..., 0, :])
            return torch.zeros((1,), dtype=torch.float32, device=p.device)

        state = {"vr": tree_map(vrow, params), "vc": tree_map(vcol, params),
                 "count": count}
    elif cfg.algorithm == "adamw":
        state = {"m": tree_map(zeros32, params),
                 "v": tree_map(zeros32, params), "count": count}
    else:
        raise ValueError(f"unknown optimizer algorithm {cfg.algorithm!r}")
    if cfg.grad_compression:
        state["err"] = tree_map(zeros32, params)
    return state


# ---------------------------------------------------------- compression
def compress_grads(grads, err):
    """int8 per-tensor quantization with error feedback: (int8 tree, scales
    tree, new residuals). The residual re-enters at the next step."""
    def one(g, e):
        g = g.to(torch.float32) + e
        scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale, g - q.to(torch.float32) * scale

    out = tree_map(one, grads, err)
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def _pick(tree, i):
    """The ``i``-th entry of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.to(torch.float32) * s, q, scales)


# ---------------------------------------------------------- update
def apply_updates(params, grads, state: dict,
                  cfg: OptimizerConfig) -> Tuple[dict, dict, dict]:
    """One step: (new params, new state, {"grad_norm", "lr"}). The
    gradients are clipped to ``clip_norm`` by their global norm; weight
    decay is decoupled and applies to matrices only."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in tree_leaves(grads)))
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    c = count.to(torch.float32)
    if cfg.algorithm == "adafactor":
        return _apply_adafactor(params, grads, state, cfg, count, lr, clip,
                                gnorm)
    bc1 = 1 - _f32(cfg.b1, c) ** c
    bc2 = 1 - _f32(cfg.b2, c) ** c

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = dict(state, m=_pick(out, 1), v=_pick(out, 2), count=count)
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _apply_adafactor(params, grads, state, cfg, count, lr, clip, gnorm):
    """Adafactor (Shazeer & Stern): a rank-1 factored second moment for
    matrices, no first moment, the update's RMS clipped to 1."""
    b2 = 1.0 - count.to(torch.float32) ** -0.8
    eps = 1e-30

    def upd(p, g, vr, vc):
        g = g.to(torch.float32) * clip
        g2 = torch.square(g) + eps
        if p.dim() >= 2:
            vr_n = b2 * vr + (1 - b2) * torch.mean(g2, dim=-1)
            vc_n = b2 * vc + (1 - b2) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr_n, dim=-1, keepdim=True),
                                min=eps)
            vhat = (vr_n[..., None] * vc_n[..., None, :]) / denom[..., None]
            step = g / torch.sqrt(vhat + eps)
        else:
            vr_n = b2 * vr + (1 - b2) * g2
            vc_n = vc
            step = g / torch.sqrt(vr_n + eps)
        rms = torch.sqrt(torch.mean(torch.square(step)) + eps)
        step = step / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), vr_n, vc_n

    out = tree_map(upd, params, grads, state["vr"], state["vc"])
    new_state = dict(state, vr=_pick(out, 1), vc=_pick(out, 2), count=count)
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}
