"""RG-LRU recurrent block (RecurrentGemma / Griffin), serving paths.

    r_t = sigmoid(W_r u_t),  i_t = sigmoid(W_i u_t)
    a_t = exp(-c · softplus(Λ) · r_t)            (per-channel gated decay)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
    out = W_o h_t

preceded by a width-``conv_width`` causal depthwise conv on the x branch.
The port's counterpart of ``repro.models.rglru`` for decode and chunked
prefill: the prefill runs the decode recurrence (``_recurrence_step``)
over the chunk in a Python loop, so a bucketed prefill stays on top of the
token-by-token path. The three input projections and the output
projection are CIM sites ("rglru"), each with its own pre-scale. The
train path (an associative scan) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense

__all__ = ["rglru_decode", "rglru_prefill", "init_rglru_state",
           "init_lam", "softplus", "causal_conv_step"]

_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(exp(x) + 1)`` as the reference takes it (``logaddexp(x, 0)``;
    ``F.softplus`` rounds otherwise for x > 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_lam(width: int) -> torch.Tensor:
    """The reference's fixed Λ (f32, on the CPU): a^c spans (0.9, 0.999)
    at r = 1, the paper's stable range."""
    return torch.log(torch.expm1(-torch.log(
        torch.linspace(0.9, 0.999, width, dtype=torch.float32)) / _C))


def init_rglru_state(cfg: ArchConfig, batch: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> dict:
    """f32 recurrent state ``h`` (B, W) and conv window (B, conv_width - 1,
    W), whatever the caches' dtype."""
    w = cfg.rnn_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=torch.float32, device=device)}


def causal_conv_step(kernel: torch.Tensor, win: torch.Tensor,
                     x_t: torch.Tensor):
    """One step of the depthwise causal conv: the window ``win`` (B, W-1, C)
    extended by ``x_t`` (B, C), summed against ``kernel`` (W, C) in tap
    order. Returns (conv output (B, C), next window)."""
    full = torch.cat([win, x_t[:, None, :].to(win.dtype)], dim=1)
    xc = full[:, 0] * kernel[0]
    for j in range(1, kernel.shape[0]):
        xc = xc + full[:, j] * kernel[j]
    return xc, full[:, 1:]


def _branches(p, u, cfg: ArchConfig):
    x = dense(p["in_proj"], u, cfg.cim, "rglru")
    r = torch.sigmoid(dense(p["gate_r"], u, cfg.cim, "rglru")
                      .to(torch.float32))
    i = torch.sigmoid(dense(p["gate_i"], u, cfg.cim, "rglru")
                      .to(torch.float32))
    log_a = -_C * softplus(p["lam"])[None, None, :] * r          # (B,S,W) <= 0
    return x, i, log_a


def _recurrence_step(kernel, h, win, x_t, i_t, log_a_t):
    """One RG-LRU time step from (h, conv window), shared by decode and
    prefill so that the two cannot drift. x_t / i_t / log_a_t: (B, W).
    Returns (h_new, win_new)."""
    xc, win_new = causal_conv_step(kernel, win, x_t)
    a = torch.exp(log_a_t)
    h_new = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i_t * xc)
    return h_new, win_new


def rglru_decode(p, u: torch.Tensor, cfg: ArchConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """One token per lane: u (B, 1, D) -> (out (B, 1, D), new state)."""
    if u.shape[1] != 1:
        raise ValueError(f"decode takes one token per lane, got S={u.shape[1]}")
    x, i, log_a = _branches(p, u, cfg)
    kernel = p["conv"].to(torch.float32)
    h_new, win_new = _recurrence_step(kernel, state["h"], state["conv"],
                                      x[:, 0], i[:, 0], log_a[:, 0])
    out = dense(p["out_proj"], h_new[:, None, :].to(u.dtype), cfg.cim,
                "rglru")
    return out, {"h": h_new, "conv": win_new}


def rglru_prefill(p, u: torch.Tensor, cfg: ArchConfig, state: dict,
                  length: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Chunked prefill: the decode recurrence over u (B, S, D).

    ``length`` (B,) counts the valid leading tokens per lane; steps at
    ``t >= length`` leave the state and the conv window as they were, so
    right-padded buckets and untouched lanes (length 0) keep ``state``
    bitwise. The projections run once over the whole chunk.
    """
    s = u.shape[1]
    x, i, log_a = _branches(p, u, cfg)
    kernel = p["conv"].to(torch.float32)
    valid = torch.arange(s, device=u.device)[None, :] < length[:, None]
    h, win = state["h"], state["conv"]
    hs = []
    for t in range(s):
        h_new, win_new = _recurrence_step(kernel, h, win, x[:, t], i[:, t],
                                          log_a[:, t])
        v_t = valid[:, t]
        h = torch.where(v_t[:, None], h_new, h)
        win = torch.where(v_t[:, None, None], win_new, win)
        hs.append(h)
    h_seq = torch.stack(hs, dim=1).to(u.dtype)                   # (B, S, W)
    out = dense(p["out_proj"], h_seq, cfg.cim, "rglru")
    return out, {"h": h, "conv": win}
