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
train path (``rglru_train``, no cache) runs the recurrence as an
associative scan over time, in the order ``jax.lax.associative_scan``
combines (``associative_scan``). Inside the SPMD program of
``parallel.sharding`` a width that divides "model" is split over it: the
input projections give this rank's channels, the conv, the gates and the
recurrence run on them (each acts per channel), the state is this rank's
chunk, and h is gathered before the output projection.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_gathered, dense_many
from repro_torch.parallel import sharding

__all__ = ["rglru_train", "rglru_decode", "rglru_prefill",
           "init_rglru_state", "init_lam", "softplus", "causal_conv",
           "causal_conv_step", "associative_scan"]

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


def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over a whole sequence: x (B, S, C) left
    padded by W - 1 zeros, summed against ``kernel`` (W, C) tap by tap."""
    w, s = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + xp[:, i:i + s] * kernel[i]
    return out


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (even has as many
    entries as odd, or one more)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1)


def associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive scan of ``fn`` (associative, on tuples of tensors) along
    dim 1, combining in the order ``jax.lax.associative_scan`` does: scan
    the pairwise reduction of adjacent entries recursively (the odd
    outputs), then combine each with the next even input."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[:, 0:n - 1:2] for e in elems),
                                  tuple(e[:, 1::2] for e in elems)))
    head = odd if n % 2 else tuple(e[:, :-1] for e in odd)
    even = fn(head, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _channels(t, cfg: ArchConfig):
    """A per-channel parameter (the conv kernel, Λ; channels last) as the
    channels this rank runs: its chunk where the width splits."""
    if sharding.splits(cfg.rnn_width):
        return sharding.split_model(t, -1)
    return sharding.gather_full(t)


def _branches(p, u, cfg: ArchConfig):
    x, r, i = dense_many(u, cfg.cim, "rglru", p["in_proj"], p["gate_r"],
                         p["gate_i"], gather=False)
    r = torch.sigmoid(r.to(torch.float32))
    i = torch.sigmoid(i.to(torch.float32))
    lam = _channels(p["lam"], cfg)
    log_a = -_C * softplus(lam)[None, None, :] * r               # (B,S,W) <= 0
    return x, i, log_a


def _out(p, h, u, cfg: ArchConfig):
    """The output projection of h (B, S, W, or this rank's channels)."""
    return dense_gathered(p["out_proj"], h.to(u.dtype), cfg.rnn_width,
                          cfg.cim, "rglru")


def rglru_train(p, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The whole sequence at once (no cache): u (B, S, D) -> (B, S, D),
    the recurrence h_t = a_t h_{t-1} + b_t as an associative scan over
    the pairs (a, b) from a zero state."""
    x, i, log_a = _branches(p, u, cfg)
    x = causal_conv(x, _channels(p["conv"], cfg).to(x.dtype))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (
        i * x.to(torch.float32))

    def combine(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return a1 * a2, a2 * b1 + b2

    _, h = associative_scan(combine, (a, gated))
    return _out(p, h, u, cfg)


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
    kernel = _channels(p["conv"], cfg).to(torch.float32)
    h_new, win_new = _recurrence_step(kernel, state["h"], state["conv"],
                                      x[:, 0], i[:, 0], log_a[:, 0])
    return _out(p, h_new[:, None, :], u, cfg), {"h": h_new, "conv": win_new}


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
    kernel = _channels(p["conv"], cfg).to(torch.float32)
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
    return _out(p, torch.stack(hs, dim=1), u, cfg), {"h": h, "conv": win}
