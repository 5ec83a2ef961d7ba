"""Mamba2 SSD block, serving paths.

Per head h with scalar decay a_t = exp(-dt_t · A_h):

    H_t = a_t · H_{t-1} + dt_t · B_t ⊗ x_t          (N × P state)
    y_t = C_tᵀ H_t + D_h · x_t

The port's counterpart of ``repro.models.ssm`` for decode and chunked
prefill: the prefill runs the decode recurrence (``_recurrence_step``)
over the chunk in a Python loop, so a bucketed prefill reproduces the
token-by-token state trajectory. The four projections are CIM sites
("ssm"). The train path (the chunked SSD dual form) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, rmsnorm, silu
from repro_torch.models.rglru import causal_conv_step, softplus

__all__ = ["ssm_decode", "ssm_prefill", "init_ssm_state"]


def init_ssm_state(cfg: ArchConfig, batch: int,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """f32 state ``h`` (B, NH, N, P) and conv window (B, conv_width - 1,
    d_inner), whatever the caches' dtype."""
    return {"h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_headdim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=torch.float32, device=device)}


def _project(p, u, cfg: ArchConfig):
    """The projection head. u: (B, S, D) -> z, x, B, C, dt."""
    di, n = cfg.d_inner, cfg.ssm_state
    zx = dense(p["in_proj"], u, cfg.cim, "ssm")
    z, x = zx[..., :di], zx[..., di:]
    bc = dense(p["bc_proj"], u, cfg.cim, "ssm").to(torch.float32)
    bmat, cmat = bc[..., :n], bc[..., n:]                        # (B,S,N) each
    dt = dense(p["dt_proj"], u, cfg.cim, "ssm").to(torch.float32)
    dt = softplus(dt + p["dt_bias"][None, None, :])              # (B,S,NH)
    return z, x, bmat, cmat, dt


def _recurrence_step(p, cfg: ArchConfig, kernel, a_rate, h, win, x_t, b_t,
                     c_t, dt_t):
    """One SSD time step from (h, conv window), shared by decode and
    prefill so that the two cannot drift. x_t (B, di), b_t / c_t (B, N),
    dt_t (B, NH). Returns (h_new, win_new, y) with y (B, NH, P) before the
    gate and the norm."""
    b = x_t.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    xc, win_new = causal_conv_step(kernel, win, x_t)
    xh = silu(xc).reshape(b, nh, hd).to(torch.float32)
    a = torch.exp(-dt_t * a_rate)                                # (B, NH)
    dbx = (dt_t[:, :, None, None] * b_t[:, None, :, None]) * xh[:, :, None, :]
    h_new = a[..., None, None] * h + dbx
    y = torch.einsum("bn,bhnp->bhp", c_t, h_new)
    y = y + p["D"][None, :, None] * xh
    return h_new, win_new, y


def _out(p, y, z, u, cfg: ArchConfig):
    """The gated RMSNorm and the output projection. y: (B, S, d_inner)."""
    y = rmsnorm(p["out_norm"], y.to(u.dtype) * silu(z))
    return dense(p["out_proj"], y, cfg.cim, "ssm")


def ssm_decode(p, u: torch.Tensor, cfg: ArchConfig,
               state: dict) -> Tuple[torch.Tensor, dict]:
    """One token per lane: u (B, 1, D) -> (out (B, 1, D), new state)."""
    b, s = u.shape[:2]
    if s != 1:
        raise ValueError(f"decode takes one token per lane, got S={s}")
    z, x, bmat, cmat, dt = _project(p, u, cfg)
    kernel = p["conv"].to(torch.float32)
    a_rate = torch.exp(p["A_log"])[None, :]
    h_new, win_new, y = _recurrence_step(
        p, cfg, kernel, a_rate, state["h"], state["conv"], x[:, 0],
        bmat[:, 0], cmat[:, 0], dt[:, 0])
    out = _out(p, y.reshape(b, 1, cfg.d_inner), z, u, cfg)
    return out, {"h": h_new, "conv": win_new}


def ssm_prefill(p, u: torch.Tensor, cfg: ArchConfig, state: dict,
                length: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Chunked prefill: the decode recurrence over u (B, S, D).

    ``length`` (B,) counts the valid leading tokens per lane; steps at
    ``t >= length`` leave the SSM state and the conv window as they were
    (length-0 lanes keep ``state`` bitwise). The projections run once over
    the whole chunk.
    """
    b, s = u.shape[:2]
    z, x, bmat, cmat, dt = _project(p, u, cfg)
    kernel = p["conv"].to(torch.float32)
    a_rate = torch.exp(p["A_log"])[None, :]
    valid = torch.arange(s, device=u.device)[None, :] < length[:, None]
    h, win = state["h"], state["conv"]
    ys = []
    for t in range(s):
        h_new, win_new, y = _recurrence_step(
            p, cfg, kernel, a_rate, h, win, x[:, t], bmat[:, t], cmat[:, t],
            dt[:, t])
        v_t = valid[:, t]
        h = torch.where(v_t[:, None, None, None], h_new, h)
        win = torch.where(v_t[:, None, None], win_new, win)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, cfg.d_inner)
    return _out(p, y, z, u, cfg), {"h": h, "conv": win}
