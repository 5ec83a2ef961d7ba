"""Mamba2 SSD block, serving paths.

Per head h with scalar decay a_t = exp(-dt_t · A_h):

    H_t = a_t · H_{t-1} + dt_t · B_t ⊗ x_t          (N × P state)
    y_t = C_tᵀ H_t + D_h · x_t

The port's counterpart of ``repro.models.ssm`` for decode and chunked
prefill: both run one recurrence step by step, so a bucketed prefill
reproduces the token-by-token state trajectory. On the card a layer's
recurrence over a whole dispatch (S = 1 in decode) is one launch of the
hand-written scan ``kernels.ssm_scan`` (under the scope ``ssm.scan``); on
the CPU and on ``meta`` it is ``_loop``, its plain version, which calls
``_recurrence_step`` once a step. The scan keeps the loop's state and
conv window bit for bit, and its y too at the engine's 8 lanes, where it
sums over the state in the order cuBLAS takes for the loop's einsum (at
other lane counts that sum runs in another order). The choice is by
device alone. The four projections are CIM sites
("ssm"). The train path (``ssm_train``, no cache) is the chunked SSD
algorithm (arXiv:2405.21060 §6): within a chunk of ``ssm_chunk`` steps the
dual quadratic (attention-like) form, across chunks a scan over the chunk
states. Its f32 sums run in another order than the recurrence's. The
SSD contractions are digital by design and run under the ``dig_ssm_ssd``
scope (``core.scopes``; the audit's declaration). Inside the SPMD program
of ``parallel.sharding`` heads that divide "model" are split over it:
``in_proj`` gives this rank's columns of z and of x, ``dt_proj`` its
heads' dt, B and C are gathered whole, the conv, the SSD and the state
run on this rank's heads, and y is gathered before the gated norm.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scopes import named_scope
from repro_torch.kernels import ssm_scan as scan
from repro_torch.models.layers import (dense, dense_many, rmsnorm, silu,
                                      whole)
from repro_torch.models.rglru import causal_conv, causal_conv_step, softplus
from repro_torch.parallel import sharding

__all__ = ["ssm_train", "ssm_decode", "ssm_prefill", "init_ssm_state"]


def init_ssm_state(cfg: ArchConfig, batch: int,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """f32 state ``h`` (B, NH, N, P) and conv window (B, conv_width - 1,
    d_inner), whatever the caches' dtype."""
    return {"h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_headdim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=torch.float32, device=device)}


def _heads(t, cfg: ArchConfig):
    """A per-head parameter (``A_log``, ``D``, ``dt_bias``; the conv kernel
    over the channels, channels last) as this rank's heads: its chunk
    where the heads split over "model"."""
    if sharding.splits(cfg.ssm_heads):
        return sharding.split_model(t, -1)
    return sharding.gather_full(t)


def _project(p, u, cfg: ArchConfig):
    """The projection head. u: (B, S, D) -> z, x (this rank's heads'
    channels), B, C (whole) and dt (this rank's heads)."""
    n = cfg.ssm_state
    split = sharding.splits(cfg.ssm_heads)
    zx, bc, dt = dense_many(
        u, cfg.cim, "ssm",
        (p["in_proj"], dict(gather=False, split=split,
                            groups=2 if split else 1)),
        p["bc_proj"], (p["dt_proj"], dict(gather=False)))
    di = zx.shape[-1] // 2
    z, x = zx[..., :di], zx[..., di:]
    bc = bc.to(torch.float32)
    if split:
        # every head reads B and C: their gradient sums over the heads' ranks
        bc = sharding.copy_to_model(bc)
    bmat, cmat = bc[..., :n], bc[..., n:]                        # (B,S,N) each
    dt = softplus(dt.to(torch.float32) + _heads(p["dt_bias"], cfg)[None, None, :])  # (B,S,NH)
    return z, x, bmat, cmat, dt


def ssm_train(p, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The whole sequence at once (no cache), from a zero state: u (B, S, D)
    -> (B, S, D); S must be a multiple of ``ssm_chunk``. The SSD
    contractions are digital (data-dependent, never on a CIM array)."""
    b, s = u.shape[:2]
    n, hd, ck = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_chunk
    if s % ck:
        raise ValueError(f"seq {s} must be a multiple of ssm_chunk {ck}")
    nc = s // ck
    z, x, bmat, cmat, dt = _project(p, u, cfg)
    # SSD is parallel over heads: this rank's heads (all without a split)
    nh, di = dt.shape[-1], x.shape[-1]
    x = silu(causal_conv(x, _heads(p["conv"], cfg).to(x.dtype)))
    xh = x.reshape(b, s, nh, hd).to(torch.float32)
    log_a = -dt * torch.exp(_heads(p["A_log"], cfg))[None, None, :]  # <= 0
    xc = xh.reshape(b, nc, ck, nh, hd)
    bc_ = bmat.reshape(b, nc, ck, n)
    cc_ = cmat.reshape(b, nc, ck, n)
    dtc = dt.reshape(b, nc, ck, nh)
    cum = torch.cumsum(log_a.reshape(b, nc, ck, nh), dim=2)      # (B,NC,CK,NH)
    # intra-chunk: decay(i <- j) = exp(cum_i - cum_j) for i >= j, masked
    # before the exp (the other side would overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,NC,i,j,NH)
    ii = torch.arange(ck, device=u.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    with named_scope("dig_ssm_ssd"):
        cb = torch.einsum("bgin,bgjn->bgij", cc_, bc_)
    att = cb[..., None] * decay * dtc[:, :, None, :, :]          # (B,NC,i,j,NH)
    with named_scope("dig_ssm_ssd"):
        y_intra = torch.einsum("bgijh,bgjhp->bgihp", att, xc)
    # chunk states, carried across chunks by a scan
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc              # (B,NC,CK,NH)
    with named_scope("dig_ssm_ssd"):
        chunk_state = torch.einsum("bgjh,bgjn,bgjhp->bghnp", tail, bc_, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,NC,NH)
    h = torch.zeros((b, nh, n, hd), dtype=torch.float32, device=u.device)
    before = []
    for g in range(nc):
        before.append(h)                     # the state before chunk g
        h = chunk_decay[:, g, :, None, None] * h + chunk_state[:, g]
    h_before = torch.stack(before, dim=1)                        # (B,NC,NH,N,P)
    decay_in = torch.exp(cum)
    with named_scope("dig_ssm_ssd"):
        y_inter = torch.einsum("bgin,bgih,bghnp->bgihp", cc_, decay_in,
                               h_before)
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    y = y + _heads(p["D"], cfg)[None, None, :, None] * xh
    return _out(p, y.reshape(b, s, di), z, u, cfg)


def _recurrence_step(d_skip, hd: int, kernel, a_rate, h, win, x_t, b_t,
                     c_t, dt_t):
    """One SSD time step from (h, conv window), shared by decode and
    prefill so that the two cannot drift. x_t (B, NH * P), b_t / c_t (B,
    N), dt_t (B, NH), ``d_skip`` (NH,) the heads' D. Returns (h_new,
    win_new, y) with y (B, NH, P) before the gate and the norm."""
    b, nh = x_t.shape[0], dt_t.shape[-1]
    xc, win_new = causal_conv_step(kernel, win, x_t)
    xh = silu(xc).reshape(b, nh, hd).to(torch.float32)
    a = torch.exp(-dt_t * a_rate)                                # (B, NH)
    dbx = (dt_t[:, :, None, None] * b_t[:, None, :, None]) * xh[:, :, None, :]
    h_new = a[..., None, None] * h + dbx
    with named_scope("dig_ssm_ssd"):
        y = torch.einsum("bn,bhnp->bhp", c_t, h_new)
    y = y + d_skip[None, :, None] * xh
    return h_new, win_new, y


def _out(p, y, z, u, cfg: ArchConfig):
    """The gated RMSNorm (over the whole width: this rank's channels are
    gathered) and the output projection. y: (B, S, d_inner or this rank's
    channels)."""
    y = whole(y.to(u.dtype) * silu(z), cfg.d_inner)
    return dense(p["out_proj"], rmsnorm(p["out_norm"], y), cfg.cim, "ssm")


def _step_params(p, cfg: ArchConfig):
    """The recurrence's per-head parameters: (D, conv kernel, decay rate)
    of this rank's heads."""
    return (_heads(p["D"], cfg), _heads(p["conv"], cfg).to(torch.float32),
            torch.exp(_heads(p["A_log"], cfg))[None, :])


def _loop(d_skip, hd: int, kernel, a_rate, h, win, x, bmat, cmat, dt,
          length=None):
    """The recurrence over a dispatch step by step (the scan's plain
    version): x (B, S, NH * P), bmat / cmat (B, S, N), dt (B, S, NH); steps
    at ``t >= length`` give their y but leave h and the conv window as they
    were (``length`` None: every step commits). Returns (y (B, S, NH * P),
    h, win)."""
    b, s = x.shape[:2]
    valid = (None if length is None else
             torch.arange(s, device=x.device)[None, :] < length[:, None])
    ys = []
    for t in range(s):
        with named_scope("ssm.step"):
            h_new, win_new, y = _recurrence_step(
                d_skip, hd, kernel, a_rate, h, win, x[:, t], bmat[:, t],
                cmat[:, t], dt[:, t])
        if valid is None:
            h, win = h_new, win_new
        else:
            v_t = valid[:, t]
            h = torch.where(v_t[:, None, None, None], h_new, h)
            win = torch.where(v_t[:, None, None], win_new, win)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, -1), h, win


def _recurrence(d_skip, hd: int, kernel, a_rate, h, win, x, bmat, cmat, dt,
                length=None):
    """A layer's recurrence over a dispatch: one launch of the card's scan
    for CUDA tensors, ``_loop`` on the CPU and ``meta``; the device alone
    decides. ``length`` None is decode's one step, which commits and is an
    ``ssm.step`` on either device. Returns (y, h, win) as ``_loop``."""
    if not scan.applies(x.device):
        return _loop(d_skip, hd, kernel, a_rate, h, win, x, bmat, cmat, dt,
                     length)
    step = (named_scope("ssm.step") if length is None
            else contextlib.nullcontext())
    with step, named_scope("dig_ssm_ssd"), named_scope("ssm.scan"):
        return scan.ssm_scan(x, bmat, cmat, dt, a_rate, d_skip, kernel, h,
                             win, length)


def ssm_decode(p, u: torch.Tensor, cfg: ArchConfig,
               state: dict) -> Tuple[torch.Tensor, dict]:
    """One token per lane: u (B, 1, D) -> (out (B, 1, D), new state)."""
    s = u.shape[1]
    if s != 1:
        raise ValueError(f"decode takes one token per lane, got S={s}")
    z, x, bmat, cmat, dt = _project(p, u, cfg)
    d_skip, kernel, a_rate = _step_params(p, cfg)
    y, h_new, win_new = _recurrence(d_skip, cfg.ssm_headdim, kernel, a_rate,
                                    state["h"], state["conv"], x, bmat,
                                    cmat, dt)
    out = _out(p, y, z, u, cfg)
    return out, {"h": h_new, "conv": win_new}


def ssm_prefill(p, u: torch.Tensor, cfg: ArchConfig, state: dict,
                length: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Chunked prefill: the decode recurrence over u (B, S, D).

    ``length`` (B,) counts the valid leading tokens per lane; steps at
    ``t >= length`` leave the SSM state and the conv window as they were
    (length-0 lanes keep ``state`` bitwise). The projections run once over
    the whole chunk, the recurrence in one launch of the scan on the card.
    """
    z, x, bmat, cmat, dt = _project(p, u, cfg)
    d_skip, kernel, a_rate = _step_params(p, cfg)
    h, win = state["h"], state["conv"]
    with named_scope("ssm.recurrence"):
        y, h, win = _recurrence(d_skip, cfg.ssm_headdim, kernel, a_rate, h,
                                win, x, bmat, cmat, dt, length)
    return _out(p, y, z, u, cfg), {"h": h, "conv": win}
