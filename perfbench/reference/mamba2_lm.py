"""A Mamba2 LM (arXiv:2405.21060): pre-norm SSD blocks with no FFN and a
tied LM head, every projection through GR-MAC, in plain PyTorch: the
reference of configurations whose ``reference`` is ``mamba2_lm``.

Per head h, with the decay a_t = exp(-dt_t A_h) and dt_t = softplus(dt
projection + dt_bias):

    H_t = a_t H_{t-1} + dt_t B_t (x) x_t,   y_t = C_t^T H_t + D_h x_t

x_t is the SiLU of a depthwise causal conv (width ``conv_width``) over the
block's x projection; y is gated by SiLU(z), RMS-normed over the inner
width and projected out. The serving forms advance the recurrence one
step at a time (float32 state and conv window); a chunk's steps past a
lane's length leave its state as it was, and a decode keeps the state of
lanes outside ``active``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from perfbench.reference.dense_lm import NEG_INF, pad_vocab
from perfbench.reference.dense_lm import Model as _Dense
from perfbench.reference.weights import make_params


def projections(arch: dict) -> list:
    """(K, N, calls) of every GR-MAC projection of one forward: the input
    projection's (z, x), (B, C) and dt parts, the output projection, and
    the tied LM head last."""
    d, nl = arch["d_model"], arch["n_layers"]
    di = arch["ssm_expand"] * d
    return [(d, 2 * di, nl), (d, 2 * arch["ssm_state"], nl),
            (d, di // arch["ssm_headdim"], nl), (di, d, nl),
            (d, pad_vocab(arch["vocab_size"]), 1)]


def token_flops(arch: dict, keys: int) -> int:
    """A token's flops besides its projections, whatever it attends: the
    depthwise conv (2 a tap a channel), the state's decay and update (3 a
    state element) and the read-out (2 a state element), in every layer."""
    di = arch["ssm_expand"] * arch["d_model"]
    return arch["n_layers"] * (2 * arch["conv_width"] * di
                               + 5 * di * arch["ssm_state"])


class Model(_Dense):
    def __init__(self, config: dict, precision: str = "f32"):
        super().__init__(config, precision)
        a = self.a
        self.d_inner = a["ssm_expand"] * a["d_model"]
        self.heads = self.d_inner // a["ssm_headdim"]

    def param_specs(self):
        a = self.a
        d, nl, di, n, nh = (a["d_model"], a["n_layers"], self.d_inner,
                            a["ssm_state"], self.heads)
        specs = [("embed", (self.padded_vocab, d), 0.02)]
        for i in range(nl):
            p = f"layers/{i}/"
            specs += [(p + "norm1/g", (d,), "ones"),
                      (p + "ssm/in_proj/w", (d, 2 * di), d ** -0.5),
                      (p + "ssm/bc_proj/w", (d, 2 * n), d ** -0.5),
                      (p + "ssm/dt_proj/w", (d, nh), d ** -0.5),
                      (p + "ssm/conv", (a["conv_width"], di), 0.1),
                      (p + "ssm/A_log", (nh,), "alog32"),
                      (p + "ssm/D", (nh,), "ones32"),
                      (p + "ssm/dt_bias", (nh,), "zeros32"),
                      (p + "ssm/out_norm/g", (di,), "ones"),
                      (p + "ssm/out_proj/w", (di, d),
                       1.0 / math.sqrt(di * 2 * nl))]
        specs.append(("final_norm/g", (d,), "ones"))
        if not a["tie_embeddings"]:
            specs.append(("lm_head/w", (d, self.padded_vocab), d ** -0.5))
        return specs

    def make_params(self, seed: int, device) -> dict:
        return make_params(self.param_specs(), seed, self.dtype, device)

    def prepare(self, params: dict) -> dict:
        c = self.cim.prepare
        layers = [{name: c(lp["ssm"][name]["w"])
                   for name in ("in_proj", "bc_proj", "dt_proj", "out_proj")}
                  for lp in params["layers"]]
        head = (params["lm_head"]["w"] if "lm_head" in params
                else params["embed"].T)
        return {"layers": layers, "head": c(head)}

    def init_cache(self, batch: int, ctx: int, device) -> list:
        a = self.a
        return [{"h": torch.zeros((batch, self.heads, a["ssm_state"],
                                   a["ssm_headdim"]), device=device),
                 "conv": torch.zeros((batch, a["conv_width"] - 1,
                                      self.d_inner), device=device)}
                for _ in range(a["n_layers"])]

    # ------------------------------------------------------------ pieces
    def _project(self, p, pl, u):
        n = self.a["ssm_state"]
        zx = self.proj(u, pl["in_proj"])
        bc = self.proj(u, pl["bc_proj"])
        dt = self.proj(u, pl["dt_proj"])
        di = zx.shape[-1] // 2
        z, x = zx[..., :di], zx[..., di:]
        bc = bc.to(torch.float32)
        dt = dt.to(torch.float32) + p["dt_bias"][None, None, :]
        dt = torch.logaddexp(dt, torch.zeros_like(dt))
        return z, x, bc[..., :n], bc[..., n:], dt

    @staticmethod
    def _consts(p):
        """A layer's (D, conv kernel in float32, decay rate exp(A_log))."""
        return (p["D"], p["conv"].to(torch.float32),
                torch.exp(p["A_log"])[None, :])

    def _step(self, consts, h, win, x_t, b_t, c_t, dt_t):
        """One recurrence step: (new state, new window, y (B, NH, P))."""
        b, nh = x_t.shape[0], dt_t.shape[-1]
        d_skip, kernel, a_rate = consts
        full = torch.cat([win, x_t[:, None, :].to(win.dtype)], dim=1)
        xc = full[:, 0] * kernel[0]
        for j in range(1, kernel.shape[0]):
            xc = xc + full[:, j] * kernel[j]
        xs = xc * torch.sigmoid(xc)
        xh = xs.reshape(b, nh, self.a["ssm_headdim"]).to(torch.float32)
        a = torch.exp(-dt_t * a_rate)
        dbx = (dt_t[:, :, None, None] * b_t[:, None, :, None]) \
            * xh[:, :, None, :]
        h_new = a[..., None, None] * h + dbx
        y = torch.einsum("bn,bhnp->bhp", c_t, h_new)
        y = y + d_skip[None, :, None] * xh
        return h_new, full[:, 1:], y

    def _out(self, p, pl, y, z, u):
        y = self.act(y.to(u.dtype)) * (z * torch.sigmoid(z))
        return self.proj(self.rmsnorm(p["out_norm"]["g"], y),
                         pl["out_proj"])

    def _head_logits(self, params, prep, x):
        x = self.rmsnorm(params["final_norm"]["g"], x)
        logits = self.proj(x, prep["head"])
        if self.padded_vocab != self.vocab:
            cols = torch.arange(logits.shape[-1], device=x.device)
            logits = torch.where(cols >= self.vocab,
                                 torch.full((), NEG_INF, dtype=logits.dtype,
                                            device=x.device), logits)
        return logits

    # ------------------------------------------------------------ forms
    def prefill(self, params, prep, tokens, cache, index, lengths):
        b, s = tokens.shape
        dev = tokens.device
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        x = self.act(params["embed"][tokens])
        for lp, pl, c in zip(params["layers"], prep["layers"], cache):
            p = lp["ssm"]
            u = self.rmsnorm(lp["norm1"]["g"], x)
            z, xs, bm, cm, dt = self._project(p, pl, u)
            h, win = c["h"], c["conv"]
            consts = self._consts(p)
            ys = []
            for t in range(s):
                h_new, win_new, y = self._step(consts, h, win, xs[:, t],
                                               bm[:, t], cm[:, t], dt[:, t])
                v_t = valid[:, t]
                h = torch.where(v_t[:, None, None, None], h_new, h)
                win = torch.where(v_t[:, None, None], win_new, win)
                ys.append(y)
            c["h"].copy_(h)
            c["conv"].copy_(win)
            y = torch.stack(ys, dim=1).reshape(b, s, -1)
            x = x + self._out(p, pl, y, z, u)
        logits = self._head_logits(params, prep, x)
        last = torch.clamp(lengths - 1, 0, s - 1)
        return logits[torch.arange(b, device=dev), last]

    def decode(self, params, prep, tokens, cache, index,
               active: Optional[torch.Tensor]):
        b = tokens.shape[0]
        x = self.act(params["embed"][tokens])
        for lp, pl, c in zip(params["layers"], prep["layers"], cache):
            p = lp["ssm"]
            u = self.rmsnorm(lp["norm1"]["g"], x)
            z, xs, bm, cm, dt = self._project(p, pl, u)
            h_new, win_new, y = self._step(self._consts(p), c["h"],
                                           c["conv"], xs[:, 0],
                                           bm[:, 0], cm[:, 0], dt[:, 0])
            out = self._out(p, pl, y.reshape(b, 1, -1), z, u)
            for name, t in (("h", h_new), ("conv", win_new)):
                keep = active.reshape(-1, *[1] * (t.dim() - 1))
                c[name].copy_(torch.where(keep, t, c[name]))
            x = x + out
        return self._head_logits(params, prep, x)[:, -1, :]

    def loss(self, params, batch):
        raise NotImplementedError("no mamba2 training cell")
