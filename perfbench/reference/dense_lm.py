"""A dense decoder LM (pre-norm, rotary GQA attention, gated SiLU MLP,
untied or tied LM head), every projection through GR-MAC, in plain
PyTorch: the reference of configurations whose ``reference`` is
``dense_lm``.

Three forms, each over the whole batch of lanes as one activation (the
pre-scale takes one max |x| over all of it, so lanes are judged together):

* ``prefill``: a chunk of S tokens a lane written into per-lane KV caches
  at per-lane offsets, steps past a lane's length writing nothing; the
  logits at each lane's last valid step.
* ``decode``: one token a lane; lanes outside ``active`` compute like the
  others and get their written KV row back.
* ``loss``: the whole sequence without a cache, the mean next-token
  cross-entropy, with straight-through gradients through every GR-MAC
  projection.

Attention scores and the softmax are float32. The KV cache holds every
slot of the context; masked slots score -1e30. The log-sum-exp of the loss
runs over 16 equal vocabulary blocks and then across them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from perfbench.reference.grmac import CIM, ste_matmul
from perfbench.reference.weights import make_params

NEG_INF = -1e30
LSE_BLOCKS = 16


def projections(arch: dict) -> list:
    """(K, N, calls) of every GR-MAC projection of one forward, the LM head
    (over the padded vocabulary) last."""
    d, nl = arch["d_model"], arch["n_layers"]
    qd = arch["n_heads"] * arch["d_head"]
    kvd = arch["n_kv_heads"] * arch["d_head"]
    f = arch["d_ff"]
    return [(d, qd, nl), (d, kvd, 2 * nl), (qd, d, nl), (d, f, 2 * nl),
            (f, d, nl), (d, pad_vocab(arch["vocab_size"]), 1)]


def token_flops(arch: dict, keys: int) -> int:
    """A token's flops besides its projections: attention's score and value
    products over ``keys`` positions in every layer (4 H Dh a key)."""
    return 4 * arch["n_layers"] * arch["n_heads"] * arch["d_head"] * keys


def pad_vocab(vocab: int) -> int:
    return (vocab + 255) // 256 * 256


class Model:
    """A configuration's sizes (its ``arch`` entry) and CIM design."""

    def __init__(self, config: dict, precision: str = "f32"):
        a = config["arch"]
        self.a = a
        self.cim = CIM(config["cim"])
        self.dtype = getattr(torch, a["dtype"])
        self.vocab = a["vocab_size"]
        self.padded_vocab = pad_vocab(self.vocab)
        self.fp8 = precision == "fp8"

    # ------------------------------------------------------------ weights
    def param_specs(self):
        """``weights.make_params`` specs of every leaf, in tree order."""
        a = self.a
        d, h, kv, dh, f, nl = (a["d_model"], a["n_heads"], a["n_kv_heads"],
                               a["d_head"], a["d_ff"], a["n_layers"])
        specs = [("embed", (self.padded_vocab, d), 0.02)]
        for i in range(nl):
            p = f"layers/{i}/"
            specs += [(p + "norm1/g", (d,), "ones"),
                      (p + "attn/wq/w", (d, h * dh), d ** -0.5),
                      (p + "attn/wk/w", (d, kv * dh), d ** -0.5),
                      (p + "attn/wv/w", (d, kv * dh), d ** -0.5),
                      (p + "attn/wo/w", (h * dh, d),
                       1.0 / math.sqrt(h * dh * 2 * nl)),
                      (p + "norm2/g", (d,), "ones"),
                      (p + "ffn/wi/w", (d, f), d ** -0.5),
                      (p + "ffn/wo/w", (f, d), 1.0 / math.sqrt(f * 2 * nl)),
                      (p + "ffn/wg/w", (d, f), d ** -0.5)]
        specs.append(("final_norm/g", (d,), "ones"))
        if not a["tie_embeddings"]:
            specs.append(("lm_head/w", (d, self.padded_vocab), d ** -0.5))
        return specs

    def make_params(self, seed: int, device) -> dict:
        return make_params(self.param_specs(), seed, self.dtype, device)

    def prepare(self, params: dict) -> dict:
        """Every projection's quantized weight and scale, once (serving)."""
        c = self.cim.prepare
        layers = [{name: c(lp["attn"][name]["w"])
                   for name in ("wq", "wk", "wv", "wo")}
                  | {"f" + name: c(lp["ffn"][name]["w"])
                     for name in ("wi", "wg", "wo")}
                  for lp in params["layers"]]
        return {"layers": layers, "head": c(_head(params))}

    # ------------------------------------------------------------ caches
    def init_cache(self, batch: int, ctx: int, device) -> list:
        a = self.a
        shape = (batch, ctx, a["n_kv_heads"], a["d_head"])
        return [{"k": torch.zeros(shape, device=device),
                 "v": torch.zeros(shape, device=device)}
                for _ in range(a["n_layers"])]

    def reset_lane(self, cache: list, lane: int) -> None:
        for layer in cache:
            for t in layer.values():
                t[lane].zero_()

    # ------------------------------------------------------------ pieces
    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation cast to the model's dtype (a round trip through
        float8 e4m3 under a per-tensor scale for the fp8 control)."""
        t = t.to(self.dtype)
        if not self.fp8:
            return t
        s = torch.clamp(torch.amax(torch.abs(t.float())), min=1e-12) / 448.0
        return (t.float() / s).to(torch.float8_e4m3fn).float().mul(s).to(
            self.dtype)

    def rmsnorm(self, g, x, eps: float = 1e-6):
        x32 = x.to(torch.float32)
        rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1,
                                    keepdim=True) + eps)
        return self.act((x32 / rms) * g.to(torch.float32))

    def rope(self, x, positions):
        half = x.shape[-1] // 2
        freqs = torch.exp(
            -math.log(self.a["rope_theta"])
            * torch.arange(0, half, dtype=torch.float32, device=x.device)
            / half)
        ang = positions[..., None].to(torch.float32) * freqs
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(x.dtype)

    def proj(self, x, prepared=None, w=None):
        """A GR-MAC projection: prepared weights (serving) or the raw
        weight with straight-through gradients (training)."""
        if prepared is not None:
            return self.act(self.cim.matmul(x, prepared))
        return self.act(ste_matmul(x, w, self.cim))

    def attend(self, q, kk, vv, pos_q, pos_k):
        """Masked causal attention of q (B, S, H, Dh) against keys (B, T,
        KV, Dh), query blocks of ``attn_chunk``."""
        b, sq, h, dh = q.shape
        kv = kk.shape[2]

        def one(q_c, pos_c):
            c = q_c.shape[1]
            qg = q_c.reshape(b, c, kv, h // kv, dh)
            scores = torch.einsum("bskgd,btkd->bkgst", qg, kk)
            scores = scores.to(torch.float32)
            scores = scores / math.sqrt(dh)
            mask = pos_c[..., :, None] >= pos_k[..., None, :]
            scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            o = torch.einsum("bkgst,btkd->bskgd", probs, vv)
            return o.reshape(b, c, h, dh)

        ck = self.a["attn_chunk"] or sq
        while sq % ck:
            ck //= 2
        if ck >= sq:
            return one(q, pos_q)
        return torch.cat([one(q[:, i * ck:(i + 1) * ck],
                              pos_q[:, i * ck:(i + 1) * ck])
                          for i in range(sq // ck)], dim=1)

    def _qkv(self, lp, pl, h, positions):
        a = self.a
        b, s, _ = h.shape
        q, k, v = (self.proj(h, pl and pl[n], lp["attn"][n]["w"])
                   for n in ("wq", "wk", "wv"))
        q = self.rope(q.reshape(b, s, a["n_heads"], a["d_head"]), positions)
        k = self.rope(k.reshape(b, s, a["n_kv_heads"], a["d_head"]),
                      positions)
        return q, k, v.reshape(b, s, a["n_kv_heads"], a["d_head"])

    def _mlp(self, lp, pl, x):
        h = self.rmsnorm(lp["norm2"]["g"], x)
        ffn = lp["ffn"]
        hidden = self.proj(h, pl and pl["fwi"], ffn["wi"]["w"])
        gate = self.proj(h, pl and pl["fwg"], ffn["wg"]["w"])
        hidden = gate * torch.sigmoid(gate) * hidden
        return x + self.proj(hidden, pl and pl["fwo"], ffn["wo"]["w"])

    def _head(self, params, prep, x):
        x = self.rmsnorm(params["final_norm"]["g"], x)
        logits = self.proj(x, prep and prep["head"], _head(params))
        if self.padded_vocab != self.vocab:
            cols = torch.arange(logits.shape[-1], device=x.device)
            logits = torch.where(cols >= self.vocab,
                                 torch.full((), NEG_INF, dtype=logits.dtype,
                                            device=x.device), logits)
        return logits

    # ------------------------------------------------------------ forms
    def prefill(self, params, prep, tokens, cache, index, lengths):
        """tokens (B, S) int64, index / lengths (B,) int64 -> the logits at
        each lane's last valid step (B, V); the caches are written."""
        a = self.a
        b, s = tokens.shape
        dev = tokens.device
        steps = torch.arange(s, device=dev)
        positions = index[:, None] + steps[None, :]
        x = self.act(params["embed"][tokens])
        for lp, pl, c in zip(params["layers"], prep["layers"], cache):
            h = self.rmsnorm(lp["norm1"]["g"], x)
            q, k, v = self._qkv(lp, pl, h, positions)
            s_ctx = c["k"].shape[1]
            slot = torch.arange(s_ctx, device=dev)[None, :]
            t_of_slot = slot - index[:, None]
            writes = (t_of_slot >= 0) & (t_of_slot
                                         < lengths.clamp(max=s)[:, None])
            src = t_of_slot.clamp(0, s - 1)[:, :, None, None]
            for name, new in (("k", k), ("v", v)):
                t = c[name]
                upd = torch.gather(new.to(t.dtype), 1,
                                   src.expand(-1, -1, *t.shape[2:]))
                torch.where(writes[:, :, None, None], upd, t, out=t)
            out = self.attend(q, c["k"].to(x.dtype), c["v"].to(x.dtype),
                              positions, slot.expand(b, s_ctx))
            out = out.reshape(b, s, a["n_heads"] * a["d_head"])
            x = x + self.proj(out, pl["wo"])
            x = self._mlp(lp, pl, x)
        logits = self._head(params, prep, x)
        last = torch.clamp(lengths - 1, 0, s - 1)
        return logits[torch.arange(b, device=dev), last]

    def decode(self, params, prep, tokens, cache, index,
               active: Optional[torch.Tensor]):
        """tokens (B, 1) int64 at offsets ``index`` (B,) -> logits (B, V);
        lanes outside ``active`` keep their caches."""
        a = self.a
        b = tokens.shape[0]
        dev = tokens.device
        kvh, dh = a["n_kv_heads"], a["d_head"]
        positions = index[:, None] + torch.arange(1, device=dev)[None, :]
        lane = torch.arange(b, device=dev)
        x = self.act(params["embed"][tokens])
        for lp, pl, c in zip(params["layers"], prep["layers"], cache):
            h = self.rmsnorm(lp["norm1"]["g"], x)
            q, k, v = self._qkv(lp, pl, h, positions)
            kk, vv = c["k"], c["v"]
            s_ctx = kk.shape[1]
            slot = torch.arange(s_ctx, device=dev)[None, :]
            at = index.clamp(max=s_ctx - 1)
            if active is not None:
                old_k, old_v = kk[lane, at].clone(), vv[lane, at].clone()
            kk[lane, at] = k[:, 0].to(kk.dtype)
            vv[lane, at] = v[:, 0].to(vv.dtype)
            qg = q.reshape(b, 1, kvh, a["n_heads"] // kvh, dh)
            scores = torch.einsum("bskgd,btkd->bkgst", qg, kk.to(x.dtype))
            scores = scores.to(torch.float32) / math.sqrt(dh)
            valid = slot <= index[:, None]
            scores = torch.where(valid[:, None, None, None, :], scores,
                                 NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bkgst,btkd->bskgd", probs, vv.to(x.dtype))
            if active is not None:
                keep = active[:, None, None]
                kk[lane, at] = torch.where(keep, kk[lane, at], old_k)
                vv[lane, at] = torch.where(keep, vv[lane, at], old_v)
            out = out.reshape(b, 1, a["n_heads"] * dh)
            x = x + self.proj(out, pl["wo"])
            x = self._mlp(lp, pl, x)
        return self._head(params, prep, x)[:, -1, :]

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over the batch's mask."""
        a = self.a
        ids = batch["inputs"]
        b, s = ids.shape
        positions = torch.arange(s, device=ids.device)[None, :].expand(b, s)
        x = self.act(params["embed"][ids])
        for lp in params["layers"]:
            h = self.rmsnorm(lp["norm1"]["g"], x)
            q, k, v = self._qkv(lp, None, h, positions)
            out = self.attend(q, k, v, positions, positions)
            out = out.reshape(b, s, a["n_heads"] * a["d_head"])
            x = x + self.proj(out, None, lp["attn"]["wo"]["w"])
            x = self._mlp(lp, None, x)
        logits = self._head(params, None, x)
        return masked_mean_nll(logits, batch["labels"], batch["mask"])


def _head(params: dict) -> torch.Tensor:
    return (params["lm_head"]["w"] if "lm_head" in params
            else params["embed"].T)


def masked_mean_nll(logits, labels, mask) -> torch.Tensor:
    """lse(logits) - logits[label], float32, its mean over ``mask``."""
    v = logits.shape[-1]
    blocks = math.gcd(v, LSE_BLOCKS)
    x32 = logits.to(torch.float32)
    lse = torch.logsumexp(x32.reshape(*x32.shape[:-1], blocks, v // blocks),
                          dim=-1)
    lse = torch.logsumexp(lse, dim=-1)
    picked = torch.gather(x32, -1, labels.to(torch.int64).clamp(
        0, v - 1)[..., None])[..., 0]
    nll = lse - picked
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
