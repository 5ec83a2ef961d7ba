"""Model assembly: embeddings + a stack of blocks + LM head.

The port's counterpart of ``repro.models.transformer`` for every block kind
("attn", "local", "rglru", "ssm") with dense or MoE FFNs (an "ssm" block
has none), on token ids or, for ``input_mode == "embeddings"``, on
precomputed (B, S, D) embeddings. Parameters are plain nested dicts of
tensors with one entry per layer (``params["layers"][l]``) where the
reference stacks super-blocks for ``lax.scan``;
``convert.params_from_jax`` maps one tree onto the other. Depth is a
Python loop over the layers.

Three execution paths share the layer code:
  train            full-sequence, no caches (attention blocks only so far:
                   the RG-LRU and SSM train forms wait for the training
                   slice)
  chunked prefill  a prompt chunk against per-layer caches, KV written at
                   per-lane offsets in one pass and recurrent states
                   advanced step by step (``prefill_step``; right padding
                   masked out)
  decode           a single token against per-layer caches
Cached paths update the cache dicts in place (tensors written in place,
recurrent states replaced) and return the same dict.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.formats import IntFormat
from repro_torch.kernels.ops import cim_matmul
from repro_torch.kernels.packed import pack_weight
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.rglru import (init_lam, init_rglru_state,
                                      rglru_decode, rglru_prefill)
from repro_torch.models.ssm import init_ssm_state, ssm_decode, ssm_prefill

__all__ = [
    "init_params",
    "init_cache",
    "pack_params",
    "to_device",
    "forward",
    "train_loss",
    "decode_step",
    "prefill_step",
]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


_KINDS = ("attn", "local", "rglru", "ssm")
# the CIM site of each projection, by parameter group (nested groups by
# nested dicts); the MoE experts are digital, as in the reference
_FFN_SITES = dict.fromkeys(("wi", "wg", "wo"), "mlp")
_SITES = {"attn": {"wq": "attn_qkv", "wk": "attn_qkv", "wv": "attn_qkv",
                   "wo": "attn_o"},
          "rglru": dict.fromkeys(("in_proj", "gate_r", "gate_i", "out_proj"),
                                 "rglru"),
          "ssm": dict.fromkeys(("in_proj", "bc_proj", "dt_proj", "out_proj"),
                               "ssm"),
          "ffn": _FFN_SITES,
          "moe": {"router": "moe_router", "dense_mlp": _FFN_SITES}}
# sites whose input is f32 whatever the model dtype, so their weight is too
_F32_SITES = ("moe_router",)


def _check_blocks(cfg: ArchConfig) -> None:
    other = sorted(set(cfg.blocks()) - set(_KINDS))
    if other:
        raise ValueError(f"unknown block kinds {other}")
    if cfg.input_mode not in ("tokens", "embeddings"):
        raise ValueError(f"unknown input_mode {cfg.input_mode!r}")


# ------------------------------------------------------------------ init
def init_params(cfg: ArchConfig, seed: int,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random weights from a seeded ``torch.Generator``, with the reference's
    shapes and scales: normal(0, 1/sqrt(d_in)) projections, output
    projections scaled by 1/sqrt(2 * n_layers) more, 0.02-scaled
    embeddings, 0.1-scaled conv kernels, unit norms, the reference's
    fixed RG-LRU ``lam`` and SSM ``A_log`` / ``D`` / ``dt_bias``, and the
    MoE layers of ``models.moe.init_moe`` (an f32 router). An
    embedding-input model has no embedding table.

    Drawn by a generator on ``device`` itself (``device=None`` means the
    card), so a full-width model's billions of normals never pass through
    the host: a seed gives the same weights on every run on one kind of
    device, but the CPU and the card draw different streams. To hold the
    card against the CPU, draw on the CPU and move the tree
    (``to_device``). On ``meta`` (the cost ledger's shape-only tree) no
    generator can live: the draws there take none and hold no values."""
    device = resolve_device(device)
    _check_blocks(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = _dtype(cfg)
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(scale)
        return w.to(dtype)

    def dense(d_in, d_out, scale=None, bias=False, dtype=dt):
        p = {"w": normal((d_in, d_out),
                         1.0 / math.sqrt(d_in) if scale is None else scale,
                         dtype)}
        if bias:
            p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
        return p

    def norm():
        return {"g": torch.ones((d,), dtype=dt, device=device)}

    def attn_layer():
        return {"wq": dense(d, h * dh, bias=cfg.qkv_bias),
                "wk": dense(d, kv * dh, bias=cfg.qkv_bias),
                "wv": dense(d, kv * dh, bias=cfg.qkv_bias),
                "wo": dense(h * dh, d, scale=1.0 / math.sqrt(
                    h * dh * 2 * cfg.n_layers))}

    def conv(width):
        return normal((cfg.conv_width, width), 0.1)

    def rglru_layer():
        w = cfg.rnn_width
        return {"in_proj": dense(d, w), "gate_r": dense(d, w),
                "gate_i": dense(d, w), "conv": conv(w),
                "lam": init_lam(w).to(device),
                "out_proj": dense(w, d, scale=1.0 / math.sqrt(
                    w * 2 * cfg.n_layers))}

    def ssm_layer():
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = dict(dtype=torch.float32, device=device)
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
        return {"in_proj": dense(d, 2 * di), "bc_proj": dense(d, 2 * n),
                "dt_proj": dense(d, nh), "conv": conv(di),
                "A_log": a_log.to(device),
                "D": torch.ones((nh,), **f32),
                "dt_bias": torch.zeros((nh,), **f32),
                "out_norm": {"g": torch.ones((di,), dtype=dt, device=device)},
                "out_proj": dense(di, d, scale=1.0 / math.sqrt(
                    di * 2 * cfg.n_layers))}

    def layer(kind):
        p = {"norm1": norm()}
        if kind == "ssm":
            p["ssm"] = ssm_layer()
            return p                      # a Mamba2 block has no FFN
        if kind == "rglru":
            p["rglru"] = rglru_layer()
        else:
            p["attn"] = attn_layer()
        p["norm2"] = norm()
        if cfg.is_moe:
            p["moe"] = init_moe(cfg, normal, dense, ffn)
        else:
            p["ffn"] = ffn()
        return p

    def ffn():
        p = {"wi": dense(d, f),
             "wo": dense(f, d, scale=1.0 / math.sqrt(f * 2 * cfg.n_layers))}
        if cfg.gated_mlp:
            p["wg"] = dense(d, f)
        return p

    params = {}
    if cfg.input_mode == "tokens":
        params["embed"] = normal((cfg.padded_vocab, d), 0.02)
    params["layers"] = [layer(kind) for kind in cfg.blocks()]
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.padded_vocab)
    return params


def pack_params(params: dict, cfg: ArchConfig) -> dict:
    """Served params: each CIM site's weight packed once
    (``kernels.packed.pack_weight``) under the design ``cfg.cim.for_site``
    resolves there, so no call re-quantizes it. Sites that do not run
    grmac with an FP input and a weight format of at most 8 bits keep
    their tensor, as do the blocks' other tensors (norms, conv kernels,
    RG-LRU ``lam``, SSM ``A_log`` / ``D`` / ``dt_bias``, the digital MoE
    experts). A weight is packed at the dtype the site computes in: the
    model's, or f32 for the MoE router (rounding it to the model dtype
    first would change its scale and every code). A tied head gets its
    own packed ``embed.T`` as ``"lm_head"``; the embedding table stays
    for the lookup. The input is not changed; untouched tensors are
    shared."""
    dt = _dtype(cfg)

    def pack(w, site):
        eff = cfg.cim.for_site(site)
        if (eff.mode != "grmac" or isinstance(eff.fmt_x, IntFormat)
                or eff.fmt_w.bits > 8):
            return w
        return pack_weight(w.to(torch.float32 if site in _F32_SITES else dt),
                           eff.fmt_w, eff.n_r)

    def packed(group, sites):
        out = dict(group)
        for name, site in sites.items():
            if name not in group:
                continue
            out[name] = (packed(group[name], site) if isinstance(site, dict)
                         else dict(group[name], w=pack(group[name]["w"],
                                                       site)))
        return out

    layers = [packed(p, _SITES) for p in params["layers"]]
    head = (params["lm_head"] if "lm_head" in params
            else {"w": params["embed"].T})
    return dict(params, layers=layers, lm_head=dict(head, w=pack(head["w"],
                                                                  "head")))


def to_device(tree, device: Union[str, torch.device]):
    """A copy of a nested dict (or list) of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------------ caches
def init_cache(cfg: ArchConfig, batch: int, ctx_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """Per-layer caches, ``{"layers": [...]}``: ``{"k", "v": (B, S, KV,
    Dh)}`` of ``dtype`` with S = ``ctx_len`` for "attn" and the ring
    length ``min(window, ctx_len)`` for "local"; f32 recurrent states
    ``{"h", "conv"}`` for "rglru" and "ssm" (conv windows (B, conv_width
    - 1, C))."""
    device = resolve_device(device)
    _check_blocks(cfg)

    def one(kind):
        if kind == "rglru":
            return init_rglru_state(cfg, batch, device)
        if kind == "ssm":
            return init_ssm_state(cfg, batch, device)
        s = ctx_len if kind == "attn" else min(cfg.window, ctx_len)
        shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"layers": [one(kind) for kind in cfg.blocks()]}


# ------------------------------------------------------------------ forward
def _recurrent(kind, p, h, cfg, cache, chunk_lengths, active):
    """An RG-LRU or SSM block's serving path; the new state replaces the
    old one in ``cache``, except in lanes outside ``active`` (decode),
    which keep theirs."""
    prefill, decode = ((rglru_prefill, rglru_decode) if kind == "rglru"
                       else (ssm_prefill, ssm_decode))
    if chunk_lengths is not None:
        out, new = prefill(p, h, cfg, cache, chunk_lengths)
    else:
        out, new = decode(p, h, cfg, cache)
        if active is not None:
            new = {name: torch.where(
                active.reshape(-1, *[1] * (t.dim() - 1)), t, cache[name])
                for name, t in new.items()}
    cache.update(new)
    return out


def _apply_layer(kind, p, x, cfg, positions, cache, cache_index,
                 chunk_lengths, active):
    """Pre-norm residual block of ``kind`` + dense or MoE FFN (none after
    "ssm"); returns (x, the MoE's aux loss or None). In a chunked prefill
    the MoE routes only each lane's valid steps; in decode every lane
    routes, inactive ones too, as in the reference (``active`` only
    freezes caches)."""
    h = L.rmsnorm(p["norm1"], x)
    if kind in ("attn", "local"):
        out, _ = L.attention(
            p["attn"], h, cfg, local=(kind == "local"), positions=positions,
            cache=cache, cache_index=cache_index,
            chunk_lengths=chunk_lengths, active=active)
    else:
        out = _recurrent(kind, p[kind], h, cfg, cache, chunk_lengths, active)
    x = x + out
    if kind == "ssm":
        return x, None
    h = L.rmsnorm(p["norm2"], x)
    if not cfg.is_moe:
        return x + L.mlp(p["ffn"], h, cfg), None
    valid = (None if chunk_lengths is None else
             torch.arange(x.shape[1], device=x.device)[None, :]
             < chunk_lengths[:, None])
    out, aux = moe(p["moe"], h, cfg, valid=valid)
    return x + out, aux


def _lanes(value, b: int, device) -> torch.Tensor:
    """A scalar or (B,) int index as a (B,) int64 tensor on ``device``."""
    return torch.as_tensor(value, dtype=torch.int64, device=device).expand(b)


def forward(
    params: dict,
    inputs: torch.Tensor,
    cfg: ArchConfig,
    *,
    cache: Optional[dict] = None,
    cache_index=None,
    positions: Optional[torch.Tensor] = None,
    chunk_lengths: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
):
    """Returns (logits, aux_loss, cache); aux_loss sums the MoE layers'
    load-balancing losses (0 without MoE).

    ``inputs``: token ids (B, S), or (B, S, D) embeddings when
    ``cfg.input_mode == "embeddings"``. ``cache_index`` (scalar or (B,))
    is the per-lane write offset of a cached call; ``chunk_lengths`` (B,)
    turns a cached call into a chunked prefill over the whole S axis;
    ``active`` (B,) bool freezes the caches of the other lanes in a
    decode. Without a cache, RG-LRU and SSM blocks raise
    ``NotImplementedError``.
    """
    _check_blocks(cfg)
    recurrent = sorted({"rglru", "ssm"} & set(cfg.blocks()))
    if cache is None and recurrent:
        raise NotImplementedError(
            f"the train path (no cache) of {recurrent} blocks is not ported "
            "yet: it comes with the training slice")
    if cfg.input_mode == "tokens":
        x = params["embed"][inputs].to(_dtype(cfg))
    else:
        x = inputs.to(_dtype(cfg))
    b, s = x.shape[:2]
    dev = x.device
    if cache is not None:
        cache_index = _lanes(cache_index, b, dev)
    if positions is None:
        steps = torch.arange(s, device=dev)[None, :]
        positions = (steps.expand(b, s) if cache is None
                     else cache_index[:, None] + steps)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (kind, p_l) in enumerate(zip(cfg.blocks(), params["layers"])):
        c = cache["layers"][i] if cache is not None else None
        x, aux = _apply_layer(kind, p_l, x, cfg, positions, c, cache_index,
                              chunk_lengths, active)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rmsnorm(params["final_norm"], x)
    # the LM head is a CIM site in both tied and untied form (served params
    # carry a tied head's packed embed.T as "lm_head")
    if "lm_head" in params:
        logits = L.dense(params["lm_head"], x, cfg.cim, "head",
                         logical_n=cfg.vocab_size)
    else:
        logits = cim_matmul(x, params["embed"].T.to(x.dtype), cfg.cim,
                            site="head", logical_n=cfg.vocab_size)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=dev) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=dev), logits)
    return logits, aux_total, cache


def train_loss(params, batch: dict, cfg: ArchConfig, aux_weight: float = 0.01):
    raise NotImplementedError("training is not ported yet")


def decode_step(params, token, cfg: ArchConfig, cache, cache_index,
                active: Optional[torch.Tensor] = None):
    """One decode step: token (B, 1), or (B, 1, D) embeddings -> (logits
    (B, V), cache).

    ``cache_index`` is a scalar or per-lane (B,) write position; ``active``
    (B,) bool, when given, leaves the other lanes' caches (KV rows, rings,
    recurrent states and conv windows) unchanged."""
    logits, _, cache = forward(params, token, cfg, cache=cache,
                               cache_index=cache_index, active=active)
    return logits[:, -1, :], cache


def prefill_step(params, tokens, cfg: ArchConfig, cache, cache_index, length):
    """Chunked prefill: tokens (B, S), or (B, S, D) embeddings -> the logits
    at each lane's last valid token (B, V), the greedy ids at *every*
    chunk position (B, S) int32, and the cache.

    ``cache_index`` (scalar or (B,)) is each lane's write offset; ``length``
    (B,) counts the valid leading tokens of this chunk per lane (the S axis
    may be right-padded to a bucket). A lane with ``length == 0`` keeps its
    cache unchanged, recurrent states and conv windows included.
    """
    b, s = tokens.shape[0], tokens.shape[1]
    dev = tokens.device
    idx = _lanes(cache_index, b, dev)
    length = _lanes(length, b, dev)
    positions = idx[:, None] + torch.arange(s, device=dev)[None, :]
    logits, _, cache = forward(params, tokens, cfg, cache=cache,
                               cache_index=idx, positions=positions,
                               chunk_lengths=length)
    last = torch.clamp(length - 1, 0, s - 1)
    last_logits = logits[torch.arange(b, device=dev), last]
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return last_logits, ids, cache
