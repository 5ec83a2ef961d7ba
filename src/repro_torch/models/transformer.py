"""Model assembly: embeddings + a stack of blocks + LM head.

The port's counterpart of ``repro.models.transformer`` for global-attention
blocks with dense FFNs. Parameters are plain nested dicts of tensors with
one entry per layer (``params["layers"][l]``) where the reference stacks
super-blocks for ``lax.scan``; ``convert.params_from_jax`` maps one tree
onto the other. Depth is a Python loop over the layers.

Three execution paths share the layer code:
  train            full-sequence, no caches
  chunked prefill  a prompt chunk against per-layer caches, KV written at
                   per-lane offsets in one pass (``prefill_step``;
                   right padding masked out)
  decode           a single token against per-layer caches
Cached paths update the cache tensors in place and return the same dict.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.ops import cim_matmul
from repro_torch.models import layers as L

__all__ = [
    "init_params",
    "init_cache",
    "forward",
    "train_loss",
    "decode_step",
    "prefill_step",
]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_blocks(cfg: ArchConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE FFNs are not ported yet")
    other = sorted(set(cfg.blocks()) - {"attn"})
    if other:
        raise NotImplementedError(
            f"block kinds {other} are not ported yet (only 'attn')")
    if cfg.input_mode != "tokens":
        raise NotImplementedError("embedding-input models are not ported yet")


# ------------------------------------------------------------------ init
def init_params(cfg: ArchConfig, seed: int,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random weights from a seeded ``torch.Generator``, with the reference's
    shapes and scales: normal(0, 1/sqrt(d_in)) projections, output
    projections scaled by 1/sqrt(2 * n_layers) more, 0.02-scaled
    embeddings, unit norms. Drawn on the CPU, so a seed gives the same
    weights on every device; ``device=None`` means the card."""
    device = resolve_device(device)
    _check_blocks(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = _dtype(cfg)
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)

    def normal(shape, scale):
        w = scale * torch.randn(shape, generator=gen, dtype=torch.float32)
        return w.to(device=device, dtype=dt)

    def dense(d_in, d_out, scale=None, bias=False):
        p = {"w": normal((d_in, d_out),
                         1.0 / math.sqrt(d_in) if scale is None else scale)}
        if bias:
            p["b"] = torch.zeros((d_out,), dtype=dt, device=device)
        return p

    def norm():
        return {"g": torch.ones((d,), dtype=dt, device=device)}

    def layer():
        p = {"norm1": norm(),
             "attn": {
                 "wq": dense(d, h * dh, bias=cfg.qkv_bias),
                 "wk": dense(d, kv * dh, bias=cfg.qkv_bias),
                 "wv": dense(d, kv * dh, bias=cfg.qkv_bias),
                 "wo": dense(h * dh, d, scale=1.0 / math.sqrt(
                     h * dh * 2 * cfg.n_layers))},
             "norm2": norm()}
        ffn = {"wi": dense(d, f),
               "wo": dense(f, d, scale=1.0 / math.sqrt(f * 2 * cfg.n_layers))}
        if cfg.gated_mlp:
            ffn["wg"] = dense(d, f)
        p["ffn"] = ffn
        return p

    params = {"embed": normal((cfg.padded_vocab, d), 0.02),
              "layers": [layer() for _ in range(cfg.n_layers)],
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.padded_vocab)
    return params


# ------------------------------------------------------------------ caches
def init_cache(cfg: ArchConfig, batch: int, ctx_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """Per-layer KV caches: ``{"layers": [{"k", "v": (B, S_ctx, KV, Dh)}]}``."""
    device = resolve_device(device)
    _check_blocks(cfg)
    shape = (batch, ctx_len, cfg.n_kv_heads, cfg.d_head)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.n_layers)]}


# ------------------------------------------------------------------ forward
def _apply_layer(p, x, cfg, positions, cache, cache_index, chunk_lengths,
                 active):
    """Pre-norm residual attention block + dense FFN; returns (x, cache)."""
    h = L.rmsnorm(p["norm1"], x)
    out, cache = L.attention(
        p["attn"], h, cfg, local=False, positions=positions, cache=cache,
        cache_index=cache_index, chunk_lengths=chunk_lengths, active=active)
    x = x + out
    x = x + L.mlp(p["ffn"], L.rmsnorm(p["norm2"], x), cfg)
    return x, cache


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
    """Returns (logits, aux_loss, cache).

    ``inputs``: token ids (B, S). ``cache_index`` (scalar or (B,)) is the
    per-lane write offset of a cached call; ``chunk_lengths`` (B,) turns a
    cached call into a chunked prefill over the whole S axis; ``active``
    (B,) bool freezes the caches of the other lanes in a decode.
    """
    _check_blocks(cfg)
    x = params["embed"][inputs].to(_dtype(cfg))
    b, s = x.shape[:2]
    dev = x.device
    if cache is not None:
        cache_index = _lanes(cache_index, b, dev)
    if positions is None:
        steps = torch.arange(s, device=dev)[None, :]
        positions = (steps.expand(b, s) if cache is None
                     else cache_index[:, None] + steps)
    for i, p_l in enumerate(params["layers"]):
        c = cache["layers"][i] if cache is not None else None
        x, _ = _apply_layer(p_l, x, cfg, positions, c, cache_index,
                            chunk_lengths, active)
    x = L.rmsnorm(params["final_norm"], x)
    # the LM head is a CIM site in both tied and untied form
    if cfg.tie_embeddings:
        logits = cim_matmul(x, params["embed"].T.to(x.dtype), cfg.cim,
                            site="head", logical_n=cfg.vocab_size)
    else:
        logits = L.dense(params["lm_head"], x, cfg.cim, "head",
                         logical_n=cfg.vocab_size)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=dev) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=dev), logits)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, aux, cache


def train_loss(params, batch: dict, cfg: ArchConfig, aux_weight: float = 0.01):
    raise NotImplementedError("training is not ported yet")


def decode_step(params, token, cfg: ArchConfig, cache, cache_index,
                active: Optional[torch.Tensor] = None):
    """One decode step: token (B, 1) -> (logits (B, V), cache).

    ``cache_index`` is a scalar or per-lane (B,) write position; ``active``
    (B,) bool, when given, leaves the other lanes' caches unchanged."""
    logits, _, cache = forward(params, token, cfg, cache=cache,
                               cache_index=cache_index, active=active)
    return logits[:, -1, :], cache


def prefill_step(params, tokens, cfg: ArchConfig, cache, cache_index, length):
    """Chunked prefill: tokens (B, S) -> the logits at each lane's last valid
    token (B, V), the greedy ids at *every* chunk position (B, S) int32, and
    the cache.

    ``cache_index`` (scalar or (B,)) is each lane's write offset; ``length``
    (B,) counts the valid leading tokens of this chunk per lane (the S axis
    may be right-padded to a bucket). A lane with ``length == 0`` keeps its
    cache unchanged.
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
