"""ArchConfig — one dataclass covering every architecture family.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package); a test holds the two field by field. A model is a stack of
*blocks* drawn cyclically from ``block_pattern``:
    "attn"   full causal self-attention (GQA/MQA)
    "local"  sliding-window causal self-attention
    "rglru"  RG-LRU recurrent block
    "ssm"    Mamba2 SSD block
Each block but "ssm" is followed by an FFN (dense MLP, or MoE when
``n_experts > 0``). The port registers every configuration of the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.cim_config import CIMConfig

__all__ = ["ArchConfig", "register", "get_config", "list_configs"]

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096                # sliding-window size for "local" blocks
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0                 # expert hidden dim (0 -> d_ff)
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- RG-LRU ---
    lru_width: int = 0                # 0 -> d_model
    # --- misc ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    gated_mlp: bool = True
    tie_embeddings: bool = False
    input_mode: str = "tokens"        # tokens | embeddings (modality-stub)
    subquadratic: bool = False
    notes: str = ""
    source: str = ""
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    # query-chunked attention: bounds score materialization to
    # (B, H, attn_chunk, S); None -> one full S x S einsum
    attn_chunk: int = 1024

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; pad logits are masked."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model

    def blocks(self) -> Tuple[str, ...]:
        """The full per-layer block-kind sequence."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests."""
        period = self.pattern_period()
        return self.replace(
            name=self.name + "-reduced",
            n_layers=max(period, 2 if period == 1 else period),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=32,
            d_ff=256,
            moe_d_ff=128 if self.is_moe else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            window=64,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32,
            ssm_chunk=16,
            lru_width=128 if self.family == "hybrid" else 0,
            dtype="float32",
            remat=False,
            attn_chunk=16,
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d
        if not self.tie_embeddings:
            total += d * v
        for kind in self.blocks():
            if kind in ("attn", "local"):
                total += d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                total += self.n_heads * self.d_head * d
                ffn = True
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + 2 * w * w // 1 + w * d
                ffn = True
            elif kind == "ssm":
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh) + di * d
                ffn = False
            else:
                raise ValueError(kind)
            if ffn:
                if self.is_moe:
                    e_ff = self.expert_d_ff
                    total += self.n_experts * (3 if self.gated_mlp else 2) * d * e_ff
                    total += d * self.n_experts
                    if self.moe_dense_residual:
                        total += (3 if self.gated_mlp else 2) * d * f
                else:
                    total += (3 if self.gated_mlp else 2) * d * f
        return total


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # Importing the modules triggers register() calls.
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        chameleon_34b,
        gemma3_1b,
        granite_8b,
        grok_1_314b,
        mamba2_1p3b,
        musicgen_medium,
        paper_cim,
        qwen2_1p5b,
        recurrentgemma_9b,
        stablelm_3b,
    )
