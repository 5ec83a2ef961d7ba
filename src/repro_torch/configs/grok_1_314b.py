"""xAI Grok-1 314B MoE. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    source="hf:xai-org/grok-1",
    notes="8 experts top-2",
))
