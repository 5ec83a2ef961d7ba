"""MusicGen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model); the EnCodec encoder and the
4-codebook interleaving live outside the backbone.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    gated_mlp=False,
    input_mode="embeddings",
    source="arXiv:2306.05284",
))
