"""Gemma-3 1B: 5:1 local:global attention, 128k-class context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    block_pattern=("local",) * 5 + ("attn",),
    window=512,
    tie_embeddings=True,
    # long_500k decode is runnable: 5/6 of layers keep a 512-token window
    # cache; the rare global layers are O(S) per decoded token.
    subquadratic=True,
    source="hf:google/gemma-3-1b-pt",
    notes="5:1 local:global, MQA (kv=1)",
))
