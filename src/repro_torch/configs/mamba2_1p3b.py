"""Mamba2-1.3B — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.21060",
    notes="SSD chunked algorithm, chunk=256",
))
