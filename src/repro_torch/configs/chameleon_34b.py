"""Chameleon-34B — early-fusion VLM over interleaved text + VQ image tokens.
[arXiv:2405.09818; unverified]

VQ image tokens live in the shared 65536 vocabulary, so the backbone
consumes plain token ids; the VQ-GAN tokenizer is the (stubbed) frontend.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=65536,
    source="arXiv:2405.09818",
))
