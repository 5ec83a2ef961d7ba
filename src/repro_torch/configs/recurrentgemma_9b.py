"""RecurrentGemma-9B — RG-LRU + local attention, 2:1 (Griffin).
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    subquadratic=True,
    source="arXiv:2402.19427",
    notes="RG-LRU recurrence with fixed-size state; local window 2048",
))
