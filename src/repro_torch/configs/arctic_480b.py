"""Snowflake Arctic 480B — dense-MoE hybrid. [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,   # dense residual MLP in parallel with the MoE
    source="hf:Snowflake/snowflake-arctic-base",
    notes="128 experts top-2 + dense residual path",
))
