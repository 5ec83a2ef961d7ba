"""The paper's own evaluation point: an edge-scale LM with the GR-CIM
matmul path enabled (FP6_E3M2 activations, FP4_E2M1 weights, N_R=32,
row normalization, ENOB from the data-invariant upper bound)."""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.formats import FP4_E2M1, FP6_E3M2

CONFIG = register(ArchConfig(
    name="paper-cim-120m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=32000,
    cim=CIMConfig(
        mode="grmac",
        granularity="row",
        fmt_x=FP6_E3M2,
        fmt_w=FP4_E2M1,
        n_r=32,
    ),
    dtype="float32",
    source="this paper (§III), edge deployment scale",
))
