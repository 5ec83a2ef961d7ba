"""Sharding on ``torch.distributed``'s ``DeviceMesh`` and DTensor; the
port's counterpart of ``repro.parallel``."""
from repro_torch.parallel.sharding import (batch_axes, get_mesh,
                                           named_sharding_tree, param_specs,
                                           set_mesh, shard, use_mesh)

__all__ = [
    "set_mesh", "get_mesh", "use_mesh", "shard", "batch_axes",
    "param_specs", "named_sharding_tree",
]
