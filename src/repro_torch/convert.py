"""Carry weights from the JAX package's parameter tree into the port.

``jax.random`` streams cannot be reproduced in torch, so parity runs take
the reference's ``init_params`` tree, turned into nested dicts of numpy
arrays by the caller, and map it onto the port's layout. Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.tree import tree_map

__all__ = ["params_from_jax"]


def params_from_jax(tree: dict, arch: ArchConfig,
                    device: Optional[Union[str, torch.device]] = None) -> dict:
    """The port's params from the reference's tree of numpy arrays.

    The reference stacks each super-block of ``len(block_pattern)`` layers
    along a leading ``n_super`` axis (``superblocks/b{j}_{kind}/...``) and
    keeps the remainder under ``tail/t{i}_{kind}``; the port keeps one
    entry per layer, in the order the reference's forward runs them
    (``arch.blocks()``), with each block kind's own subtree: an MoE
    layer's ``moe`` holds the f32 router, the stacked experts (E, D, F) /
    (E, F, D) and arctic's ``dense_mlp``. An embedding-input model's tree
    has no ``embed``. Arrays are copied onto ``device`` (None means the
    card).
    """
    device = resolve_device(device)
    pat = arch.block_pattern
    n_super, n_tail = divmod(arch.n_layers, arch.pattern_period())
    layers = []
    for i in range(n_super):
        for j, kind in enumerate(pat):
            layers.append(tree_map(lambda a: a[i],
                                    tree["superblocks"][f"b{j}_{kind}"]))
    for i in range(n_tail):
        layers.append(tree["tail"][f"t{i}_{pat[i]}"])

    def to_torch(a):
        return torch.tensor(np.asarray(a), device=device)

    out = {}
    if "embed" in tree:
        out["embed"] = to_torch(tree["embed"])
    out["layers"] = [tree_map(to_torch, layer) for layer in layers]
    out["final_norm"] = tree_map(to_torch, tree["final_norm"])
    if "lm_head" in tree:
        out["lm_head"] = tree_map(to_torch, tree["lm_head"])
    return out
