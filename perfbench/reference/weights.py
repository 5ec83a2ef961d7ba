"""Seeded weights, drawn on the device in one call and cut into the tree
the port takes (nested dicts, one entry a layer, ``layers/<i>/...``).

A spec is ``(path, shape, init)``: a float is the standard deviation of a
normal draw, ``"ones"`` a norm gain, and the float32 constants of the SSD
block are ``"ones32"``, ``"zeros32"`` and ``"alog32"`` (log of 1..16 over
the heads). Normal leaves are taken in order from one float32 draw of a
``torch.Generator`` on the device, scaled, and cast to the model's dtype.
"""
from __future__ import annotations

import math

import torch


def make_params(specs, seed: int, dtype: torch.dtype, device) -> dict:
    total = sum(math.prod(shape) for _, shape, init in specs
                if isinstance(init, float))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    tree: dict = {}
    off = 0
    for path, shape, init in specs:
        if isinstance(init, float):
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape).mul(init).to(dtype)
            off += n
        elif init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif init == "ones32":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "zeros32":
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        elif init == "alog32":
            leaf = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                            dtype=torch.float32)).to(device)
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
        _put(tree, path.split("/"), leaf)
    del flat
    return _lists(tree)


def _put(tree: dict, keys, leaf) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def _lists(tree):
    """``layers`` as a list in index order."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if "layers" in out:
        layers = out["layers"]
        out["layers"] = [layers[str(i)] for i in range(len(layers))]
    return out


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def leaves(tree, prefix: str = ""):
    """(path, leaf) pairs in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree
