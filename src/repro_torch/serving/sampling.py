"""Per-lane token sampling: the port's counterpart of the reference engine's
``_lane_keys`` and the categorical draw of its decode step
(``repro.serving.engine``).

``jax.random`` streams cannot be reproduced in torch, and a
``torch.Generator`` per lane would make a lane's stream depend on how many
draws it had made on which device. So the sampler's streams are, like the
reference's, a pure function of integers:

* A **key** is a Python int of 64 bits. ``key(seed)`` stands for
  ``jax.random.PRNGKey(seed)``, ``fold_in(key, data)`` and ``split(key,
  n)`` for their ``jax.random`` namesakes: each is an integer hash
  (splitmix64's finalizer), so the reference's calls map one to one.
* ``lane_keys(key, seeds, ctrs)`` gives each lane of a batch its key for
  one sampling event: a lane with ``seeds[i] >= 0`` takes ``fold_in(
  key(seed), ctr)`` (its stream depends only on its seed and event
  index), an unseeded lane ``fold_in(key, i)``. They are computed on the
  host (a handful of lanes) as 32-bit values.
* ``select(logits, temps, keys)`` is the Gumbel-max draw that
  ``jax.random.categorical`` makes: ``argmax(logits / max(T, 1e-6) +
  g)`` with ``g = -log(-log(u))``, and ``argmax(logits)`` in lanes whose
  ``T <= 0``. ``u`` is a counter hash of (lane key, vocabulary index)
  computed in one vectorized pass over the (B, V) tile: a 32-bit state
  held in int64, multiplied only by constants below 2**31, so no product
  reaches 2**63 and the CPU and CUDA give the same bits. ``u`` is the
  top 24 bits times 2**-24, exact in f32, with 0 taken as 1 so that it
  is never 0 or 1.

A stream is then independent of slot placement, of the other traffic in
the batch and of the device (up to an ulp of ``log`` at a near tie), and
a sampled step costs a fixed number of launches, not one generator a
lane.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "lane_keys", "uniform", "select"]

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
# a tag that keeps split()'s children apart from fold_in()'s
_SPLIT = 0x5EED5EED5EED5EED
# odd multipliers below 2**31 (a 32-bit state times one stays below 2**63)
_C1, _C2, _WEYL = 0x7FEB352D, 0x045D9F3B, 0x61C88647


def _mix64(x: int) -> int:
    """splitmix64's finalizer over Python ints."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def key(seed: int) -> int:
    """The root key of ``seed`` (``jax.random.PRNGKey``)."""
    return _mix64(int(seed) & _M64)


def fold_in(k: int, data: int) -> int:
    """A key derived from ``k`` and an integer (``jax.random.fold_in``)."""
    return _mix64(k ^ _mix64(int(data) & _M64))


def split(k: int, n: int = 2) -> List[int]:
    """``n`` keys derived from ``k`` (``jax.random.split``)."""
    return [_mix64(k ^ _mix64(_SPLIT + i)) for i in range(n)]


def lane_keys(k: int, seeds: Sequence[int], ctrs: Sequence[int]
              ) -> np.ndarray:
    """(B,) int64 32-bit lane keys of one sampling event: ``fold_in(key(
    seed), ctr)`` for a seeded lane, ``fold_in(k, lane)`` otherwise."""
    return np.array([(fold_in(key(s), c) if s >= 0 else fold_in(k, i))
                     & _M32
                     for i, (s, c) in enumerate(zip(seeds, ctrs))],
                    np.int64)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash over int64 tensors (values in
    [0, 2**32)); every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1), one per (lane key, index)."""
    v = (torch.arange(n, device=keys.device) * _WEYL) & _M32
    h = _mix32(_mix32(v[None, :] ^ keys[:, None]) ^ keys[:, None])
    return (h >> 8).clamp_(min=1).to(torch.float32) * 2.0 ** -24


def select(logits: torch.Tensor, temps: torch.Tensor,
           keys: torch.Tensor) -> torch.Tensor:
    """(B,) int32 ids: Gumbel-max over ``logits / max(T, 1e-6)`` in lanes
    with ``T > 0`` (``temps`` (B,) f32), ``argmax(logits)`` elsewhere;
    ``keys`` (B,) int64 from ``lane_keys``."""
    lg = logits.to(torch.float32)
    g = -torch.log(-torch.log(uniform(keys, lg.shape[-1])))
    drawn = torch.argmax(lg / temps.clamp(min=1e-6)[:, None] + g, dim=-1)
    return torch.where(temps > 0, drawn,
                       torch.argmax(logits, dim=-1)).to(torch.int32)
