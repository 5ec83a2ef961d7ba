"""CUDA graphs of the engine's dispatches.

On the card an eager dispatch is host-bound: a decode step of
paper-cim-120m issues about a thousand kernel launches from Python, and
the device idles between them. The engine therefore captures, once per
shape, each dispatch of the served arch whose shapes it knows in advance
(the decode forward over all ``batch_slots`` lanes, and ``prefill_step``
at every bucket a prompt can need) into a ``torch.cuda.CUDAGraph``, and
replays it: the same kernels in the same order on the same buffers, so
the served tokens are the eager path's bit for bit.

``DispatchGraph`` holds one capture. Its inputs are static device
buffers; a replay copies the dispatch's host arrays into them (one
host-to-device copy each, in the scope ``engine.h2d``) and launches the
graph. The capture warms the dispatch up and captures it on inputs that
freeze every lane (decode: ``active`` all False; prefill: every length
0), which leave the caches as they were. The caches themselves are
captured where they lie: every path of the engine writes them in place,
and a dispatch replays only while each cache tensor is still the one
captured (``replayable``).

Outputs are the graph's own buffers, overwritten by the next replay of
any graph of the engine (the graphs share one memory pool: they replay
one at a time on one stream). A caller consumes an output, or clones it,
before the next replay.

Launch counters: ``grmac_matmul_cuda.launches`` (and per design) count
the kernel's launches on the host, in Python. A capture's warm-ups and
the capture itself launch through the wrapper, so they count; a replay
runs the captured kernels without the host, so it counts none. The
kernels a replay runs are seen on the device, by the profiler (their
names hold ``grmac``).

Which engines replay (``applies``) follows from the arch and the
runtime, never from a setting: a CUDA device, no mesh active (the SPMD
program runs eagerly), the sanitizer off (its instantiation and records
are chosen on every call), every block attention (``attn`` or
``local``: RG-LRU and SSM blocks swap state tensors out of the cache), a
dense FFN (MoE routing), a vocabulary that fills its padded width (the
head's padding mask builds a constant from the host, which a capture
cannot hold) and the kernel's route (``cim.backend != "ref"``: the plain
version is the independent oracle, and its temporaries at the largest
bucket do not fit the card).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scopes import named_scope
from repro_torch.parallel import sharding

__all__ = ["GRAPH_BLOCKS", "WARMUP", "applies", "runtime_allows",
           "replayable", "cache_leaves", "DispatchGraph"]

# the block kinds whose serving paths write the cache only in place
GRAPH_BLOCKS = ("attn", "local")
# eager runs before a capture (lazy set-up of libraries and workspaces)
WARMUP = 2


def applies(arch: ArchConfig, device: Union[str, torch.device]) -> bool:
    """Whether an engine of ``arch`` on ``device`` replays its dispatches
    from graphs under the runtime's present state (module docstring)."""
    return (torch.device(device).type == "cuda"
            and runtime_allows()
            and all(kind in GRAPH_BLOCKS for kind in arch.blocks())
            and not arch.is_moe
            and arch.padded_vocab == arch.vocab_size
            and arch.cim.backend != "ref")


def runtime_allows() -> bool:
    """No mesh is active and the sanitizer is off: read on every dispatch,
    since both can change after an engine captured."""
    return sharding.get_mesh() is None and not sanitize.enabled()


def cache_leaves(cache: dict) -> Tuple[torch.Tensor, ...]:
    """Every tensor of an engine's cache, in order."""
    return tuple(t for layer in cache["layers"] for t in layer.values())


def replayable(cache: dict, captured: Sequence[torch.Tensor]) -> bool:
    """The runtime allows graphs and ``cache`` still holds the very
    tensors the graphs were captured on."""
    leaves = cache_leaves(cache)
    return (runtime_allows() and len(leaves) == len(captured)
            and all(a is b for a, b in zip(leaves, captured)))


class DispatchGraph:
    """One dispatch, ``fn(*inputs) -> tuple of tensors``, captured on the
    static device buffers ``inputs`` (which must freeze every lane) into
    ``pool``; calling it with host arrays of the inputs' shapes replays it
    and returns the outputs (module docstring: consume them before the
    next replay)."""

    def __init__(self, fn: Callable[..., tuple],
                 inputs: Sequence[torch.Tensor], pool):
        self.inputs = tuple(inputs)
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = tuple(fn(*self.inputs))

    def __call__(self, *host: np.ndarray) -> tuple:
        with named_scope("engine.h2d"):
            for buf, a in zip(self.inputs, host):
                # a blocking copy: the host may change ``a`` right after
                buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        self.graph.replay()
        return self.outputs
