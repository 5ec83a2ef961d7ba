"""Hashed-prefix cache of per-slot prefill snapshots: the port's
counterpart of ``repro.serving.prefix_cache``.

Shared prefixes prefill once: a trie keyed on token-id chunks stores
snapshots of one lane's caches, and ``Engine.begin_request`` adopts the
longest cached prefix into the claimed lane, so only the suffix is
dispatched.

Key alignment: trie edges are ``chunk_tokens``-token tuples and snapshots
live only at multiples of ``chunk_tokens``, which the engine sets to its
``prefill_bucket_min``; after adopting P tokens the suffix prefills
through the same power-of-two buckets as a cold prompt from cache index
P.

Snapshot layout: ``{"kinds": (...), "layers": [...]}``, one dict of
tensors a layer in the engine cache's order, the lane's axis dropped; the
kind comes from ``arch.blocks()``:

* ``attn`` — global attention writes K/V linearly by position: the
  snapshot holds K/V rows ``[:P]``; restore writes them back there.
* ``local`` — the ring buffers whole (validity follows from the restored
  length).
* ``rglru`` / ``ssm`` — the recurrent state ``h`` and the conv window
  whole: the whole prefix in a few KB.

The engine changes its caches in place (K/V rows and ring slots are
written into the tensors, a freed lane is zeroed before reuse), so a
snapshot is a copy (``clone``) and a restore copies into the lane
(``copy_``): a stored prefix never aliases a live lane. Capture and
restore stay on the device; nothing crosses to the host.

Attention-only subsumption: when every layer is ``attn``, a stored
snapshot of N tokens serves any shorter shared prefix P < N by slicing
its rows to ``[:P]``, so lookup matches the divergence point. Recurrent
states cannot be rewound: other archs hit only at stored boundaries.

Eviction: one LRU over snapshot-bearing trie nodes under ``byte_budget``
(the snapshots' ``numel() * element_size()``); a hit refreshes recency
(a sliced hit its donor's); an insert past the budget evicts the least
recently used entries; an entry larger than the whole budget is refused;
evicted nodes prune their empty trie paths. The counters
``hits/misses/inserts/evictions/hit_tokens/bytes`` are functions of the
request stream alone.

Lookup always leaves at least one suffix token, so ``finish_prefill``
selects the first output from real last-token logits.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "snapshot_slot", "restore_slot"]


def snapshot_slot(cache: dict, slot: int, length: int,
                  kinds: Sequence[str]) -> dict:
    """A copy of one lane of ``cache`` at prefix ``length``: an ``attn``
    layer's first ``length`` K/V rows, every other layer's tensors
    whole."""
    layers = []
    for kind, layer in zip(kinds, cache["layers"]):
        rows = slice(0, length) if kind == "attn" else slice(None)
        layers.append({name: t[slot, rows].clone()
                       for name, t in layer.items()})
    return {"kinds": tuple(kinds), "layers": layers}


def restore_slot(cache: dict, slot: int, length: int, snap: dict) -> dict:
    """Write a snapshot into one lane of ``cache`` (in place; the inverse
    of ``snapshot_slot``) and return the cache."""
    for kind, layer, saved in zip(snap["kinds"], cache["layers"],
                                  snap["layers"]):
        rows = slice(0, length) if kind == "attn" else slice(None)
        for name, t in saved.items():
            layer[name][slot, rows].copy_(t)
    return cache


def _snap_bytes(snap: dict) -> int:
    return sum(t.numel() * t.element_size()
               for layer in snap["layers"] for t in layer.values())


def _slice_snapshot(snap: dict, length: int) -> dict:
    """An attention-only snapshot rewound to a shorter prefix: every K/V
    tensor's rows cut to ``[:length]`` (views; a restore copies them)."""
    return {"kinds": snap["kinds"],
            "layers": [{name: t[:length] for name, t in layer.items()}
                       for layer in snap["layers"]]}


def _sliceable(snap: dict) -> bool:
    return all(kind == "attn" for kind in snap["kinds"])


class _Node:
    __slots__ = ("children", "parent", "edge", "snap", "length", "nbytes")

    def __init__(self, parent=None, edge=None):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.edge = edge          # chunk tuple keying this node in parent
        self.snap = None          # snapshot, or None (path-only node)
        self.length = 0           # prefix tokens covered by self.snap
        self.nbytes = 0


class PrefixCache:
    """Chunk-aligned prefix trie with LRU-evicted per-slot snapshots.

    ``chunk_tokens`` must equal the engine's ``prefill_bucket_min`` (the
    engine checks it when the cache is wired in)."""

    def __init__(self, byte_budget: int, chunk_tokens: int = 8):
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.chunk = int(chunk_tokens)
        self.byte_budget = int(byte_budget)
        self._root = _Node()
        # LRU over snapshot-bearing nodes, oldest first (dicts keep
        # insertion order; a touch deletes and re-adds)
        self._lru: Dict[_Node, None] = {}
        self._sliceable: Optional[bool] = None   # learned at first insert
        self.stats = {"hits": 0, "misses": 0, "inserts": 0,
                      "evictions": 0, "hit_tokens": 0, "bytes": 0}

    # ------------------------------------------------------------- lookup
    def lookup(self, prompt: List[int]) -> Optional[Tuple[int, dict]]:
        """Longest usable cached prefix of ``prompt`` as ``(length,
        snapshot)``, or None; at most ``len(prompt) - 1`` tokens, so a
        suffix token remains. Counts one hit or miss."""
        usable = (len(prompt) - 1) // self.chunk   # whole chunks adoptable
        node, depth = self._root, 0
        best: Optional[_Node] = None
        while depth < usable:
            nxt = node.children.get(
                tuple(prompt[depth * self.chunk:(depth + 1) * self.chunk]))
            if nxt is None:
                break
            node, depth = nxt, depth + 1
            if node.snap is not None:
                best = node
        if self._sliceable and depth > (best.length // self.chunk
                                        if best else 0):
            # attention-only: any stored descendant of the deepest matched
            # node shares its first depth * chunk tokens with the prompt;
            # slice the most recently used one down to the match point
            donor = self._mru_descendant(node)
            if donor is not None and donor.length > depth * self.chunk:
                self._touch(donor)
                self.stats["hits"] += 1
                self.stats["hit_tokens"] += depth * self.chunk
                return depth * self.chunk, _slice_snapshot(
                    donor.snap, depth * self.chunk)
        if best is None:
            self.stats["misses"] += 1
            return None
        self._touch(best)
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += best.length
        return best.length, best.snap

    def _mru_descendant(self, node: _Node) -> Optional[_Node]:
        """The most recently used snapshot-bearing node in ``node``'s
        subtree (itself included)."""
        for cand in reversed(self._lru):
            n = cand
            while n is not None:
                if n is node:
                    return cand
                n = n.parent
        return None

    # ------------------------------------------------------------- insert
    def insert(self, prefix: List[int],
               snap_fn: Callable[[], dict]) -> bool:
        """Store a snapshot for ``prefix`` (a positive multiple of
        ``chunk`` tokens). ``snap_fn()`` builds it, and is not called when
        the boundary is already stored (an equal prefix gives an equal
        state). True when a new entry was stored."""
        n = len(prefix)
        if n <= 0 or n % self.chunk:
            raise ValueError(
                f"prefix length {n} not a positive multiple of chunk "
                f"{self.chunk}")
        node = self._root
        for d in range(n // self.chunk):
            key = tuple(prefix[d * self.chunk:(d + 1) * self.chunk])
            nxt = node.children.get(key)
            if nxt is None:
                nxt = node.children[key] = _Node(node, key)
            node = nxt
        if node.snap is not None:
            self._touch(node)
            return False
        snap = snap_fn()
        nbytes = _snap_bytes(snap)
        if nbytes > self.byte_budget:
            # can never fit: refuse, and prune the path this call made
            self._prune(node)
            return False
        if self._sliceable is None:
            self._sliceable = _sliceable(snap)
        node.snap, node.length, node.nbytes = snap, n, nbytes
        self._lru[node] = None
        self.stats["bytes"] += nbytes
        self.stats["inserts"] += 1
        while self.stats["bytes"] > self.byte_budget:
            self._evict(next(iter(self._lru)))
        return True

    # ----------------------------------------------------------- internals
    def _touch(self, node: _Node) -> None:
        del self._lru[node]
        self._lru[node] = None

    def _evict(self, node: _Node) -> None:
        self.stats["bytes"] -= node.nbytes
        self.stats["evictions"] += 1
        node.snap, node.length, node.nbytes = None, 0, 0
        del self._lru[node]
        self._prune(node)

    @staticmethod
    def _prune(node: _Node) -> None:
        """Drop ``node`` and its ancestors while they hold nothing."""
        while (node.parent is not None and not node.children
               and node.snap is None):
            parent = node.parent
            del parent.children[node.edge]
            node = parent

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def bytes(self) -> int:
        return self.stats["bytes"]

    def hit_rate(self) -> float:
        n = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / n if n else 0.0

